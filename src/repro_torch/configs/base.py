"""Model and run configurations and the architecture registry (port of
``repro/configs/base.py``).

``ModelConfig`` describes the ten LM architectures of
``repro_torch.configs.archs``; ``SimArch`` one row of the paper's Table I.
Nothing here imports the model stack: the methods that build models
import it lazily, so the configs load before any device is touched.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    expert_ff: int = 1024
    num_shared: int = 0
    first_k_dense: int = 0          # leading dense layers (deepseek/kimi)
    dense_ff: Optional[int] = None  # d_ff of those dense layers
    capacity_factor: float = 1.25
    aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"             # "mamba" | "rwkv6"
    state_size: int = 16
    head_dim: int = 64              # rwkv6 wkv head size
    d_inner: Optional[int] = None
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | hybrid | audio | ssm
    num_layers: int
    d_model: int
    num_q_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_q_heads
    # --- attention / positions ---
    attention_kind: str = "gqa"             # gqa | mla | none
    pos_enc: str = "rope1d"                 # rope1d | absolute | sinusoidal | none
    rope_base: float = 10000.0
    rope_fraction: float = 1.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    window: Optional[int] = None            # sliding window for local layers
    window_pattern: str = "none"            # none|alternating|mostly_local
    attn_bias: bool = False
    mla: Optional[MLAConfig] = None
    # --- channel mixer ---
    activation: str = "silu"
    mlp_kind: str = "gated"                 # gated | plain | rwkv
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    parallel_ssm: bool = False              # hymba
    # --- embeddings / norms ---
    norm: str = "rms"                       # rms | layer | rms_offset
    tie_embeddings: bool = False
    scale_embeddings: bool = False          # gemma sqrt(d) embed scaling
    learned_positions: bool = False         # granite / whisper decoder
    max_position: int = 1 << 20
    # --- enc-dec (whisper) ---
    enc_dec: bool = False
    encoder_layers: int = 0
    encoder_frames: int = 1500
    frontend_dim: Optional[int] = None      # stubbed modality frontend width
    # --- vlm ---
    vision_prefix: int = 0                  # patch-embedding prefix length
    # --- bookkeeping ---
    long_context_ok: bool = False           # sub-quadratic -> run long_500k
    notes: str = ""
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_q_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 (the reference's, for TP
        sharding over up to 16 chips)."""
        mult = 128
        return self.vocab_size + (-self.vocab_size) % mult

    def depth_variant(self, iters: int) -> "ModelConfig":
        """Full-width config whose every multi-layer group runs ``iters``
        iterations (the reference's): the dry-run counts two such variants
        and extrapolates linearly to the full depth (layer groups are
        homogeneous)."""
        if self.window_pattern == "alternating":
            n = 2 * iters
        elif self.window_pattern == "mostly_local":
            n = 3 + 2 * iters
        elif self.moe and self.moe.first_k_dense:
            n = self.moe.first_k_dense + iters
        else:
            n = iters
        kw = dict(num_layers=n)
        if self.enc_dec:
            kw["encoder_layers"] = iters
            kw["num_layers"] = iters
        return dataclasses.replace(self, **kw)

    def scan_iters(self) -> int:
        """Iterations across multi-layer groups: the variable of the
        dry-run's linear extrapolation, matching :meth:`depth_variant`."""
        if self.window_pattern == "alternating":
            return self.num_layers // 2
        if self.window_pattern == "mostly_local":
            return self.num_layers - 3
        if self.moe and self.moe.first_k_dense:
            return self.num_layers - self.moe.first_k_dense
        return self.num_layers   # an encoder-decoder's two stacks move together

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        n_small = min(self.num_layers,
                      2 + (self.moe.first_k_dense if self.moe else 0))
        if self.window_pattern == "mostly_local":
            n_small = 5       # pattern needs first/middle/last global layers
        small: Dict = dict(
            num_layers=n_small,
            d_model=128,
            num_q_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=32,
            d_ff=256,
            vocab_size=256,
            window=16 if self.window else None,
            max_position=4096,
        )
        if self.moe:
            small["moe"] = dataclasses.replace(
                self.moe, num_experts=8, top_k=2, expert_ff=64,
                dense_ff=256 if self.moe.dense_ff else None,
                capacity_factor=8.0)
        if self.mla:
            small["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_dim=16,
                                     qk_rope_dim=16, v_head_dim=32)
        if self.ssm:
            small["ssm"] = dataclasses.replace(
                self.ssm, d_inner=None, state_size=8,
                head_dim=32 if self.ssm.kind == "rwkv6" else self.ssm.head_dim,
                chunk=16)
        if self.enc_dec:
            small["encoder_layers"] = 2
            small["encoder_frames"] = 32
            small["frontend_dim"] = 128
        if self.vision_prefix:
            small["vision_prefix"] = 8
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class SimArch:
    """Scene-transformer hyperparameters paired with the ScenarioConfig
    whose action grid it predicts (one row of the paper's Table I)."""
    name: str
    encoding: str                 # absolute | rope2d | se2_repr | se2_fourier
    d_model: int = 256
    num_layers: int = 6
    num_heads: int = 8
    head_dim: int = 24
    d_ff: int = 1024
    fourier_terms: int = 12
    pos_scale: float = 0.05
    num_map: int = 48
    num_agents: int = 12
    num_steps: int = 24
    dtype: str = "float32"
    notes: str = ""

    def scenario_config(self):
        from repro_torch.scenarios.core import ScenarioConfig
        return ScenarioConfig(num_map=self.num_map,
                              num_agents=self.num_agents,
                              num_steps=self.num_steps)

    def agent_sim_config(self):
        from repro_torch.nn.agent_sim import AgentSimConfig
        scen = self.scenario_config()
        return AgentSimConfig(
            d_model=self.d_model, num_layers=self.num_layers,
            num_heads=self.num_heads, head_dim=self.head_dim,
            d_ff=self.d_ff, num_actions=scen.num_actions,
            agent_feat_dim=scen.agent_feat_dim,
            map_feat_dim=scen.map_feat_dim,
            encoding=self.encoding, fourier_terms=self.fourier_terms,
            pos_scale=self.pos_scale, dtype=self.dtype)

    def reduced(self, **overrides) -> "SimArch":
        """CPU-sized same-encoding config."""
        small: Dict = dict(d_model=64, num_layers=2, num_heads=4,
                           head_dim=24, d_ff=256,
                           num_map=16, num_agents=6, num_steps=10,
                           dtype="float32")
        small.update(overrides)
        return dataclasses.replace(self, **small)


_REGISTRY: Dict[str, ModelConfig] = {}
SIM_ARCHS: Dict[str, SimArch] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def register_sim(arch: SimArch) -> SimArch:
    SIM_ARCHS[arch.name] = arch
    return arch


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (ensure registrations ran)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    import repro_torch.configs  # noqa: F401
    return dict(_REGISTRY)


def get_sim_arch(name: str) -> SimArch:
    import repro_torch.configs  # noqa: F401
    if name not in SIM_ARCHS:
        raise KeyError(f"unknown sim arch {name!r}; have {sorted(SIM_ARCHS)}")
    return SIM_ARCHS[name]
