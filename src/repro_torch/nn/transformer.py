"""Config-driven decoder LM (port of ``repro/nn/transformer.py``:
``TransformerLM`` and ``build_model``) for the dense families (stablelm-3b,
phi4-mini-3.8b, granite-20b, internvl2-26b's backbone, gemma2-27b) and the
MoE families (deepseek-v2-lite-16b with MLA, kimi-k2-1t-a32b).

The model is built from a ``ModelConfig`` as layer groups, one
``nn.ModuleList`` per group (the reference scans a stacked group;
``params.py`` carries weights across). The dense families are one plain
stack; gemma2's ``window_pattern="alternating"`` is one group of
(local, global) :class:`LayerPair` s, the reference's ``("pair", a, b)``
group. A MoE config's first ``first_k_dense`` layers are a group of their
own with a dense MLP of width ``dense_ff`` (deepseek's and kimi's one
leading layer), then one group of MoE layers; ``attention_kind="mla"``
takes ``MLAttention``. Learned positions (granite), a precomputed modality
prefix (internvl's 256 patch embeddings), tied or untied heads, scaled
embeddings, the attention and final softcaps and gemma2's post-norms.

Training: ``forward(..., remat=True)`` (the default, as the reference's)
recomputes each layer's activations in the backward
(``torch.utils.checkpoint``, the reference's ``nothing_saveable``
checkpoint of each scanned layer); it engages only where autograd
records and no cache is given. The aux loss is the sum of the MoE layers'
load-balance losses (0 for a dense model).

Decode: ``init_cache`` gives one layer-stacked buffer per group (per half
of a pair group): (L, B, Hkv, max_len, D) ``k`` / ``v``, or MLA's latent
rows ``ckv`` (L, B, 1, max_len, r + dr), the shape
``ops.decode_attention(layer=)`` reads in place; ``forward(tokens,
cache=, cache_index=)`` writes the new rows and returns the same cache
dict.

Families the port has not taken yet raise ``NotImplementedError`` naming
their ROADMAP item: SSMs (hymba's mostly-local groups come with its SSM
heads), enc-dec.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.encodings import Rope1D
from repro_torch.device import resolve_device
from repro_torch.nn.attention import Attention, MLAttention, cache_step
from repro_torch.nn.blocks import Block, make_norm
from repro_torch.nn.layers import Dense, Embedding
from repro_torch.nn.mlp import MLP, GatedMLP
from repro_torch.nn.module import init_params
from repro_torch.nn.moe import MoE


def unsupported(cfg) -> Optional[str]:
    """Why the port cannot build ``cfg`` yet (with the ROADMAP item that
    will port it), or None for the dense and MoE families."""
    if cfg.enc_dec:
        return "encoder-decoder models (ROADMAP A10.5)"
    if (cfg.ssm is not None or cfg.parallel_ssm
            or cfg.attention_kind == "none" or cfg.mlp_kind == "rwkv"):
        return "SSM and RWKV mixers (ROADMAP A10.4)"
    if cfg.window_pattern == "mostly_local":
        return "hymba's mostly-local layer groups (ROADMAP A10.4)"
    return None


class LayerPair(nn.Module):
    """gemma2's scanned unit: a local (windowed) block ``a`` and a global
    block ``b``; its cache is ``{"a": ..., "b": ...}``, each stacked over
    the group's pairs."""

    def __init__(self, a: Block, b: Block):
        super().__init__()
        self.a, self.b = a, b

    def forward(self, x, pose=None, *, cache=None, layer: int = 0,
                step=None, impl=None):
        x, aux_a = self.a(x, pose, cache=None if cache is None
                          else cache["a"], layer=layer, step=step, impl=impl)
        x, aux_b = self.b(x, pose, cache=None if cache is None
                          else cache["b"], layer=layer, step=step, impl=impl)
        if aux_a is None or aux_b is None:
            return x, aux_a if aux_b is None else aux_b
        return x, aux_a + aux_b


class TransformerLM(nn.Module):
    """Decoder-only LM; built on ``device`` (default ``cuda``; raises
    without a card unless ``device="cpu"``, ``"meta"`` for shapes only)
    with weights drawn from ``generator`` (default: a CPU generator seeded
    0). ``impl`` is every attention call's (default "auto": the kernels on
    the card, their plain versions on the CPU)."""

    def __init__(self, cfg, impl: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        why = unsupported(cfg)
        if why is not None:
            raise NotImplementedError(f"{cfg.name}: the port does not have "
                                      f"{why} yet")
        self.cfg = cfg
        self.impl = impl or "auto"
        dev = resolve_device(device)
        d = cfg.d_model
        self.embedding = Embedding(cfg.padded_vocab, d, dev,
                                   scale_by_sqrt_dim=cfg.scale_embeddings)
        # the reference's layer groups (``_build_groups``): a MoE config's
        # leading dense layers, then one plain stack or gemma2's (local,
        # global) pairs
        groups, n = [], cfg.num_layers
        moe = cfg.moe is not None
        if moe and cfg.moe.first_k_dense:
            k = cfg.moe.first_k_dense
            groups.append(nn.ModuleList(
                self._block(dev, d_ff=cfg.moe.dense_ff or cfg.d_ff)
                for _ in range(k)))
            n -= k
        if cfg.window_pattern == "alternating":
            if n % 2:
                raise ValueError(f"{cfg.name}: alternating layers need an "
                                 f"even count, got {n}")
            groups.append(nn.ModuleList(
                LayerPair(self._block(dev, cfg.window, moe=moe),
                          self._block(dev, moe=moe))
                for _ in range(n // 2)))
        else:
            groups.append(nn.ModuleList(
                self._block(dev, cfg.window, moe=moe) for _ in range(n)))
        self.groups = nn.ModuleList(groups)
        self.final_norm = make_norm(cfg.norm, d, dev)
        if not cfg.tie_embeddings:
            self.lm_head = Dense((d,), (cfg.padded_vocab,), dev)
        if cfg.learned_positions:
            self.pos_embedding = Embedding(cfg.max_position, d, dev,
                                           scale=0.01)
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))

    def _attention(self, dev, window: Optional[int]) -> nn.Module:
        cfg = self.cfg
        if cfg.attention_kind == "mla":
            m = cfg.mla
            return MLAttention(
                cfg.d_model, cfg.num_q_heads, kv_lora_rank=m.kv_lora_rank,
                qk_nope_dim=m.qk_nope_dim, qk_rope_dim=m.qk_rope_dim,
                v_head_dim=m.v_head_dim, q_lora_rank=m.q_lora_rank,
                rope_base=cfg.rope_base, impl=self.impl, device=dev)
        hd = cfg.resolved_head_dim
        enc = None
        if cfg.pos_enc == "rope1d":
            rd = int(hd * cfg.rope_fraction)
            enc = Rope1D(head_dim=rd - rd % 2, base=cfg.rope_base)
        return Attention(cfg.d_model, cfg.num_q_heads, cfg.num_kv_heads, hd,
                         encoding=enc, rope_fraction=cfg.rope_fraction,
                         query_scale=cfg.query_scale, window=window,
                         softcap=cfg.attn_softcap or None,
                         use_bias=cfg.attn_bias, impl=self.impl, device=dev)

    def _block(self, dev, window: Optional[int] = None, moe: bool = False,
               d_ff: Optional[int] = None) -> Block:
        cfg = self.cfg
        attn = self._attention(dev, window)
        d_ff = d_ff or cfg.d_ff
        if moe:
            m = cfg.moe
            mlp = MoE(cfg.d_model, m.num_experts, m.top_k, m.expert_ff,
                      num_shared=m.num_shared,
                      capacity_factor=m.capacity_factor,
                      aux_weight=m.aux_weight, activation=cfg.activation,
                      device=dev)
        elif cfg.mlp_kind == "plain":
            mlp = MLP(cfg.d_model, d_ff, dev, activation=cfg.activation,
                      use_bias=cfg.attn_bias)
        else:
            mlp = GatedMLP(cfg.d_model, d_ff, dev, activation=cfg.activation)
        return Block(cfg.d_model, attn, mlp, norm=cfg.norm,
                     post_norms=cfg.norm == "rms_offset", device=dev)

    @property
    def device(self) -> torch.device:
        return self.embedding.embedding.device

    def forward(self, tokens: torch.Tensor, *,
                prefix_embeds: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, Any]] = None, cache_index=None,
                remat: bool = True):
        """tokens (B, S) -> (logits (B, S', padded_vocab) in the compute
        dtype, aux loss (float32: the MoE layers' load-balance losses
        summed, 0 for a dense model), cache).

        ``prefix_embeds`` (B, P, d_model) is prepended before the token
        embeddings (S' = P + S). With ``cache`` and ``cache_index`` (an int,
        or a (B,) tensor of per-slot cursors for single-token steps) the S'
        tokens are a decode chunk written at ``cache_index``; the cache is
        updated in place and returned. ``remat``: recompute each layer (or
        pair) in the backward instead of keeping its activations.
        """
        cfg = self.cfg
        dtype = cfg.compute_dtype
        x = self.embedding(tokens, dtype)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(dtype), x], 1)
        b, s, _ = x.shape
        ar = torch.arange(s, device=x.device)
        if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
            positions = cache_index.to(x.device, torch.int64)[:, None] + ar
        else:
            start = 0 if cache_index is None else int(cache_index)
            positions = (start + ar)[None].expand(b, s)
        if cfg.learned_positions:
            x = x + self.pos_embedding(positions, dtype)
        pose = positions.to(torch.float32)[..., None]
        step = None
        if cache is not None:
            g0 = cache["group0"]
            rows = next(iter(g0.get("a", g0).values()))   # "k" or MLA's "ckv"
            step = cache_step(cache_index, s, b, rows.shape[3], x.device)
        remat = remat and cache is None and torch.is_grad_enabled()
        aux = torch.zeros((), device=x.device)
        for gi, group in enumerate(self.groups):
            gc = cache[f"group{gi}"] if cache is not None else None
            for li, blk in enumerate(group):
                if remat:
                    x, layer_aux = checkpoint(blk, x, pose,
                                              use_reentrant=False,
                                              impl=self.impl)
                else:
                    x, layer_aux = blk(x, pose, cache=gc, layer=li,
                                       step=step, impl=self.impl)
                if layer_aux is not None:
                    aux = aux + layer_aux
        x = self.final_norm(x)
        if cfg.tie_embeddings:
            logits = self.embedding.attend(x)
        else:
            logits = self.lm_head(x)
        if cfg.final_softcap:
            logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
        return logits, aux, cache

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """{"group{i}": {"k", "v"[, "k_scale", "v_scale"]}} (MLA:
        {"ckv"}), each stacked over the group's layers (a pair group:
        {"a": ..., "b": ...}, each stacked over its pairs); ``dtype`` as
        ``Attention.init_cache`` (MLA takes no int8)."""
        def one(blk, n):
            return blk.attn.init_cache(batch, max_len, dtype, layers=n)

        return {f"group{gi}": ({"a": one(group[0].a, len(group)),
                                "b": one(group[0].b, len(group))}
                               if isinstance(group[0], LayerPair)
                               else one(group[0], len(group)))
                for gi, group in enumerate(self.groups)}


def build_model(cfg, impl: Optional[str] = None, *, device=None,
                generator: Optional[torch.Generator] = None
                ) -> TransformerLM:
    """The model of ``cfg`` (the reference's ``build_model``); raises
    ``NotImplementedError`` for a family the port has not taken yet."""
    return TransformerLM(cfg, impl, device=device, generator=generator)
