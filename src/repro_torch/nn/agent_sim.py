"""Agent-simulation model (port of ``repro/nn/agent_sim.py``).

Scene tokens are [map..., agents@t0, agents@t1, ...], each with an SE(2)
pose; attention is block-causal over times (map tokens have time 0, agents
at step t time t + 1) with segment ids masking invalid tokens. The model
predicts a categorical distribution over the action grid for every agent
token. The attention mechanism is one of the four rows of the paper's
Table I:

* ``absolute``: a Fourier-feature pose embedding added to the token
  features, standard attention;
* ``rope2d``: translation invariant only (Sec. II-D): q and k rotated by
  the token's (x, y), values untransformed;
* ``se2_repr``: the homogeneous-matrix SE(2) representation (Sec. II-E):
  q, k and v transformed, the output untransformed;
* ``se2_fourier``: the paper's encoding (Sec. III), whose transforms run
  in the SE(2) projection kernels in both directions.

``rope2d`` and ``se2_repr`` transform in plain PyTorch (the reference
computes them outside any TPU kernel).

Incremental decode: a cached key/value row is ``phi_k(p_m) k`` / ``phi_k(p_m)
v``, which depends only on token m's own pose, and a token's output never
changes when later tokens arrive (block-causal times), so ``prefill`` plus
repeated ``step`` reproduces the full forward. The cache is one stacked
(L, B, H, S_max, c) buffer per K and V; each layer writes only its n new
rows, in place, and the decode kernel reads the buffer in place at the
layer's index. Nothing copies a layer slice or the whole cache in a tick.

Compute dtype (``AgentSimConfig.dtype``): "float32", or "bfloat16" with
the reference's rules. Parameters stay float32 and each ``Dense`` casts its
kernel to its input's dtype (the train and eval steps cast every parameter
first, ``params.cast``, as the reference's ``cast_params``); token
features, the pose embedding and the blocks compute in bf16; ``RMSNorm``
normalises in float32; the encodings take angles and scales in float32;
the cache defaults to the compute dtype; the logits come out in the
compute dtype, and log-softmax, the NLL and the sampler read them as
float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.encodings import GroupEncoding, make_encoding
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import canonical_cache_dtype, quantize_kv
from repro_torch.kernels.se2_project import (se2_fourier_project,
                                             se2_fourier_project_t)
from repro_torch.nn.attention import _merge_heads, _split_heads
from repro_torch.nn.layers import Dense, RMSNorm
from repro_torch.nn.mlp import GatedMLP
from repro_torch.nn.module import init_params


@dataclasses.dataclass(frozen=True)
class AgentSimConfig:
    d_model: int = 256
    num_layers: int = 4
    num_heads: int = 8
    head_dim: int = 24
    d_ff: int = 1024
    num_actions: int = 63         # 7 accel bins x 9 yaw-rate bins
    agent_feat_dim: int = 8
    map_feat_dim: int = 8
    encoding: str = "se2_fourier"
    fourier_terms: int = 12
    min_scale: float = 0.25
    max_scale: float = 1.0
    pos_scale: float = 0.05       # world meters -> encoder units
    #: full forward (``ops.attention``): "auto" runs the flash forward and
    #: backward kernels on the card and their plain versions on the CPU
    attn_impl: str = "auto"
    #: cached decode path (``ops.decode_attention``): "auto" runs the CUDA
    #: kernel on the card and its plain version on the CPU
    decode_impl: str = "auto"
    #: compute dtype: "float32" or "bfloat16" (parameters stay float32;
    #: Dense casts its kernel to its input's dtype)
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def build_sim_encoding(cfg: AgentSimConfig) -> Optional[GroupEncoding]:
    """The attention's encoding with the reference's own settings; None
    for ``absolute``, whose attention transforms nothing."""
    if cfg.encoding == "absolute":
        return None
    kwargs: Dict[str, Any] = {}
    if cfg.encoding == "se2_fourier":
        kwargs = dict(num_terms=cfg.fourier_terms, min_scale=cfg.min_scale,
                      max_scale=cfg.max_scale)
    elif cfg.encoding == "se2_repr":
        kwargs = dict(min_scale=cfg.min_scale, max_scale=cfg.max_scale)
    elif cfg.encoding == "rope2d":
        kwargs = dict(max_freq=cfg.max_scale, base=100.0)
    return make_encoding(cfg.encoding, cfg.head_dim, **kwargs)


def _row_index(cursor: torch.Tensor, n: int, max_len: int) -> torch.Tensor:
    """(B, n) cache positions [start, start + n) per slot, where start is
    the cursor clamped to [0, max_len - n], as ``dynamic_update_slice``
    clamps the reference's writes: a retired server slot whose cursor sits
    at ``max_len`` is still decoded (and discarded) every tick, and its rows
    land at ``max_len - n``, past any live row."""
    start = torch.clamp(cursor.to(torch.int64), 0, max_len - n)
    return start[:, None] + torch.arange(n, device=cursor.device)[None, :]


def install_slot_rows(cache, sub, si: int, n_rows: int):
    """Install the first ``n_rows`` rows of a freshly written 1-slot cache
    ``sub`` into slot ``si`` of a multi-slot cache, in place
    (continuous-batching admission: a retiring scene's slot is reused by
    the next scene); returns ``cache``.

    Only rows ``[0, n_rows)`` and the slot's cursor are written: rows at
    and past the reset cursor keep whatever the evicted scene left there,
    segment ids claiming validity included. They are unreachable, because
    every decode masks key positions >= ``kv_length = cursor + n`` and the
    cursor only ever advances over freshly written rows.
    """
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in cache:
            cache[key][:, si, :, :n_rows] = sub[key][:, 0, :, :n_rows]
    for key in ("times", "seg"):
        cache[key][si, :n_rows] = sub[key][0, :n_rows]
    cache["cursor"][si].copy_(sub["cursor"][0])
    return cache


def _write_layer_rows(buf: torch.Tensor, layer: int, new: torch.Tensor,
                      rows: torch.Tensor) -> None:
    """Write one layer's new rows into the stacked cache in place.

    buf (L, B, H, S, c) or (L, B, H, S); new (B, H, n, c) / (B, H, n);
    rows (B, n) from :func:`_row_index`, inside [0, S). One scatter of the
    B * H * n new rows into the layer's view.
    """
    b, h = new.shape[0], new.shape[1]
    bi = torch.arange(b, device=buf.device)[:, None, None]
    hi = torch.arange(h, device=buf.device)[None, :, None]
    buf[layer][bi, hi, rows[:, None, :]] = new.to(buf.dtype)


class SimAttention(nn.Module):
    """Relative attention over scene tokens: Algorithm 2 around the
    attention kernel, block-causal over times."""

    def __init__(self, cfg: AgentSimConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.enc = build_sim_encoding(cfg)
        d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
        self.q = Dense((d,), (h, hd), device)
        self.k = Dense((d,), (h, hd), device)
        self.v = Dense((d,), (h, hd), device)
        self.o = Dense((h, hd), (d,), device)

    @property
    def cache_dims(self) -> Tuple[int, int]:
        """(key_dim, value_dim) of one cached row (post-transform)."""
        if self.enc is None:
            return self.cfg.head_dim, self.cfg.head_dim
        return self.enc.expanded_dim, self.enc.expanded_v_dim

    def _qkv(self, x, pose):
        """q~, k~, v~ (B, H, n, .) for new tokens x (B, n, d_model) at
        encoder-scaled poses (B, n, 3). ``se2_fourier``: the SE(2)
        projection kernel in mode "q" for queries and mode "k" for keys and
        values; ``rope2d`` / ``se2_repr``: the encoding's transforms
        (``rope2d`` reads (x, y) and leaves values alone); ``absolute``:
        none."""
        h, hd = self.cfg.num_heads, self.cfg.head_dim
        q = _split_heads(self.q(x), h, hd).contiguous()
        k = _split_heads(self.k(x), h, hd).contiguous()
        v = _split_heads(self.v(x), h, hd).contiguous()
        if self.cfg.encoding == "se2_fourier":
            return (se2_fourier_project(q, pose, self.enc, "q"),
                    se2_fourier_project(k, pose, self.enc, "k"),
                    se2_fourier_project(v, pose, self.enc, "k"))
        if self.enc is None:
            return q, k, v
        p4 = pose[:, None]                                  # (B, 1, n, 3)
        if self.enc.pose_dim == 2:
            p4 = p4[..., :2]
        q = self.enc.transform_q(q, p4).contiguous()
        k = self.enc.transform_k(k, p4).contiguous()
        if self.enc.transforms_values:
            v = self.enc.transform_v(v, p4).contiguous()
        return q, k, v

    def _finish(self, out, pose):
        """phi_q o~ where the encoding transforms values (``se2_fourier``:
        the transposed "q" projection; ``se2_repr``: ``untransform_out``),
        then the output projection."""
        if self.cfg.encoding == "se2_fourier":
            out = se2_fourier_project_t(out.contiguous(), pose, self.enc,
                                        "q")
        elif self.enc is not None and self.enc.transforms_values:
            out = self.enc.untransform_out(out, pose[:, None])
        return self.o(_merge_heads(out))

    def forward(self, x, pose, times, segment_ids):
        q, k, v = self._qkv(x, pose)
        out = ops.attention(q, k, v, impl=self.cfg.attn_impl,
                            scale=1.0 / float(self.cfg.head_dim) ** 0.5,
                            causal=True, q_times=times, k_times=times,
                            q_segment_ids=segment_ids,
                            k_segment_ids=segment_ids)
        return self._finish(out, pose)

    def decode_step(self, x, pose, times, segment_ids, cache, layer: int,
                    rows, kv_length, impl: str):
        """Attend n new tokens over the cache and write their rows.

        x (B, n, d_model); pose (B, n, 3) encoder-scaled; times /
        segment_ids (B, n); ``cache`` the model's stacked cache, whose
        ``times`` / ``seg`` already hold the new rows; ``rows`` (B, n) the
        positions the new rows go to; ``kv_length`` (B,) int32 = cursor + n.
        int8 caches are quantized on write (one scale per row).
        """
        q, k_new, v_new = self._qkv(x, pose)
        if "k_scale" in cache:
            for key, new in (("k", k_new), ("v", v_new)):
                vals, scales = quantize_kv(new)
                _write_layer_rows(cache[key], layer, vals, rows)
                _write_layer_rows(cache[f"{key}_scale"], layer, scales, rows)
        else:
            _write_layer_rows(cache["k"], layer, k_new, rows)
            _write_layer_rows(cache["v"], layer, v_new, rows)
        out = ops.decode_attention(
            q, cache["k"], cache["v"], kv_length=kv_length, layer=layer,
            impl=impl, scale=1.0 / float(self.cfg.head_dim) ** 0.5,
            q_times=times, k_times=cache["times"],
            q_segment_ids=segment_ids, k_segment_ids=cache["seg"],
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
        return self._finish(out, pose)


class SimBlock(nn.Module):
    def __init__(self, cfg: AgentSimConfig, device=None):
        super().__init__()
        self.attn = SimAttention(cfg, device)
        self.mlp = GatedMLP(cfg.d_model, cfg.d_ff, device)
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        self.norm2 = RMSNorm(cfg.d_model, device=device)


class AgentSimModel(nn.Module):
    """Scene transformer -> per-(agent, t) action logits.

    Built on ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``) with weights drawn from ``generator`` (default: a
    CPU generator seeded 0).
    """

    #: frequencies of the ``absolute`` baseline's pose embedding
    pose_freqs = 16

    def __init__(self, cfg: AgentSimConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute dtype must be float32 or bfloat16, "
                             f"got {cfg.dtype!r}")
        self.cfg = cfg
        dev = resolve_device(device)
        d = cfg.d_model
        self.map_enc = Dense((cfg.map_feat_dim,), (d,), dev)
        self.agent_enc = Dense((cfg.agent_feat_dim,), (d,), dev)
        self.blocks = nn.ModuleList(SimBlock(cfg, dev)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(d, device=dev)
        self.head = Dense((d,), (cfg.num_actions,), dev)
        if cfg.encoding == "absolute":
            # the absolute baseline's Fourier pose embedding
            self.pose_proj = Dense((3 * self.pose_freqs,), (d,), dev)
            self.register_buffer("pose_ladder", torch.as_tensor(
                2.0 ** np.arange(self.pose_freqs // 2), dtype=torch.float32,
                device=dev), persistent=False)
        self.register_buffer("pose_scale", torch.tensor(
            [cfg.pos_scale, cfg.pos_scale, 1.0], device=dev), persistent=False)
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))

    @property
    def device(self) -> torch.device:
        return self.head.kernel.device

    def _pose_embedding(self, pose):
        """Fourier features of the raw (x, y, theta), x and y times
        ``pos_scale``, projected to d_model (``absolute`` only)."""
        s = self.cfg.pos_scale
        scaled = torch.cat([pose[..., 0:1] * s, pose[..., 1:2] * s,
                            pose[..., 2:3]], -1)
        ang = scaled[..., None] * self.pose_ladder        # (..., 3, PF/2)
        feats = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
        return self.pose_proj(feats.reshape(*pose.shape[:-1],
                                            3 * self.pose_freqs))

    def _with_pose(self, x, pose):
        """Token features plus the pose embedding (computed in float32,
        added in the compute dtype) where the encoding is ``absolute``."""
        if self.cfg.encoding == "absolute":
            return x + self._pose_embedding(pose.to(torch.float32)).to(
                x.dtype)
        return x

    def _enc_pose(self, pose):
        return (pose.to(torch.float32) * self.pose_scale).contiguous()

    def tokenize(self, batch: Dict[str, torch.Tensor]):
        """(pose (B, S, 3), times (B, S), segment_ids (B, S)) with
        S = M + T * A."""
        b, m, _ = batch["map_feats"].shape
        _, t, a, _ = batch["agent_feats"].shape
        dev = batch["map_feats"].device
        pose = torch.cat([batch["map_pose"],
                          batch["agent_pose"].reshape(b, t * a, 3)], 1)
        agent_t = (1 + torch.arange(t, dtype=torch.int32, device=dev))
        times = torch.cat([torch.zeros((b, m), dtype=torch.int32, device=dev),
                           agent_t[None, :, None].expand(b, t, a)
                           .reshape(b, t * a)], 1)
        valid = torch.cat([batch["map_valid"],
                           batch["agent_valid"].reshape(b, t * a)], 1)
        seg = torch.where(valid, 0, -1).to(torch.int32)
        return pose, times, seg

    def _embed(self, batch):
        b = batch["map_feats"].shape[0]
        _, t, a, _ = batch["agent_feats"].shape
        dt = self.cfg.compute_dtype
        mtok = self.map_enc(batch["map_feats"].to(dt))
        atok = self.agent_enc(batch["agent_feats"].to(dt))
        return torch.cat([mtok, atok.reshape(b, t * a, -1)], 1)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Full forward: logits (B, T, A, num_actions) in the compute
        dtype, differentiable in the parameters (which are created with
        ``requires_grad=False``; the train step switches gradients on)."""
        b, m, _ = batch["map_feats"].shape
        _, t, a, _ = batch["agent_feats"].shape
        pose, times, seg = self.tokenize(batch)
        x = self._with_pose(self._embed(batch), pose)
        enc_pose = self._enc_pose(pose)
        for blk in self.blocks:
            x = x + blk.attn(blk.norm1(x), enc_pose, times, seg)
            x = x + blk.mlp(blk.norm2(x))
        logits = self.head(self.final_norm(x)[:, m:])
        return logits.reshape(b, t, a, self.cfg.num_actions)

    # -- incremental decode -------------------------------------------------

    def init_cache(self, batch_size: int, max_len: int, dtype=None):
        """Preallocate the decode cache for ``batch_size`` slots.

        ``k`` / ``v`` (L, B, H, max_len, c) in the storage dtype (float32,
        bfloat16 or int8, by default the compute dtype, as the
        reference's; int8 adds per-row float32 ``k_scale`` /
        ``v_scale`` (L, B, H, max_len)); layer-independent ``times``,
        ``seg`` (B, max_len) int32, ``seg`` starting at -1 so unwritten rows
        are masked; ``cursor`` (B,) int32.
        """
        cfg = self.cfg
        dtype = canonical_cache_dtype(dtype, default=cfg.compute_dtype)
        ck, cv = self.blocks[0].attn.cache_dims
        l, b, h, s = cfg.num_layers, batch_size, cfg.num_heads, max_len
        dev = self.device
        cache = {
            "k": torch.zeros((l, b, h, s, ck), dtype=dtype, device=dev),
            "v": torch.zeros((l, b, h, s, cv), dtype=dtype, device=dev),
            "times": torch.zeros((b, s), dtype=torch.int32, device=dev),
            "seg": torch.full((b, s), -1, dtype=torch.int32, device=dev),
            "cursor": torch.zeros((b,), dtype=torch.int32, device=dev),
        }
        if dtype == torch.int8:
            cache["k_scale"] = torch.zeros((l, b, h, s), device=dev)
            cache["v_scale"] = torch.zeros((l, b, h, s), device=dev)
        return cache

    @torch.no_grad()
    def _extend(self, cache, x, pose, times, segment_ids, impl=None):
        """Feed n new tokens through every layer against the cache.

        x (B, n, d_model); pose (B, n, 3) world poses; times / segment_ids
        (B, n). Updates ``cache`` in place (rows, times, seg) and returns
        (logits (B, n, num_actions), cache) with the cursor advanced by n.
        """
        n = x.shape[1]
        cursor = cache["cursor"]
        rows = _row_index(cursor, n, cache["seg"].shape[1])
        bi = torch.arange(x.shape[0], device=x.device)[:, None]
        cache["times"][bi, rows] = times
        cache["seg"][bi, rows] = segment_ids
        kv_length = cursor + n
        enc_pose = self._enc_pose(pose)
        impl = impl or self.cfg.decode_impl
        for li, blk in enumerate(self.blocks):
            x = x + blk.attn.decode_step(blk.norm1(x), enc_pose, times,
                                         segment_ids, cache, li, rows,
                                         kv_length, impl)
            x = x + blk.mlp(blk.norm2(x))
        logits = self.head(self.final_norm(x))
        cache["cursor"] = kv_length
        return logits, cache

    def prefill(self, cache, batch, impl=None):
        """Write a scene's map and agent history into the cache; returns
        (logits (B, T, A, num_actions) of the history's agent tokens,
        cache)."""
        b, m, _ = batch["map_feats"].shape
        _, t, a, _ = batch["agent_feats"].shape
        pose, times, seg = self.tokenize(batch)
        logits, cache = self._extend(
            cache, self._with_pose(self._embed(batch), pose), pose, times,
            seg, impl=impl)
        return logits[:, m:].reshape(b, t, a, self.cfg.num_actions), cache

    def admit_map(self, cache, map_feats, map_pose, map_valid, impl=None):
        """Write ONLY a scene's map tokens into the cache: times 0, segment
        0 where ``map_valid``, else -1.

        The continuous-batching admission primitive: the map is the one
        token block whose width (M) differs from a tick's A agent tokens,
        so a server admits a scene by writing its map here and then
        streams the history through the shared tick (``step`` with
        teacher-forced inputs). map_feats (B, M, Fm); map_pose (B, M, 3);
        map_valid (B, M) bool. Returns (the map tokens' logits, which
        callers discard, and the cache)."""
        b, m, _ = map_feats.shape
        x = self._with_pose(
            self.map_enc(map_feats.to(self.cfg.compute_dtype)), map_pose)
        times = torch.zeros((b, m), dtype=torch.int32, device=x.device)
        seg = torch.where(map_valid, 0, -1).to(torch.int32)
        return self._extend(cache, x, map_pose, times, seg, impl=impl)

    def step(self, cache, agent_feats, agent_pose, agent_valid, step_time,
             impl=None):
        """Advance every slot by one simulation step.

        agent_feats (B, A, Fa); agent_pose (B, A, 3); agent_valid (B, A)
        bool; step_time (B,) the step index t of these tokens (attention
        time t + 1). Returns (logits (B, A, num_actions), cache).
        """
        b, a, _ = agent_feats.shape
        x = self._with_pose(
            self.agent_enc(agent_feats.to(self.cfg.compute_dtype)),
            agent_pose)
        times = (step_time.to(torch.int32) + 1)[:, None].expand(b, a) \
            .contiguous()
        seg = torch.where(agent_valid, 0, -1).to(torch.int32)
        return self._extend(cache, x, agent_pose, times, seg, impl=impl)


def nll_terms(logits, actions, valid):
    """:func:`action_nll`'s numerator and denominator: the summed NLL of
    the ground-truth actions over valid agent steps, and their count."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, actions[..., None].long())[..., 0]
    w = valid.to(torch.float32)
    return torch.sum(nll * w), torch.sum(w)


def action_nll(logits, actions, valid):
    """Mean NLL of ground-truth actions over valid agent steps."""
    total, count = nll_terms(logits, actions, valid)
    return total / torch.clamp(count, min=1.0)
