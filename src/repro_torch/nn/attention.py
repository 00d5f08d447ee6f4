"""LM attention with grouped KV heads and a decode cache (port of
``repro/nn/attention.py``: ``_split_heads``, ``_merge_heads``,
``_cache_update``, ``Attention`` and ``MLAttention``).

GQA, MQA and MHA; rotary positions (``Rope1D``) on all or a fraction of
each head's columns (stablelm rotates 20 of 80); ``query_scale``; biases;
a sliding window (a key is kept where ``k_pos > q_pos - window``) and a
tanh softcap on the scaled scores (gemma2's local layers and every layer);
non-causal attention and cross-attention from a ``kv`` source (whisper's
encoder and decoder, ``EncDecLM``).

The cache is one layer-stacked buffer per layer group: ``k`` / ``v``
(L, B, Hkv, max_len, D) in float32, bfloat16 or int8, int8 with float32
``k_scale`` / ``v_scale`` (L, B, Hkv, max_len), one scale per row,
quantized on write. A layer writes its new rows in place and attends the
buffer in place at its own index.

Where the two packages part ways, on purpose: the reference's decode runs
``"chunked"`` attention over the whole preallocated cache with
``q_offset=cache_index`` (causality masks the rows past the cursor). The
port's ``impl="auto"`` runs the decode kernel (``ops.decode_attention``)
bounded by each slot's cursor (``kv_length = index + S``): the kernel
reads no row past it. For a chunk of S > 1 new tokens, causality inside
the chunk comes from ``q_times`` / ``k_times`` set to the positions.
A windowed layer passes the positions as times at every step (the window
compares them); the decode kernel applies the window and the softcap
itself. ``impl="chunked"`` (and ``"ref"``) run the reference's way.

Cross-attention has no cache, in the reference as here: at a decode step
its keys and values are projected from the encoder's output again. The
reference runs its full attention over them; the port runs the decode
kernel with every row's ``kv_length`` at the F encoder frames and no
times (unmasked), since a step's few query rows are its shape.

``MLAttention`` (deepseek's multi-head latent attention) caches one row a
token: the normed latent ``ckv`` (``kv_lora_rank`` wide) and the shared
rotary key ``kr`` side by side, under ``"ckv"`` (L, B, 1, max_len, r + dr).
Its decode is the reference's absorbed form: queries ``[qn W_uk, qr]``
score the whole row and the values are the latent, the same rows' first r
columns, which the decode kernel reads in place through a column view.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from repro_torch.core.encodings import GroupEncoding, Rope1D
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (canonical_cache_dtype,
                                              dequantize_kv, quantize_kv)
from repro_torch.nn.layers import Dense, RMSNorm


def _split_heads(x: torch.Tensor, num_heads: int, head_dim: int
                 ) -> torch.Tensor:
    """(B, S, H, D) or (B, S, H*D) -> (B, H, S, D)."""
    if x.ndim == 4:
        return x.transpose(1, 2)
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads, head_dim).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H, D); the output projection contracts both
    head axes."""
    return x.transpose(1, 2)


@dataclasses.dataclass
class CacheStep:
    """Where a chunk of ``n`` new tokens goes in every layer's cache and what
    its queries attend; built once a model call by :func:`cache_step`.

    ``index`` is the reference's ``cache_index``: an int (every slot at
    one position) or a (B,) tensor (per-slot cursors, single-token
    steps). ``start`` (int index) is the first row written, clamped to
    [0, max_len - n] as ``dynamic_update_slice`` clamps; ``rows`` / ``valid``
    (tensor index) are each slot's row and whether it lies in the cache (a
    row past the cache is dropped, as the reference's scatter drops it).
    ``kv_length`` (B,) int32 = min(index + n, max_len); ``q_times`` /
    ``k_times`` are the positions (n > 1 only; :meth:`times` gives them at
    any n, for a windowed layer).
    """
    index: Union[int, torch.Tensor]
    n: int
    start: Optional[int]
    rows: Optional[torch.Tensor]
    valid: Optional[torch.Tensor]
    kv_length: torch.Tensor
    q_times: Optional[torch.Tensor]
    k_times: Optional[torch.Tensor]
    max_len: int = 0

    def times(self):
        """(q_times (B, n), k_times (B, max_len)) int32: the new rows'
        positions and the cache rows' (built once a step, then kept)."""
        if self.q_times is None:
            b, dev = self.kv_length.shape[0], self.kv_length.device
            if isinstance(self.index, torch.Tensor):
                q = self.index.to(dev, torch.int32)[:, None]
            else:
                q = torch.full((b, 1), self.index, dtype=torch.int32,
                               device=dev)
            self.q_times = q.contiguous()
            self.k_times = torch.arange(
                self.max_len, dtype=torch.int32, device=dev)[None].expand(
                    b, self.max_len).contiguous()
        return self.q_times, self.k_times


def cache_step(index, n: int, batch: int, max_len: int,
               device) -> CacheStep:
    """The :class:`CacheStep` of ``n`` new tokens at ``index``."""
    if isinstance(index, torch.Tensor) and index.ndim == 1:
        if n != 1:
            raise ValueError("vector cursors require single-token steps")
        idx = index.to(device, torch.int64)
        valid = (idx >= 0) & (idx < max_len)
        return CacheStep(
            index=index.to(device), n=1, start=None,
            rows=torch.clamp(idx, 0, max_len - 1), valid=valid,
            kv_length=torch.clamp(idx + 1, max=max_len).to(torch.int32),
            q_times=None, k_times=None, max_len=max_len)
    index = int(index)
    q_times = k_times = None
    if n > 1:
        q_times = (index + torch.arange(n, dtype=torch.int32, device=device)
                   )[None].expand(batch, n).contiguous()
        k_times = torch.arange(max_len, dtype=torch.int32, device=device
                               )[None].expand(batch, max_len).contiguous()
    return CacheStep(
        index=index, n=n, start=min(max(index, 0), max_len - n), rows=None,
        valid=None,
        kv_length=torch.full((batch,), min(index + n, max_len),
                             dtype=torch.int32, device=device),
        q_times=q_times, k_times=k_times, max_len=max_len)


def _cache_update(buf: torch.Tensor, layer: int, new: torch.Tensor,
                  step: CacheStep) -> None:
    """Write ``new`` (B, H, n, ...) into layer ``layer`` of the stacked
    ``buf`` (L, B, H, max_len, ...) in place, at ``step``'s rows."""
    view = buf[layer]
    new = new.to(buf.dtype)
    if step.rows is None:
        view[:, :, step.start:step.start + step.n] = new
        return
    bi = torch.arange(new.shape[0], device=buf.device)
    old = view[bi, :, step.rows]                      # (B, H, ...)
    keep = step.valid.reshape((-1,) + (1,) * (old.ndim - 1))
    view[bi, :, step.rows] = torch.where(keep, new[:, :, 0], old)


class Attention(nn.Module):
    """Multi-head attention with ``num_kv_heads`` dividing ``num_q_heads``,
    causal unless ``causal=False`` (whisper's encoder and cross-attention),
    an optional sliding ``window`` and score ``softcap``.

    ``impl``: "auto" (the flash forward and the decode kernel on the card,
    their plain versions on the CPU), "plain", "chunked" or "ref" (the
    reference's paths by name; see the module docstring).
    """

    def __init__(self, d_model: int, num_q_heads: int, num_kv_heads: int,
                 head_dim: int, *, encoding: Optional[GroupEncoding] = None,
                 rope_fraction: float = 1.0,
                 query_scale: Optional[float] = None,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None, causal: bool = True,
                 use_bias: bool = False, impl: str = "auto", device=None):
        super().__init__()
        if num_q_heads % num_kv_heads:
            raise ValueError(f"{num_kv_heads} kv heads do not divide "
                             f"{num_q_heads} query heads")
        self.num_q_heads, self.num_kv_heads = num_q_heads, num_kv_heads
        self.head_dim = head_dim
        self.encoding = encoding
        self.rope_fraction = rope_fraction
        self.query_scale = query_scale
        self.window, self.softcap = window, softcap
        self.causal = causal
        self.impl = impl
        h, hk, hd, d = num_q_heads, num_kv_heads, head_dim, d_model
        emb, heads, kv = ("embed",), ("heads", "head_dim"), ("kv_heads",
                                                            "head_dim")
        self.q = Dense((d,), (h, hd), device, use_bias, in_axes=emb,
                       out_axes=heads)
        self.k = Dense((d,), (hk, hd), device, use_bias, in_axes=emb,
                       out_axes=kv)
        self.v = Dense((d,), (hk, hd), device, use_bias, in_axes=emb,
                       out_axes=kv)
        self.o = Dense((h, hd), (d,), device, use_bias, in_axes=heads,
                       out_axes=emb)

    @property
    def rot_dim(self) -> int:
        """Columns the encoding rotates (even)."""
        if self.encoding is None:
            return 0
        rd = int(self.head_dim * self.rope_fraction)
        return rd - rd % 2

    def _encode(self, q, k, pose):
        """The encoding on the first ``rot_dim`` columns of q and k; pose
        (B, S, 1) float32 positions."""
        enc = self.encoding
        if enc is None or pose is None:
            return q, k
        p4 = pose[:, None]
        rd = self.rot_dim
        if rd == self.head_dim:
            return enc.transform_q(q, p4), enc.transform_k(k, p4)
        return (torch.cat([enc.transform_q(q[..., :rd], p4), q[..., rd:]], -1),
                torch.cat([enc.transform_k(k[..., :rd], p4), k[..., rd:]], -1))

    def _scale(self) -> float:
        if self.query_scale is not None:
            return self.query_scale ** -0.5
        return 1.0 / float(self.head_dim) ** 0.5

    def forward(self, x: torch.Tensor, pose: Optional[torch.Tensor] = None,
                *, kv: Optional[torch.Tensor] = None, kv_length=None,
                cache=None, layer: int = 0,
                step: Optional[CacheStep] = None,
                impl: Optional[str] = None) -> torch.Tensor:
        """x (B, S, d_model); pose (B, S, 1) positions. ``kv`` (B, F,
        d_model): the cross-attention source, keys and values projected from
        it instead of x. Without a cache: the full forward (causal unless
        ``causal=False``). With ``kv_length`` ((B,) int32, F for every row):
        a decode step's cross-attention, the few new query rows against all
        F keys through the decode kernel, unmasked (the reference runs its
        full attention there). With ``cache`` (a group's stacked dict) and
        ``step``: write the S new rows at layer ``layer`` and attend the
        cache."""
        impl = impl or self.impl
        src = x if kv is None else kv
        q = _split_heads(self.q(x), self.num_q_heads, self.head_dim)
        k = _split_heads(self.k(src), self.num_kv_heads, self.head_dim)
        v = _split_heads(self.v(src), self.num_kv_heads, self.head_dim)
        q, k = self._encode(q, k, pose)
        if cache is not None:
            out = self._decode(q, k, v, cache, layer, step, impl)
        elif kv_length is not None and impl not in ("chunked", "ref"):
            out = ops.decode_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                kv_length=kv_length,
                impl="plain" if impl == "plain" else "auto",
                scale=self._scale(), softcap=self.softcap)
        else:
            out = ops.attention(
                q.contiguous(), k.contiguous(), v.contiguous(), impl=impl,
                causal=self.causal, window=self.window, softcap=self.softcap,
                scale=self._scale())
        return self.o(_merge_heads(out))

    def _decode(self, q, k, v, cache, layer, step, impl):
        if "k_scale" in cache:
            for key, new in (("k", k), ("v", v)):
                vals, scales = quantize_kv(new)
                _cache_update(cache[key], layer, vals, step)
                _cache_update(cache[f"{key}_scale"], layer, scales, step)
        else:
            _cache_update(cache["k"], layer, k, step)
            _cache_update(cache["v"], layer, v, step)
        if impl in ("chunked", "ref"):
            ck, cv = cache["k"][layer], cache["v"][layer]
            if "k_scale" in cache:
                ck = dequantize_kv(ck, cache["k_scale"][layer], dtype=q.dtype)
                cv = dequantize_kv(cv, cache["v_scale"][layer], dtype=q.dtype)
            return ops.attention(q, ck, cv, impl=impl, causal=self.causal,
                                 window=self.window, softcap=self.softcap,
                                 scale=self._scale(), q_offset=step.index)
        q_times, k_times = (step.times() if self.window is not None
                            else (step.q_times, step.k_times))
        return ops.decode_attention(
            q.contiguous(), cache["k"], cache["v"], kv_length=step.kv_length,
            layer=layer, impl="plain" if impl == "plain" else "auto",
            scale=self._scale(), q_times=q_times, k_times=k_times,
            window=self.window, softcap=self.softcap,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   layers: int = 1):
        """The stacked cache of ``layers`` such layers: ``dtype`` a torch
        dtype or "float32" / "bfloat16" / "int8" (int8 adds float32 per-row
        scales)."""
        dtype = canonical_cache_dtype(dtype, default=torch.bfloat16)
        if self.encoding is not None and self.encoding.transforms_values:
            raise NotImplementedError(
                "KV cache with value-transforming encodings")
        device = self.q.kernel.device
        shape = (layers, batch, self.num_kv_heads, max_len, self.head_dim)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
        if dtype == torch.int8:
            cache["k_scale"] = torch.zeros(shape[:-1], device=device)
            cache["v_scale"] = torch.zeros(shape[:-1], device=device)
        return cache


class MLAttention(nn.Module):
    """Multi-head latent attention (deepseek-v2): queries through
    ``q_lora_rank`` or directly; keys and values from a normed
    ``kv_lora_rank`` latent, their rotary half from one key shared by the
    heads. Scores are scaled by ``(qk_nope_dim + qk_rope_dim) ** -0.5``.

    Without a cache, the full causal forward over ``k = [ckv W_uk, kr]``
    and ``v = ckv W_uv`` (``ops.attention``: the flash kernels on the card).
    With one, the absorbed decode over the latent rows
    (``ops.decode_attention`` with one kv head; ``impl="chunked"`` /
    ``"ref"`` run the reference's attention over the whole cache).
    """

    def __init__(self, d_model: int, num_heads: int, kv_lora_rank: int = 512,
                 qk_nope_dim: int = 128, qk_rope_dim: int = 64,
                 v_head_dim: int = 128, q_lora_rank: Optional[int] = None,
                 rope_base: float = 10000.0, impl: str = "auto", device=None):
        super().__init__()
        d, h, r = d_model, num_heads, kv_lora_rank
        dn, dr, dv = qk_nope_dim, qk_rope_dim, v_head_dim
        self.num_heads, self.kv_lora_rank = h, r
        self.qk_nope_dim, self.qk_rope_dim = dn, dr
        self.rope = Rope1D(head_dim=dr, base=rope_base)
        self.impl = impl
        self.q_lora_rank = q_lora_rank
        emb, lora, heads = ("embed",), ("kv_lora",), ("heads", "head_dim")
        if q_lora_rank:
            self.q_down = Dense((d,), (q_lora_rank,), device, in_axes=emb,
                                out_axes=lora)
            self.q_up = Dense((q_lora_rank,), (h, dn + dr), device,
                              in_axes=lora, out_axes=heads)
        else:
            self.q = Dense((d,), (h, dn + dr), device, in_axes=emb,
                           out_axes=heads)
        self.kv_down = Dense((d,), (r,), device, in_axes=emb, out_axes=lora)
        self.k_rope = Dense((d,), (dr,), device, in_axes=emb,
                            out_axes=("head_dim",))
        self.k_up = Dense((r,), (h, dn), device, in_axes=lora,
                          out_axes=heads)
        self.v_up = Dense((r,), (h, dv), device, in_axes=lora,
                          out_axes=heads)
        self.o = Dense((h, dv), (d,), device, in_axes=heads, out_axes=emb)
        self.kv_norm = RMSNorm(r, device=device)

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    def forward(self, x: torch.Tensor, pose: Optional[torch.Tensor] = None,
                *, cache=None, layer: int = 0,
                step: Optional[CacheStep] = None,
                impl: Optional[str] = None) -> torch.Tensor:
        """As :meth:`Attention.forward`; pose (B, S, 1) positions."""
        impl = impl or self.impl
        b, s, _ = x.shape
        if pose is None:
            pose = torch.arange(s, dtype=torch.float32, device=x.device
                                )[None, :, None].expand(b, s, 1)
        p4 = pose[:, None]
        q = (self.q_up(self.q_down(x)) if self.q_lora_rank else self.q(x)
             ).transpose(1, 2)                              # (B, H, S, dn+dr)
        qn, qr = q[..., :self.qk_nope_dim], q[..., self.qk_nope_dim:]
        qr = self.rope.transform_q(qr, p4)
        ckv = self.kv_norm(self.kv_down(x))                 # (B, S, r)
        kr = self.rope.transform_k(self.k_rope(x)[:, None], p4)  # (B,1,S,dr)
        scale = 1.0 / float(self.qk_dim) ** 0.5
        if cache is not None:
            out = self._decode(x, qn, qr, ckv, kr, cache, layer, step, impl,
                               scale)
        else:
            kn = self.k_up(ckv).transpose(1, 2)
            v = self.v_up(ckv).transpose(1, 2)
            k = torch.cat([kn, kr.expand(b, self.num_heads, s,
                                         self.qk_rope_dim)], -1)
            out = ops.attention(torch.cat([qn, qr], -1).contiguous(),
                                k.contiguous(), v.contiguous(), impl=impl,
                                causal=True, scale=scale)
        return self.o(_merge_heads(out))

    def _decode(self, x, qn, qr, ckv, kr, cache, layer, step, impl, scale):
        """Write the new latent rows, then the absorbed attention: scores
        ``qn W_uk . ckv + qr . kr``, values the latent, out through W_uv."""
        r = self.kv_lora_rank
        rows = cache["ckv"]
        _cache_update(rows, layer, torch.cat([ckv[:, None].to(kr.dtype), kr],
                                             -1), step)
        q_lat = torch.einsum("bhsd,rhd->bhsr", qn,
                             self.k_up.kernel.to(x.dtype))
        q_full = torch.cat([q_lat, qr], -1).contiguous()
        if impl in ("chunked", "ref"):
            k_full = rows[layer]
            o_lat = ops.attention(q_full, k_full, k_full[..., :r], impl=impl,
                                  causal=True, scale=scale,
                                  q_offset=step.index)
        else:
            o_lat = ops.decode_attention(
                q_full, rows, rows[..., :r], kv_length=step.kv_length,
                layer=layer, impl="plain" if impl == "plain" else "auto",
                scale=scale, q_times=step.q_times, k_times=step.k_times)
        return torch.einsum("bhsr,rhd->bhsd", o_lat.to(x.dtype),
                            self.v_up.kernel.to(x.dtype))

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   layers: int = 1):
        """``{"ckv": (layers, batch, 1, max_len, kv_lora_rank +
        qk_rope_dim)}``: each row the latent, then the rotary key. An int8
        cache raises: the reference has no quantized MLA cache."""
        dtype = canonical_cache_dtype(dtype, default=torch.bfloat16)
        if dtype == torch.int8:
            raise NotImplementedError(
                "MLA has no int8 cache (neither has the reference's "
                "MLAttention): use float32 or bfloat16")
        return {"ckv": torch.zeros(
            (layers, batch, 1, max_len, self.kv_lora_rank + self.qk_rope_dim),
            dtype=dtype, device=self.kv_down.kernel.device)}
