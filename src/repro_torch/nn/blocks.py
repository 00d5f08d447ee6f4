"""The transformer block (port of ``repro/nn/blocks.py::Block``):
pre-norms, optional post-norms (gemma2's), a sequence mixer and a channel
mixer (an MLP, RWKV's channel mix, or a ``MoE`` whose load-balance loss
the block returns beside its output).

The sequence mixer is an attention (``Attention``, causal or not as
whisper's encoder, or ``MLAttention``), an SSM (``MambaMixer`` or
``RWKV6TimeMix``; rwkv6's has no attention beside it), or both: with
``parallel_ssm`` (hymba) each branch's output is RMS-normed and the two
are averaged; without it they are summed.

A block's slice of its group's cache is one dict: the attention's rows
(``k`` / ``v`` and their scales, or MLA's ``ckv``), the SSM's recurrent
state under ``"ssm"`` and the channel mix's last input under
``"cmix_shift"``, each stacked over the group's layers and updated in
place at ``layer``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.flash_decode import canonical_cache_dtype
from repro_torch.nn.attention import CacheStep
from repro_torch.nn.layers import LayerNorm, RMSNorm
from repro_torch.nn.mlp import RWKVChannelMix
from repro_torch.nn.moe import MoE


def make_norm(kind: str, dim: int, device=None) -> nn.Module:
    """"layer" -> LayerNorm; "rms_offset" -> RMSNorm storing (w - 1);
    anything else RMSNorm."""
    if kind == "layer":
        return LayerNorm(dim, device=device)
    if kind == "rms_offset":
        return RMSNorm(dim, device=device, weight_offset=1.0)
    return RMSNorm(dim, device=device)


class Block(nn.Module):
    def __init__(self, d_model: int, attention: Optional[nn.Module] = None,
                 mlp: Optional[nn.Module] = None, norm: str = "rms",
                 post_norms: bool = False, ssm: Optional[nn.Module] = None,
                 parallel_ssm: bool = False, device=None):
        super().__init__()
        self.d_model = d_model
        self.attn, self.ssm, self.mlp = attention, ssm, mlp
        self.parallel_ssm = parallel_ssm
        if attention is not None or ssm is not None:
            self.norm_mix = make_norm(norm, d_model, device)
            if post_norms and attention is not None:
                self.post_norm_mix = make_norm(norm, d_model, device)
        if parallel_ssm:
            # learned per-branch output norms (hymba averages the branches)
            self.attn_out_norm = RMSNorm(d_model, device=device)
            self.ssm_out_norm = RMSNorm(d_model, device=device)
        if mlp is not None:
            self.norm_mlp = make_norm(norm, d_model, device)
            if post_norms:
                self.post_norm_mlp = make_norm(norm, d_model, device)
        self.post_norms = post_norms

    def forward(self, x: torch.Tensor, pose: Optional[torch.Tensor] = None,
                *, cache=None, layer: int = 0,
                step: Optional[CacheStep] = None,
                impl: Optional[str] = None):
        """(x, aux): aux is the MoE's load-balance loss, None without a
        MoE (a tuple, so that it passes through ``torch.utils.checkpoint``
        with x)."""
        aux = None
        if self.attn is not None or self.ssm is not None:
            h = self.norm_mix(x)
            parts = []
            if self.attn is not None:
                parts.append(self.attn(h, pose, cache=cache, layer=layer,
                                       step=step, impl=impl))
            if self.ssm is not None:
                parts.append(self._ssm(h, cache, layer))
            if self.parallel_ssm and len(parts) == 2:
                mixed = (self.attn_out_norm(parts[0])
                         + self.ssm_out_norm(parts[1])) * 0.5
            else:
                mixed = parts[0]
                for p in parts[1:]:
                    mixed = mixed + p
            if self.post_norms and self.attn is not None:
                mixed = self.post_norm_mix(mixed)
            x = x + mixed
        if self.mlp is not None:
            h = self.norm_mlp(x)
            if isinstance(self.mlp, RWKVChannelMix):
                out = self._channel_mix(h, cache, layer)
            else:
                out = self.mlp(h)
            if isinstance(self.mlp, MoE):
                out, aux = out
            if self.post_norms:
                out = self.post_norm_mlp(out)
            x = x + out
        return x, aux

    def _ssm(self, h, cache, layer):
        """The SSM from the layer's cached state (written back in place),
        or from zeros without a cache."""
        if cache is None:
            return self.ssm(h)[0]
        stacked = cache["ssm"]
        out, new = self.ssm(h, {k: t[layer] for k, t in stacked.items()})
        for k, t in new.items():
            stacked[k][layer].copy_(t)
        return out

    def _channel_mix(self, h, cache, layer):
        if cache is None:
            return self.mlp(h)
        shift = cache["cmix_shift"][layer]
        out = self.mlp(h, shifted=torch.cat([shift[:, None].to(h.dtype),
                                             h[:, :-1]], 1))
        shift.copy_(h[:, -1])
        return out

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   layers: int = 1, compute_dtype=torch.float32) -> dict:
        """The cache of ``layers`` such blocks: the attention's (``dtype``
        as ``Attention.init_cache``), the SSM's state and the channel
        mix's shift. The recurrent state is never int8: ``h`` and ``s``
        are float32, the conv window and the shifts take ``dtype``, or
        ``compute_dtype`` where ``dtype`` is int8 (the cache is updated in
        place, so an int8 state would truncate the activations it
        keeps)."""
        cache = {}
        if self.attn is not None:
            cache.update(self.attn.init_cache(batch, max_len, dtype,
                                              layers=layers))
        state_dtype = canonical_cache_dtype(dtype, default=torch.bfloat16)
        if state_dtype == torch.int8:
            state_dtype = compute_dtype
        if self.ssm is not None:
            cache["ssm"] = self.ssm.init_state(batch, state_dtype, layers)
        if isinstance(self.mlp, RWKVChannelMix):
            cache["cmix_shift"] = torch.zeros(
                (layers, batch, self.d_model), dtype=state_dtype,
                device=self.norm_mlp.scale.device)
        return cache
