"""Config-driven decoder LM (port of ``repro/nn/transformer.py``:
``TransformerLM`` and ``build_model``) for the dense families: stablelm-3b,
phi4-mini-3.8b, granite-20b, internvl2-26b's backbone and gemma2-27b.

The model is built from a ``ModelConfig`` as layer groups, one
``nn.ModuleList`` per group (the reference scans a stacked group;
``params.py`` carries weights across). The dense families are one plain
stack; gemma2's ``window_pattern="alternating"`` is one group of
(local, global) :class:`LayerPair` s, the reference's ``("pair", a, b)``
group. Learned positions (granite), a precomputed modality prefix
(internvl's 256 patch embeddings), tied or untied heads, scaled
embeddings, the attention and final softcaps and gemma2's post-norms.

Training: ``forward(..., remat=True)`` (the default, as the reference's)
recomputes each layer's activations in the backward
(``torch.utils.checkpoint``, the reference's ``nothing_saveable``
checkpoint of each scanned layer); it engages only where autograd
records and no cache is given.

Decode: ``init_cache`` gives one layer-stacked (L, B, Hkv, max_len, D)
buffer per group, per half of a pair group (the shape
``ops.decode_attention(layer=)`` reads in place); ``forward(tokens,
cache=, cache_index=)`` writes the new rows and returns the same cache
dict.

Families the port has not taken yet raise ``NotImplementedError`` naming
their ROADMAP item: MoE and MLA, SSMs (hymba's mostly-local groups come
with its SSM heads), enc-dec.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.encodings import Rope1D
from repro_torch.device import resolve_device
from repro_torch.nn.attention import Attention, cache_step
from repro_torch.nn.blocks import Block, make_norm
from repro_torch.nn.layers import Dense, Embedding
from repro_torch.nn.mlp import MLP, GatedMLP
from repro_torch.nn.module import init_params


def unsupported(cfg) -> Optional[str]:
    """Why the port cannot build ``cfg`` yet (with the ROADMAP item that
    will port it), or None for the dense families."""
    if cfg.enc_dec:
        return "encoder-decoder models (ROADMAP A10.5)"
    if cfg.moe is not None or cfg.attention_kind == "mla":
        return "MoE and MLA (ROADMAP A10.3)"
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
        x = self.a(x, pose, cache=None if cache is None else cache["a"],
                   layer=layer, step=step, impl=impl)
        return self.b(x, pose, cache=None if cache is None else cache["b"],
                      layer=layer, step=step, impl=impl)


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
        # the reference's layer groups (``_build_groups``): one plain stack,
        # or gemma2's (local, global) pairs
        if cfg.window_pattern == "alternating":
            if cfg.num_layers % 2:
                raise ValueError(f"{cfg.name}: alternating layers need an "
                                 f"even count, got {cfg.num_layers}")
            self.groups = nn.ModuleList([nn.ModuleList(
                LayerPair(self._block(dev, cfg.window), self._block(dev))
                for _ in range(cfg.num_layers // 2))])
        else:
            self.groups = nn.ModuleList([nn.ModuleList(
                self._block(dev, cfg.window)
                for _ in range(cfg.num_layers))])
        self.final_norm = make_norm(cfg.norm, d, dev)
        if not cfg.tie_embeddings:
            self.lm_head = Dense((d,), (cfg.padded_vocab,), dev)
        if cfg.learned_positions:
            self.pos_embedding = Embedding(cfg.max_position, d, dev,
                                           scale=0.01)
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))

    def _block(self, dev, window: Optional[int] = None) -> Block:
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        enc = None
        if cfg.pos_enc == "rope1d":
            rd = int(hd * cfg.rope_fraction)
            enc = Rope1D(head_dim=rd - rd % 2, base=cfg.rope_base)
        attn = Attention(cfg.d_model, cfg.num_q_heads, cfg.num_kv_heads, hd,
                         encoding=enc, rope_fraction=cfg.rope_fraction,
                         query_scale=cfg.query_scale, window=window,
                         softcap=cfg.attn_softcap or None,
                         use_bias=cfg.attn_bias, impl=self.impl, device=dev)
        if cfg.mlp_kind == "plain":
            mlp = MLP(cfg.d_model, cfg.d_ff, dev, activation=cfg.activation,
                      use_bias=cfg.attn_bias)
        else:
            mlp = GatedMLP(cfg.d_model, cfg.d_ff, dev,
                           activation=cfg.activation)
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
        dtype, aux loss 0 (float32; the dense families have none), cache).

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
            max_len = g0.get("a", g0)["k"].shape[3]
            step = cache_step(cache_index, s, b, max_len, x.device)
        remat = remat and cache is None and torch.is_grad_enabled()
        for gi, group in enumerate(self.groups):
            gc = cache[f"group{gi}"] if cache is not None else None
            for li, blk in enumerate(group):
                if remat:
                    x = checkpoint(blk, x, pose, use_reentrant=False,
                                   impl=self.impl)
                else:
                    x = blk(x, pose, cache=gc, layer=li, step=step,
                            impl=self.impl)
        x = self.final_norm(x)
        aux = torch.zeros((), device=x.device)
        if cfg.tie_embeddings:
            logits = self.embedding.attend(x)
        else:
            logits = self.lm_head(x)
        if cfg.final_softcap:
            logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
        return logits, aux, cache

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """{"group{i}": {"k", "v"[, "k_scale", "v_scale"]}}, each stacked
        over the group's layers (a pair group: {"a": ..., "b": ...}, each
        stacked over its pairs); ``dtype`` as ``Attention.init_cache``."""
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
