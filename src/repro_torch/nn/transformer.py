"""Config-driven LMs (port of ``repro/nn/transformer.py``:
``TransformerLM``, ``EncDecLM`` and ``build_model``): the decoder-only
dense families (stablelm-3b, phi4-mini-3.8b, granite-20b, internvl2-26b's
backbone, gemma2-27b), the MoE families (deepseek-v2-lite-16b with MLA,
kimi-k2-1t-a32b), the SSM families (hymba-1.5b, rwkv6-7b) and the
encoder-decoder (whisper-base).

The model is built from a ``ModelConfig`` as layer groups, one
``nn.ModuleList`` per group (the reference scans a stacked group;
``params.py`` carries weights across). The dense families are one plain
stack; gemma2's ``window_pattern="alternating"`` is one group of
(local, global) :class:`LayerPair` s, the reference's ``("pair", a, b)``
group; hymba's ``"mostly_local"`` is five groups: one global layer, half
of the windowed layers, one global layer, the other windowed layers, one
global layer (the reference stacks none of the three single layers). A
MoE config's first ``first_k_dense`` layers are a group of their own with
a dense MLP of width ``dense_ff`` (deepseek's and kimi's one leading
layer), then one group of MoE layers; ``attention_kind="mla"`` takes
``MLAttention``. An SSM config adds a Mamba or RWKV-6 mixer to every
block (``nn/ssm.py``): hymba's runs beside the attention
(``parallel_ssm``), rwkv6's alone (``attention_kind="none"``, with the
RWKV channel mix). Learned positions (granite), a precomputed modality
prefix (internvl's 256 patch embeddings), tied or untied heads, scaled
embeddings, the attention and final softcaps and gemma2's post-norms.

Training: ``forward(..., remat=True)`` (the default, as the reference's)
recomputes each layer's activations in the backward
(``torch.utils.checkpoint``, the reference's ``nothing_saveable``
checkpoint of each scanned layer); it engages only where autograd
records and no cache is given. The aux loss is the sum of the MoE layers'
load-balance losses (0 for a dense model).

Decode: ``init_cache`` gives one layer-stacked dict per group (per half
of a pair group): (L, B, Hkv, max_len, D) ``k`` / ``v``, or MLA's latent
rows ``ckv`` (L, B, 1, max_len, r + dr), the shape
``ops.decode_attention(layer=)`` reads in place, and an SSM's recurrent
state (``Block.init_cache``); ``forward(tokens, cache=, cache_index=)``
writes the new rows and state and returns the same cache dict. No cursor
masks a recurrent state as it masks rows: :meth:`TransformerLM.reset_slots`
zeroes a slot's state before a new sequence starts in it.

:class:`EncDecLM` (whisper's family; the conv frontend is stubbed in
the reference too, so its inputs are precomputed frame embeddings): a
non-causal encoder over the frames with sinusoidal positions, and a
causal decoder with learned positions whose every layer adds
cross-attention over the encoder's output. Its cache is one stack of the
decoder's self-attention rows; cross-attention is not cached (the
reference projects its keys and values again at every step). Every
registered family builds: :func:`unsupported` is None for each.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.encodings import Rope1D
from repro_torch.device import resolve_device
from repro_torch.nn.attention import Attention, MLAttention, cache_step
from repro_torch.nn.blocks import Block, make_norm
from repro_torch.nn.layers import (Dense, Embedding, LayerNorm,
                                   sinusoidal_positions)
from repro_torch.nn.mlp import MLP, GatedMLP, RWKVChannelMix
from repro_torch.nn.module import init_params
from repro_torch.nn.moe import MoE
from repro_torch.nn.ssm import MambaMixer, RWKV6TimeMix

# a block cache's recurrent state (``Block.init_cache``), zeroed by
# ``reset_slots``; every other entry is attention rows
_STATE_KEYS = ("ssm", "cmix_shift")


def unsupported(cfg) -> Optional[str]:
    """Why the port cannot build ``cfg`` yet (with the ROADMAP item that
    will port it), or None: None for every registered config."""
    return None


def _positions(cache_index, b: int, s: int, device) -> torch.Tensor:
    """(B, S) int64 positions of S tokens starting at ``cache_index`` (0,
    an int or a (B,) tensor of per-slot cursors)."""
    ar = torch.arange(s, device=device)
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        return cache_index.to(device, torch.int64)[:, None] + ar
    start = 0 if cache_index is None else int(cache_index)
    return (start + ar)[None].expand(b, s)


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


def _block_caches(cache: Dict[str, Any]) -> Iterable[dict]:
    """Every block-level cache dict of a model's cache (both halves of a
    pair group)."""
    for gc in cache.values():
        if "a" in gc and "b" in gc:
            yield gc["a"]
            yield gc["b"]
        else:
            yield gc


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
        # leading dense layers, then one plain stack, gemma2's (local,
        # global) pairs or hymba's mostly-local groups
        groups, n = [], cfg.num_layers
        moe = cfg.moe is not None

        def stack(count, window=None, **kw):
            return nn.ModuleList(self._block(dev, window, moe=moe, **kw)
                                 for _ in range(count))

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
        elif cfg.window_pattern == "mostly_local":
            # global at the first, middle and last layer (hymba)
            if n < 5:
                raise ValueError(f"{cfg.name}: mostly-local layers need at "
                                 f"least 5, got {n}")
            mid1 = (n - 3) // 2
            groups += [stack(1), stack(mid1, cfg.window), stack(1),
                       stack(n - 3 - mid1, cfg.window), stack(1)]
        else:
            groups.append(stack(n, cfg.window))
        self.groups = nn.ModuleList(groups)
        self.final_norm = make_norm(cfg.norm, d, dev)
        if not cfg.tie_embeddings:
            self.lm_head = Dense((d,), (cfg.padded_vocab,), dev,
                                 in_axes=("embed",), out_axes=("vocab",))
        if cfg.learned_positions:
            self.pos_embedding = Embedding(cfg.max_position, d, dev,
                                           scale=0.01, axes=(None, "embed"))
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))

    def _attention(self, dev, window: Optional[int]) -> Optional[nn.Module]:
        cfg = self.cfg
        if cfg.attention_kind == "none":
            return None
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

    def _ssm(self, dev) -> Optional[nn.Module]:
        ssm = self.cfg.ssm
        if ssm is None:
            return None
        if ssm.kind == "rwkv6":
            return RWKV6TimeMix(self.cfg.d_model, head_dim=ssm.head_dim,
                                chunk=ssm.chunk, device=dev)
        return MambaMixer(self.cfg.d_model, d_inner=ssm.d_inner,
                          state_size=ssm.state_size,
                          conv_width=ssm.conv_width, chunk=ssm.chunk,
                          device=dev)

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
        elif cfg.mlp_kind == "rwkv":
            mlp = RWKVChannelMix(cfg.d_model, d_ff, dev)
        elif cfg.mlp_kind == "plain":
            mlp = MLP(cfg.d_model, d_ff, dev, activation=cfg.activation,
                      use_bias=cfg.attn_bias)
        else:
            mlp = GatedMLP(cfg.d_model, d_ff, dev, activation=cfg.activation)
        return Block(cfg.d_model, attn, mlp, norm=cfg.norm,
                     post_norms=cfg.norm == "rms_offset", ssm=self._ssm(dev),
                     parallel_ssm=cfg.parallel_ssm, device=dev)

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
        updated in place and returned. An SSM's chunk of S' > 1 tokens
        must be a multiple of its scan chunk (or shorter than it), as in
        the reference. ``remat``: recompute each layer (or pair) in the
        backward instead of keeping its activations.
        """
        cfg = self.cfg
        dtype = cfg.compute_dtype
        x = self.embedding(tokens, dtype)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(dtype), x], 1)
        b, s, _ = x.shape
        positions = _positions(cache_index, b, s, x.device)
        if cfg.learned_positions:
            x = x + self.pos_embedding(positions, dtype)
        pose = positions.to(torch.float32)[..., None]
        step = None
        rows = None if cache is None else self._rows(cache)
        if rows is not None:
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

    @staticmethod
    def _rows(cache) -> Optional[torch.Tensor]:
        """A cache's attention rows (``k`` or MLA's ``ckv``: their length is
        the cache's max_len), or None for an attention-free model."""
        for bc in _block_caches(cache):
            for key in ("k", "ckv"):
                if key in bc:
                    return bc[key]
        return None

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """{"group{i}": {"k", "v"[, "k_scale", "v_scale"]}} (MLA:
        {"ckv"}), each stacked over the group's layers (a pair group:
        {"a": ..., "b": ...}, each stacked over its pairs); ``dtype`` as
        ``Attention.init_cache`` (MLA takes no int8). An SSM block's dict
        also holds its recurrent state (``Block.init_cache``: never int8;
        the compute dtype stands in for an int8 ``dtype``)."""
        def one(blk, n):
            return blk.init_cache(batch, max_len, dtype, layers=n,
                                  compute_dtype=self.cfg.compute_dtype)

        return {f"group{gi}": ({"a": one(group[0].a, len(group)),
                                "b": one(group[0].b, len(group))}
                               if isinstance(group[0], LayerPair)
                               else one(group[0], len(group)))
                for gi, group in enumerate(self.groups)}

    @staticmethod
    def reset_slots(cache: Dict[str, Any], slots) -> None:
        """Zero the recurrent state (SSM state, channel-mix shift) of the
        cache's batch rows ``slots`` in every layer, in place, before a
        new sequence starts there. Attention rows are left: the new
        sequence's cursor starts at 0 and no decode reads past it."""
        for bc in _block_caches(cache):
            for key in _STATE_KEYS:
                if key not in bc:
                    continue
                tensors = (bc[key].values() if isinstance(bc[key], dict)
                           else (bc[key],))
                for t in tensors:
                    t[:, slots] = 0


class CrossLayer(nn.Module):
    """A decoder layer's cross-attention, added to the residual: LayerNorm,
    then non-causal attention from the encoder's output (the reference's
    ``cross`` stack of ``norm`` and ``attn``)."""

    def __init__(self, d_model: int, attn: Attention, device=None):
        super().__init__()
        self.norm = LayerNorm(d_model, device=device)
        self.attn = attn

    def forward(self, x, enc_out, *, kv_length=None, impl=None):
        return x + self.attn(self.norm(x), kv=enc_out, kv_length=kv_length,
                             impl=impl)


class EncDecLM(nn.Module):
    """Encoder-decoder transformer (whisper's family); built on ``device``
    with weights from ``generator`` as :class:`TransformerLM`.

    Parameters follow the reference's tree: ``embedding`` (tied logits),
    ``pos_embedding`` (learned decoder positions), ``encoder`` and
    ``decoder`` (``Block`` s, LayerNorm, a plain gelu MLP and biased
    attention; the encoder's non-causal), ``cross`` (:class:`CrossLayer`
    a decoder layer), ``enc_norm`` and ``dec_norm``."""

    def __init__(self, cfg, impl: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.enc_dec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        self.impl = impl or "auto"
        dev = resolve_device(device)
        d = cfg.d_model
        self.embedding = Embedding(cfg.padded_vocab, d, dev)
        self.pos_embedding = Embedding(cfg.max_position, d, dev, scale=0.01,
                                       axes=(None, "embed"))
        self.encoder = nn.ModuleList(self._block(dev, causal=False)
                                     for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(self._block(dev, causal=True)
                                     for _ in range(cfg.num_layers))
        self.cross = nn.ModuleList(
            CrossLayer(d, self._attention(dev, causal=False), dev)
            for _ in range(cfg.num_layers))
        self.enc_norm = LayerNorm(d, device=dev)
        self.dec_norm = LayerNorm(d, device=dev)
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))

    def _attention(self, dev, causal: bool) -> Attention:
        cfg = self.cfg
        return Attention(cfg.d_model, cfg.num_q_heads, cfg.num_kv_heads,
                         cfg.resolved_head_dim, causal=causal, use_bias=True,
                         impl=self.impl, device=dev)

    def _block(self, dev, causal: bool) -> Block:
        cfg = self.cfg
        return Block(cfg.d_model, self._attention(dev, causal),
                     MLP(cfg.d_model, cfg.d_ff, dev, activation="gelu"),
                     norm="layer", device=dev)

    @property
    def device(self) -> torch.device:
        return self.embedding.embedding.device

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, F, d_model), the stubbed frontend's output -> the
        encoder's output (B, F, d_model) in the compute dtype."""
        x = frames.to(self.device, self.cfg.compute_dtype)
        pos = sinusoidal_positions(x.shape[1], self.cfg.d_model)
        x = x + pos.to(x.device, x.dtype)[None]
        for blk in self.encoder:
            x, _ = blk(x, impl=self.impl)
        return self.enc_norm(x)

    def decode(self, tokens: torch.Tensor, enc_out: torch.Tensor, *,
               cache: Optional[Dict[str, Any]] = None, cache_index=None):
        """tokens (B, S) -> (logits (B, S, padded_vocab), cache). With
        ``cache`` and ``cache_index`` (as :meth:`TransformerLM.forward`'s)
        the tokens are a decode chunk written into the decoder's stacked
        cache in place, and cross-attention runs the decode kernel over
        the F frames of ``enc_out``."""
        dtype = self.cfg.compute_dtype
        x = self.embedding(tokens, dtype)
        b, s, _ = x.shape
        x = x + self.pos_embedding(_positions(cache_index, b, s, x.device),
                                   dtype)
        step = kv_length = None
        if cache is not None:
            step = cache_step(cache_index, s, b, cache["k"].shape[3],
                              x.device)
            kv_length = torch.full((b,), enc_out.shape[1],
                                   dtype=torch.int32, device=x.device)
        for i, (blk, cross) in enumerate(zip(self.decoder, self.cross)):
            x, _ = blk(x, cache=cache, layer=i, step=step, impl=self.impl)
            x = cross(x, enc_out, kv_length=kv_length, impl=self.impl)
        return self.embedding.attend(self.dec_norm(x)), cache

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor, *,
                cache: Optional[Dict[str, Any]] = None, cache_index=None):
        """(logits, aux (a float32 zero), cache): the encoder over
        ``frames``, then :meth:`decode`. The reference's enc-dec forward
        takes no ``remat``; neither does this one."""
        logits, cache = self.decode(tokens, self.encode(frames), cache=cache,
                                    cache_index=cache_index)
        return logits, torch.zeros((), device=logits.device), cache

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """The decoder's self-attention cache, one group stacked over its
        layers: {"k", "v"} (L, B, H, max_len, D) (int8 adds the scales), as
        the reference's ``EncDecLM.init_cache``."""
        return self.decoder[0].init_cache(
            batch, max_len, dtype, layers=len(self.decoder),
            compute_dtype=self.cfg.compute_dtype)


def build_model(cfg, impl: Optional[str] = None, *, device=None,
                generator: Optional[torch.Generator] = None):
    """The model of ``cfg`` (the reference's ``build_model``): an
    :class:`EncDecLM` for an encoder-decoder config, else a
    :class:`TransformerLM`."""
    cls = EncDecLM if cfg.enc_dec else TransformerLM
    return cls(cfg, impl, device=device, generator=generator)
