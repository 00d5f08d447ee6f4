"""LM step functions (port of ``repro/runtime/steps.py``): the token
cross entropy, the train step, the prefill step and the serve (decode)
step; and the dry-run's stand-ins for a step's inputs
(:func:`input_specs`) with their shardings by logical axes
(:func:`cache_sharding`, :func:`batch_shardings`).

The reference's step functions build a model from a config and take its
parameter tree at every call; the port's take the model, whose weights it
holds. The train step updates them in place, so it comes in two halves
(:class:`~repro_torch.runtime.trainer.TrainStep`), as the sim's does: the
gradients and metrics, then the update, which the ``Trainer`` skips on a
non-finite loss.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.distributed.sharding import shard_of
from repro_torch.optim import Optimizer, global_norm, step_in_place
from repro_torch.runtime.trainer import TrainStep


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask=None) -> torch.Tensor:
    """Mean token cross entropy in float32 (masked mean where ``mask``)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - picked
    if mask is None:
        return torch.mean(nll)
    w = mask.to(torch.float32)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def make_train_step(model, optimizer: Optimizer, *,
                    remat: bool = True) -> TrainStep:
    """The LM train step (the reference's ``make_train_step``): the full
    forward over ``batch["tokens"]`` (after ``batch["prefix"]`` for a
    vision-prefix config, whose positions are then dropped from the
    logits; with ``batch["frames"]`` through the encoder for an
    encoder-decoder, whose forward takes no ``remat``), ``lm_loss`` on ``batch["labels"]`` plus the model's aux loss,
    their gradients and the optimizer step.

    The forward runs in ``cfg.compute_dtype``: each layer casts its float32
    weights as it uses them (the port's ``Dense``), so the master weights,
    the gradients and the optimizer's state stay float32. ``remat``
    recomputes each layer in the backward (``TransformerLM.forward``).
    Switches on gradients for the model's parameters; start from
    ``optimizer.init(dict(model.named_parameters()))``. Metrics are 0-d
    tensors on the model's device: ``loss``, ``aux`` and ``grad_norm`` (the
    float32 norm of the gradients before any clipping)."""
    cfg = model.cfg
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def grads_half(batch):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if cfg.enc_dec:
            logits, aux, _ = model(batch["frames"], batch["tokens"])
        else:
            logits, aux, _ = model(
                batch["tokens"], remat=remat,
                prefix_embeds=batch["prefix"] if cfg.vision_prefix else None)
        if cfg.vision_prefix:
            logits = logits[:, cfg.vision_prefix:]
        loss = lm_loss(logits, batch["labels"])
        del logits
        grads = dict(zip(params, torch.autograd.grad(
            loss + aux, list(params.values()))))
        with torch.no_grad():
            metrics = {"loss": loss.detach(), "aux": aux.detach(),
                       "grad_norm": global_norm(grads)}
        return grads, metrics

    def update_half(opt_state, grads):
        return step_in_place(optimizer, grads, opt_state, params)

    return TrainStep(grads_half, update_half)


def make_prefill_step(model) -> Callable:
    """``prefill(batch) -> logits (B, vocab)`` of the last position of the
    full forward over ``batch["tokens"]`` (after ``batch["prefix"]`` for a
    vision-prefix config; over ``batch["frames"]`` and the tokens for an
    encoder-decoder). Nothing is cached."""
    cfg = model.cfg

    @torch.no_grad()
    def prefill(batch):
        if cfg.enc_dec:
            logits, _, _ = model(batch["frames"], batch["tokens"])
        elif cfg.vision_prefix:
            logits, _, _ = model(batch["tokens"],
                                 prefix_embeds=batch["prefix"])
        else:
            logits, _, _ = model(batch["tokens"])
        return logits[:, -1]

    return prefill


def make_serve_step(model) -> Callable:
    """``serve_step(cache, tokens, index, enc_out=None) -> (logits (B,
    vocab), cache)``: one decode step of ``tokens`` (B, S) written into the
    preallocated ``cache`` at ``index`` (an int, or a (B,) tensor of
    per-slot cursors with S = 1); the cache is updated in place. An
    encoder-decoder decodes against ``enc_out`` (``model.encode``'s)."""
    enc_dec = model.cfg.enc_dec

    @torch.no_grad()
    def serve_step(cache, tokens, index, enc_out=None):
        if enc_dec:
            logits, cache = model.decode(tokens, enc_out, cache=cache,
                                         cache_index=index)
        else:
            logits, _, cache = model(tokens, cache=cache, cache_index=index)
        return logits[:, -1], cache

    return serve_step


# ---------------------------------------------------------------------------
# Stand-in inputs (dry-run) and their shardings
# ---------------------------------------------------------------------------

def input_specs(cfg, shape, model=None) -> Dict[str, Any]:
    """``meta`` tensors for the non-parameter inputs of ``shape``'s step,
    in the reference's shapes and dtypes: train and prefill ``tokens`` (and
    train ``labels``) (B, S) int32, an encoder-decoder's ``frames`` and a
    vision prefix's ``prefix`` in the compute dtype; decode ``tokens``
    (B, 1), ``index`` () int32, ``cache`` (the meta ``model``'s
    ``init_cache(B, S)`` in the compute dtype; built on ``meta`` from
    ``cfg`` when not given) and an encoder-decoder's ``enc_out``."""
    b, s = shape.global_batch, shape.seq_len
    meta = dict(device="meta")
    i32, cdt = torch.int32, cfg.compute_dtype

    def enc_inputs(specs, key):
        if cfg.enc_dec:
            specs[key] = torch.empty((b, cfg.encoder_frames, cfg.d_model),
                                     dtype=cdt, **meta)
        return specs

    if shape.mode in ("train", "prefill"):
        specs = {"tokens": torch.empty((b, s), dtype=i32, **meta)}
        if shape.mode == "train":
            specs["labels"] = torch.empty((b, s), dtype=i32, **meta)
        enc_inputs(specs, "frames")
        if cfg.vision_prefix:
            specs["prefix"] = torch.empty((b, cfg.vision_prefix,
                                           cfg.d_model), dtype=cdt, **meta)
        return specs
    if shape.mode == "decode":
        if model is None:
            from repro_torch.nn.transformer import build_model
            model = build_model(cfg, device="meta")
        specs = {"tokens": torch.empty((b, 1), dtype=i32, **meta),
                 "index": torch.empty((), dtype=i32, **meta),
                 "cache": model.init_cache(b, s, cdt)}
        return enc_inputs(specs, "enc_out")
    raise ValueError(shape.mode)


# Logical axes of cache entries, keyed by leaf name (the reference's).
# Trailing dims are matched right-to-left so the leading "layers" stacking
# dim is covered.
_CACHE_AXES = {
    "k": (None, "act_batch", "act_kv", "act_kvlen", None),
    "v": (None, "act_batch", "act_kv", "act_kvlen", None),
    "ckv": (None, "act_batch", None, "act_kvlen", None),
    "kr": (None, "act_batch", None, "act_kvlen", None),
    "s": (None, "act_batch", "act_heads", None, None),
    "h": (None, "act_batch", "act_mlp", None),
    "conv": (None, "act_batch", None, "act_mlp"),
    "shift": (None, "act_batch", None),
    "cmix_shift": (None, "act_batch", None),
}


def cache_sharding(cache_tree, mesh, rules=None):
    """The (possibly layer-stacked) decode cache's tree with a
    :class:`~repro_torch.distributed.sharding.Shard` at every tensor."""
    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        axes = _CACHE_AXES.get(key)
        if axes is None:
            logical = [None] * tree.ndim
        elif tree.ndim >= len(axes):
            logical = [None] * (tree.ndim - len(axes)) + list(axes)
        else:
            logical = list(axes[len(axes) - tree.ndim:])
        return shard_of(tree.shape, logical, mesh, rules, tree.element_size())

    return walk(cache_tree)


def batch_shardings(specs: Dict[str, Any], mesh, rules=None):
    """Shards of :func:`input_specs`' dict: the cache by
    :func:`cache_sharding`, ``index`` replicated, every other (batch-
    leading) tensor over the data-parallel axes, as ``batch_sharding``."""
    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = cache_sharding(v, mesh, rules)
        elif k == "index":
            out[k] = shard_of(v.shape, (), mesh, rules, v.element_size())
        else:
            out[k] = shard_of(v.shape, ["act_batch"] + [None] * (v.ndim - 1),
                              mesh, rules, v.element_size())
    return out
