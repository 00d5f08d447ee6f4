"""Gradient-transform optimizers (port of ``repro/optim/transforms.py``).

The reference's ``(init, update)`` protocol over a dict of named tensors,
written as the reference writes it rather than with ``torch.optim``, so
that the arithmetic matches by construction: AdamW's ``b2 = 0.95`` and
``eps`` outside the square root of the bias-corrected second moment, the
schedule evaluated at ``step + 1``, and the clip scale
``min(1, max_norm / max(norm, 1e-9))``.

``update(grads, state, params) -> (updates, new_state)``: updates carry the
``-lr`` sign and are added to the parameters by :func:`apply_updates`.
Every step-dependent scalar stays a tensor, so an update never waits on
the card.

The port's train steps apply a step with :func:`step_in_place`, through
each optimizer's ``start(grads, state)``: it takes each gradient out of its
dict, computes its update, adds it to the parameter and drops it before
the next, so that a step holds one tensor's transients and never a second
copy of the gradients, the updates or the moments (a 3.8 B-parameter
model's AdamW step fits one 80 GB card that way; ``update`` would need
three more copies). ``update``, the reference's functional form, is built
from ``start`` on a copy of the state's containers, so the two compute the
same values bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.params import is_stacked, reference_groups, reference_leaf

Params = Dict[str, torch.Tensor]
OptState = Any
Schedule = Callable[[Any], torch.Tensor]
#: ``leaf(names, grads, params) -> updates``: the update of one unit of
#: tensors (a name, or the names of one reference leaf for adafactor)
Leaf = Callable[[List[str], List[torch.Tensor], List[torch.Tensor]],
                List[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, new_state)``; ``start(grads, state) -> (leaf, new_state,
    units)``: ``units(names)`` splits the names into the units ``leaf``
    takes, and each ``leaf`` call writes its tensors' new moments into
    ``new_state``, whose dicts are ``state``'s (their entries replaced as
    the units go, so the old moments are freed one unit at a time).
    ``grads`` is None for a transform that is not first in a chain."""
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], Tuple[Params, OptState]]
    start: Callable[..., Tuple[Leaf, OptState, Callable]]


def _singles(names):
    return [[n] for n in names]


def _containers(state):
    """``state`` with its dicts and tuples rebuilt and its tensors shared:
    a state ``start`` may write into and leave ``state`` as it was."""
    if isinstance(state, dict):
        return {k: _containers(v) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(_containers(v) for v in state)
    return state


def _from_start(start) -> Callable:
    """The whole-tree ``update`` of a ``start``: the old state is left as
    it was."""
    def update(grads, state, params):
        leaf, new_state, units = start(grads, _containers(state))
        updates = {}
        for unit in units(list(grads)):
            for n, u in zip(unit, leaf(unit, [grads[n] for n in unit],
                                       [params.get(n) for n in unit])):
                updates[n] = u
        return {n: updates[n] for n in grads}, new_state
    return update


def step_in_place(optimizer: Optimizer, grads: Params, state: OptState,
                  params: Params) -> OptState:
    """One optimizer step applied to ``params`` in place, a unit of tensors
    at a time, the smallest first (see the module docstring); returns the
    new state. It consumes ``grads`` (each entry is popped as its unit
    goes) and ``state`` (the new state reuses its dicts): neither may be
    read after.
    The parameters end bitwise as ``apply_updates(params,
    optimizer.update(grads, state, params)[0])`` leaves them."""
    leaf, new_state, units = optimizer.start(grads, state)
    # the smallest units first: the largest (an LM's embedding) then runs
    # when the other gradients are already freed
    with torch.no_grad():
        for unit in sorted(units(list(grads)), key=lambda u: sum(
                grads[n].numel() for n in u)):
            gs = [grads.pop(n) for n in unit]
            ps = [params[n] for n in unit]
            for p, u in zip(ps, leaf(unit, gs, ps)):
                p.copy_((p.float() + u).to(p.dtype))
            del gs
    return new_state


def _to_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def global_norm(tensors: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tensors.values()))


def chain(*opts: Optimizer) -> Optimizer:
    """The transforms in turn on each gradient; a transform that reads every
    gradient (``clip_by_global_norm``) must come first."""
    def init(params):
        return tuple(o.init(params) for o in opts)

    def start(grads, state):
        """Each unit through every transform in turn; the units are the
        coarsest any transform asks for (adafactor's reference leaves)."""
        leaves, new_states, splits = [], [], []
        for i, (o, s) in enumerate(zip(opts, state)):
            leaf, ns, units = o.start(grads if i == 0 else None, s)
            leaves.append(leaf)
            new_states.append(ns)
            splits.append(units)

        def leaf(names, gs, ps):
            for f in leaves:
                gs = f(names, gs, ps)
            return gs

        def units(names):
            return min((u(names) for u in splits), key=len,
                       default=_singles(names))

        return leaf, tuple(new_states), units

    return Optimizer(init, _from_start(start), start)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def init(params):
        return ()

    def start(grads, state):
        if grads is None:
            raise ValueError("clip_by_global_norm reads every gradient: it "
                             "takes a step a tensor at a time only first "
                             "in a chain")
        gnorm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

        def leaf(names, gs, ps):
            return [(g.float() * scale).to(g.dtype) for g in gs]

        return leaf, (), _singles

    return Optimizer(init, _from_start(start), start)


def sgd(lr) -> Optimizer:
    sched = _to_schedule(lr)

    def init(params):
        return {"step": 0}

    def start(grads, state):
        step = state["step"] + 1
        lr_t = sched(step)

        def leaf(names, gs, ps):
            return [-lr_t * g.float() for g in gs]

        return leaf, {"step": step}, _singles

    return Optimizer(init, _from_start(start), start)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    sched = _to_schedule(lr)

    def init(params):
        return {"step": 0,
                "mu": {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in params.items()},
                "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in params.items()}}

    def start(grads, state):
        step = state["step"] + 1
        lr_t = sched(step)
        t = torch.tensor(step, dtype=torch.float32)
        b1c = 1.0 - torch.pow(b1, t)
        b2c = 1.0 - torch.pow(b2, t)
        mu_all, nu_all = state["mu"], state["nu"]

        def leaf(names, gs, ps):
            out = []
            for n, g, p in zip(names, gs, ps):
                g = g.float()
                mu = b1 * mu_all[n] + (1 - b1) * g
                nu = b2 * nu_all[n] + (1 - b2) * g * g
                mu_all[n], nu_all[n] = mu, nu
                out.append(-lr_t * (mu / b1c / (torch.sqrt(nu / b2c) + eps)
                                    + weight_decay * p.float()))
            return out

        return leaf, {"step": step, "mu": mu_all, "nu": nu_all}, _singles

    return Optimizer(init, _from_start(start), start)


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0,
              min_dim_size_to_factor: int = 128) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern, 2018), the
    reference's: momentum-free, update clipping at ``clip_threshold``.

    The reference runs it on its own tree, where a layer group's tensors
    are one stacked leaf: whether a leaf is factored depends on its two
    trailing dims (a stacked vector (L, d) too), and the update's RMS clip
    is taken over the whole leaf. So the port works a reference leaf at a
    time (:func:`repro_torch.params.reference_groups`): the group's
    tensors stacked as the reference stacks them, its arithmetic run on the
    stack, and each layer's part of the result and the statistics kept
    under the layer's own name. State: ``{"step": int, "v": {name:
    {"vr", "vc"} or {"v"}}}``, float32. A stack of vectors (a layer group's
    norm scales) that the reference would factor (a group of at least
    ``min_dim_size_to_factor`` layers; none of the registered configs has
    one) raises: its column statistic belongs to no one layer."""
    sched = _to_schedule(lr)

    def _factored(shape):
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def _stack(ts, stacked):
        return torch.stack(ts) if stacked else ts[0]

    def init(params):
        v = {}
        for leaf_name, names in reference_groups(params).items():
            stacked = is_stacked(leaf_name, names)
            shape = (len(names),) * stacked + tuple(params[names[0]].shape)
            if stacked and len(shape) == 2 and _factored(shape):
                # the column statistic of a factored stacked vector spans
                # the layers: no layer owns a part of it
                raise NotImplementedError(
                    f"{leaf_name}: a stack of {len(names)} vectors, factored "
                    f"at min_dim_size_to_factor={min_dim_size_to_factor}")
            for i, n in enumerate(names):
                dev = params[n].device
                if _factored(shape):
                    vr = torch.zeros(shape[:-1], device=dev)
                    vc = torch.zeros(shape[:-2] + shape[-1:], device=dev)
                    v[n] = ({"vr": vr[i], "vc": vc[i]} if stacked
                            else {"vr": vr, "vc": vc})
                else:
                    v[n] = {"v": torch.zeros(params[n].shape, device=dev)}
        return {"step": 0, "v": {n: {k: t.clone() for k, t in slots.items()}
                                 for n, slots in v.items()}}

    def start(grads, state):
        step = state["step"] + 1
        lr_t = sched(step)
        beta = 1.0 - torch.pow(torch.tensor(step, dtype=torch.float32),
                               -decay)
        v_all = state["v"]

        def leaf(names, gs, ps):
            stacked = is_stacked(reference_leaf(names[0]), names)
            g = _stack([x.float() for x in gs], stacked)
            slots = v_all[names[0]]
            g2 = g * g + eps
            if "vr" in slots:
                vr = beta * _stack([v_all[n]["vr"] for n in names], stacked) \
                    + (1 - beta) * g2.mean(dim=-1)
                vc = beta * _stack([v_all[n]["vc"] for n in names], stacked) \
                    + (1 - beta) * g2.mean(dim=-2)
                row = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                denom = row[..., None] * vc[..., None, :]
                u = g * torch.rsqrt(torch.clamp(denom, min=eps))
                new = {"vr": vr, "vc": vc}
            else:
                nv = beta * _stack([v_all[n]["v"] for n in names], stacked) \
                    + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp(nv, min=eps))
                new = {"v": nv}
            del g, g2
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            u = -lr_t * (u + weight_decay * _stack([p.float() for p in ps],
                                                   stacked))
            for i, n in enumerate(names):
                v_all[n] = {k: t[i] if stacked else t for k, t in new.items()}
            return [u[i] for i in range(len(names))] if stacked else [u]

        def units(names):
            return list(reference_groups(names).values())

        return leaf, {"step": step, "v": v_all}, units

    return Optimizer(init, _from_start(start), start)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """Add ``updates`` to ``params`` in place (the reference returns new
    arrays; the port updates the model's own parameters) and return
    ``params``."""
    for n, p in params.items():
        p.copy_((p.float() + updates[n]).to(p.dtype))
    return params
