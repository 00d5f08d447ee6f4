"""Cost accounting of the hot paths, recorded once, at the first call (port
of ``repro/obs/cost.py``).

The reference reads XLA's ``cost_analysis`` / ``memory_analysis`` of a
jitted hot path once, at compile time, and records them as ``cost.*``
gauges labeled by path. Eager PyTorch compiles nothing, so the port counts
the first call instead: :class:`CostAccounted` runs it under a
``TorchDispatchMode`` that sees every aten op, then records

* ``flops``: ``torch.utils.flop_counter``'s registered formula of each op
  (the matrix products; an elementwise op counts 0, as in the flop
  counter);
* ``bytes_accessed``: each op's input and output bytes, views left out;
* ``argument_bytes`` / ``output_bytes`` of the call's tensors, and
  ``peak_bytes`` their sum (the reference's own fallback on a backend
  with no peak; this never touches the allocator's peak statistics);
* ``kernel_flops``: the hand-written kernels' share of ``flops``.

The hand-written kernels are ``ctypes`` calls, which no dispatch mode
sees. So the attention ops, the se2 projections and the sampler report a
formula of their shapes (:func:`kernel_cost`, the formulas of ``bound_ms``
in ``PERF.md``: every (query, key) pair, halved where causal over
indices) and the ops inside such a call are not counted: a call counts
the same through the kernel on the card as through its plain version on
the CPU.

Zero syncs: every number comes from shapes, dtypes and the op registry;
no device value is read. After the first call the wrapper is one ``is
None`` check away from the bare function, the counting mode only observes
the ops it sees, and outputs are bitwise those of the bare function
whether telemetry is on or off. The reference's ``lower_seconds`` and
``compile_seconds`` have no counterpart and are absent.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.obs.registry import Registry, get_registry

__all__ = ["CostAccounted", "compiled_cost", "record_compiled_cost",
           "kernel_cost", "analytic_flops"]

#: the counter of the first call in progress (one at a time; the kernels'
#: wrappers report to it from any thread, the autograd engine's too)
_ACTIVE: list = []


def op_tensors(node) -> Iterable[torch.Tensor]:
    """The tensors of an op's arguments or results: ``node`` and the
    tuples, lists and dicts in it (``tree_leaves`` of aten's argument
    types, at a fraction of its cost a call)."""
    if isinstance(node, torch.Tensor):
        yield node
    elif isinstance(node, (tuple, list)):
        for x in node:
            yield from op_tensors(x)
    elif isinstance(node, dict):
        for x in node.values():
            yield from op_tensors(x)


def _nbytes(tensors: Iterable[Any]) -> int:
    """Bytes of the distinct tensors among ``tensors`` (shape metadata)."""
    seen, total = set(), 0
    for t in tensors:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


class _Counter(TorchDispatchMode):
    """Sums the flop formula and the bytes of every aten op it sees, and
    the kernels' reports; ``dispatch=False`` takes the reports alone."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing under this mode is compiled: without Dynamo's wrapper a
        # process that counts does not import torch._dynamo (seconds on a
        # card's host, in every rank) and an op costs half as much
        return False

    def __init__(self, dispatch: bool = True):
        super().__init__()
        # imported here: a process that never counts never loads it
        from torch.utils.flop_counter import flop_registry
        self.formulas = flop_registry
        self.dispatch = dispatch
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.opaque = 0              # > 0 inside a kernel's report

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.dispatch and not self.opaque:
            formula = self.formulas.get(func.overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            if not func.is_view:
                self.bytes += _nbytes(op_tensors((args, kwargs, out)))
        return out

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__() if self.dispatch else self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        if self.dispatch:
            return super().__exit__(*exc)
        return None


_IDLE = contextlib.nullcontext()


def kernel_cost(formula: Callable[[], tuple]):
    """Around a hand-written kernel's call (or its plain version's): adds
    ``formula() -> (flops, bytes)`` to the first call being counted, and
    leaves the ops inside uncounted. Outside a count it is a shared
    ``nullcontext``: one list check a call."""
    if not _ACTIVE:
        return _IDLE
    return _reporting(_ACTIVE[-1], formula)


@contextlib.contextmanager
def _reporting(counter: _Counter, formula):
    counter.opaque += 1
    try:
        flops, nbytes = formula()
        counter.flops += flops
        counter.kernel_flops += flops
        counter.bytes += nbytes
        yield
    finally:
        counter.opaque -= 1


# ---------------------------------------------------------------------------
# The kernels' shape-only formulas.
# ---------------------------------------------------------------------------

def _masks_bytes(*ts) -> int:
    return _nbytes(t for t in ts if t is not None)


def attention_pairs(q, k, causal: bool, q_times) -> float:
    """(query, key) pairs of a full attention call: B * Hq * Sq * Sk,
    halved where causal over indices (times decide per row, which reading
    them would need)."""
    b, hq, sq, _ = q.shape
    pairs = float(b * hq * sq * k.shape[2])
    return pairs / 2 if causal and q_times is None else pairs


def flash_fwd_cost(q, k, v, causal, q_times, *masks):
    """The flash forward: 2 (D + Dv) FLOPs a pair; q, k, v, the masks read,
    out and the float32 lse written."""
    b, hq, sq, d = q.shape
    dv = v.shape[-1]
    pairs = attention_pairs(q, k, causal, q_times)
    nbytes = (_nbytes((q, k, v)) + b * hq * sq * (dv * v.element_size() + 4)
              + _masks_bytes(q_times, *masks))
    return 2.0 * pairs * (d + dv), float(nbytes)


def flash_bwd_cost(q, k, v, causal, q_times, *masks):
    """The flash backward, dq and dk/dv: 2 (2D + Dv) + 2 (2D + 2Dv) FLOPs a
    pair; q, k, v, out, dout, the lse and the masks read, dq, dk, dv
    written."""
    b, hq, sq, d = q.shape
    dv = v.shape[-1]
    pairs = attention_pairs(q, k, causal, q_times)
    es = q.element_size()
    nbytes = (2 * _nbytes((q, k, v)) + 2 * b * hq * sq * dv * es
              + b * hq * sq * 4 + _masks_bytes(q_times, *masks))
    return 2.0 * pairs * (4 * d + 3 * dv), float(nbytes)


def decode_cost(q, k, v, layer, k_scale, v_scale, *masks):
    """The decode: 2 (D + Dv) FLOPs for every query row against every row
    of the cache's length axis (a cursor bounds the work, which reading it
    would need); q, the layer's K and V rows, their scales and the masks
    (cursors, times, segment ids) read, out written."""
    b, hq, sq, d = q.shape
    if layer is not None:
        k, v = k[layer], v[layer]
        k_scale = None if k_scale is None else k_scale[layer]
        v_scale = None if v_scale is None else v_scale[layer]
    hkv, sk, dv = v.shape[1], v.shape[2], v.shape[3]
    pairs = float(b * hq * sq * sk)
    nbytes = (_nbytes((q,)) + b * hkv * sk * (d + dv) * k.element_size()
              + b * hq * sq * dv * q.element_size()
              + _masks_bytes(k_scale, v_scale, *masks))
    return 2.0 * pairs * (d + dv), float(nbytes)


def se2_cost(x, enc, mode: str, transposed: bool):
    """An se2 projection: the pose's coefficients once a token and each
    row's expansion or contraction (sin and cos not counted); x and the
    pose read, the projection written."""
    nb, nf = enc.num_blocks, enc.num_terms
    tokens = x.shape[0] * x.shape[2] if x.ndim == 4 else x.shape[0]
    rows = x.numel() // x.shape[-1]
    per_token = nb * (8 * nf + 16 * nf * nf) if mode == "k" else nf + 8 * nb
    per_row = {("k", False): 12 * nf + 6, ("q", False): 4 * nf + 18,
               ("k", True): 16 * nf + 6, ("q", True): 8 * nf + 18}[
                   mode, transposed]
    width = enc.head_dim + enc.expanded_dim
    nbytes = rows * width * x.element_size() + tokens * 3 * 4
    return float(tokens * per_token + rows * nb * per_row), float(nbytes)


# csrc/categorical.cu: Threefry-2x32 (the key schedule, 20 rounds of add,
# rotate and xor, 5 key injections), then each element's xor, uniform,
# two logs, the logit's add and the argmax compare
_THREEFRY_OPS = 2 + 20 * 3 + 5 * 3 + 2
_SAMPLE_OPS = _THREEFRY_OPS + 13


def sampler_cost(logits):
    """The sampler: its integer and float operations an element and a key
    fold a row; the logits, keys and steps read, the actions written."""
    b, a, k = logits.shape
    ops = b * a * (k * _SAMPLE_OPS + _THREEFRY_OPS)
    return float(ops), float(b * a * k * logits.element_size() + b * 20
                             + b * a * 8)


# ---------------------------------------------------------------------------
# Records and the wrapper.
# ---------------------------------------------------------------------------

def compiled_cost(counter: _Counter, args=(), out=None) -> Dict[str, float]:
    """The flat ``{metric: value}`` record of one counted call."""
    arg_b = float(_nbytes(tree_leaves(args)))
    out_b = float(_nbytes(tree_leaves(out)))
    return {"flops": float(counter.flops),
            "bytes_accessed": float(counter.bytes),
            "kernel_flops": float(counter.kernel_flops),
            "argument_bytes": arg_b, "output_bytes": out_b,
            "peak_bytes": arg_b + out_b}


def record_compiled_cost(registry: Registry, path: str,
                         rec: Dict[str, float], **labels
                         ) -> Dict[str, float]:
    """Record one hot path's cost as ``cost.*{path=...}`` gauges, a
    ``cost.compilations`` count and a ``cost.compiled`` event."""
    if registry.enabled:
        for metric, v in rec.items():
            registry.gauge(f"cost.{metric}", path=path, **labels).set(v)
        registry.counter("cost.compilations", path=path, **labels).inc()
        registry.event("cost.compiled", path=path, **labels, **rec)
    return rec


class CostAccounted:
    """Wrap a hot path so its cost is accounted at the first call.

    The first call runs ``fn`` under the counting mode and records the
    result into ``registry`` (the process default if None, resolved then);
    every later call is the bare ``fn``. ``num_compilations`` and
    ``_cache_size()`` are 1 from then on, as the reference's.

    ``fn`` may be a ``TrainStep`` (``grads`` and ``update`` halves, which
    the ``Trainer`` calls apart): the wrapper is one too, and its first
    gradients half and the update after it are one count, recorded when
    the update returns (or, if the trainer skips that update, when the
    next gradients half starts).
    """

    def __init__(self, fn: Callable, name: str, *,
                 registry: Optional[Registry] = None,
                 labels: Optional[Dict[str, str]] = None):
        self._fn = fn
        self.name = name
        self._labels = dict(labels or {})
        self._registry = registry
        self.num_compilations = 0
        self.cost: Optional[Dict[str, float]] = None
        self._open: Optional[tuple] = None      # (counter, args, out)

    def _cache_size(self) -> int:
        return self.num_compilations

    def _record(self, counter, args, out):
        reg = self._registry if self._registry is not None \
            else get_registry()
        self.num_compilations += 1
        self.cost = record_compiled_cost(
            reg, self.name, compiled_cost(counter, args, out), **self._labels)

    def _counted(self, fn, args, kwargs, counter=None):
        counter = counter or _Counter()
        with counter:
            out = fn(*args, **kwargs)
        return counter, out

    def __call__(self, *args, **kwargs):
        if self.cost is not None:
            return self._fn(*args, **kwargs)
        counter, out = self._counted(self._fn, args, kwargs)
        self._record(counter, args, out)
        return out

    # a TrainStep's halves ------------------------------------------------
    def grads(self, batch):
        if self.cost is not None:
            return self._fn.grads(batch)
        if self._open is not None:                # the update was skipped
            self._record(*self._open)
        counter, out = self._counted(self._fn.grads, (batch,), {})
        self._open = (counter, (batch,), out[1])
        return out

    def update(self, opt_state, grads):
        if self._open is None:
            return self._fn.update(opt_state, grads)
        counter, args, metrics = self._open
        self._open = None
        _, out = self._counted(self._fn.update, (opt_state, grads), {},
                               counter)
        self._record(counter, args + (opt_state,), (metrics, out))
        return out


def analytic_flops(model: torch.nn.Module, fn: Callable) -> tuple:
    """``(flops, kernel_flops)`` of running ``fn`` by module formulas alone
    (no op is counted): each ``Dense`` call 2 * rows * in * out, once more
    for its weight's gradient and once more for its input's where autograd
    records them; an LM's tied logits (``Embedding.attend``) the same; the
    kernels' shape-only formulas. The yardstick :class:`CostAccounted`'s
    dispatch count is held to (a ``TrainStep``'s backward runs within
    ``fn``)."""
    from repro_torch.nn.layers import Dense, Embedding

    total = [0.0]

    def gemm(x, n_in: int, n_out: int, weight):
        """x @ W, x (..., n_in) and W (n_in, n_out)."""
        f = 2.0 * x.numel() * n_out
        grad = torch.is_grad_enabled()
        total[0] += f * (1 + (grad and weight.requires_grad)
                         + (grad and x.requires_grad))

    def on_dense(mod, inputs, _out):
        gemm(inputs[0], math.prod(mod.in_shape), math.prod(mod.out_shape),
             mod.kernel)

    hooks = [m.register_forward_hook(on_dense) for m in model.modules()
             if isinstance(m, Dense)]
    patched = []
    for m in model.modules():
        if isinstance(m, Embedding):
            def attend(x, _m=m, _orig=m.attend):
                gemm(x, x.shape[-1], _m.embedding.shape[0], _m.embedding)
                return _orig(x)
            m.attend = attend
            patched.append(m)
    counter = _Counter(dispatch=False)
    try:
        with counter:
            fn()
    finally:
        for h in hooks:
            h.remove()
        for m in patched:
            del m.attend
    return total[0] + counter.kernel_flops, counter.kernel_flops
