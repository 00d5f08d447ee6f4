"""Dry-run of every (arch x shape x mesh) cell on the ``meta`` device (port
of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step for the production
mesh and reads XLA's cost and memory analyses. The port runs the step
once on the ``meta`` device, where tensors have shapes and no storage,
under ``obs/cost.py``'s counter: the model is built on ``meta`` at full
width, the inputs are :func:`repro_torch.runtime.steps.input_specs`'
stand-ins, and every aten op and every hand-written kernel's shape formula
is counted as it would be on the card (the kernel wrappers' meta route
allocates their outputs and computes nothing). A cell never needs a card
or ``nvcc``. Per cell:

  1. The step at full depth, at the batch one rank of the mesh holds under
     the port's placement (parameters replicated, the batch split over the
     data-parallel axes): its FLOPs and bytes, and its memory. Memory:
     ``argument_bytes`` are the parameters, optimizer state, cache and
     inputs one rank holds when sharded by the logical-axis rules
     (``distributed/sharding.py``), the reference's meaning of
     ``fits_hbm``; ``temp_bytes`` is the peak of the storages the step
     allocates (:class:`LiveBytes`), an upper bound until activations are
     sharded over "model" (ROADMAP A10.9); ``memory_replicated`` is what
     the port places on a rank today (whole parameters and optimizer
     state).
  2. Two depth variants (``depth_variant(2)`` and ``(4)``, full width):
     their counts give the per-iteration slope and the intercept, and the
     linear extrapolation to full depth (``flops``, ``bytes_accessed``,
     ``per_iter_flops``), as the reference's. The reference must
     extrapolate (XLA counts a loop body once); the port counts every
     layer, so the record also holds the full-depth count and
     ``extrapolation_rel_err`` between the two.

The multi-pod pass (2 x 16 x 16) runs step 1 only, as the reference's.
The roofline terms are computed for an H100 SXM 80GB's datasheet constants
(``launch.mesh.HW``; ``hbm_bytes`` read from the card where one is
present); nothing here is measured on a card.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCH_NAMES, SHAPES, SIM_ARCH_NAMES,
                                 ShapeConfig, get_config, get_sim_arch)
from repro_torch.distributed.sharding import (batch_sharding,
                                              derive_opt_shardings,
                                              shard_bytes, sharding_for_specs)
from repro_torch.launch.mesh import hw as mesh_hw
from repro_torch.launch.mesh import mesh_shape
from repro_torch.launch.roofline import (model_flops_for,
                                         placement_collectives,
                                         roofline_terms)
from repro_torch.nn.module import count_params
from repro_torch.nn.transformer import build_model
from repro_torch.obs.cost import CostAccounted, op_tensors
from repro_torch.obs.registry import NULL
from repro_torch.optim import adafactor, adamw, chain, clip_by_global_norm
from repro_torch.runtime.steps import (batch_shardings, input_specs,
                                       make_prefill_step, make_serve_step,
                                       make_train_step)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
VARIANT_ITERS = (2, 4)
SIM_SHAPE = "sim_train"        # the one shape a sim arch counts
SIM_TRAIN_BATCH = 256          # global batch for the sim train cell
TEMP_NOTE = ("upper bound: the step's activations, gradients and "
             "temporaries at a rank's batch, unsharded over 'model' until "
             "FSDP / tensor parallelism (ROADMAP A10.9)")
GIB = 1024 ** 3


def production_sizes(multi_pod: bool) -> Dict[str, int]:
    """Axis sizes of the production mesh: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model")."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def choose_optimizer(cfg):
    """Adafactor for the 1T config (optimizer-state memory); AdamW
    everywhere else."""
    if cfg.name.startswith("kimi"):
        return chain(clip_by_global_norm(1.0), adafactor(1e-4))
    return chain(clip_by_global_norm(1.0), adamw(3e-4))


def applicable(cfg, shape) -> bool:
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return False
    return True


_aten = torch.ops.aten
#: float elementwise ops whose meta kernels run the Python references
#: (about 0.2 ms a call; a full-depth SSM step makes 10^5 of them)
_ELEMENTWISE = {_aten.mul.Tensor, _aten.add.Tensor, _aten.sub.Tensor,
                _aten.div.Tensor, _aten.mul.Scalar, _aten.add.Scalar,
                _aten.div.Scalar, _aten.pow.Tensor_Scalar, _aten.exp.default,
                _aten.neg.default, _aten.sqrt.default, _aten.rsqrt.default,
                _aten.sigmoid.default, _aten.tanh.default}


def _elementwise_meta(func, args):
    """The output of a float elementwise op on meta tensors whose operands
    are all contiguous, one of them of the full broadcast shape:
    contiguous, as its kernel's is then (an operand of another layout
    would set the output's strides); None where that shortcut does not
    apply."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not all(t.is_floating_point() and t.is_contiguous()
               for t in tensors):
        return None
    shapes = {t.shape for t in tensors}
    shape = shapes.pop() if len(shapes) == 1 else torch.broadcast_shapes(
        *shapes)
    if not any(t.shape == shape for t in tensors):
        return None
    dtype = torch.result_type(*args[:2]) if len(args) > 1 else args[0].dtype
    return torch.empty(shape, dtype=dtype, device="meta")


class LiveBytes(TorchDispatchMode):
    """Peak bytes of the storages allocated while the mode is on.

    An op's output whose storage is neither one of its inputs' (a view,
    an in-place result) nor already tracked is a new allocation: its bytes
    are added and a finalizer on its storage takes them off when the
    storage is freed (a storage's Python object lives as long as the
    storage). ``peak`` is the largest sum seen. Storages that existed
    before (parameters, optimizer state, inputs) are not counted; those of
    ``watch`` (a tree of them) are taken off when the step frees them, as
    an optimizer step frees the moments it replaces.

    On ``meta`` tensors the float elementwise ops of :data:`_ELEMENTWISE`
    and ``slice_backward`` take their output's shape, dtype and layout
    directly (:func:`_elementwise_meta`) instead of the Python reference
    kernels: the same tensor metadata at a fraction of the cost."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        return False        # as obs.cost's counter: nothing here compiles

    def __init__(self, watch=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._keys: set = set()
        for t in op_tensors(watch):
            st = t.untyped_storage()
            if st._cdata not in self._keys:
                self._keys.add(st._cdata)
                weakref.finalize(st, self._free, st._cdata, st.nbytes())

    def _free(self, key, nbytes):
        self._keys.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = None
        if func in _ELEMENTWISE and args[0].device.type == "meta":
            out = _elementwise_meta(func, args)
        elif func is _aten.slice_backward.default \
                and args[0].device.type == "meta":
            out = torch.empty(args[1], dtype=args[0].dtype, device="meta")
        if out is None:
            out = func(*args, **kwargs)
        inputs = None
        for t in op_tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._keys:
                continue
            if inputs is None:
                inputs = {a.untyped_storage()._cdata
                          for a in op_tensors((args, kwargs))}
            if key in inputs:
                continue
            nbytes = st.nbytes()
            self._keys.add(key)
            self.live += nbytes
            weakref.finalize(st, self._free, key, nbytes)
        self.peak = max(self.peak, self.live)
        return out


def rank_shape(shape, sizes):
    """``shape`` at the batch one rank holds: the global batch over the
    data-parallel shards (replicated where they do not divide it)."""
    shards = batch_sharding(sizes,
                            (shape.global_batch, shape.seq_len)).shards
    return dataclasses.replace(shape, global_batch=shape.global_batch
                               // shards)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in op_tensors(tree))


def count_step(cfg, shape, opt=None) -> Dict:
    """One step of ``shape``'s mode, built and run on ``meta`` under the
    cost counter and :class:`LiveBytes`: train (the gradients, then the
    update with ``opt``, else :func:`choose_optimizer`'s), prefill, or
    decode (one serve
    step at the cache's last row, the cache ``shape.seq_len`` long).
    Returns the count (``flops``, ``bytes_accessed``, ``kernel_flops``,
    ``output_bytes``), ``temp_bytes``, the seconds to build (``lower_s``)
    and to run (``run_s``), and the model, inputs and optimizer state."""
    t0 = time.perf_counter()
    model = build_model(cfg, device="meta")
    ins = input_specs(cfg, shape, model)
    state = None
    if shape.mode == "train":
        opt = opt or choose_optimizer(cfg)
        state = opt.init(dict(model.named_parameters()))
        step = CostAccounted(make_train_step(model, opt, remat=True),
                             "train", registry=NULL)
    elif shape.mode == "prefill":
        step = CostAccounted(make_prefill_step(model), "prefill",
                             registry=NULL)
    else:
        step = CostAccounted(make_serve_step(model), "decode",
                             registry=NULL)
    lower_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with LiveBytes(watch=(state, ins)) as live:
        if shape.mode == "train":
            grads, _ = step.grads(ins)
            state = step.update(state, grads)
            del grads
        elif shape.mode == "prefill":
            step(ins)
        else:
            step(ins["cache"], ins["tokens"], shape.seq_len - 1,
                 enc_out=ins.get("enc_out"))
    run_s = time.perf_counter() - t0
    rec = {k: step.cost[k] for k in ("flops", "bytes_accessed",
                                     "kernel_flops", "output_bytes")}
    return {**rec, "temp_bytes": live.peak, "lower_s": lower_s,
            "run_s": run_s, "model": model, "inputs": ins, "state": state}


def _memory_record(argument_bytes, output_bytes, temp_bytes, hw):
    """The shared fits-in-HBM accounting (LM and sim cells agree)."""
    memory = {"argument_bytes": argument_bytes, "output_bytes": output_bytes,
              "temp_bytes": temp_bytes}
    hbm = (argument_bytes + temp_bytes) / GIB
    return {"memory": memory, "hbm_per_chip_gib": hbm,
            "fits_hbm": hbm < hw["hbm_bytes"] / GIB}


def _memory(run, global_ins, sizes, hw):
    """The memory keys of a cell from its full-depth run: by the rules
    (``memory``) and as the port places it today (``memory_replicated``)."""
    model, state = run["model"], run["state"]
    args = shard_bytes(sharding_for_specs(model, sizes)) + shard_bytes(
        batch_shardings(global_ins, sizes))
    repl = sum(p.numel() * 4 for p in model.parameters()) + _nbytes(
        run["inputs"])
    if state is not None:
        args += shard_bytes(derive_opt_shardings(model, state, sizes))
        repl += _nbytes(state)
    rec = _memory_record(args, run["output_bytes"], run["temp_bytes"], hw)
    rep = _memory_record(repl, run["output_bytes"], run["temp_bytes"], hw)
    rec["memory_replicated"] = {**rep["memory"],
                                "hbm_per_chip_gib": rep["hbm_per_chip_gib"],
                                "fits_hbm": rep["fits_hbm"]}
    rec["temp_bytes_note"] = TEMP_NOTE
    return rec


def lower_cell(arch: str, shape_name: str, multi_pod: bool, *,
               cfg=None, shape: Optional[ShapeConfig] = None,
               mesh=None, opt=None) -> Dict:
    """The record of one LM cell. ``cfg``, ``shape``, ``mesh`` (a
    DeviceMesh or a mapping of axis sizes) and ``opt`` replace the
    registered config, the named shape, the production mesh and
    :func:`choose_optimizer`'s where given."""
    hw = mesh_hw()
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    if not applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "full-attention arch at 500k decode "
                          "(see DESIGN.md Arch-applicability)"}
    sizes = mesh_shape(mesh) if mesh is not None \
        else production_sizes(multi_pod)
    chips = math.prod(sizes.values())
    local = rank_shape(shape, sizes)

    # --- 1. full depth: memory, and the count the variants are held to ---
    full = count_step(cfg, local, opt)
    n_params = count_params(full["model"])
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "ok",
        "chips": chips, "n_params": n_params, "mode": shape.mode,
        "hw": hw["name"], "mesh_sizes": sizes,
        "batch_per_rank": local.global_batch,
        "full_compile_s": full["run_s"], "full_lower_s": full["lower_s"],
        **_memory(full, input_specs(cfg, shape, full["model"]), sizes, hw),
        "full_depth": {"flops": full["flops"],
                       "bytes_accessed": full["bytes_accessed"],
                       "kernel_flops": full["kernel_flops"]},
    }
    del full
    if multi_pod:
        return record

    # --- 2. depth variants: the per-iteration slope, extrapolated ---------
    meas = []
    for it in VARIANT_ITERS:
        vcfg = cfg.depth_variant(it)
        run = count_step(vcfg, local, opt)
        coll = placement_collectives(shape.mode,
                                     4.0 * count_params(run["model"]), sizes)
        meas.append({"iters": vcfg.scan_iters(), "flops": run["flops"],
                     "bytes": run["bytes_accessed"],
                     "coll": coll.per_chip_bytes,
                     "coll_by_kind": coll.by_kind, "compile_s": run["run_s"]})
        del run
    (m1, m2) = meas
    s1, s2 = m1["iters"], m2["iters"]
    s_full = cfg.scan_iters()

    def extrap(key):
        slope = (m2[key] - m1[key]) / (s2 - s1)
        return m1[key] + (s_full - s1) * slope, slope

    flops, flops_slope = extrap("flops")
    bytes_acc, _ = extrap("bytes")
    coll = placement_collectives(shape.mode, 4.0 * n_params, sizes)
    terms = roofline_terms(flops, bytes_acc, coll, hw)
    mflops = model_flops_for(cfg, shape, n_params)
    exact = record["full_depth"]["flops"]
    record.update({
        "flops": flops, "bytes_accessed": bytes_acc,
        "per_iter_flops": flops_slope,
        "extrapolation_rel_err": abs(flops - exact) / exact if exact else 0.0,
        "collectives": coll.to_dict(),
        "variant_measurements": meas,
        "terms": terms,
        "model_flops": mflops,
        "useful_flops_frac": (mflops / (flops * chips)) if flops else None,
    })
    return record


def lower_sim_cell(arch: str, multi_pod: bool, *, sim=None,
                   batch: int = SIM_TRAIN_BATCH, mesh=None) -> Dict:
    """The record of an agent-sim arch: its BC train step
    (``training/steps.py``) counted on ``meta`` at a rank's share of the
    ``batch``-scene global batch; memory as an LM cell's (no depth
    variants, as the reference's). ``sim`` replaces the registered arch."""
    from repro_torch.nn.agent_sim import AgentSimModel
    from repro_torch.training.steps import (make_sim_train_step,
                                            sim_input_specs)

    hw = mesh_hw()
    sim = sim or get_sim_arch(arch)
    scen = sim.scenario_config()
    sizes = mesh_shape(mesh) if mesh is not None \
        else production_sizes(multi_pod)
    chips = math.prod(sizes.values())
    shards = batch_sharding(sizes, (batch,)).shards
    t0 = time.perf_counter()
    model = AgentSimModel(sim.agent_sim_config(), device="meta")
    opt = chain(clip_by_global_norm(1.0), adamw(3e-4))
    state = opt.init(dict(model.named_parameters()))
    ins = sim_input_specs(scen, batch // shards)
    step = CostAccounted(make_sim_train_step(model, opt), "sim_train",
                         registry=NULL)
    lower_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with LiveBytes(watch=state) as live:
        grads, _ = step.grads(ins)
        state = step.update(state, grads)
        del grads
    run_s = time.perf_counter() - t0
    run = {"model": model, "state": state, "inputs": ins,
           "output_bytes": step.cost["output_bytes"],
           "temp_bytes": live.peak}
    mem = _memory(run, sim_input_specs(scen, batch), sizes, hw)
    return {
        "arch": arch, "shape": SIM_SHAPE,
        "mesh": "multi" if multi_pod else "single", "status": "ok",
        "chips": chips, "n_params": count_params(model), "mode": "train",
        "encoding": sim.encoding, "hw": hw["name"], "mesh_sizes": sizes,
        "batch_per_rank": batch // shards,
        "full_compile_s": run_s, "full_lower_s": lower_s, **mem,
        "full_depth": {"flops": step.cost["flops"],
                       "bytes_accessed": step.cost["bytes_accessed"],
                       "kernel_flops": step.cost["kernel_flops"]},
    }


def run_cell(arch, shape_name, multi_pod, out_dir, skip_existing=False):
    mesh_name = "multi" if multi_pod else "single"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}_{shape_name}_{mesh_name}.json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") in ("ok", "skipped"):
            print(f"[cached] {arch} {shape_name} {mesh_name}", flush=True)
            return rec
    try:
        rec = (lower_sim_cell(arch, multi_pod)
               if arch in SIM_ARCH_NAMES
               else lower_cell(arch, shape_name, multi_pod))
    except Exception as e:  # record failures; they are bugs to fix
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    status = rec["status"]
    extra = ""
    if status == "ok":
        extra = (f" hbm={rec['hbm_per_chip_gib']:.2f}GiB "
                 f"count={rec['full_compile_s']:.1f}s")
        if "terms" in rec:
            extra += f" dom={rec['terms']['dominant']}"
    print(f"[{status}] {arch} {shape_name} {mesh_name}{extra}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    all_archs = ARCH_NAMES + SIM_ARCH_NAMES
    archs = all_archs if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    # a sim arch has exactly one shape (its scenario config fixes the token
    # budget); LM archs iterate the LM shapes
    cells = [(a, s) for a in archs
             for s in ([SIM_SHAPE] if a in SIM_ARCH_NAMES else shapes)]
    failures = 0
    t0 = time.perf_counter()
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, mp, args.out,
                           skip_existing=args.skip_existing)
            failures += rec["status"] == "error"
    print(f"{len(cells) * len(meshes)} cells in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
