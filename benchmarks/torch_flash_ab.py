"""Time versions of one of the port's CUDA sources in one process on one
card.

    python3 benchmarks/torch_flash_ab.py --kernel fwd|bwd|decode|se2 A.cu B.cu [C.cu ...] [--rounds 3]
        [--splits auto|old|N ...]

With ``--kernel fwd`` each source is a version of ``src/repro_torch/kernels/
csrc/flash_attention.cu`` (the forward); with ``--kernel bwd`` (the
default), of ``flash_attention_bwd.cu`` (dq and dk/dv); with ``--kernel
decode``, of ``flash_decode.cu``; with ``--kernel se2``, of
``se2_project.cu`` (its forward modes, through ``se2_project_launch``, whose
C signature every version keeps; the transposed modes too where every
source has ``se2_project_t_launch``). All are built as the port builds that
file (the same nvcc flags, ``csrc/`` on the include path, all builds
started together) into ``build/ab/`` and run through the port's own
wrappers: fwd and bwd at the train step's attention shape
(``chip_smoke.py``'s scene layout: 32 scenes x 8 heads x 336 tokens,
c = 200, float32); decode at the rollout's tick (64 slots x 8 heads x 12
query rows, cursor 312) and prefill (144 query rows, cursor 144,
block-causal), and at phi4-mini-3.8b's tick (8 slots x 24 / 8 heads x 128,
one row, cursors 1-2,048), each with a float32 and an int8 cache, as
``chip_smoke.py`` phase 6 times the tick; se2 in modes "q" and "k" at the
tick (64 slots x 8 heads x 12 tokens) and at the train step (32 scenes x 8
heads x 336 tokens), float32. ``--splits`` gives each decode
source its ``num_splits``: ``auto`` (the kernel's own choice, from the
source's ``flash_decode_num_splits``, which the CUDA-core decode before
the tensor-core redesign does not have), ``old`` (the choice of that
decode's wrapper, which split a row's keys over ceil(4 x SMs / (B x Hq x
ceil(Sq / 16))) CTAs) or a number. A decode source from before the bf16
query, whose C entry has no query-type argument, or from before the
window and softcap, whose entry has neither, is called with its own
signature. Every round
times the sources in order and then in
reverse (A, B, B, A for two): CUPTI kernel time per call
(``chip_smoke.kernel_ms``) and CUDA-event time per call
(``chip_smoke.time_ms``). Each source's outputs are compared with A's:
whether they agree within the checks' tolerances (the forward's out within
``chip_smoke.FLASH_TOL`` and its live lse rows within 1e-5, the backward's
gradients within ``chip_smoke.FLASH_GRAD_TOL``, the decode's output within
``chip_smoke.DECODE_TOL`` of its cache type, se2 within
``chip_smoke.SE2_TOL``), whether they are bitwise
equal, and the largest difference. Prints the card and each build's
registers and spills, then one JSON line with every round's times; exits
with 1 when a version's outputs disagree with A's, after timing it all
the same (a version that drops part of the work, to see what that part
costs, disagrees by design).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the library each --kernel routes, and its wrapper module's name
SOURCE = {"fwd": "flash_attention", "bwd": "flash_attention_bwd",
          "decode": "flash_decode", "se2": "se2_project"}


def build(sources, out_dir):
    """One nvcc per source, all started together; returns the libraries."""
    from repro_torch.kernels import cuda
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, src in enumerate(sources):
        lib = out_dir / f"lib{i}_{Path(src).stem}.so"
        cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o",
               str(lib), str(src)]
        jobs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    libs = []
    for lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log}")
        registers = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
        print(f"{lib.name}: {len(registers)} kernels, {min(registers)}-"
              f"{max(registers)} registers a thread, {spills} spill bytes",
              flush=True)
        libs.append(lib)
    return libs


_WRAPPER_KERNEL = {}      # each wrapper module's own _kernel


def use(kernel, path, source):
    """Route the port's wrappers of ``kernel`` to the library at ``path``,
    built from ``source``."""
    import importlib
    from repro_torch.kernels import cuda
    name = SOURCE[kernel]
    lib = ctypes.CDLL(str(path))
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    cuda._LIBS[name] = lib
    module = importlib.import_module(f"repro_torch.kernels.{name}")
    module._kernel = _WRAPPER_KERNEL.setdefault(name, module._kernel)
    for cached in ("_kernel", "_num_splits"):   # what the wrapper bound
        if hasattr(module, cached):
            getattr(module, cached).cache_clear()
    text = Path(source).read_text()
    if kernel == "decode" and "softcap" not in text:
        # a decode from before the window and softcap takes neither (the
        # 27th and 28th arguments), and one from before the bf16 query no
        # query-type argument (the 25th): bind its own signature and drop
        # what it lacks
        with_q = "q_bf16" in text
        fn = lib.flash_decode_launch
        fn.argtypes = ([ctypes.c_void_p] * 14
                       + [ctypes.c_int] * (11 if with_q else 10)
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int

        def call(*args):
            if args[26] != -1 or args[27] != 0.0:
                raise ValueError("this decode source takes no window or "
                                 "softcap")
            err = fn(*args[:25 if with_q else 24], args[25], args[28])
            if err:
                raise RuntimeError(f"flash_decode_launch: CUDA error {err}: "
                                   f"{err_fn(err).decode()}")
        module._kernel = lambda: call


def decode_kernels(cs, torch, dev, cfg, scen, c, gen, splits):
    """name -> fn(source letter) for the decode at the tick and the prefill,
    float32 and int8 caches, and at phi4-mini-3.8b's tick; each returns
    (out,)."""
    import numpy as np
    from repro_torch.kernels import flash_decode as fd
    n_slots = cs.N_SLOTS
    s_max = -(-(scen.num_map + scen.num_steps * scen.num_agents) // 128) * 128
    tick = scen.num_map + scen.num_steps * scen.num_agents \
        - 2 * scen.num_agents
    prefill = scen.num_map + cs.T_HIST * scen.num_agents
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kernels = {}
    for shape, sq, cursor in (("tick", scen.num_agents, tick),
                              ("prefill", prefill, prefill)):
        for dtype in ("float32", "int8"):
            case = cs.decode_case(gen, dev, dtype, layers=cfg.num_layers,
                                  b=n_slots, h=cfg.num_heads, s=s_max, c=c,
                                  sq=sq, cursors=[cursor] * n_slots,
                                  num_map=scen.num_map,
                                  num_agents=scen.num_agents,
                                  prefill=shape == "prefill")
            q, k, v = case.pop("q"), case.pop("k"), case.pop("v")
            kvl = case.pop("kv_length")
            old = -(-4 * sms // (n_slots * cfg.num_heads * -(-sq // 16)))

            def fn(which, q=q, k=k, v=v, kvl=kvl, case=case, old=old):
                n = splits[which]
                n = None if n == "auto" else old if n == "old" else int(n)
                return (fd.flash_decode(q, k, v, kvl, layer=3, num_splits=n,
                                        scale=1.0 / math.sqrt(cfg.head_dim),
                                        **case),)
            kernels[f"{shape} {dtype}"] = fn
    # phi4-mini-3.8b's tick (chip_smoke.py phase 13a's shape)
    rng = np.random.default_rng(13)
    cursors = np.concatenate([[1, cs.LM_MAX_CURSOR], rng.integers(
        1, cs.LM_MAX_CURSOR + 1, cs.LM_SLOTS - 2)])
    for dtype in ("float32", "int8"):
        q, k, v, kvl, opts = cs.lm_decode_case(
            gen, dev, b=cs.LM_SLOTS, hq=24, hkv=8, d=128,
            s=cs.LM_MAX_CURSOR, cursors=cursors, cache_dtype=dtype,
            q_dtype=torch.float32)

        def fn(which, q=q, k=k, v=v, kvl=kvl, opts=opts):
            n = splits[which]
            n = None if n in ("auto", "old") else int(n)
            return (fd.flash_decode(q, k, v, kvl, layer=1, num_splits=n,
                                    **opts),)
        kernels[f"lm_tick {dtype}"] = fn
    return kernels


def se2_kernels(cs, cfg, scen, enc, dev, gen, transposed):
    """name -> fn for the se2 forward modes (and with ``transposed`` the
    transposed ones) at the tick and the train step's shapes; each returns
    (out,)."""
    names = ["se2_project_q", "se2_project_k"]
    if transposed:
        names += ["se2_project_q_t", "se2_project_k_t"]
    kernels = {}
    for shape, b, n in (("tick", cs.N_SLOTS, scen.num_agents),
                        ("train", cs.TRAIN_BATCH,
                         scen.num_map + scen.num_steps * scen.num_agents)):
        for name in names:
            fn, _, mode, t = cs.se2_mode(name)
            x, pose = cs.se2_case(gen, dev, b, cfg.num_heads, n,
                                  enc.expanded_dim if t else cfg.head_dim,
                                  cfg.pos_scale)
            kernels[f"{shape} {name[12:]}"] = (
                lambda fn=fn, x=x, pose=pose, mode=mode:
                (fn(x, pose, enc, mode),))
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", metavar="SOURCE")
    ap.add_argument("--kernel", choices=sorted(SOURCE), default="bwd")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--splits", nargs="+", default=None,
                    help="decode: num_splits a source (auto, old or N)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.nn.agent_sim import AgentSimModel

    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: "
          f"{cs.smi_line()} | torch {torch.__version__}", flush=True)
    dev = torch.device("cuda", 0)
    arch = configs.get_sim_arch("sim-se2-fourier")
    cfg = arch.agent_sim_config()
    model = AgentSimModel(cfg, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    names = [chr(ord("A") + i) for i in range(len(args.sources))]
    splits = dict(zip(names, args.splits or ["auto"] * len(names)))
    if args.kernel == "decode":
        kernels = decode_kernels(cs, torch, dev, cfg, arch.scenario_config(),
                                 model.blocks[0].attn.enc.expanded_dim, gen,
                                 splits)
        shape = ("64 slots x 8 heads, c = 200: tick and prefill; "
                 "phi4-mini-3.8b's tick")
    elif args.kernel == "se2":
        kernels = None     # once the builds show which modes every one has
        shape = "8 heads x 24 <-> 200: tick 64 x 12 tokens, train 32 x 336"
    else:
        q, k, v, do, opts = cs.scene_attention_case(
            gen, dev, model, arch.scenario_config(), cs.TRAIN_BATCH,
            1.0 / math.sqrt(cfg.head_dim),
            model.blocks[0].attn.enc.expanded_dim)
        shape = list(q.shape)
    if args.kernel == "fwd":
        kernels = {"flash_attention_fwd": lambda: fa.flash_attention_fwd(
            q, k, v, **opts)}
    elif args.kernel == "bwd":
        out, lse = fa.flash_attention_fwd(q, k, v, **opts)
        delta = torch.sum(do * out, dim=-1)
        kernels = {
            "flash_attention_dq": lambda: (fab.flash_attention_dq(
                q, k, v, do, lse, delta, **opts),),
            "flash_attention_dkv": lambda: fab.flash_attention_dkv(
                q, k, v, do, lse, delta, **opts),
        }
    libs = dict(zip(names, build(args.sources, ROOT / "build" / "ab")))
    sources = dict(zip(names, args.sources))
    if args.kernel == "se2":      # the first design has no transposed modes
        kernels = se2_kernels(
            cs, cfg, arch.scenario_config(), model.blocks[0].attn.enc, dev,
            gen, all(hasattr(ctypes.CDLL(str(p)), "se2_project_t_launch")
                     for p in libs.values()))

    def bound(fn, which):
        return (lambda: fn(which)) if args.kernel == "decode" else fn

    results = {}
    for which, lib in libs.items():
        use(args.kernel, lib, sources[which])
        results[which] = [t_ for fn in kernels.values()
                          for t_ in bound(fn, which)()]
    torch.cuda.synchronize()
    checks = {}
    for which in names[1:]:
        agree, equal, max_abs_diff = [], [], []
        for i, (a, b) in enumerate(zip(results["A"], results[which])):
            if args.kernel == "fwd" and i == 1:       # lse, its live rows
                live = a > -1e29
                a, b, tol = a[live], b[live], dict(atol=1e-5, rtol=1e-5)
            elif args.kernel == "decode":
                tol = cs.DECODE_TOL[list(kernels)[i].split()[-1]]
            elif args.kernel == "se2":
                tol = cs.SE2_TOL
            else:
                tol = (cs.FLASH_TOL if args.kernel == "fwd"
                       else cs.FLASH_GRAD_TOL)["float32"]
            agree.append(bool(torch.isclose(b, a, **tol).all()))
            equal.append(torch.equal(a, b))
            max_abs_diff.append(float((a - b).abs().max()))
        checks[which] = {"within_tolerance": agree, "bitwise_equal": equal,
                         "max_abs_diff": max_abs_diff}

    times = {w: {n: {"kernel_ms": [], "event_ms": []} for n in kernels}
             for w in libs}
    for _ in range(args.rounds):
        for which in names + names[::-1]:
            use(args.kernel, libs[which], sources[which])
            for name, fn in kernels.items():
                fn = bound(fn, which)
                times[which][name]["kernel_ms"].append(cs.kernel_ms(fn))
                times[which][name]["event_ms"].append(cs.time_ms(fn))
    print(json.dumps({"kernel": args.kernel,
                      "sources": dict(zip(names, args.sources)),
                      "splits": splits if args.kernel == "decode" else None,
                      "shape": shape, "against_A": checks,
                      "times": times}))
    return 0 if all(all(c["within_tolerance"]) for c in checks.values()) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
