"""Time versions of one of the port's attention CUDA sources in one
process on one card.

    python3 benchmarks/torch_flash_ab.py --kernel fwd|bwd|decode A.cu B.cu [C.cu ...] [--rounds 3]
        [--splits auto|old|N ...]

With ``--kernel fwd`` each source is a version of ``src/repro_torch/kernels/
csrc/flash_attention.cu`` (the forward); with ``--kernel bwd`` (the
default), of ``flash_attention_bwd.cu`` (dq and dk/dv); with ``--kernel
decode``, of ``flash_decode.cu``. All are built as the port builds that
file (the same nvcc flags, ``csrc/`` on the include path, all builds
started together) into ``build/ab/`` and run through the port's own
wrappers: fwd and bwd at the train step's attention shape
(``chip_smoke.py``'s scene layout: 32 scenes x 8 heads x 336 tokens,
c = 200, float32); decode at the rollout's tick (64 slots x 8 heads x 12
query rows, cursor 312) and prefill (144 query rows, cursor 144,
block-causal), each with a float32 and an int8 cache, as
``chip_smoke.py`` phase 6 times the tick. ``--splits`` gives each decode
source its ``num_splits``: ``auto`` (the kernel's own choice, from the
source's ``flash_decode_num_splits``, which the CUDA-core decode before
the tensor-core redesign does not have), ``old`` (the choice of that
decode's wrapper, which split a row's keys over ceil(4 x SMs / (B x Hq x
ceil(Sq / 16))) CTAs) or a number. Every round
times the sources in order and then in
reverse (A, B, B, A for two): CUPTI kernel time per call
(``chip_smoke.kernel_ms``) and CUDA-event time per call
(``chip_smoke.time_ms``). Each source's outputs are compared with A's:
whether they agree within the checks' tolerances (the forward's out within
``chip_smoke.FLASH_TOL`` and its live lse rows within 1e-5, the backward's
gradients within ``chip_smoke.FLASH_GRAD_TOL``, the decode's output within
``chip_smoke.DECODE_TOL`` of its cache type), whether they are bitwise
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
          "decode": "flash_decode"}


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


def use(kernel, path):
    """Route the port's wrappers of ``kernel`` to the library at ``path``."""
    import importlib
    from repro_torch.kernels import cuda
    name = SOURCE[kernel]
    lib = ctypes.CDLL(str(path))
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    cuda._LIBS[name] = lib
    module = importlib.import_module(f"repro_torch.kernels.{name}")
    for cached in ("_kernel", "_num_splits"):   # what the wrapper bound
        if hasattr(module, cached):
            getattr(module, cached).cache_clear()


def decode_kernels(cs, torch, dev, cfg, scen, c, gen, splits):
    """name -> fn(source letter) for the decode at the tick and the prefill,
    float32 and int8 caches; each returns (out,)."""
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
        shape = "64 slots x 8 heads, c = 200: tick and prefill"
    else:
        q, k, v, do, opts = cs.scene_attention_case(
            gen, dev, model, arch.scenario_config(), cs.TRAIN_BATCH,
            1.0 / math.sqrt(cfg.head_dim))
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

    def bound(fn, which):
        return (lambda: fn(which)) if args.kernel == "decode" else fn

    results = {}
    for which, lib in libs.items():
        use(args.kernel, lib)
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
            use(args.kernel, libs[which])
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
