"""Time versions of one of the port's flash-attention CUDA sources in one
process on one card.

    python3 benchmarks/torch_flash_ab.py --kernel fwd|bwd A.cu B.cu [C.cu ...] [--rounds 3]

With ``--kernel fwd`` each source is a version of ``src/repro_torch/kernels/
csrc/flash_attention.cu`` (the forward); with ``--kernel bwd`` (the
default), of ``flash_attention_bwd.cu`` (dq and dk/dv). All are built as
the port builds that file (the same nvcc flags, ``csrc/`` on the include
path, all builds started together) into ``build/ab/`` and run through the
port's own wrappers at the train step's attention shape
(``chip_smoke.py``'s scene layout: 32 scenes x 8 heads x 336 tokens,
c = 200, float32). Every round times the sources in order and then in
reverse (A, B, B, A for two): CUPTI kernel time per call
(``chip_smoke.kernel_ms``) and CUDA-event time per call
(``chip_smoke.time_ms``). Each source's outputs are compared with A's:
whether they agree within the checks' tolerances (the forward's out within
``chip_smoke.FLASH_TOL`` and its live lse rows within 1e-5, the backward's
gradients within ``chip_smoke.FLASH_GRAD_TOL``), whether they are bitwise
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
SOURCE = {"fwd": "flash_attention", "bwd": "flash_attention_bwd"}


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
    importlib.import_module(f"repro_torch.kernels.{name}")._kernel.cache_clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", metavar="SOURCE")
    ap.add_argument("--kernel", choices=sorted(SOURCE), default="bwd")
    ap.add_argument("--rounds", type=int, default=3)
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
    q, k, v, do, opts = cs.scene_attention_case(
        gen, dev, model, arch.scenario_config(), cs.TRAIN_BATCH,
        1.0 / math.sqrt(cfg.head_dim))
    if args.kernel == "fwd":
        kernels = {"flash_attention_fwd": lambda: fa.flash_attention_fwd(
            q, k, v, **opts)}
    else:
        out, lse = fa.flash_attention_fwd(q, k, v, **opts)
        delta = torch.sum(do * out, dim=-1)
        kernels = {
            "flash_attention_dq": lambda: (fab.flash_attention_dq(
                q, k, v, do, lse, delta, **opts),),
            "flash_attention_dkv": lambda: fab.flash_attention_dkv(
                q, k, v, do, lse, delta, **opts),
        }
    names = [chr(ord("A") + i) for i in range(len(args.sources))]
    libs = dict(zip(names, build(args.sources, ROOT / "build" / "ab")))

    results = {}
    for which, lib in libs.items():
        use(args.kernel, lib)
        results[which] = [t_ for fn in kernels.values() for t_ in fn()]
    torch.cuda.synchronize()
    checks = {}
    for which in names[1:]:
        agree, equal, max_abs_diff = [], [], []
        for i, (a, b) in enumerate(zip(results["A"], results[which])):
            if args.kernel == "fwd" and i == 1:       # lse, its live rows
                live = a > -1e29
                a, b, tol = a[live], b[live], dict(atol=1e-5, rtol=1e-5)
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
                times[which][name]["kernel_ms"].append(cs.kernel_ms(fn))
                times[which][name]["event_ms"].append(cs.time_ms(fn))
    print(json.dumps({"kernel": args.kernel,
                      "sources": dict(zip(names, args.sources)),
                      "shape": list(q.shape), "against_A": checks,
                      "times": times}))
    return 0 if all(all(c["within_tolerance"]) for c in checks.values()) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
