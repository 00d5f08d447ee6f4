"""Time the port's flash-attention backward (dq, dk/dv) built from two CUDA
sources, in one process on one card.

    python3 benchmarks/torch_flash_bwd_ab.py A.cu B.cu [--rounds 3]

Each source is a version of ``src/repro_torch/kernels/csrc/
flash_attention_bwd.cu``. Both are built as the port builds that file (the
same nvcc flags, ``csrc/`` on the include path, both builds started
together) into ``build/ab/`` and run through the port's own wrappers at the
train step's attention shape (``chip_smoke.py``'s scene layout: 32 scenes
x 8 heads x 336 tokens, c = 200, float32). Every round times A, B, B, A:
CUPTI kernel time per call (``chip_smoke.kernel_ms``). The two versions'
gradients must agree within ``chip_smoke.FLASH_GRAD_TOL``. Prints the
card, then one JSON line with every round's times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
        libs.append(lib)
    return libs


def use(path):
    """Route the port's backward wrappers to the library at ``path``."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels import flash_attention_bwd as fab
    lib = ctypes.CDLL(str(path))
    err_fn = lib.flash_attention_bwd_error_string
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    cuda._LIBS["flash_attention_bwd"] = lib
    fab._kernel.cache_clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_bwd_ab: no CUDA device is available",
              file=sys.stderr)
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
    out, lse = fa.flash_attention_fwd(q, k, v, **opts)
    delta = torch.sum(do * out, dim=-1)
    kernels = {
        "flash_attention_dq": lambda: fab.flash_attention_dq(
            q, k, v, do, lse, delta, **opts),
        "flash_attention_dkv": lambda: fab.flash_attention_dkv(
            q, k, v, do, lse, delta, **opts),
    }
    names = {"A": args.a, "B": args.b}
    libs = dict(zip(names, build([args.a, args.b], ROOT / "build" / "ab")))

    grads = {}
    for which, lib in libs.items():
        use(lib)
        grads[which] = (kernels["flash_attention_dq"](),
                        *kernels["flash_attention_dkv"]())
    torch.cuda.synchronize()
    equal = []
    for a, b in zip(grads["A"], grads["B"]):
        torch.testing.assert_close(b, a, **cs.FLASH_GRAD_TOL["float32"])
        equal.append(torch.equal(a, b))

    times = {w: {n: [] for n in kernels} for w in libs}
    for _ in range(args.rounds):
        for which in ("A", "B", "B", "A"):
            use(libs[which])
            for name, fn in kernels.items():
                times[which][name].append(cs.kernel_ms(fn))
    print(json.dumps({"sources": names, "shape": list(q.shape),
                      "bitwise_equal": equal, "kernel_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
