"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries are keyed by a hash of their
source and land in ``build/kernels/`` at the root of the source checkout,
which ``.gitignore`` lists; a stale library is never loaded. Nothing here
runs at import: a build happens at first use on the card, or all at once,
in parallel, through :func:`build_all`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the repro_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, keyed by a hash of that source
    and of every shared header in ``csrc/``."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library for this exact source already exists."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, str]:
    """Compile every kernel source at once (one nvcc each, all started
    together); returns each build's compiler log ('' when it was built
    before)."""
    jobs = {name: _start_build(name) for name in sources()}
    logs = {}
    for name, job in jobs.items():
        logs[name] = "" if job is None else _finish_build(name, job)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed. Every
    library exports launch functions ``int <entry>_launch(...)`` returning
    the launch's ``cudaGetLastError()`` (``<entry>`` is ``<name>`` unless
    the source holds several kernels) and
    ``const char* <name>_error_string(int)``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start_build(name)
            if job is not None:
                _finish_build(name, job)
            lib = ctypes.CDLL(str(library_path(name)))
            # attribute lookup caches the function object, so these stick
            err_fn = getattr(lib, f"{name}_error_string")
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def launcher(name: str, argtypes, entry: str = "") -> Callable[..., None]:
    """``<entry>_launch`` (default ``<name>_launch``) from the library of
    ``csrc/<name>.cu``, bound with ``argtypes``; calling it raises when the
    launch reports an error."""
    lib = load(name)
    entry = entry or name
    fn = getattr(lib, f"{entry}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    err_fn = getattr(lib, f"{name}_error_string")

    def call(*args) -> None:
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{entry}: CUDA error {err} at launch: "
                               f"{err_fn(err).decode()}")
    return call


#: kernel launches per kernel name, counted by each wrapper where it
#: launches its kernel; a run resets them to read what it launched
LAUNCHES: Dict[str, int] = {}


def count_launch(kernel: str) -> None:
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()
