"""Build and load the hand-written CUDA kernels.

Route: ``nvcc`` straight into one shared library per ``csrc/*.cu``, each
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds, not minutes). Every source that is not built yet
gets its own ``nvcc`` process, all started together, at first use. The
libraries land in ``kernels/build/`` under a name that carries a hash of
the sources and flags, so an edited source is rebuilt and a stale library
is never loaded. A failed build raises with the compiler's output.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# torch dtype -> the kernels' dtype code (hydra::DType in csrc/common.cuh)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}
BUILD_LOGS: dict = {}          # source stem -> nvcc output (ptxas -v report),
                               # kept beside each library as <name>.log


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing; returns
    {source stem: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    jobs = []
    for src in sources:
        out = _target(src)
        if out.exists():
            log = out.with_suffix(".log")
            if log.exists():
                BUILD_LOGS.setdefault(src.stem, log.read_text())
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(src)]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOGS[src.stem] = log
        if proc.returncode == 0:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)        # atomic: racing builders agree
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {src.name} (nvcc exit {proc.returncode})\n"
                          f"{log}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {s.stem: _target(s) for s in sources}


def kernel(lib: str, name: str, argtypes: list):
    """The C entry ``name`` of ``csrc/<lib>.cu``, built and loaded on first
    use, with its ctypes signature set. Entries return a cudaError_t."""
    key = (lib, name)
    fn = _fns.get(key)
    if fn is not None:
        return fn
    with _lock:
        if not _libs:
            for stem, path in build_all().items():
                _libs[stem] = ctypes.CDLL(str(path))
        fn = getattr(_libs[lib], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def stream(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``t``'s device, as
    an int, without building a ``torch.cuda.Stream`` object (PyTorch's own
    generated code reads it the same way)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
