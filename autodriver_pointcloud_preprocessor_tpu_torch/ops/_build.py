"""Build and load the hand-written CUDA kernels (``csrc/``).

The kernels have a plain C interface and are compiled by ``nvcc`` into
one shared library, loaded with ``ctypes``; no PyTorch headers are
involved, so a cold build takes seconds. Each source compiles in its own
``nvcc`` process, all started together, and one more links them. The build happens at the first
launch of any kernel, never at import, into ``build/torch_kernels/`` at
the repository root. The library's file name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is.

Each kernel wrapper counts its launches in ``LAUNCHES``; a run resets
the counts with ``reset_launches()`` and reads them after, to show which
kernels it went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = [
    "LAUNCHES", "build_seconds", "check", "load_library", "require_cuda",
    "reset_launches", "stream_handle",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # no contraction of a*b+c into FMA: the kernels then round exactly as
    # the plain PyTorch versions (separate elementwise ops) do
    "-fmad=false",
)

#: launches per kernel wrapper (plain integers; see module docstring)
LAUNCHES: Dict[str, int] = {
    "masked_compact": 0, "segmented_sums": 0, "window_stats": 0,
}

_lib: Optional[ctypes.CDLL] = None
_build_seconds: Optional[float] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name -> argtypes (every one returns cudaError_t as int)
_SIGNATURES = {
    # values, mask, out, scratch, batch, c, n, capacity, stream
    "apc_masked_compact": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # values, run_start, out, scratch, batch, c, n, stream
    "apc_segmented_sums": (_P, _P, _P, _P, _I, _I, _I, _P),
    # x, y, z, valid, r2, mean, cnt, mom, cnt2, batch, n, k, wb,
    # direction, kmode, moments, stream
    "apc_window_stats": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _P),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_seconds() -> Optional[float]:
    """Seconds the first load in this process took, nvcc included when it
    had to build (None before the first load)."""
    return _build_seconds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _check_nvcc(cmd, returncode: int, out: str, err: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n{out}\n{err}")


def load_library() -> ctypes.CDLL:
    """Build (when needed) and load the kernel library; raises on failure."""
    global _lib, _build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256()
    for path in sources + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    target = BUILD_DIR / f"libapc_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
            compiles = [
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(sources, objs)
            ]
            procs = [
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for cmd in compiles
            ]
            outputs = [proc.communicate() for proc in procs]  # waits for all
            for cmd, proc, (out, err) in zip(compiles, procs, outputs):
                _check_nvcc(cmd, proc.returncode, out, err)
            lib_tmp = str(Path(tmp) / target.name)
            link = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            _check_nvcc(link, proc.returncode, proc.stdout, proc.stderr)
            os.replace(lib_tmp, target)  # atomic: concurrent builds are safe
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_handle(device: torch.device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Check that every tensor is contiguous and on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
