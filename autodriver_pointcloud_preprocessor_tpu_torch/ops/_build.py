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
kernels it went through. A CUDA graph's replay launches the kernels its
capture recorded without calling their wrappers, so the captured program
(``models/graphs.py``) adds the counts its capture saw on every replay.

A launch goes through ``launch``: the C entry runs inside
``device_guard`` of its tensors' device, on that device's current
stream. ctypes calls run in the CUDA context of the current device, so
without the guard a tensor on ``cuda:1`` while ``cuda:0`` is current
would be handed to a stream of the wrong device. The guard costs one
device switch (and one back) a launch when the tensors' device is not
the current one, and nothing when it is. The captured programs
(``models/graphs.py``) enter the same guard around capture and replay.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

__all__ = [
    "LAUNCHES", "build_seconds", "check", "device_guard", "kernel_info",
    "launch", "load_library", "require_cuda", "reset_launches", "stream_handle",
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
    # row table (4 int64s a row, packed bytes), rows, mask, mask_out, batch,
    # n, capacity, stream
    "apc_masked_compact": (ctypes.c_char_p, _I, _P, _P, _I, _I, _I, _P),
    # values, run_start, out, batch, c, n, stream
    "apc_segmented_sums": (_P, _P, _P, _I, _I, _I, _P),
    # x, y, z, valid, rad, rad_stride, rad2, rad2_stride, mean, cnt, mom,
    # cnt2, batch, n, k, wb, direction, kmode, moments, stream
    "apc_window_stats": (_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _P),
    # index, name buffer, its length, registers, CTAs an SM, local bytes
    # (kernel_info)
    "apc_segmean_info": (_I, ctypes.c_char_p, _I, _P, _P, _P),
    # the same, and the window blocks that set K3's shared memory
    "apc_window_stats_info": (_I, ctypes.c_char_p, _I, _P, _P, _P, _I),
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


def load_library(extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (when needed) and load the kernel library; raises on failure.

    ``extra_flags`` go to every nvcc call (``kernel_ab.py`` passes a
    ``-D`` that selects a kernel variant to time); the first load in a
    process decides, later calls return the loaded library."""
    global _lib, _build_seconds
    if _lib is not None:
        return _lib
    flags = (*NVCC_FLAGS, *extra_flags)
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256()
    for path in sources + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(flags).encode())
    target = BUILD_DIR / f"libapc_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
            compiles = [
                [_nvcc(), *flags, "-c", "-o", obj, str(src)]
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
            link = [_nvcc(), *flags, "-shared", "-o", lib_tmp, *objs]
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


def kernel_info(window_blocks: int = 1) -> Dict[str, Dict[str, int]]:
    """{kernel instantiation: {"regs": registers a thread, "ctas_per_sm":
    resident CTAs an SM, "local_bytes": local memory a thread (spills)}} of
    every kernel in the library, at the block size each is launched with
    (K3's shared memory at ``window_blocks``)."""
    lib = load_library()
    info = {}
    for fn, extra in ((lib.apc_segmean_info, ()),
                      (lib.apc_window_stats_info, (window_blocks,))):
        for index in range(1024):
            name = ctypes.create_string_buffer(96)
            regs, ctas, local = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
            err = fn(index, name, len(name), ctypes.addressof(regs), ctypes.addressof(ctas),
                     ctypes.addressof(local), *extra)
            if err == -1:
                break
            check(err, "kernel_info")
            info[name.value.decode()] = {"regs": regs.value, "ctas_per_sm": ctas.value,
                                         "local_bytes": local.value}
    return info


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def device_guard(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, a no-op context for
    the CPU (see the module docstring)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` (C entry ``apc_<name>``) with ``args`` and the
    current stream of ``device``, inside ``device_guard(device)``; raise
    on a CUDA error, count the launch in ``LAUNCHES``."""
    fn = getattr(load_library(), f"apc_{name}")
    with device_guard(device):
        err = fn(*args, stream_handle(device))
    check(err, name)
    LAUNCHES[name] += 1


def stream_handle(device: torch.device) -> int:
    """Raw handle of PyTorch's current stream on ``device`` (the raw query
    skips building a Stream object: a launch's host time matters here)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Check that every tensor is contiguous and on one CUDA device (cheap
    attribute reads only: this runs on every launch)."""
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
