"""Build and load the host-side native sidecars (``native/*.cc``).

``velodyne_pcap.cc`` walks a pcap container and extracts Velodyne
payloads; ``compressor.cc`` runs the codec's delta + zigzag + varint
loops. Both are copies of the reference package's sidecars with a plain C
interface, loaded with ``ctypes``.

A sidecar is compiled with ``g++`` (from ``PATH``) at its first use, never
at import, into ``build/torch_native/`` at the repository root. The file
name carries a hash of the source and flags, so an edited source rebuilds
and an unchanged one is loaded as it is. The compiler writes to a
temporary file that is renamed into place, so several processes building
at once do not collide. A failed build raises: the numpy versions in
``io/pcap.py`` and ``io/compressor.py`` run only when a caller asks for
them (``native=False``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

__all__ = ["BUILD_DIR", "CXX_FLAGS", "load"]

_SRC = Path(__file__).resolve().parent
BUILD_DIR = _SRC.parent.parent / "build" / "torch_native"
#: no -march=native: the library must not be tied to the machine that
#: built it; -fwrapv makes int32 overflow wrap as numpy's does
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fwrapv", "-Wall", "-Wextra")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: it builds the native sidecars")
    return found


def _build(name: str) -> Path:
    source = _SRC / f"{name}.cc"
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    target = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}.", suffix=".so")
    os.close(fd)
    try:
        cmd = [_cxx(), *CXX_FLAGS, "-o", tmp, str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, target)  # atomic: concurrent builds are safe
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load(name: str, signatures: Dict[str, Tuple[object, Sequence[object]]]) -> ctypes.CDLL:
    """The sidecar ``native/<name>.cc``, built when needed, with each entry
    point of ``signatures`` (name -> (restype, argtypes)) declared. Raises
    when the build or the load fails."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            for fn_name, (restype, argtypes) in signatures.items():
                fn = getattr(lib, fn_name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _loaded[name] = lib
    return lib
