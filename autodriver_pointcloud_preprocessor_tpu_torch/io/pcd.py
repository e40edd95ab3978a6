"""Point-cloud file IO: PCD (ascii/binary/binary_compressed), PLY, XYZ family.

Capability parity with the reference's persistence path — Open3D's C++
``o3d.t.io.write_point_cloud`` with ascii/compressed flags (reference:
pointcloud_preprocessor.py:1010-1022) and the loader module's declared
PCD/PLY directory reading (pointcloud_loader.py:1-5). Host-side and
IO-bound, so numpy vectorization is the right tool (SURVEY.md §2b notes
native code is not warranted here); the binary_compressed body uses the
PCL-standard LZF codec implemented below.

SoA convention matches core/codec.py: positions (N,3) f32, intensity (N,)
f32, ring (N,) u16, rgb (N,3) u8 or packed, normals (N,3) f32.

A copy of the reference package's ``io/pcd.py`` (the port does not
import the reference).
"""
from __future__ import annotations

import os
import struct
from typing import Dict

import numpy as np

__all__ = ["write_point_cloud", "read_point_cloud", "lzf_compress", "lzf_decompress"]


# ---------------------------------------------------------------------------
# LZF codec (PCL-compatible) — pure Python; a C++ sidecar can override.
# ---------------------------------------------------------------------------

def lzf_compress(data: bytes) -> bytes:
    """LibLZF-format compression (as used by PCL binary_compressed PCD).

    Greedy matcher keyed on exact 3-byte sequences (no hash collisions, so
    every candidate is a true match). Format: control byte < 32 -> literal
    run of ctrl+1 bytes; else a back-reference of length (ctrl>>5)+2
    (7 -> +extension byte) at offset ((ctrl&0x1F)<<8 | next)+1.
    """
    n = len(data)
    out = bytearray()
    lit = bytearray()
    table: dict = {}

    def flush():
        i = 0
        while i < len(lit):
            run = min(32, len(lit) - i)
            out.append(run - 1)
            out.extend(lit[i : i + run])
            i += run
        lit.clear()

    ip = 0
    while ip < n:
        if ip + 2 < n:
            key = data[ip] | (data[ip + 1] << 8) | (data[ip + 2] << 16)
            ref = table.get(key, -1)
            table[key] = ip
            off = ip - ref - 1
            if ref >= 0 and off < (1 << 13):
                maxlen = min(n - ip, 264)  # l = len-2 <= 262
                length = 3
                while length < maxlen and data[ref + length] == data[ip + length]:
                    length += 1
                flush()
                l = length - 2
                if l < 7:
                    out.append((off >> 8) | (l << 5))
                else:
                    out.append((off >> 8) | (7 << 5))
                    out.append(l - 7)
                out.append(off & 0xFF)
                ip += length
                continue
        lit.append(data[ip])
        ip += 1
    flush()
    return bytes(out)


def lzf_decompress(data: bytes, expected_length: int) -> bytes:
    """LibLZF-format decompression."""
    out = bytearray()
    ip, n = 0, len(data)
    while ip < n:
        ctrl = data[ip]
        ip += 1
        if ctrl < 32:  # literal run
            run = ctrl + 1
            out.extend(data[ip : ip + run])
            ip += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[ip]
                ip += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[ip] - 1
            ip += 1
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    if len(out) != expected_length:
        raise ValueError(
            f"LZF decompression produced {len(out)} bytes, expected {expected_length}"
        )
    return bytes(out)


# ---------------------------------------------------------------------------
# SoA <-> flat field table
# ---------------------------------------------------------------------------

_PCD_TYPE = {np.dtype(np.float32): ("F", 4), np.dtype(np.float64): ("F", 8),
             np.dtype(np.uint8): ("U", 1), np.dtype(np.uint16): ("U", 2),
             np.dtype(np.uint32): ("U", 4), np.dtype(np.int8): ("I", 1),
             np.dtype(np.int16): ("I", 2), np.dtype(np.int32): ("I", 4)}

_PCD_INV = {("F", 4): np.float32, ("F", 8): np.float64, ("U", 1): np.uint8,
            ("U", 2): np.uint16, ("U", 4): np.uint32, ("I", 1): np.int8,
            ("I", 2): np.int16, ("I", 4): np.int32}


def _soa_to_columns(soa: Dict[str, np.ndarray]):
    """SoA -> ordered (name, column) pairs of 1-D arrays."""
    cols = []
    pos = np.asarray(soa["positions"])
    cols += [("x", pos[:, 0].astype(np.float32)),
             ("y", pos[:, 1].astype(np.float32)),
             ("z", pos[:, 2].astype(np.float32))]
    if soa.get("normals") is not None:
        nm = np.asarray(soa["normals"])
        cols += [("normal_x", nm[:, 0].astype(np.float32)),
                 ("normal_y", nm[:, 1].astype(np.float32)),
                 ("normal_z", nm[:, 2].astype(np.float32))]
    if soa.get("rgb") is not None:
        rgb = np.asarray(soa["rgb"])
        if rgb.ndim == 2:  # channels -> PCL packed float
            if rgb.dtype != np.uint8:
                rgb = (rgb * 255).clip(0, 255).astype(np.uint8)
            packed = (
                (rgb[:, 0].astype(np.uint32) << 16)
                | (rgb[:, 1].astype(np.uint32) << 8)
                | rgb[:, 2].astype(np.uint32)
            ).view(np.float32)
        else:
            packed = rgb.astype(np.float32)
        cols.append(("rgb", packed))
    for name in ("intensity", "ring", "time", "return_type", "azimuth", "distance"):
        if soa.get(name) is not None:
            arr = np.asarray(soa[name])
            if name == "time":
                arr = arr.astype(np.float64)
            cols.append((name, arr.reshape(-1)))
    return cols


def _columns_to_soa(cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    soa: Dict[str, np.ndarray] = {}
    soa["positions"] = np.stack(
        [cols["x"], cols["y"], cols["z"]], axis=1
    ).astype(np.float32)
    if {"normal_x", "normal_y", "normal_z"}.issubset(cols):
        soa["normals"] = np.stack(
            [cols["normal_x"], cols["normal_y"], cols["normal_z"]], axis=1
        ).astype(np.float32)
    if "rgb" in cols:
        bits = cols["rgb"].astype(np.float32).view(np.uint32)
        soa["rgb"] = np.stack(
            [(bits >> 16) & 0xFF, (bits >> 8) & 0xFF, bits & 0xFF], axis=1
        ).astype(np.uint8)
    if {"r", "g", "b"}.issubset(cols):
        soa["rgb"] = np.stack([cols["r"], cols["g"], cols["b"]], axis=1).astype(np.uint8)
    for name in ("intensity", "ring", "time", "return_type", "azimuth", "distance"):
        if name in cols:
            soa[name] = cols[name]
    return soa


# ---------------------------------------------------------------------------
# PCD
# ---------------------------------------------------------------------------

def _write_pcd(path: str, soa, ascii: bool, compressed: bool) -> None:
    cols = _soa_to_columns(soa)
    n = len(cols[0][1])
    names = " ".join(name for name, _ in cols)
    sizes = " ".join(str(_PCD_TYPE[c.dtype][1]) for _, c in cols)
    types = " ".join(_PCD_TYPE[c.dtype][0] for _, c in cols)
    counts = " ".join("1" for _ in cols)
    mode = "ascii" if ascii else ("binary_compressed" if compressed else "binary")
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {names}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {mode}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if ascii:
            table = np.column_stack([c.astype(np.float64) for _, c in cols])
            np.savetxt(f, table, fmt="%.10g")
        elif compressed:
            # PCL layout: per-FIELD contiguous blocks (SoA), LZF-compressed,
            # prefixed by u32 compressed_size + u32 uncompressed_size
            raw = b"".join(np.ascontiguousarray(c).tobytes() for _, c in cols)
            comp = lzf_compress(raw)
            f.write(struct.pack("<II", len(comp), len(raw)))
            f.write(comp)
        else:
            dtype = np.dtype([(name, c.dtype) for name, c in cols])
            rec = np.zeros(n, dtype=dtype)
            for name, c in cols:
                rec[name] = c
            f.write(rec.tobytes())


def _read_pcd(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        header: Dict[str, list] = {}
        while True:
            line = f.readline().decode("latin-1").strip()
            if line.startswith("#") or not line:
                continue
            key, *vals = line.split()
            header[key] = vals
            if key == "DATA":
                break
        names = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        n = int(header["POINTS"][0])
        mode = header["DATA"][0]
        dtypes = [_PCD_INV[(t, s)] for t, s in zip(types, sizes)]

        if mode == "ascii":
            table = np.loadtxt(f, dtype=np.float64, ndmin=2)
            table = table.reshape(n, len(names)) if n else table.reshape(0, len(names))
            cols = {
                name: table[:, i].astype(dt)
                for i, (name, dt) in enumerate(zip(names, dtypes))
            }
        elif mode == "binary":
            dtype = np.dtype(
                [(name, dt) for name, dt in zip(names, dtypes)]
            )
            cols_rec = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
            cols = {name: np.ascontiguousarray(cols_rec[name]) for name in names}
        elif mode == "binary_compressed":
            comp_size, raw_size = struct.unpack("<II", f.read(8))
            raw = lzf_decompress(f.read(comp_size), raw_size)
            cols = {}
            off = 0
            for name, dt in zip(names, dtypes):
                nbytes = np.dtype(dt).itemsize * n
                cols[name] = np.frombuffer(raw[off : off + nbytes], dtype=dt)
                off += nbytes
        else:
            raise ValueError(f"unsupported PCD DATA mode {mode!r}")
    return _columns_to_soa(cols)


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_TYPE = {np.dtype(np.float32): "float", np.dtype(np.float64): "double",
             np.dtype(np.uint8): "uchar", np.dtype(np.uint16): "ushort",
             np.dtype(np.uint32): "uint", np.dtype(np.int32): "int"}
_PLY_INV = {"float": np.float32, "float32": np.float32, "double": np.float64,
            "float64": np.float64, "uchar": np.uint8, "uint8": np.uint8,
            "ushort": np.uint16, "uint16": np.uint16, "uint": np.uint32,
            "uint32": np.uint32, "int": np.int32, "int32": np.int32,
            "short": np.int16, "char": np.int8}


def _write_ply(path: str, soa, ascii: bool) -> None:
    cols = _soa_to_columns(soa)
    # PLY convention: separate uchar r/g/b channels
    out_cols = []
    for name, c in cols:
        if name == "rgb":
            bits = c.view(np.uint32)
            out_cols += [("red", ((bits >> 16) & 0xFF).astype(np.uint8)),
                         ("green", ((bits >> 8) & 0xFF).astype(np.uint8)),
                         ("blue", (bits & 0xFF).astype(np.uint8))]
        else:
            out_cols.append((name, c))
    n = len(out_cols[0][1])
    fmt = "ascii" if ascii else "binary_little_endian"
    header = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
    header += [f"property {_PLY_TYPE[c.dtype]} {name}" for name, c in out_cols]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if ascii:
            table = np.column_stack([c.astype(np.float64) for _, c in out_cols])
            np.savetxt(f, table, fmt="%.10g")
        else:
            dtype = np.dtype([(name, c.dtype) for name, c in out_cols])
            rec = np.zeros(n, dtype=dtype)
            for name, c in out_cols:
                rec[name] = c
            f.write(rec.tobytes())


def _read_ply(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        line = f.readline().decode("latin-1").strip()
        if line != "ply":
            raise ValueError("not a PLY file")
        fmt = None
        n = 0
        props = []
        while True:
            line = f.readline().decode("latin-1").strip()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                if parts[1] == "vertex":
                    n = int(parts[2])
                elif props:
                    raise ValueError("non-vertex elements unsupported")
            elif parts[0] == "property" and parts[1] != "list":
                props.append((parts[2], _PLY_INV[parts[1]]))
        if fmt == "ascii":
            table = np.loadtxt(f, dtype=np.float64, ndmin=2).reshape(n, len(props))
            cols = {name: table[:, i].astype(dt) for i, (name, dt) in enumerate(props)}
        else:
            dtype = np.dtype([(name, dt) for name, dt in props])
            rec = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
            cols = {name: np.ascontiguousarray(rec[name]) for name, _ in props}
    rename = {"red": "r", "green": "g", "blue": "b"}
    cols = {rename.get(k, k): v for k, v in cols.items()}
    return _columns_to_soa(cols)


# ---------------------------------------------------------------------------
# XYZ-family (Open3D-supported text formats, reference :161)
# ---------------------------------------------------------------------------

def _write_xyz_family(path: str, soa, variant: str) -> None:
    pos = np.asarray(soa["positions"], np.float64)
    if variant == "xyz":
        table = pos
    elif variant == "xyzn":
        table = np.hstack([pos, np.asarray(soa["normals"], np.float64)])
    elif variant == "xyzrgb":
        rgb = np.asarray(soa["rgb"], np.float64)
        if rgb.max() > 1.0:
            rgb = rgb / 255.0
        table = np.hstack([pos, rgb])
    elif variant == "pts":
        table = pos
    else:
        raise ValueError(variant)
    np.savetxt(path, table, fmt="%.10g")


def _read_xyz_family(path: str, variant: str) -> Dict[str, np.ndarray]:
    table = np.loadtxt(path, dtype=np.float64, ndmin=2)
    soa = {"positions": table[:, :3].astype(np.float32)}
    if variant == "xyzn" and table.shape[1] >= 6:
        soa["normals"] = table[:, 3:6].astype(np.float32)
    elif variant == "xyzrgb" and table.shape[1] >= 6:
        soa["rgb"] = (table[:, 3:6] * 255).clip(0, 255).astype(np.uint8)
    return soa


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _write_kitti_bin(path: str, soa) -> None:
    """KITTI velodyne .bin: rows of (x, y, z, intensity) float32."""
    pos = np.asarray(soa["positions"], np.float32)
    intensity = soa.get("intensity")
    if intensity is None:
        intensity = np.zeros(pos.shape[0], np.float32)
    table = np.column_stack([pos, np.asarray(intensity, np.float32)])
    table.astype(np.float32).tofile(path)


def _read_kitti_bin(path: str) -> Dict[str, np.ndarray]:
    table = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return {
        "positions": np.ascontiguousarray(table[:, :3]),
        "intensity": np.ascontiguousarray(table[:, 3]),
    }


def write_point_cloud(
    path: str,
    soa: Dict[str, np.ndarray],
    ascii: bool = False,
    compressed: bool = False,
) -> None:
    """Write an SoA cloud; format chosen by extension
    (.pcd/.ply/.xyz/.xyzn/.xyzrgb/.pts per reference :161, plus KITTI
    velodyne .bin)."""
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext == "pcd":
        _write_pcd(path, soa, ascii, compressed)
    elif ext == "ply":
        _write_ply(path, soa, ascii)
    elif ext in ("xyz", "xyzn", "xyzrgb", "pts"):
        _write_xyz_family(path, soa, ext)
    elif ext == "bin":
        _write_kitti_bin(path, soa)
    else:
        raise ValueError(f"unsupported point-cloud extension .{ext}")


def read_point_cloud(path: str) -> Dict[str, np.ndarray]:
    """Read a cloud file back into the SoA convention."""
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext == "pcd":
        return _read_pcd(path)
    if ext == "ply":
        return _read_ply(path)
    if ext in ("xyz", "xyzn", "xyzrgb", "pts"):
        return _read_xyz_family(path, ext)
    if ext == "bin":
        return _read_kitti_bin(path)
    raise ValueError(f"unsupported point-cloud extension .{ext}")
