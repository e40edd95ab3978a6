"""Point-cloud compression codec + node.

Realizes the reference's sketched compressor (reference:
pointcloud_compressor.py:1-23 — a ``point_cloud_transport`` Draco codec the
reference never wired up; its console entry point has no ``main``,
setup.py:66). This is a self-contained Draco-style sequential codec:

* positions: bounding-box quantization to ``quantization_bits`` (lossy,
  error <= extent / 2^bits / 2) -> per-axis delta + zigzag -> varint ->
  DEFLATE. LiDAR scans are azimuth-ordered, so deltas are small and the
  varint stage does most of the work.
* attributes: dtype-preserving byte streams -> DEFLATE (lossless).
* ``quantization_bits=0`` stores raw float32 positions (fully lossless).

The delta/zigzag/varint byte loop is the hot native part (SURVEY.md §2b):
native/compressor.cc implements it (built at first use; a failed build
raises). The numpy-vectorized variant beside it is its plain version,
run when a caller asks for it (``native=False``); the wire format is the
same.

The host part is a copy of the reference package's ``io/compressor.py``.
The device part, ``device_quantizer`` and ``compress_buffer``, is ported
to PyTorch: the compaction of the live columns goes through K1
(``ops/segmean.compact_rows``), and the blobs are byte-identical to the
reference's for the same quantized input.

The writers compress a blob's streams (three position streams, or the one
raw stream, and one per attribute) concurrently on one process-wide
thread pool, created at first use with one worker a usable core, at most
8 (``_executor``); with one usable core they compress inline. Each stream
is deterministic and ``zlib.compress`` and the varint sidecar release the
GIL, so a blob costs about its slowest stream and its bytes are those of
a serial writer. Longest streams first: a writer submits the attribute
records as soon as their arrays exist, before it quantizes the positions
(a merged round's float32 intensity and uint16 ring take the longest),
then one task a position axis (varint, then DEFLATE). The caller joins the
futures in wire order, so a worker's exception reaches it there. Tasks
never submit into the pool, so no worker waits on another.
``decompress_soa`` stays serial.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import native as _native
from ..core.msg import CompressedPointCloud2, PointCloud2
from ..core.codec import pointcloud_to_dict
from ..ops.segmean import compact_rows
from .loader import soa_to_pointcloud2

__all__ = [
    "compress_soa",
    "compress_buffer",
    "decompress_soa",
    "PointCloudCodec",
    "PointcloudCompressorNode",
]

_MAGIC = b"APCZ"
_VERSION = 1

_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.uint16): 3,
    np.dtype(np.uint32): 4,
    np.dtype(np.int32): 5,
}
_DTYPE_INV = {v: k for k, v in _DTYPE_CODES.items()}

#: the quantizer's bounding-box sentinels (the reference's)
_BIG = 3.4e38


# ---------------------------------------------------------------------------
# varint + zigzag streams (native sidecar with numpy fallback)
# ---------------------------------------------------------------------------

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_ubyte)
_SIGNATURES = {
    "apc_delta_zigzag_varint_encode": (
        ctypes.c_longlong, (_I32P, ctypes.c_longlong, _U8P, ctypes.c_longlong)),
    "apc_delta_zigzag_varint_decode": (
        ctypes.c_longlong, (_U8P, ctypes.c_longlong, _I32P, ctypes.c_longlong)),
}


def _load_native():
    """The codec's sidecar library (built at first use; raises when the
    build fails)."""
    return _native.load("compressor", _SIGNATURES)


def _zigzag(v: np.ndarray) -> np.ndarray:
    return ((v << 1) ^ (v >> 31)).astype(np.uint32)


def _unzigzag(v: np.ndarray) -> np.ndarray:
    return ((v >> 1).astype(np.int32)) ^ -(v & 1).astype(np.int32)


def _varint_encode_np(values: np.ndarray) -> bytes:
    """Vectorized LEB128 encode of uint32 values."""
    v = values.astype(np.uint64)
    nbytes = np.ones(v.shape, np.int64)
    for b in range(1, 5):
        nbytes += v >= (1 << (7 * b))
    total = int(nbytes.sum())
    out = np.zeros(total, np.uint8)
    pos = np.concatenate([[0], np.cumsum(nbytes)[:-1]])
    rem = v.copy()
    for b in range(5):
        active = nbytes > b
        if not active.any():
            break
        byte = (rem & 0x7F).astype(np.uint8)
        more = (nbytes > b + 1) & active
        byte[more] |= 0x80
        out[pos[active] + b] = byte[active]
        rem >>= np.uint64(7)
    return out.tobytes()


def _varint_decode_np(data: bytes, count: int) -> np.ndarray:
    """Vectorized LEB128 decode of ``count`` uint32 values."""
    raw = np.frombuffer(data, np.uint8)
    is_last = (raw & 0x80) == 0
    ends = np.flatnonzero(is_last)[:count]
    starts = np.concatenate([[0], ends[:-1] + 1])
    out = np.zeros(count, np.uint64)
    max_len = int((ends - starts).max()) + 1 if count else 1
    for b in range(max_len):
        idx = starts + b
        active = idx <= ends
        out[active] |= (raw[idx[active]] & 0x7F).astype(np.uint64) << np.uint64(7 * b)
    return out.astype(np.uint32)


def _encode_i32_stream(values: np.ndarray, native: bool = True) -> bytes:
    """int32 sequence -> delta -> zigzag -> varint bytes (``native=False``:
    the numpy version)."""
    values = np.ascontiguousarray(values, np.int32)
    if not native:
        deltas = np.diff(values, prepend=np.int32(0)).astype(np.int32)
        return _varint_encode_np(_zigzag(deltas))
    cap = values.size * 5 + 16
    out = np.empty(cap, np.uint8)
    n = _load_native().apc_delta_zigzag_varint_encode(
        values.ctypes.data_as(_I32P), values.size, out.ctypes.data_as(_U8P), cap
    )
    if n < 0:
        raise RuntimeError("varint encode overflowed its buffer")
    return out[:n].tobytes()


def _decode_i32_stream(data: bytes, count: int, native: bool = True) -> np.ndarray:
    """Inverse of ``_encode_i32_stream``."""
    if not native:
        deltas = _unzigzag(_varint_decode_np(data, count))
        return np.cumsum(deltas, dtype=np.int64).astype(np.int32)
    out = np.empty(count, np.int32)
    buf = np.frombuffer(data, np.uint8)
    n = _load_native().apc_delta_zigzag_varint_decode(
        buf.ctypes.data_as(_U8P), buf.size, out.ctypes.data_as(_I32P), count
    )
    if n != count:
        raise ValueError(f"truncated varint stream: {count} values expected")
    return out


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

#: a blob has 3 position streams and a few attribute streams
_MAX_WORKERS = 8
_pool: Optional[ThreadPoolExecutor] = None
_pool_pid: Optional[int] = None
_pool_lock = threading.Lock()


def _executor() -> Optional[ThreadPoolExecutor]:
    """The process's stream pool (created at first use, and again in a
    process forked from one that had it); None with one usable core."""
    global _pool, _pool_pid
    with _pool_lock:
        if _pool_pid != os.getpid():
            workers = min(len(os.sched_getaffinity(0)), _MAX_WORKERS)
            _pool = (ThreadPoolExecutor(workers, thread_name_prefix="apcz")
                     if workers > 1 else None)
            _pool_pid = os.getpid()
        return _pool


def _submit(fn, *args) -> Future:
    """``fn(*args)`` on the stream pool, or here and now with one core."""
    pool = _executor()
    if pool is not None:
        return pool.submit(fn, *args)
    done: Future = Future()
    done.set_result(fn(*args))
    return done


def _attr_record(name: str, arr: np.ndarray, level: int) -> bytes:
    """One attribute's record: name, dtype code, columns, DEFLATE body."""
    code = _DTYPE_CODES[arr.dtype]
    cols = arr.shape[1] if arr.ndim == 2 else 0
    body = zlib.compress(np.ascontiguousarray(arr), level)
    nm = name.encode()
    return struct.pack("<B", len(nm)) + nm + struct.pack("<BBI", code, cols, len(body)) + body


def _submit_attrs(attrs, level: int) -> List[Future]:
    """Start compressing every attribute of ``attrs`` ((name, ndarray)
    pairs, in wire order); ``_write_attrs`` joins them."""
    return [_submit(_attr_record, name, arr, level) for name, arr in attrs]


def _write_attrs(out: bytearray, records: List[Future]) -> None:
    """Append the attribute section: count byte + per-attr records."""
    out += struct.pack("<B", len(records))
    for record in records:
        out += record.result()


def _position_stream(values: np.ndarray, level: int) -> bytes:
    """One quantized axis: varint stream, then DEFLATE."""
    return zlib.compress(_encode_i32_stream(values), level)


def _write_stream(out: bytearray, stream: Future) -> None:
    body = stream.result()
    out += struct.pack("<I", len(body)) + body


def _write_quantized_container(
    q: np.ndarray,
    lo: np.ndarray,
    step: np.ndarray,
    n: int,
    qbits: int,
    records: List[Future],
    level: int,
) -> bytes:
    """The ONE writer of the quantized-positions APCZ container.

    ``q``: int32[3, n] quantized position columns; ``records``: the
    attributes' futures from ``_submit_attrs``. Shared by compress_soa,
    compress_buffer, and the StreamingEngine egress so the wire format
    cannot drift.
    """
    streams = [_submit(_position_stream, q[c], level) for c in range(3)]
    out = bytearray()
    out += _MAGIC
    out += struct.pack("<BBIB", _VERSION, 0, n, qbits)
    out += struct.pack("<6d", *lo, *step)
    for stream in streams:
        _write_stream(out, stream)
    _write_attrs(out, records)
    return bytes(out)


def encode_device_quantized(
    packed: np.ndarray,
    meta: np.ndarray,
    qbits: int,
    intensity_scale: float = 1.0,
    level: int = 6,
) -> bytes:
    """Host finish of the device-quantized egress: ``(packed int16 rows,
    meta)`` from ``device_quantizer`` -> APCZ blob. Row 3, when present, is
    quantized intensity."""
    n = int(meta[0])
    attrs = []
    if packed.shape[0] > 3:
        attrs.append(
            (
                "intensity",
                packed[3, :n].astype(np.float32) / np.float32(intensity_scale),
            )
        )
    records = _submit_attrs(attrs, level)
    offset = 2 ** (qbits - 1)
    q = packed[:3, :n].astype(np.int32) + offset
    lo = meta[[1, 3, 5]].astype(np.float64)
    step = meta[[2, 4, 6]].astype(np.float64)
    return _write_quantized_container(q, lo, step, n, qbits, records, level)


def compress_soa(
    soa: Dict[str, np.ndarray],
    quantization_bits: int = 14,
    level: int = 6,
) -> bytes:
    """SoA dict -> compressed bytes (see module docstring for the scheme)."""
    positions = np.asarray(soa["positions"], np.float32)
    n = positions.shape[0]

    attrs = [
        (name, np.asarray(arr))
        for name, arr in sorted(soa.items())
        if name != "positions" and arr is not None
    ]
    records = _submit_attrs(attrs, level)  # before the quantization: see above
    if quantization_bits > 0 and n > 0:
        lo = positions.min(axis=0).astype(np.float64)
        hi = positions.max(axis=0).astype(np.float64)
        scale = (2**quantization_bits - 1) / np.maximum(hi - lo, 1e-30)
        q = ((positions - lo) * scale + 0.5).astype(np.int64).astype(np.int32)
        return _write_quantized_container(
            q.T, lo, 1.0 / scale, n, quantization_bits, records, level
        )

    # lossless raw-float path (quantization_bits == 0)
    stream = _submit(zlib.compress, np.ascontiguousarray(positions), level)
    out = bytearray()
    out += _MAGIC
    out += struct.pack("<BBIB", _VERSION, 0, n, quantization_bits)
    out += struct.pack("<6d", *([0.0] * 6))
    _write_stream(out, stream)
    _write_attrs(out, records)
    return bytes(out)


def decompress_soa(data: bytes) -> Dict[str, np.ndarray]:
    """Inverse of compress_soa."""
    if data[:4] != _MAGIC:
        raise ValueError("not an APCZ stream")
    version, _flags, n, qbits = struct.unpack_from("<BBIB", data, 4)
    if version != _VERSION:
        raise ValueError(f"unsupported version {version}")
    off = 4 + 7
    lo_and_step = struct.unpack_from("<6d", data, off)
    off += 48
    lo = np.array(lo_and_step[:3])
    step = np.array(lo_and_step[3:])

    if qbits > 0 and n > 0:
        cols = []
        for _c in range(3):
            (clen,) = struct.unpack_from("<I", data, off)
            off += 4
            stream = zlib.decompress(data[off : off + clen])
            off += clen
            cols.append(_decode_i32_stream(stream, n))
        q = np.stack(cols, axis=1).astype(np.float64)
        positions = (q * step + lo).astype(np.float32)
    else:
        (clen,) = struct.unpack_from("<I", data, off)
        off += 4
        positions = np.frombuffer(
            zlib.decompress(data[off : off + clen]), np.float32
        ).reshape(n, 3).copy()
        off += clen

    soa: Dict[str, np.ndarray] = {"positions": positions}
    (n_attrs,) = struct.unpack_from("<B", data, off)
    off += 1
    for _ in range(n_attrs):
        (nmlen,) = struct.unpack_from("<B", data, off)
        off += 1
        name = data[off : off + nmlen].decode()
        off += nmlen
        dtype_code, cols, blen = struct.unpack_from("<BBI", data, off)
        off += 6
        arr = np.frombuffer(
            zlib.decompress(data[off : off + blen]), _DTYPE_INV[dtype_code]
        )
        off += blen
        if cols:
            arr = arr.reshape(n, cols)
        soa[name] = arr.copy()
    return soa


class PointCloudCodec:
    """Message-level codec (point_cloud_transport PointCloudCodec analog,
    reference pointcloud_compressor.py:12-23)."""

    FORMAT = "apcz; draco-style sequential quantization codec"

    def __init__(self, quantization_bits: int = 14, level: int = 6):
        self.quantization_bits = quantization_bits
        self.level = level

    def encode(self, msg: PointCloud2) -> CompressedPointCloud2:
        soa, _meta = pointcloud_to_dict(msg, skip_nans=False)
        blob = compress_soa(soa, self.quantization_bits, self.level)
        return CompressedPointCloud2(header=msg.header, format=self.FORMAT, data=blob)

    def decode(self, msg: CompressedPointCloud2) -> PointCloud2:
        soa = decompress_soa(msg.data)
        out = soa_to_pointcloud2(soa, frame_id=msg.header.frame_id, stamp=msg.header.stamp)
        return out


class PointcloudCompressorNode:
    """Subscribe PointCloud2 -> publish CompressedPointCloud2 (and back).

    The runnable node the reference's entry point promised but never
    implemented (setup.py:66 with no ``main``).
    """

    def __init__(
        self,
        bus,
        input_topic: str = "/points",
        output_topic: str = "/points/compressed",
        decompress: bool = False,
        quantization_bits: int = 14,
        level: int = 6,
    ):
        from ..runtime.bus import qos_from_name

        self.codec = PointCloudCodec(quantization_bits, level)
        self.decompress = decompress
        self.bus = bus
        self.pub = bus.create_publisher(output_topic, qos_from_name("sensor_data"))
        self.sub = bus.create_subscription(
            input_topic, self.callback, qos_from_name("sensor_data")
        )
        self.frame_count = 0
        self.last_ratio: Optional[float] = None

    def callback(self, msg) -> None:
        if self.decompress:
            out = self.codec.decode(msg)
        else:
            out = self.codec.encode(msg)
            if msg.data:
                self.last_ratio = len(msg.data) / max(len(out.data), 1)
        self.pub.publish(out)
        self.frame_count += 1


# ---------------------------------------------------------------------------
# device-side quantization egress
# ---------------------------------------------------------------------------

def device_quantizer(qbits: int):
    """``quantize(buf, intensity_scale=1.0) -> (packed int16 rows, meta
    float32[7])`` on the buffer's device. ``intensity_scale`` is a float or
    a float32 scalar tensor on that device (a captured program takes the
    tensor: a float would be frozen into the graph).

    Runs the codec's lossy step on the device and emits int16, so only
    ~8 bytes a point leave it. Output columns are compacted (live points
    first, in buffer order) by one K1 launch over the position rows and
    intensity (``ops/segmean.compact_rows``); columns past the live count
    hold the quantized zeros of K1's padding. ``meta`` carries [count,
    (lo, step) per axis]. A buffer with a batch axis gives ``packed``
    [B, R, N] and ``meta`` [B, 7], every scan with its own box, in the same
    one launch. The StreamingEngine's egress uses this same function.
    ``qbits`` must be >= 1 (the qbits=0 lossless path exists only in
    compress_soa; levels=0 here would collapse every position).
    """
    if qbits < 1:
        raise ValueError(
            f"device quantization requires quantization_bits >= 1, got {qbits}"
        )
    levels = float(2**qbits - 1)
    offset = 2 ** (qbits - 1)
    # a CPU scalar tensor as the dividend: a true division on every device
    # (``float / tensor`` would multiply by a reciprocal, which rounds twice)
    levels_t = torch.tensor(levels, dtype=torch.float32)

    def quantize(buf, intensity_scale: float = 1.0):
        inten = buf.attributes.get("intensity")
        sources = [buf.positions] + ([inten] if inten is not None else [])
        outs, live = compact_rows(sources, buf.mask, buf.capacity)
        pos, live = outs[0], live.unsqueeze(-2)
        lo = torch.where(live, pos, _BIG).amin(-1)  # [..., 3]
        hi = torch.where(live, pos, -_BIG).amax(-1)
        scale = torch.div(levels_t, torch.clamp_min(hi - lo, 1e-30))
        q = torch.clamp((pos - lo.unsqueeze(-1)) * scale.unsqueeze(-1) + 0.5, 0.0, levels)
        # int16 with offset so qbits <= 15 fits: store q - 2^(qbits-1)
        rows = [(q.to(torch.int32) - offset).to(torch.int16)]
        if inten is not None:
            iq = torch.round(torch.clamp(outs[1] * intensity_scale, -32767.0, 32767.0))
            rows.append(iq.to(torch.int16).unsqueeze(-2))
        packed = torch.cat(rows, dim=-2)
        count = buf.mask.sum(-1, keepdim=True).to(torch.float32)
        bbox = torch.stack([lo, scale.reciprocal()], dim=-1).flatten(-2)  # lo, step per axis
        return packed, torch.cat([count, bbox], dim=-1)

    return quantize


def compress_buffer(
    buf,
    quantization_bits: int = 14,
    level: int = 6,
    intensity_scale: float = 1.0,
) -> bytes:
    """Compress one scan's device ScanBuffer: quantize on the device,
    transfer int16 only.

    Positions-and-intensity profile (the high-rate streaming path); the
    wire format matches compress_soa's container so decompress_soa reads
    it. Transfers ~8 bytes/point instead of ~32 (float egress).
    ``quantization_bits`` must be >= 1 (use compress_soa for lossless).
    """
    packed, meta = device_quantizer(quantization_bits)(buf, intensity_scale)
    return encode_device_quantized(
        packed.cpu().numpy(), meta.cpu().numpy(), quantization_bits, intensity_scale, level
    )
