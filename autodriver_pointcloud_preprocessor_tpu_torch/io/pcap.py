"""Velodyne PCAP replay: UDP packet decode -> padded scan buffers.

Realizes the reference's declared-but-stub PCAP capability
(reference: pcap_player.py is empty; pointcloud_loader.py:1-5 declares
"load from a Velodyne PCAP"). A libpcap-free C++ parser
(``native/velodyne_pcap.cc``, built at first use) extracts the payloads;
the numpy parser beside it is its plain version (``native=False``), and
both give identical payloads. The decode of the host-side reader is
vectorized numpy; the streaming engine decodes on the device instead
(``io/streaming.py``).

Supported sensors: VLP-16 (dual-firing-sequence blocks) and HDL-32E.
Velodyne coordinate convention: x = r*cos(el)*sin(az), y = r*cos(el)*cos(az),
z = r*sin(el); azimuth in hundredths of a degree, distance in 2 mm ticks.

A copy of the reference package's ``io/pcap.py``, except that the sidecar
is built at first use and a failed build raises.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Dict, Iterator, Optional

import numpy as np

from .. import native as _native

__all__ = [
    "VelodynePcapReader", "VelodyneUdpSource", "decode_packets",
    "VLP16", "HDL32E",
]

_PORT = 2368
_PAYLOAD = 1206

#: vertical angles (degrees) per laser id
VLP16 = "VLP16"
HDL32E = "HDL32E"

_ELEVATIONS = {
    VLP16: np.array(
        [-15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15],
        dtype=np.float32,
    ),
    HDL32E: np.array(
        [
            -30.67, -9.33, -29.33, -8.0, -28.0, -6.67, -26.67, -5.33,
            -25.33, -4.0, -24.0, -2.67, -22.67, -1.33, -21.33, 0.0,
            -20.0, 1.33, -18.67, 2.67, -17.33, 4.0, -16.0, 5.33,
            -14.67, 6.67, -13.33, 8.0, -12.0, 9.33, -10.67, 10.67,
        ],
        dtype=np.float32,
    ),
}


# ---------------------------------------------------------------------------
# pcap container parsing (host-side, format-only — no libpcap dependency)
# ---------------------------------------------------------------------------

def _iter_udp_payloads(data: bytes):
    """Yield (timestamp_sec float64, payload bytes) for UDP packets to 2368."""
    if len(data) < 24:
        return
    magic = struct.unpack("<I", data[:4])[0]
    if magic == 0xA1B2C3D4:
        endian, ts_scale = "<", 1e-6
    elif magic == 0xA1B23C4D:
        endian, ts_scale = "<", 1e-9
    elif magic == 0xD4C3B2A1:
        endian, ts_scale = ">", 1e-6
    elif magic == 0x4D3CB2A1:
        endian, ts_scale = ">", 1e-9
    else:
        raise ValueError("not a pcap file (bad magic)")
    linktype = struct.unpack(endian + "I", data[20:24])[0]
    off = 24
    n = len(data)
    while off + 16 <= n:
        ts_sec, ts_frac, incl, _orig = struct.unpack(
            endian + "IIII", data[off : off + 16]
        )
        off += 16
        frame = data[off : off + incl]
        off += incl
        payload = _extract_udp(frame, linktype)
        if payload is not None:
            yield ts_sec + ts_frac * ts_scale, payload


def _extract_udp(frame: bytes, linktype: int) -> Optional[bytes]:
    if linktype == 1:  # Ethernet
        if len(frame) < 14:
            return None
        ethertype = struct.unpack(">H", frame[12:14])[0]
        ip_off = 14
        if ethertype == 0x8100:  # 802.1Q VLAN tag
            ethertype = struct.unpack(">H", frame[16:18])[0]
            ip_off = 18
        if ethertype != 0x0800:
            return None
    elif linktype == 101:  # raw IP
        ip_off = 0
    else:
        return None
    if len(frame) < ip_off + 20:
        return None
    ihl = (frame[ip_off] & 0x0F) * 4
    proto = frame[ip_off + 9]
    if proto != 17:  # UDP
        return None
    udp_off = ip_off + ihl
    if len(frame) < udp_off + 8:
        return None
    dport = struct.unpack(">H", frame[udp_off + 2 : udp_off + 4])[0]
    if dport != _PORT:
        return None
    payload = frame[udp_off + 8 :]
    if len(payload) != _PAYLOAD:
        return None
    return payload


# ---------------------------------------------------------------------------
# vectorized packet decode (numpy fallback path)
# ---------------------------------------------------------------------------

def decode_packets(
    payloads: np.ndarray,
    stamps: np.ndarray,
    model: str = VLP16,
    min_range: float = 0.4,
    max_range: float = 130.0,
) -> Dict[str, np.ndarray]:
    """Decode (P, 1206) uint8 payloads into one flat SoA point dict.

    Returns positions/intensity/ring/time/azimuth/distance arrays plus
    ``block_azimuth`` (per point, hundredths of deg) used for scan
    splitting. Out-of-range returns are dropped.
    """
    elev = _ELEVATIONS[model]
    p = payloads.shape[0]
    blocks = payloads[:, :1200].reshape(p, 12, 100)
    azimuth_raw = (
        blocks[:, :, 2].astype(np.uint16) | (blocks[:, :, 3].astype(np.uint16) << 8)
    ).astype(np.float32)  # (P, 12) hundredths of degrees
    ch = blocks[:, :, 4:100].reshape(p, 12, 32, 3)
    dist = (
        ch[:, :, :, 0].astype(np.uint16) | (ch[:, :, :, 1].astype(np.uint16) << 8)
    ).astype(np.float32) * 0.002  # meters
    refl = ch[:, :, :, 2].astype(np.float32)

    laser = np.arange(32)
    if model == VLP16:
        ring = (laser % 16).astype(np.uint16)
        seq = laser // 16  # 0 or 1: second firing sequence within the block
        # azimuth interpolation between blocks for the second sequence
        az_next = np.empty_like(azimuth_raw)
        az_next[:, :-1] = azimuth_raw[:, 1:]
        az_next[:, -1] = azimuth_raw[:, -1] + (
            azimuth_raw[:, -1] - azimuth_raw[:, -2]
        )
        daz = (az_next - azimuth_raw) % 36000.0
        az = azimuth_raw[:, :, None] + 0.5 * daz[:, :, None] * seq[None, None, :]
    else:
        ring = laser.astype(np.uint16)
        az = np.broadcast_to(azimuth_raw[:, :, None], (p, 12, 32)).copy()
    az = az % 36000.0

    az_rad = np.deg2rad(az / 100.0).astype(np.float32)
    el_rad = np.deg2rad(elev[ring]).astype(np.float32)[None, None, :]
    cos_el = np.cos(el_rad)
    x = dist * cos_el * np.sin(az_rad)
    y = dist * cos_el * np.cos(az_rad)
    z = dist * np.sin(el_rad)

    time_pt = np.broadcast_to(stamps[:, None, None], dist.shape)
    ring_pt = np.broadcast_to(ring[None, None, :], dist.shape)

    keep = (dist >= min_range) & (dist <= max_range)
    flat = lambda a: np.ascontiguousarray(a[keep] if a.shape == dist.shape else a)
    positions = np.stack([x[keep], y[keep], z[keep]], axis=1).astype(np.float32)
    return {
        "positions": positions,
        "intensity": refl[keep].astype(np.float32),
        "ring": ring_pt[keep].astype(np.uint16),
        "time": time_pt[keep].astype(np.float64),
        "azimuth": az[keep].astype(np.float32) / 100.0,
        "distance": dist[keep].astype(np.float32),
        "block_azimuth": az[keep].astype(np.float32),
    }


# ---------------------------------------------------------------------------
# native sidecar (C++)
# ---------------------------------------------------------------------------

_SIGNATURES = {
    "vp_extract_payloads": (
        ctypes.c_longlong,
        (ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
         ctypes.POINTER(ctypes.c_double), ctypes.c_longlong),
    ),
    "vp_count_packets": (ctypes.c_longlong, (ctypes.c_char_p,)),
}


def _load_native():
    """The payload extractor's library (built at first use; raises when
    the build fails)."""
    return _native.load("velodyne_pcap", _SIGNATURES)


def _read_payloads_np(path: str):
    """Plain version of the sidecar's payload extraction."""
    with open(path, "rb") as f:
        data = f.read()
    pairs = list(_iter_udp_payloads(data))
    if not pairs:
        return np.empty((0, _PAYLOAD), np.uint8), np.empty(0, np.float64)
    stamps = np.array([t for t, _ in pairs], dtype=np.float64)
    payloads = np.frombuffer(
        b"".join(p for _, p in pairs), dtype=np.uint8
    ).reshape(-1, _PAYLOAD)
    return payloads, stamps


def _read_payloads(path: str, native: bool = True):
    """(P, 1206) uint8 payloads + float64 stamps of a capture, through the
    sidecar (``native=False``: its numpy version)."""
    if not native:
        return _read_payloads_np(path)
    lib = _load_native()
    count = lib.vp_count_packets(path.encode())
    if count < 0:
        raise IOError(f"native pcap parse failed for {path}")
    payloads = np.empty((count, _PAYLOAD), dtype=np.uint8)
    stamps = np.empty(count, dtype=np.float64)
    got = lib.vp_extract_payloads(
        path.encode(),
        payloads.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        count,
    )
    return payloads[:got], stamps[:got]


class VelodynePcapReader:
    """Replay a Velodyne capture as per-revolution SoA scans.

    Scans split on azimuth rollover (the start of each new revolution).
    """

    def __init__(
        self,
        path: str,
        model: str = VLP16,
        min_range: float = 0.4,
        max_range: float = 130.0,
    ):
        self.path = path
        self.model = model
        self.min_range = min_range
        self.max_range = max_range

    def read_all(self) -> Dict[str, np.ndarray]:
        """Decode the whole capture into one flat SoA dict."""
        payloads, stamps = _read_payloads(self.path)
        return decode_packets(
            payloads, stamps, self.model, self.min_range, self.max_range
        )

    def scans(self) -> Iterator[Dict[str, np.ndarray]]:
        """Yield one SoA dict per sensor revolution."""
        flat = self.read_all()
        az = flat.pop("block_azimuth")
        if az.size == 0:
            return
        # rollover: azimuth decreases between consecutive points
        wraps = np.flatnonzero(np.diff(az) < -18000.0) + 1
        bounds = [0, *wraps.tolist(), az.size]
        for a, b in zip(bounds[:-1], bounds[1:]):
            if b - a == 0:
                continue
            yield {k: v[a:b] for k, v in flat.items()}


class VelodyneUdpSource:
    """LIVE UDP packet source: sensor datagrams -> per-revolution scans.

    Completes the reference's declared live-replay capability (its
    pcap_player/loader docstrings imply a live source beyond file replay;
    pointcloud_loader.py:1-5) — the file reader above covers captures,
    this covers the sensor itself. Binds the Velodyne data port, splits
    revolutions on block-0 azimuth rollover by peeking 2 bytes per packet
    (the same split io/streaming.py uses), and yields either raw
    ``(payloads, stamps)`` revolutions (feed ``StreamingEngine``) or
    decoded SoA scans. Packet timestamps are host receipt times.

    Iteration ends on ``max_scans`` or when no packet arrives within
    ``timeout`` seconds (sensor gone quiet).
    """

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = _PORT,
        model: str = VLP16,
        min_range: float = 0.4,
        max_range: float = 130.0,
        timeout: float = 2.0,
        max_packets_per_rev: int = 2048,
    ):
        import socket

        self.model = model
        self.min_range = min_range
        self.max_range = max_range
        self.timeout = timeout
        self.max_packets_per_rev = max_packets_per_rev
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        self._sock.bind((host, port))
        self._sock.settimeout(timeout)

    @property
    def port(self) -> int:
        """The bound port (useful when constructed with port=0)."""
        return self._sock.getsockname()[1]

    def close(self) -> None:
        self._sock.close()

    def revolutions(self, max_scans: Optional[int] = None):
        """Yield raw ``(payloads uint8[P,1206], stamps float64[P])`` per
        revolution until ``max_scans`` or receive timeout."""
        import socket
        import time as _time

        buf_payloads = []
        buf_stamps = []
        last_az = None
        yielded = 0
        while max_scans is None or yielded < max_scans:
            try:
                data = self._sock.recv(65535)
            except socket.timeout:
                break
            if len(data) != _PAYLOAD:
                continue  # position/telemetry packets etc.
            az0 = data[2] | (data[3] << 8)
            if (
                last_az is not None
                and az0 < last_az - 18000
                and buf_payloads
            ) or len(buf_payloads) >= self.max_packets_per_rev:
                yield (
                    np.frombuffer(
                        b"".join(buf_payloads), dtype=np.uint8
                    ).reshape(-1, _PAYLOAD),
                    np.asarray(buf_stamps, dtype=np.float64),
                )
                yielded += 1
                buf_payloads, buf_stamps = [], []
            buf_payloads.append(data)
            buf_stamps.append(_time.time())
            last_az = az0
        if buf_payloads and (max_scans is None or yielded < max_scans):
            yield (
                np.frombuffer(
                    b"".join(buf_payloads), dtype=np.uint8
                ).reshape(-1, _PAYLOAD),
                np.asarray(buf_stamps, dtype=np.float64),
            )

    def scans(
        self, max_scans: Optional[int] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield one decoded SoA dict per live revolution."""
        for payloads, stamps in self.revolutions(max_scans):
            soa = decode_packets(
                payloads, stamps, self.model, self.min_range, self.max_range
            )
            soa.pop("block_azimuth", None)
            yield soa
