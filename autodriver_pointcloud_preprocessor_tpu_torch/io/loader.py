"""Point-cloud loader node: publish scans from files (or a PCAP).

Realizes the reference's declared-but-stub loader capability
(reference: pointcloud_loader.py:1-5 — "load pointclouds from a directory
of .pcd/.ply files or a Velodyne PCAP; looping support"). File parsing is
host-side numpy (io/pcd.py); PCAP decoding comes from io/pcap.py.

A copy of the reference package's ``io/loader.py`` (the port does not
import the reference).
"""
from __future__ import annotations

import glob
import os
import time
from typing import Iterator, List, Optional

import numpy as np

from ..core.codec import build_pointfields
from ..core.fields import PointFieldType
from ..core.msg import Header, PointCloud2, Time, make_pointcloud2
from ..runtime.bus import TopicBus, qos_from_name
from .pcd import read_point_cloud

__all__ = ["PointcloudLoader", "soa_to_pointcloud2"]

_EXTS = (".pcd", ".ply", ".xyz", ".xyzn", ".xyzrgb", ".pts", ".bin")

_SOA_FIELD_TYPES = {
    "intensity": PointFieldType.FLOAT32,
    "ring": PointFieldType.UINT16,
    "time": PointFieldType.FLOAT64,
    "return_type": PointFieldType.UINT8,
    "azimuth": PointFieldType.FLOAT32,
    "distance": PointFieldType.FLOAT32,
}


def soa_to_pointcloud2(
    soa, frame_id: str = "lidar", stamp: Optional[Time] = None
) -> PointCloud2:
    """Build a wire PointCloud2 from a host SoA dict."""
    names: List[str] = ["x", "y", "z"]
    types: List[int] = [PointFieldType.FLOAT32] * 3
    for name, t in _SOA_FIELD_TYPES.items():
        if soa.get(name) is not None:
            names.append(name)
            types.append(t)
    has_rgb = soa.get("rgb") is not None
    if has_rgb:
        names.append("rgb")
        types.append(PointFieldType.FLOAT32)
    fields, step = build_pointfields(names, types)
    from ..core.msg import structured_dtype_from_fields

    pos = np.asarray(soa["positions"])
    n = pos.shape[0]
    arr = np.zeros(n, dtype=structured_dtype_from_fields(fields, step))
    arr["x"], arr["y"], arr["z"] = pos[:, 0], pos[:, 1], pos[:, 2]
    for name in _SOA_FIELD_TYPES:
        if name in names:
            arr[name] = np.asarray(soa[name]).reshape(n)
    if has_rgb:
        rgb = np.asarray(soa["rgb"])
        if rgb.ndim == 2:
            packed = (
                (rgb[:, 0].astype(np.uint32) << 16)
                | (rgb[:, 1].astype(np.uint32) << 8)
                | rgb[:, 2].astype(np.uint32)
            ).view(np.float32)
        else:
            packed = rgb.astype(np.float32)
        arr["rgb"] = packed
    header = Header(stamp=stamp or Time.now(), frame_id=frame_id)
    return make_pointcloud2(arr, fields, header=header)


class PointcloudLoader:
    """Iterate a directory of cloud files (sorted) and publish each as a scan.

    Args:
        source: directory of supported files, a single file, or a .pcap
            path (delegated to io/pcap.py).
        topic: output topic on ``bus``.
        rate_hz: publishing rate for ``spin`` (0 = as fast as possible).
        loop: restart from the first file at the end (reference loader
            docstring intent).
    """

    def __init__(
        self,
        source: str,
        bus: Optional[TopicBus] = None,
        topic: str = "/loader/points",
        frame_id: str = "lidar",
        rate_hz: float = 10.0,
        loop: bool = False,
        qos: str = "SENSOR_DATA",
    ):
        self.source = source
        self.bus = bus if bus is not None else TopicBus()
        self.topic = topic
        self.frame_id = frame_id
        self.rate_hz = rate_hz
        self.loop = loop
        self.publisher = self.bus.create_publisher(topic, qos_from_name(qos))
        self.files = self._discover(source)

    @staticmethod
    def _discover(source: str) -> List[str]:
        if os.path.isdir(source):
            files = []
            for ext in _EXTS:
                files.extend(glob.glob(os.path.join(source, f"*{ext}")))
            return sorted(files)
        return [source]

    def scans(self) -> Iterator[PointCloud2]:
        """Yield PointCloud2 messages (one pass, or endless when looping)."""
        while True:
            for path in self.files:
                if path.endswith(".pcap"):
                    from .pcap import VelodynePcapReader

                    for soa in VelodynePcapReader(path).scans():
                        yield soa_to_pointcloud2(soa, self.frame_id)
                else:
                    yield soa_to_pointcloud2(read_point_cloud(path), self.frame_id)
            if not self.loop:
                return

    def publish_next(self, it: Optional[Iterator[PointCloud2]] = None) -> bool:
        """Publish a single scan; False when the (non-looping) source is done."""
        if it is None:
            if not hasattr(self, "_iter"):
                self._iter = self.scans()
            it = self._iter
        try:
            self.publisher.publish(next(it))
            return True
        except StopIteration:
            return False

    def spin(self, max_scans: Optional[int] = None) -> int:
        """Publish scans at ``rate_hz``; returns the number published."""
        count = 0
        period = 1.0 / self.rate_hz if self.rate_hz > 0 else 0.0
        for msg in self.scans():
            start = time.perf_counter()
            self.publisher.publish(msg)
            count += 1
            if max_scans is not None and count >= max_scans:
                break
            if period:
                remaining = period - (time.perf_counter() - start)
                if remaining > 0:
                    time.sleep(remaining)
        return count
