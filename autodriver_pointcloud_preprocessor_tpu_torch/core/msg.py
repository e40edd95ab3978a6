"""ROS-free message containers, wire-compatible with ``sensor_msgs/PointCloud2``.

The reference binds directly to rclpy message classes
(reference: pointcloud_preprocessor.py:96-100). This framework keeps the
engine ROS-free: these dataclasses carry the exact same wire layout
(``data`` is the little-endian packed point buffer), so a thin adapter can
copy to/from real ROS 2 messages field-for-field when rclpy is present.

A copy of the reference package's ``core/msg.py`` (the port does not
import the reference).
"""
from __future__ import annotations

import dataclasses
import sys
import time as _time
from typing import List, Optional

import numpy as np

from .fields import FIELD_DTYPE_MAP, PointFieldType


@dataclasses.dataclass
class Time:
    """``builtin_interfaces/Time`` analog (sec + nanosec)."""

    sec: int = 0
    nanosec: int = 0

    @classmethod
    def now(cls) -> "Time":
        t = _time.time()
        sec = int(t)
        return cls(sec=sec, nanosec=int((t - sec) * 1e9))

    def to_float(self) -> float:
        return self.sec + self.nanosec * 1e-9

    @classmethod
    def from_float(cls, t: float) -> "Time":
        sec = int(t)
        return cls(sec=sec, nanosec=int(round((t - sec) * 1e9)))


@dataclasses.dataclass
class Header:
    """``std_msgs/Header`` analog."""

    stamp: Time = dataclasses.field(default_factory=Time)
    frame_id: str = ""


@dataclasses.dataclass
class PointField:
    """``sensor_msgs/PointField`` analog (same wire constants, see fields.py)."""

    name: str = ""
    offset: int = 0
    datatype: int = PointFieldType.FLOAT32
    count: int = 1

    # ROS-compatible class constants
    INT8 = int(PointFieldType.INT8)
    UINT8 = int(PointFieldType.UINT8)
    INT16 = int(PointFieldType.INT16)
    UINT16 = int(PointFieldType.UINT16)
    INT32 = int(PointFieldType.INT32)
    UINT32 = int(PointFieldType.UINT32)
    FLOAT32 = int(PointFieldType.FLOAT32)
    FLOAT64 = int(PointFieldType.FLOAT64)


@dataclasses.dataclass
class PointCloud2:
    """``sensor_msgs/PointCloud2`` analog with an identical byte layout."""

    header: Header = dataclasses.field(default_factory=Header)
    height: int = 1
    width: int = 0
    fields: List[PointField] = dataclasses.field(default_factory=list)
    is_bigendian: bool = False
    point_step: int = 0
    row_step: int = 0
    data: bytes = b""
    is_dense: bool = True

    @property
    def num_points(self) -> int:
        return self.height * self.width


@dataclasses.dataclass
class CompressedPointCloud2:
    """``point_cloud_transport/CompressedPointCloud2`` analog.

    The reference sketches Draco compression through point_cloud_transport
    (reference: pointcloud_compressor.py:12-23); this carries the compressed
    payload plus the metadata needed to reconstruct a PointCloud2.
    """

    header: Header = dataclasses.field(default_factory=Header)
    format: str = ""
    data: bytes = b""


@dataclasses.dataclass
class Marker:
    """``visualization_msgs/Marker`` analog (ARROW markers for normals)."""

    ARROW = 0
    ADD = 0

    header: Header = dataclasses.field(default_factory=Header)
    ns: str = ""
    id: int = 0
    type: int = 0
    action: int = 0
    points: list = dataclasses.field(default_factory=list)  # [(x,y,z), ...]
    scale: tuple = (0.01, 0.02, 0.0)
    color_rgba: tuple = (0.1, 0.9, 0.2, 1.0)


@dataclasses.dataclass
class MarkerArray:
    """``visualization_msgs/MarkerArray`` analog."""

    markers: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TransformStamped:
    """``geometry_msgs/TransformStamped`` analog (translation + quaternion)."""

    header: Header = dataclasses.field(default_factory=Header)
    child_frame_id: str = ""
    translation: tuple = (0.0, 0.0, 0.0)
    rotation_xyzw: tuple = (0.0, 0.0, 0.0, 1.0)


def structured_dtype_from_fields(
    fields: List[PointField], point_step: Optional[int] = None
) -> np.dtype:
    """Build a numpy structured dtype mirroring a PointCloud2 field layout.

    Honors per-field offsets and the overall ``point_step`` (itemsize) so
    ``np.frombuffer`` can view the message payload zero-copy.
    """
    names, formats, offsets = [], [], []
    for f in fields:
        base = np.dtype(FIELD_DTYPE_MAP[f.datatype])
        if f.count == 1:
            fmt: object = base
        else:
            fmt = (base, (f.count,))
        names.append(f.name)
        formats.append(fmt)
        offsets.append(f.offset)
    spec = {"names": names, "formats": formats, "offsets": offsets}
    if point_step is not None:
        spec["itemsize"] = point_step
    return np.dtype(spec)


def make_pointcloud2(
    struct_array: np.ndarray,
    fields: List[PointField],
    header: Optional[Header] = None,
    is_dense: bool = True,
    height: int = 1,
) -> PointCloud2:
    """Pack a structured numpy array into a PointCloud2 (create_cloud analog).

    Parity with ``sensor_msgs_py.point_cloud2.create_cloud`` as used at
    reference pointcloud_preprocessor.py:762-769.
    """
    if header is None:
        header = Header(stamp=Time.now())
    point_step = struct_array.dtype.itemsize
    n = struct_array.shape[0] if struct_array.ndim else 0
    if height <= 0:
        height = 1
    width = n // height
    return PointCloud2(
        header=header,
        height=height,
        width=width,
        fields=list(fields),
        is_bigendian=sys.byteorder != "little",
        point_step=point_step,
        row_step=point_step * width,
        data=struct_array.tobytes(order="C"),
        is_dense=is_dense,
    )
