"""Host-side PointCloud2 <-> struct-of-arrays codec.

Capability parity with the reference's tensor-interchange layer
(reference: utils.py:51-133 ``convert_pointcloud_to_numpy``,
utils.py:140-199 ``numpy_struct_to_pointcloud2``, utils.py:202-223
``pointcloud_to_dict``, utils.py:304-356 RGB pack/unpack), redesigned for the
device data path: one vectorized numpy pass from message bytes to a
struct-of-arrays dict, so the device sees exactly one H2D transfer of flat
arrays per scan (SURVEY.md L1 mapping).

Note on ``time``: ROS point times are float64; device compute runs float32. The
codec splits time into a float64 scalar ``time_base`` (host metadata) plus a
float32 offset array so per-point precision is preserved end-to-end.

A copy of the reference package's ``core/codec.py`` (the port does not
import the reference).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .fields import FIELD_DTYPE_MAP, get_pointcloud_metadata
from .msg import Header, PointCloud2, PointField, structured_dtype_from_fields

__all__ = [
    "read_points",
    "create_cloud",
    "build_pointfields",
    "pointcloud_to_dict",
    "structured_to_soa",
    "soa_to_structured",
    "merge_rgb_fields",
    "extract_rgb_from_packed",
    "pack_rgb_float",
    "rgb_to_intensity",
    "intensity_to_rgb",
]


# ---------------------------------------------------------------------------
# PointCloud2 message <-> structured numpy
# ---------------------------------------------------------------------------

def read_points(
    cloud: PointCloud2,
    field_names: Optional[Sequence[str]] = None,
    skip_nans: bool = False,
    reshape_organized_cloud: bool = False,
) -> np.ndarray:
    """View a PointCloud2 payload as a structured numpy array.

    Analog of ``sensor_msgs_py.point_cloud2.read_points`` as invoked at
    reference utils.py:206-211: optional field selection, NaN-row skipping,
    and organized (H, W) reshape.
    """
    dtype = structured_dtype_from_fields(cloud.fields, cloud.point_step)
    n = cloud.num_points
    arr = np.frombuffer(bytearray(cloud.data), dtype=dtype, count=n)

    if field_names is not None:
        arr = arr[list(field_names)]

    if skip_nans and not cloud.is_dense:
        finite = np.ones(arr.shape[0], dtype=bool)
        for name in arr.dtype.names:
            col = arr[name]
            if np.issubdtype(col.dtype, np.floating):
                colv = col if col.ndim == 1 else col.reshape(col.shape[0], -1)
                finite &= np.isfinite(colv).all(axis=-1) if colv.ndim > 1 else np.isfinite(colv)
        arr = arr[finite]
    # Both flags apply INDEPENDENTLY, like sensor_msgs_py.read_points as
    # invoked at reference utils.py:206-211 (skip-nans first, then the
    # organized reshape). When nan-skipping dropped rows the (H, W) grid no
    # longer exists; sensor_msgs_py would raise on the reshape — we keep
    # the cloud flat instead (documented deviation: degrade, don't drop
    # the scan).
    if reshape_organized_cloud and cloud.height > 1:
        if arr.shape[0] == cloud.height * cloud.width:
            arr = arr.reshape(cloud.height, cloud.width)
    return arr


def create_cloud(
    header: Header, fields: List[PointField], points: np.ndarray, is_dense: bool = True
) -> PointCloud2:
    """Pack a structured array into a PointCloud2 (create_cloud analog)."""
    from .msg import make_pointcloud2

    return make_pointcloud2(points, fields, header=header, is_dense=is_dense)


def build_pointfields(
    field_names: Sequence[str], field_datatypes: Sequence[int]
) -> Tuple[List[PointField], int]:
    """Build the PointField list + point_step for an output schema.

    Parity with reference ``numpy_struct_to_pointcloud2`` (utils.py:140-199):
    fields are tightly packed in declaration order with a running byte offset.
    Returns ``(fields, point_step)``.
    """
    fields: List[PointField] = []
    offset = 0
    for name, datatype in zip(field_names, field_datatypes):
        np_dt = FIELD_DTYPE_MAP[datatype]
        byte_size = np.dtype(np_dt).itemsize
        fields.append(PointField(name=name, offset=offset, datatype=int(datatype), count=1))
        offset += byte_size
    return fields, offset


# ---------------------------------------------------------------------------
# RGB codecs (reference: utils.py:304-356)
# ---------------------------------------------------------------------------

def merge_rgb_fields(
    r: np.ndarray, g: np.ndarray, b: np.ndarray, return_int: bool = False
) -> np.ndarray:
    """Merge separate r/g/b (PCL-style) channels.

    ``return_int=True`` -> (N, 3) uint8; else packed float32 with byte layout
    [0, R, G, B]. Parity with reference utils.py:304-322.
    """
    if return_int:
        return np.vstack((r.astype(np.uint8), g.astype(np.uint8), b.astype(np.uint8))).T
    r32 = r.astype(np.uint32)
    g32 = g.astype(np.uint32)
    b32 = b.astype(np.uint32)
    return np.asarray((r32 << 16) | (g32 << 8) | b32).view(np.float32)


def extract_rgb_from_packed(rgb: np.ndarray) -> np.ndarray:
    """Packed float32 rgb -> (N, 3) uint8 via bit shifts (utils.py:324-345)."""
    rgb_bytes = np.ascontiguousarray(rgb, dtype=np.float32).view(np.uint32)
    r = ((rgb_bytes >> 16) & 0xFF).astype(np.uint8)
    g = ((rgb_bytes >> 8) & 0xFF).astype(np.uint8)
    b = (rgb_bytes & 0xFF).astype(np.uint8)
    return np.vstack((r, g, b)).T


def pack_rgb_float(rgb01: np.ndarray) -> np.ndarray:
    """Float colors in [0, 1] (N, 3) -> packed float32 for publishing.

    Parity with reference ``rgb_int_to_float`` (utils.py:347-356).
    """
    colors_u8 = (np.asarray(rgb01) * 255).clip(0, 255).astype(np.uint8)
    r = colors_u8[:, 0].astype(np.uint32)
    g = colors_u8[:, 1].astype(np.uint32)
    b = colors_u8[:, 2].astype(np.uint32)
    return ((r << 16) | (g << 8) | b).view(np.float32)


def rgb_to_intensity(color: np.ndarray) -> np.ndarray:
    """Rec.709 luma from (N, 3) colors in [0, 1] (utils.py:358-367)."""
    rgb = np.asarray(color)
    return (0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1] + 0.0722 * rgb[:, 2]).astype(
        np.float32
    )


def intensity_to_rgb(intensity: np.ndarray) -> np.ndarray:
    """Min-max normalized grayscale replication (utils.py:370-421, method 1)."""
    intensity = np.asarray(intensity, dtype=np.float32)
    i_min, i_max = intensity.min(), intensity.max()
    i_norm = (intensity - i_min) / max(float(i_max - i_min), 1e-6)
    return np.stack([i_norm, i_norm, i_norm], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Structured array <-> SoA dict
# ---------------------------------------------------------------------------

def structured_to_soa(
    structured: np.ndarray, metadata: Dict[str, object]
) -> Dict[str, np.ndarray]:
    """Structured array -> struct-of-arrays dict.

    Parity with reference ``convert_pointcloud_to_numpy`` (utils.py:51-133):
    positions float32 (N, 3); rgb merged from r/g/b or unpacked from packed
    float; intensity float32; ring uint16; time float64; return_type uint8.
    """
    positions = np.vstack(
        (structured["x"], structured["y"], structured["z"])
    ).T.astype(np.float32)
    out: Dict[str, np.ndarray] = {"positions": positions}

    field_names = metadata.get("field_names") or structured.dtype.names

    if metadata.get("has_rgb"):
        if {"r", "g", "b"}.issubset(field_names):
            rgb = merge_rgb_fields(
                structured["r"], structured["g"], structured["b"], return_int=True
            )
        else:
            rgb = extract_rgb_from_packed(structured["rgb"].astype(np.float32))
        out["rgb"] = rgb
    if metadata.get("has_intensity"):
        out["intensity"] = structured[metadata["intensity_field_name"]].astype(np.float32)
    if metadata.get("has_ring"):
        out["ring"] = structured[metadata["ring_field_name"]].astype(np.uint16)
    if metadata.get("has_time"):
        out["time"] = structured[metadata["time_field_name"]].astype(np.float64)
    if metadata.get("has_return_type"):
        out["return_type"] = structured[metadata["return_type_field_name"]].astype(
            np.uint8
        )
    return out


def pointcloud_to_dict(
    ros_cloud: PointCloud2,
    field_names: Optional[Sequence[str]] = None,
    skip_nans: bool = True,
    organize_cloud: bool = False,
    metadata_dict: Optional[dict] = None,
) -> Tuple[Dict[str, np.ndarray], dict]:
    """PointCloud2 -> (SoA dict, metadata), caching vendor-field resolution.

    Parity with reference utils.py:202-223, including the metadata cache
    (vendor aliases recomputed only when ``has_intensity`` is absent).
    """
    if not metadata_dict:
        metadata_dict = {}
    metadata_dict.update({"header": ros_cloud.header, "field_names": None})
    cloud_array = read_points(
        ros_cloud,
        field_names=field_names,
        skip_nans=skip_nans,
        reshape_organized_cloud=organize_cloud,
    )
    metadata_dict["field_names"] = cloud_array.dtype.names
    metadata_dict["num_fields"] = len(cloud_array.dtype.names)

    if not metadata_dict.get("has_intensity", False):
        metadata_dict.update(get_pointcloud_metadata(metadata_dict["field_names"]))

    if cloud_array.ndim > 1:
        cloud_array = cloud_array.reshape(-1)
    return structured_to_soa(cloud_array, metadata_dict), metadata_dict


def soa_to_structured(
    soa: Dict[str, np.ndarray],
    metadata: Dict[str, object],
    new_dtype: np.dtype | list,
    include_normals: bool = False,
) -> np.ndarray:
    """SoA dict -> output structured array for publishing.

    Parity with the egress copy loop at reference
    pointcloud_preprocessor.py:576-625: x/y/z from positions, rgb re-packed
    from [0,1] floats, per-vendor attribute names restored, normals appended
    when present. (Fixes the reference's ``if rgb_np:`` ndarray-truthiness
    bug at :600 by checking presence explicitly.)
    """
    positions = soa["positions"]
    n = positions.shape[0]
    out = np.zeros(n, dtype=new_dtype)
    out["x"] = positions[:, 0]
    out["y"] = positions[:, 1]
    out["z"] = positions[:, 2]

    rgb = soa.get("rgb")
    if rgb is not None and "rgb" in out.dtype.names:
        rgb = np.asarray(rgb)
        if rgb.ndim == 2:  # float [0,1] channels -> packed float32
            out["rgb"] = pack_rgb_float(rgb)
        else:  # already packed
            out["rgb"] = rgb.astype(out["rgb"].dtype)

    # Every scalar SoA attribute whose (vendor-aliased or literal) field
    # name exists in the output schema passes through — not just the four
    # canonical ones. PCAP-decoded clouds carry azimuth/distance
    # (io/loader.py) and those must survive publishing.
    handled = {"positions", "rgb", "normals"}
    for canonical, arr in soa.items():
        if canonical in handled or arr is None:
            continue
        name = metadata.get(f"{canonical}_field_name") or canonical
        if name in out.dtype.names:
            out[name] = np.asarray(arr).reshape(n).astype(out[name].dtype)

    if include_normals and soa.get("normals") is not None:
        normals = np.asarray(soa["normals"])
        out["normal_x"] = normals[:, 0].astype(out["normal_x"].dtype)
        out["normal_y"] = normals[:, 1].astype(out["normal_y"].dtype)
        out["normal_z"] = normals[:, 2].astype(out["normal_z"].dtype)
    return out
