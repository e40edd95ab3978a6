"""Point-field schema tables and vendor alias resolution.

Capability parity with the reference's dtype/vendor tables and metadata
resolver (reference: autodriver_pointcloud_preprocessor/utils.py:28-48,
:423-472), re-implemented ROS-free: the ``PointFieldType`` enum mirrors the
``sensor_msgs/PointField`` wire constants so messages produced here are
byte-compatible with ROS 2 consumers without importing rclpy.

A copy of the reference package's ``core/fields.py`` (the port does not
import the reference).
"""
from __future__ import annotations

import enum
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class PointFieldType(enum.IntEnum):
    """Wire-compatible ``sensor_msgs/PointField`` datatype constants."""

    INT8 = 1
    UINT8 = 2
    INT16 = 3
    UINT16 = 4
    INT32 = 5
    UINT32 = 6
    FLOAT32 = 7
    FLOAT64 = 8


#: PointField datatype -> numpy dtype (reference: utils.py:28-37).
FIELD_DTYPE_MAP: Dict[int, type] = {
    PointFieldType.INT8: np.int8,
    PointFieldType.UINT8: np.uint8,
    PointFieldType.INT16: np.int16,
    PointFieldType.UINT16: np.uint16,
    PointFieldType.INT32: np.int32,
    PointFieldType.UINT32: np.uint32,
    PointFieldType.FLOAT32: np.float32,
    PointFieldType.FLOAT64: np.float64,
}

#: numpy dtype -> PointField datatype (reference: utils.py:39).
FIELD_DTYPE_MAP_INV: Dict[type, int] = {v: k for k, v in FIELD_DTYPE_MAP.items()}

#: Canonical attribute -> per-vendor field-name aliases
#: (reference: utils.py:41-48; Velodyne/Livox/Autoware conventions).
VENDOR_MAPPINGS: Dict[str, List[str]] = {
    "intensity": ["I", "intensity"],
    "ring": ["C", "ring", "line"],
    "time": ["t", "time", "timestamp"],
    "return_type": ["return_type", "tag", "R"],
    "azimuth": ["azimuth"],
    "distance": ["distance", "depth", "d"],
}


def resolve_field_alias(
    options: Sequence[str] | str, field_names: Iterable[str]
) -> Tuple[bool, Optional[str]]:
    """Case-insensitive match of any alias in ``options`` against ``field_names``.

    Returns ``(found, matching_name)`` where ``matching_name`` is the *alias*
    (lower-cased match target lives in ``field_names``). Mirrors the
    reference's ``parse_differing_fields`` (utils.py:423-438), including its
    behavior of returning the *last* matching option when several match.
    """
    if isinstance(options, str):
        options = [options]
    field_names = [f.lower() for f in field_names]
    found = False
    corresponding = None
    for option in options:
        if option.lower() in field_names:
            found = True
            corresponding = option
    return found, corresponding


def get_pointcloud_metadata(
    field_names: Iterable[str],
    vendor_mappings: Optional[Dict[str, List[str]]] = None,
) -> Dict[str, object]:
    """Resolve vendor-specific field names into canonical ``has_*`` metadata.

    Parity with reference utils.py:441-472, including the separate
    r/g/b-triple special case (utils.py:450-452).
    """
    if vendor_mappings is None:
        vendor_mappings = VENDOR_MAPPINGS
    field_names = [f.lower() for f in field_names]

    if {"r", "g", "b"}.issubset(field_names):
        has_rgb = True
        rgb_field_name: object = ["r", "g", "b"]
    else:
        has_rgb, rgb_field_name = resolve_field_alias("rgb", field_names)

    has_intensity, intensity_field_name = resolve_field_alias(
        vendor_mappings["intensity"], field_names
    )
    has_ring, ring_field_name = resolve_field_alias(vendor_mappings["ring"], field_names)
    has_time, time_field_name = resolve_field_alias(vendor_mappings["time"], field_names)
    has_return_type, return_type_field_name = resolve_field_alias(
        vendor_mappings["return_type"], field_names
    )

    return {
        "has_rgb": has_rgb,
        "rgb_field_name": rgb_field_name,
        "has_intensity": has_intensity,
        "intensity_field_name": intensity_field_name,
        "has_ring": has_ring,
        "ring_field_name": ring_field_name,
        "has_time": has_time,
        "time_field_name": time_field_name,
        "has_return_type": has_return_type,
        "return_type_field_name": return_type_field_name,
    }


def check_field(field: str, pointcloud_dict: dict, metadata_dict: dict) -> bool:
    """True when an attribute is present in the cloud dict or flagged in metadata.

    Parity with reference utils.py:226-229.
    """
    if pointcloud_dict.get(field, None) is not None or metadata_dict.get(
        f"has_{field}", None
    ):
        return True
    return False
