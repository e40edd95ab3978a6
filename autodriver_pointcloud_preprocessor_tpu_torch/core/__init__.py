"""Core types: the torch ScanBuffer, its host-side conversions, field
schemas, message containers and codecs, and the stage timers."""
from .fields import (
    FIELD_DTYPE_MAP,
    FIELD_DTYPE_MAP_INV,
    VENDOR_MAPPINGS,
    PointFieldType,
    check_field,
    get_pointcloud_metadata,
    resolve_field_alias,
)
from .msg import (
    CompressedPointCloud2,
    Header,
    PointCloud2,
    PointField,
    Time,
    TransformStamped,
    make_pointcloud2,
    structured_dtype_from_fields,
)
from .codec import (
    build_pointfields,
    create_cloud,
    extract_rgb_from_packed,
    intensity_to_rgb,
    merge_rgb_fields,
    pack_rgb_float,
    pointcloud_to_dict,
    read_points,
    rgb_to_intensity,
    soa_to_structured,
    structured_to_soa,
)
from .scan import (
    ATTR_DEVICE_DTYPES,
    ATTR_HOST_DTYPES,
    ScanBuffer,
    bucket_capacity,
    from_soa,
    pad_to_capacity,
    resolve_device,
    stack_buffers,
    to_soa,
    unstack_buffer,
    valid_count,
)
from .timing import (
    REFERENCE_STAGE_KEYS,
    StageTimer,
    ThrottledWarner,
    get_current_time,
    get_time_difference,
)
