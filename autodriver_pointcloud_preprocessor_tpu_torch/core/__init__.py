"""Core types: the torch ScanBuffer, its host-side conversions, and the
stage timers."""
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
from .timing import StageTimer, ThrottledWarner, get_current_time, get_time_difference
