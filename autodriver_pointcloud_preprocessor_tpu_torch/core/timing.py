"""Overridable time sources + per-stage timing dict.

A copy of ``autodriver_pointcloud_preprocessor_tpu/core/timing.py`` (the
port keeps its own; it imports nothing of the JAX package). Parity with
reference utils.py:474-500 (``get_current_time`` /
``get_time_difference`` as overridable time sources) and the
``processing_times`` stage-timing mechanism at reference
pointcloud_preprocessor.py:322 and :417-678 — same stage-key names are used
by the pipeline so benches are directly comparable (SURVEY.md §6).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional


def get_current_time(monotonic: bool = True) -> float:
    """Current time; monotonic=True returns a monotonically increasing clock.

    Designed to be overridable (e.g. by a ROS clock), matching reference
    utils.py:474-483.
    """
    if not monotonic:
        return time.time()
    return time.perf_counter()


def get_time_difference(
    start_time: float, end_time: float, return_absolute_difference: bool = False
) -> float:
    """Difference between two time points (reference utils.py:486-500)."""
    diff = end_time - start_time
    if return_absolute_difference:
        return abs(diff)
    return diff


#: Stage keys emitted by the reference's per-scan instrumentation
#: (pointcloud_preprocessor.py:417-678); kept verbatim for bench parity.
REFERENCE_STAGE_KEYS = (
    "ros_to_numpy",
    "point_clearing",
    "tensor_transfer",
    "remove_duplicate_points",
    "remove_nan_points",
    "tf_lookup",
    "transform",
    "crop",
    "voxel_downsampling",
    "remove_statistical_outliers",
    "normal_estimation",
    "ground_segmentation",
    "preprocessing_time",
    "pointcloud_msg_parsing",
    "pointcloud_pub",
    "total_callback_time",
)


class ThrottledWarner:
    """Per-key warning rate limiter (reference pointcloud_preprocessor.py
    :806-807 ``throttle_duration_sec=60`` on repeated missing-field warns).

    ``warn(key, message)`` forwards to the logger at most once per
    ``period`` seconds per key; the clock is overridable like the time
    sources above.
    """

    def __init__(
        self,
        logger,
        period: float = 60.0,
        clock: Callable[[bool], float] = get_current_time,
    ):
        self._logger = logger
        self._period = period
        self._clock = clock
        self._last: Dict[str, float] = {}

    def warn(self, key: str, message: str) -> bool:
        """Emit ``message`` unless ``key`` warned within the period.

        Returns True when the warning was actually emitted.
        """
        now = self._clock(True)
        last = self._last.get(key)
        if last is not None and now - last < self._period:
            return False
        self._last[key] = now
        self._logger.warning(message)
        return True


class StageTimer:
    """Collects per-stage wall times into a ``processing_times``-style dict."""

    def __init__(
        self,
        sink: Optional[Dict[str, float]] = None,
        clock: Callable[[bool], float] = get_current_time,
    ):
        self.times: Dict[str, float] = sink if sink is not None else {}
        self._clock = clock

    def stage(self, name: str, monotonic: bool = True) -> "_StageContext":
        return _StageContext(self, name, monotonic)

    def record(self, name: str, seconds: float) -> None:
        self.times[name] = seconds


class _StageContext:
    def __init__(self, timer: StageTimer, name: str, monotonic: bool):
        self._timer = timer
        self._name = name
        self._monotonic = monotonic
        self._start = 0.0

    def __enter__(self):
        self._start = self._timer._clock(self._monotonic)
        return self

    def __exit__(self, *exc):
        end = self._timer._clock(self._monotonic)
        self._timer.record(self._name, get_time_difference(self._start, end))
        return False
