"""Parallel execution: multi-LiDAR concatenation.

The reference's SPMD sharding (``parallel/sharding.py``) is ROADMAP item
13, not ported yet.
"""
from .concat import (
    ApproximateTimeSynchronizer,
    PointcloudConcatenatorNode,
    concatenate_buffers,
)
