"""Parallel execution: multi-LiDAR concatenation and the pipeline sharded
along the point axis of a ``torch.distributed`` process group."""
from .concat import (
    ApproximateTimeSynchronizer,
    PointcloudConcatenatorNode,
    concatenate_buffers,
)
from .sharding import (
    buffer_pspecs,
    build_sharded_pipeline,
    make_local_run,
    make_mesh,
    shard_buffer,
    spatial_sort,
    unshard_buffer,
)
