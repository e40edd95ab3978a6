"""Filter/op library: ``(ScanBuffer, params) -> ScanBuffer`` functions on tensors.

Ports of the JAX package's ops that the ported pipeline stages run. Every
filter is mask-only; compaction happens in explicit stages. Every op takes
a single scan or a batch of scans (a leading axis on every tensor). The kernel
modules (``segmean``, ``window_stats``) launch hand-written CUDA kernels
for CUDA tensors and run their plain PyTorch versions for CPU tensors.
"""
from .compact import (
    compact,
    compact_to,
    compaction_order,
    shrink_front,
    stream_compact_to,
    subsample_to,
)
from .crop import crop_box
from .dedup import duplicate_mask, remove_duplicates
from .downsample import farthest_point_downsample, random_downsample, uniform_downsample
from .finite import mask_non_finite
from .ground import remove_ground, segment_plane
from .height_ground import remove_ground_by_height
from .knn import knn_exact
from .linalg import (
    quaternion_to_matrix,
    se3_matrix,
    smallest_eigenvector_sym3x3,
    smallest_eigvec_entries,
)
from .normals import estimate_normals
from .outliers import remove_statistical_outliers
from .radius_outliers import remove_radius_outliers
from .segmean import compact_rows, masked_compact, segmented_sums
from .transform import rotate_rows, se3_transform, transform_points
from .voxel import voxel_downsample
from .window import (
    fused_neighborhood_stats,
    fused_neighborhood_stats_reordered,
    hilbert_cell_codes,
    hilbert_cell_codes_wide,
    hilbert_codes,
    morton_codes,
    window_mean_knn_dist,
    window_normal_stats,
)
from .window_stats import window_stats
