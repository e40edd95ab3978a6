"""Ground removal against a fixed plane (no RANSAC).

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/height_ground.py``:
points within ``distance_threshold`` of a known plane (or below it, with
``signed``) are masked out, in one elementwise pass. Buffers may carry a
batch axis; the plane is one [4] for every scan or [B, 4].
"""
from __future__ import annotations

import torch

from ..core.scan import ScanBuffer

__all__ = ["remove_ground_by_height"]


def remove_ground_by_height(
    buf: ScanBuffer,
    plane: torch.Tensor,
    distance_threshold: torch.Tensor | float = 0.2,
    signed: bool = False,
) -> ScanBuffer:
    """Mask out points near (or below, when ``signed``) a fixed plane.

    Args:
        plane: float32[4] (or [..., 4] per scan) = [a, b, c, d] with
            a*x + b*y + c*z + d = 0.
        distance_threshold: removal band.
        signed: False removes |dist| <= threshold (a slab around the
            plane); True removes dist <= threshold (everything below it,
            along the normal).
    """
    plane = torch.as_tensor(plane, dtype=torch.float32, device=buf.device)
    a, b, c, d = (plane[..., i, None] for i in range(4))
    norm = torch.sqrt(torch.clamp(a * a + b * b + c * c, min=1e-12))
    dist = (buf.x * a + buf.y * b + buf.z * c + d) / norm
    thresh = torch.as_tensor(distance_threshold, dtype=torch.float32, device=buf.device)
    keep = dist > thresh if signed else torch.abs(dist) > thresh
    return buf.with_mask(keep)
