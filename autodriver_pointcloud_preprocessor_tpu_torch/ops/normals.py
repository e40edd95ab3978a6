"""Normals from covariance entries.

Port of ``_normals_from_entries`` in
``autodriver_pointcloud_preprocessor_tpu/ops/normals.py``: the smallest
eigenvector of each point's neighbourhood covariance, signed so that its
largest-magnitude component is positive; points with fewer than 3
neighbours get (0, 0, 1). ``estimate_normals`` is not ported yet (ROADMAP
item 8).
"""
from __future__ import annotations

import torch

from .linalg import smallest_eigvec_entries

__all__ = ["_normals_from_entries"]


def _normals_from_entries(a00, a11, a22, a01, a02, a12, count) -> torch.Tensor:
    """float32[..., 3, N] unit normals from the six covariance entries
    (each [..., N])."""
    nx, ny, nz = smallest_eigvec_entries(a00, a11, a22, a01, a02, a12)
    ax, ay, az = torch.abs(nx), torch.abs(ny), torch.abs(nz)
    lead = torch.where((ax >= ay) & (ax >= az), nx, torch.where(ay >= az, ny, nz))
    flip = torch.where(lead < 0, -1.0, 1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip
    ok = count >= 3
    zero = torch.zeros_like(nx)
    return torch.stack([
        torch.where(ok, nx, zero),
        torch.where(ok, ny, zero),
        torch.where(ok, nz, torch.ones_like(nz)),
    ], dim=-2)
