"""SE(3) point-cloud transforms.

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/transform.py``
(Open3D's ``PointCloud.transform(4x4)`` in the original node). The
rotation is written out as nine scalar-times-row products over the planar
(3, N) rows, in the reference's order of operations, so both packages
round alike. Normals (when present) are rotated without translation, as
Open3D does. Rows may carry a leading batch axis; one matrix serves every
scan.
"""
from __future__ import annotations

import torch

from ..core.scan import ScanBuffer

__all__ = ["rotate_rows", "se3_transform", "transform_points"]


def _apply(rows: torch.Tensor, matrix: torch.Tensor, translate: bool) -> torch.Tensor:
    x, y, z = rows[..., 0, :], rows[..., 1, :], rows[..., 2, :]
    m = torch.as_tensor(matrix, device=rows.device).to(rows.dtype)
    out = []
    for i in range(3):
        r = m[i, 0] * x + m[i, 1] * y + m[i, 2] * z
        out.append(r + m[i, 3] if translate else r)
    return torch.stack(out, dim=-2)


def rotate_rows(rows: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Rotate planar [..., 3, N] rows by the 3x3 part of ``matrix`` (no
    translation)."""
    return _apply(rows, matrix, translate=False)


def transform_points(points: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Apply a homogeneous 4x4 to planar float32[..., 3, N] points."""
    return _apply(points, matrix, translate=True)


def se3_transform(buf: ScanBuffer, matrix: torch.Tensor) -> ScanBuffer:
    """Transform a ScanBuffer into the frame given by ``matrix``.

    Padded (masked-out) rows are transformed too, as in the reference.
    """
    attrs = dict(buf.attributes)
    if "normals" in attrs:
        attrs["normals"] = rotate_rows(attrs["normals"], matrix)
    return buf.replace(positions=transform_points(buf.positions, matrix), attributes=attrs)
