"""Exact k-nearest neighbours over padded planar point buffers.

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/knn.py``
(``knn_exact``): tiled brute force over the whole buffer, the oracle and
the small-capacity path of the standalone filters (``method='exact'``,
and ``'auto'`` at capacity <= 8192). The reference computes it in plain
XLA with no Pallas kernel, so it is plain PyTorch here: one ``[tile, N]``
distance block and ``torch.topk`` per query tile.

Deliberate deviation: the reference forms ``|q|^2 + |c|^2 - 2 q.c``,
which cancels to about one ulp of ``|p|^2`` (2e-4 m^2 at 40 m from the
origin); here the squared distance is the sum of squared coordinate
differences, exact to a few ulps of the distance itself.

Buffers may carry a leading batch axis (positions [B, 3, N], mask
[B, N]); each scan's neighbours come from its own points.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["knn_exact"]


def knn_exact(
    positions: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    query_tile: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN among live points (self included).

    Args:
        positions: float32[..., 3, N] planar padded points.
        mask: bool[..., N]; False rows are excluded as neighbours.
        k: neighbour count (at most N).
        query_tile: query rows per step; bounds the [..., tile, N]
            distance block (at 131072 rows and tile 512, 256 MiB).
    Returns:
        (sq_dists float32[..., N, k] ascending, indices int64[..., N, k]).
        Rows of masked-out queries are meaningless; when fewer than k live
        neighbours exist the trailing entries are +inf.
    """
    n = positions.shape[-1]
    k = min(k, n)
    pts = positions.to(torch.float32)
    dead = ~mask.unsqueeze(-2)
    dists, idx = [], []
    for s in range(0, n, query_tile):
        q = pts[..., :, s : s + query_tile]  # [..., 3, T]
        # in place on the [..., T, N] block: the roundings of
        # dx*dx + dy*dy + dz*dz with no temporary beyond the block
        d2 = None
        for c in range(3):
            diff = q[..., c, :, None] - pts[..., c, None, :]
            diff.mul_(diff)
            d2 = diff if d2 is None else d2.add_(diff)
        d2.masked_fill_(dead, float("inf"))
        top = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
        dists.append(top.values)
        idx.append(top.indices)
    return torch.cat(dists, dim=-2), torch.cat(idx, dim=-2)
