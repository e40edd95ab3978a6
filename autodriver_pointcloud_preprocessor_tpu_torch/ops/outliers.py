"""Statistical outlier removal.

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/outliers.py``: per
point, the mean distance to its ``nb_neighbors`` nearest neighbours (self
included); points whose mean exceeds ``mean + std_ratio * std`` of the
scan's live means are masked out. The threshold is taken per scan, so a
batch (leading axis) filters each scan on its own.

``method='exact'`` uses exact kNN (the oracle), ``'window'`` the curve
window (``ops/window.py``: kernel K3, or its XLA route with
``window_backend='xla'``), ``'auto'`` picks exact at capacity <= 8192.
"""
from __future__ import annotations

import torch

from ..core.scan import ScanBuffer
from .knn import knn_exact
from .window import window_mean_knn_dist

__all__ = ["outlier_keep", "remove_statistical_outliers"]

#: capacities at or below this take the exact path under method='auto'
_AUTO_EXACT_MAX = 8192


def outlier_keep(mean_d: torch.Tensor, valid: torch.Tensor, std_ratio) -> torch.Tensor:
    """``mean_d <= mu + std_ratio * std`` with the mean and (population)
    standard deviation of each scan's live ``mean_d`` (last axis)."""
    zero = torch.zeros((), dtype=mean_d.dtype, device=mean_d.device)
    n_live = torch.clamp(valid.sum(-1, keepdim=True), min=1)
    mu = torch.where(valid, mean_d, zero).sum(-1, keepdim=True) / n_live
    var = torch.where(valid, (mean_d - mu) ** 2, zero).sum(-1, keepdim=True) / n_live
    return mean_d <= mu + std_ratio * torch.sqrt(var)


def remove_statistical_outliers(
    buf: ScanBuffer,
    nb_neighbors: int = 20,
    std_ratio: torch.Tensor | float = 2.0,
    method: str = "auto",
    window_blocks: int | tuple = 2,
    passes: int = 2,
    kmode: str = "sweep",
    window_backend: str = "auto",
) -> ScanBuffer:
    """Mask out points with an anomalously large mean kNN distance."""
    if method == "auto":
        method = "exact" if buf.capacity <= _AUTO_EXACT_MAX else "window"
    if method == "exact":
        sq, _ = knn_exact(buf.positions, buf.mask, k=nb_neighbors)
        d = torch.sqrt(sq)
        # neighbours that do not exist (fewer than k live points) are +inf
        finite = torch.isfinite(d)
        d = torch.where(finite, d, torch.zeros((), dtype=d.dtype, device=d.device))
        mean_d = d.sum(-1) / torch.clamp(finite.sum(-1), min=1)
    elif method == "window":
        mean_d = window_mean_knn_dist(
            buf.positions, buf.mask, k=nb_neighbors, window_blocks=window_blocks,
            passes=passes, kmode=kmode, backend=window_backend,
        )
    else:
        raise ValueError(f"unknown kNN method {method!r}")
    return buf.with_mask(outlier_keep(mean_d, buf.mask, std_ratio))
