"""Radius outlier removal.

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/radius_outliers.py``
(Open3D's ``remove_radius_outliers``): points with fewer than
``nb_points`` neighbours (self included) within ``search_radius`` are
masked out. ``method='exact'`` counts among the ``exact_k`` nearest of
exact kNN, ``'window'`` takes the in-radius count of the curve window
(``window_normal_stats``: kernel K3, or its XLA route with
``window_backend='xla'``), ``'auto'`` picks exact at capacity <= 8192. Buffers may carry a batch axis.
"""
from __future__ import annotations

import torch

from ..core.scan import ScanBuffer
from .knn import knn_exact
from .window import window_normal_stats

__all__ = ["remove_radius_outliers"]

#: capacities at or below this take the exact path under method='auto'
_AUTO_EXACT_MAX = 8192


def remove_radius_outliers(
    buf: ScanBuffer,
    nb_points: torch.Tensor | int = 16,
    search_radius: torch.Tensor | float = 0.05,
    method: str = "auto",
    exact_k: int = 64,
    window_blocks: int | tuple = 2,
    passes: int = 2,
    window_backend: str = "auto",
) -> ScanBuffer:
    """Mask out points with fewer than ``nb_points`` in-radius neighbours.

    The exact path is exact whenever ``nb_points <= exact_k``; as in the
    reference, it compares its integer count with ``nb_points`` cast to an
    integer, the window path its float count with ``nb_points`` as given.
    """
    if method == "auto":
        method = "exact" if buf.capacity <= _AUTO_EXACT_MAX else "window"
    if method == "exact":
        r = torch.as_tensor(search_radius, dtype=torch.float32, device=buf.device)
        sq, _ = knn_exact(buf.positions, buf.mask, k=min(exact_k, buf.capacity))
        count = ((sq <= r * r) & torch.isfinite(sq)).sum(-1)
    elif method == "window":
        _entries, count = window_normal_stats(
            buf.positions, buf.mask, search_radius, window_blocks=window_blocks, passes=passes,
            backend=window_backend,
        )
    else:
        raise ValueError(f"unknown kNN method {method!r}")
    need = torch.as_tensor(nb_points, device=buf.device).to(count.dtype)
    return buf.with_mask(count >= need)
