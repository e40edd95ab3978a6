"""Normal estimation by neighbourhood PCA.

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/normals.py``: each
live point's normal is the smallest eigenvector of the covariance of its
neighbourhood (closed form over the six entries), signed so that its
largest-magnitude component is positive; points with fewer than 3
neighbours get (0, 0, 1).

``method='exact'`` is the hybrid radius + ``max_nn`` search over exact
kNN (the oracle); ``'window'`` takes the covariance over every in-radius
candidate of the curve window (``ops/window.py``: kernel K3, or its XLA
route with ``window_backend='xla'``); ``'auto'`` picks exact at capacity
<= 8192. Buffers may carry a batch axis.
"""
from __future__ import annotations

import torch

from ..core.scan import ScanBuffer
from .knn import knn_exact
from .linalg import normals_from_entries as _normals_from_entries
from .window import window_normal_stats

__all__ = ["_normals_from_entries", "estimate_normals"]

#: capacities at or below this take the exact path under method='auto'
_AUTO_EXACT_MAX = 8192


def estimate_normals(
    buf: ScanBuffer,
    search_radius: torch.Tensor | float = 0.1,
    max_nn: int = 30,
    method: str = "auto",
    window_blocks: int | tuple = 2,
    passes: int = 2,
    window_backend: str = "auto",
) -> ScanBuffer:
    """Attach float32[..., 3, capacity] unit normals as attribute
    ``normals``."""
    if method == "auto":
        method = "exact" if buf.capacity <= _AUTO_EXACT_MAX else "window"
    if method == "exact":
        r = torch.as_tensor(search_radius, dtype=torch.float32, device=buf.device)
        sq, idx = knn_exact(buf.positions, buf.mask, k=max_nn)
        w = ((sq <= r * r) & torch.isfinite(sq)).to(torch.float32)  # [..., N, k]
        flat = idx.flatten(-2)
        nbr = [c.gather(-1, flat).reshape(idx.shape) for c in (buf.x, buf.y, buf.z)]
        count = w.sum(-1)
        denom = torch.clamp(count, min=1.0)
        ctr = [(w * c).sum(-1) / denom for c in nbr]
        e = [c - m.unsqueeze(-1) for c, m in zip(nbr, ctr)]
        entries = [
            (e[i] * w * e[j]).sum(-1)
            for i, j in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
        ]
    elif method == "window":
        ent, count = window_normal_stats(
            buf.positions, buf.mask, search_radius, window_blocks=window_blocks, passes=passes,
            backend=window_backend,
        )
        entries = ent.unbind(-2)
    else:
        raise ValueError(f"unknown kNN method {method!r}")
    attrs = dict(buf.attributes)
    attrs["normals"] = _normals_from_entries(*entries, count)
    return buf.replace(attributes=attrs)
