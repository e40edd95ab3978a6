"""Mask compaction: move live points to the front of a (smaller) buffer.

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/compact.py``
(``compact``, ``compact_to``, ``shrink_front``, ``stream_compact_to``,
``subsample_to``). All but the last keep the order of surviving points; ``subsample_to`` keeps
an unbiased hash-priority subset. Buffers may carry a batch axis; each scan
compacts on its own.
"""
from __future__ import annotations

import torch

from ..core.scan import ScanBuffer
from .segmean import compact_rows

__all__ = [
    "compact", "compact_to", "compaction_order", "gather_columns", "shrink_front", "stream_compact_to",
    "subsample_to",
]

#: the reference's ``backend`` values (``ops/window.py default_backend``)
BACKENDS = ("auto", "pallas", "pallas_interpret", "xla")


def check_backend(backend: str) -> str:
    """``backend`` if it is one of the reference's values, else raise."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    return backend


def compaction_order(mask: torch.Tensor) -> torch.Tensor:
    """Stable permutation (along the last axis) putting True rows first."""
    return torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)


def gather_columns(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` per scan: ``idx`` [..., M] (one row of column indices
    per scan, the mask's leading shape) applied to x [..., N] or
    [..., C, N]."""
    if x.dim() > idx.dim():
        idx = idx.unsqueeze(-2).expand(x.shape[:-1] + idx.shape[-1:])
    return torch.gather(x, -1, idx)


def compact_to(buf: ScanBuffer, capacity: int) -> ScanBuffer:
    """Compact into a smaller capacity by a stable argsort and gathers.

    Live points beyond ``capacity`` are dropped; the slots past the live
    count hold dead rows' values (mask False).
    """
    if capacity > buf.capacity:
        raise ValueError(
            f"compact_to grows capacity {buf.capacity} -> {capacity}; use pad_to_capacity"
        )
    idx = compaction_order(buf.mask)[..., :capacity]
    n = buf.mask.sum(-1, keepdim=True)
    return ScanBuffer(
        positions=gather_columns(buf.positions, idx),
        mask=torch.arange(capacity, device=buf.device) < n,
        attributes={k: gather_columns(v, idx) for k, v in buf.attributes.items()},
    )


def compact(buf: ScanBuffer) -> ScanBuffer:
    """Move every live point to the front, in order (same capacity)."""
    return compact_to(buf, buf.capacity)


def shrink_front(buf: ScanBuffer, capacity: int) -> ScanBuffer:
    """Prefix slice into a smaller capacity (live points must form a
    prefix, as after ``voxel_downsample``). Live points past ``capacity``
    are dropped."""
    if capacity > buf.capacity:
        raise ValueError(f"shrink_front grows capacity {buf.capacity} -> {capacity}")
    return ScanBuffer(
        positions=buf.positions[..., :capacity],
        mask=buf.mask[..., :capacity],
        attributes={k: v[..., :capacity] for k, v in buf.attributes.items()},
    )


def subsample_to(buf: ScanBuffer, capacity: int) -> ScanBuffer:
    """Cap to ``capacity`` keeping an unbiased subset of live points.

    Each slot gets a fixed pseudo-random priority, the multiplicative hash
    ``(slot * -1640531527) & 0x7FFFFFFF`` of its index (the reference's
    int32 wraparound product, computed in int64 and masked), invalid slots
    ``0x7FFFFFFF``; the ``capacity`` best priorities survive, live points
    first, in hash order. Valid slots' priorities are distinct below 2**31
    slots, so the live prefix equals the reference's; the sort here is
    stable where the reference's is not, which fixes the order of the
    invalid tail.
    """
    if capacity > buf.capacity:
        raise ValueError(f"subsample_to grows capacity {buf.capacity} -> {capacity}")
    slot = torch.arange(buf.capacity, dtype=torch.int64, device=buf.device)
    pri = torch.where(buf.mask, (slot * -1640531527) & 0x7FFFFFFF, 0x7FFFFFFF)
    idx = torch.sort(pri, dim=-1, stable=True).indices[..., :capacity]
    return ScanBuffer(
        positions=gather_columns(buf.positions, idx),
        mask=buf.mask.gather(-1, idx),
        attributes={k: gather_columns(v, idx) for k, v in buf.attributes.items()},
    )


def stream_compact_to(buf: ScanBuffer, capacity: int, backend: str = "auto") -> ScanBuffer:
    """Compact live points to the front of a smaller buffer with K1.

    Every row (positions and each attribute row, float32 or int32) rides
    one K1 launch as 32-bit words, read from the buffer's own tensors and
    written into the new ones (a batch shares the launch), so values come
    through bit for bit; the same launch writes the new mask. Live points
    with rank >= ``capacity`` are dropped (capped-output semantics); dead
    output slots hold zeros. Other dtypes raise; on a card every tensor
    must be contiguous.

    Every ``backend`` of the reference takes K1: its ``"xla"`` route
    (``compact_to``) gives the same survivors in the same order.
    """
    check_backend(backend)
    if capacity > buf.capacity:
        raise ValueError(
            f"stream_compact_to grows capacity {buf.capacity} -> {capacity}"
        )
    names = sorted(buf.attributes)
    outs, mask = compact_rows(
        [buf.positions, *(buf.attributes[name] for name in names)], buf.mask, capacity
    )
    return ScanBuffer(positions=outs[0], mask=mask, attributes=dict(zip(names, outs[1:])))
