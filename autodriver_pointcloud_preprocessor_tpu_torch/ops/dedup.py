"""Exact duplicate-coordinate removal, and the multi-key sort it needs.

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/dedup.py``: the first
occurrence (in buffer order) of each distinct live coordinate survives;
mask-only.

The reference sorts on several keys at once (``lax.sort(num_keys=...)``,
int32 signed and uint32 bit keys); ``torch.sort`` takes one. ``lexsort``
gets the same order from stable passes over int64 keys that pack two
32-bit keys each. Everything works along the last axis, so a leading batch
axis sorts each scan on its own.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.scan import ScanBuffer

__all__ = ["duplicate_mask", "lexsort", "remove_duplicates", "signed_key", "unsigned_key"]

_U32 = 0xFFFFFFFF
_SENTINEL = _U32


def signed_key(v: torch.Tensor) -> torch.Tensor:
    """int32 key -> int64 in [0, 2^32) with the same (signed) order."""
    return v.to(torch.int64) + (1 << 31)


def unsigned_key(bits: torch.Tensor) -> torch.Tensor:
    """32-bit pattern -> int64 in [0, 2^32) in unsigned order."""
    return bits.to(torch.int64) & _U32


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation (along the last axis) ordering rows by ``keys``,
    most significant first.

    Each key is int64 in [0, 2^32) (see ``signed_key``/``unsigned_key``).
    Pairs of keys pack into one int64 ``(a - 2^31) * 2^32 + b``, whose
    signed order is the pair's lexicographic order; the packed keys are
    then sorted least significant first, each pass stable.
    """
    keys = list(keys)
    packed = []
    while keys:
        if len(keys) >= 2:
            a, b = keys[-2], keys[-1]
            keys = keys[:-2]
            packed.append((a - (1 << 31)) * (1 << 32) + b)
        else:
            packed.append(keys.pop())
    order = None
    for key in packed:  # least significant first
        if order is None:
            order = torch.sort(key, dim=-1, stable=True).indices
        else:
            step = torch.sort(key.gather(-1, order), dim=-1, stable=True).indices
            order = order.gather(-1, step)
    return order


def _coordinate_keys(positions: torch.Tensor, valid: torch.Tensor):
    """Bit-exact unsigned keys per planar row (as ``unsigned_key`` int64);
    -0.0 is canonicalized to +0.0 so it dedups like ``np.unique``. Invalid
    rows get the all-ones sentinel, so they sort last and match no live
    key."""
    canon = torch.where(positions == 0, torch.zeros_like(positions), positions)
    bits = unsigned_key(canon.view(torch.int32))
    bits = torch.where(valid.unsqueeze(-2), bits, torch.full_like(bits, _SENTINEL))
    return bits[..., 0, :], bits[..., 1, :], bits[..., 2, :]


def duplicate_mask(positions: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """bool[..., capacity]: True for the first occurrence of each live
    coordinate (of its scan)."""
    kx, ky, kz = _coordinate_keys(positions, valid)
    order = lexsort((kx, ky, kz))
    sx, sy, sz = (k.gather(-1, order) for k in (kx, ky, kz))
    first = torch.ones_like(valid)
    first[..., 1:] = ~(
        (sx[..., 1:] == sx[..., :-1]) & (sy[..., 1:] == sy[..., :-1])
        & (sz[..., 1:] == sz[..., :-1])
    )
    return torch.empty_like(valid).scatter_(-1, order, first & valid.gather(-1, order))


def remove_duplicates(buf: ScanBuffer) -> ScanBuffer:
    """Mask out all but the first occurrence of duplicated coordinates."""
    return buf.with_mask(duplicate_mask(buf.positions, buf.mask))
