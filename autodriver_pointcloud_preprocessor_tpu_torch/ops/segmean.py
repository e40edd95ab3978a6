"""K1 masked compaction and K2 segmented sums: CUDA kernels and plain versions.

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/pallas_segmean.py``
(``masked_compact_pallas`` and ``segmented_sums_pallas``, one TPU kernel
in two modes). The CUDA kernels are in ``csrc/segmean.cu``; each function
here launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors. There is no other path: a tensor on another
device raises. Both take an optional leading batch axis (the reference's
``custom_vmap`` rule), launched as one kernel for the batch.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = [
    "masked_compact", "masked_compact_plain",
    "run_ids", "segmented_sums", "segmented_sums_plain",
]

_MAX_CHANNELS = 8
_TILE = 1024  # columns per scan tile (csrc/scan.cuh kScanTile)


def _check_rows(name: str, values: torch.Tensor, flags: torch.Tensor, dtypes):
    """Validate [C, N] / [B, C, N] values with [N] / [B, N] flags; returns
    (batch, C, N)."""
    if values.dim() not in (2, 3) or not 1 <= values.shape[-2] <= _MAX_CHANNELS:
        raise ValueError(
            f"{name}: values must be [C<=8, N] or [B, C<=8, N], got {tuple(values.shape)}"
        )
    if values.dtype not in dtypes:
        raise ValueError(f"{name}: values dtype {values.dtype} not in {dtypes}")
    vshape, fshape = values.shape, flags.shape
    if flags.dtype != torch.bool or len(fshape) != len(vshape) - 1 or fshape[-1] != vshape[-1] or (
        len(vshape) == 3 and fshape[0] != vshape[0]
    ):
        raise ValueError(f"{name}: flags must be bool{list(vshape[:-2] + vshape[-1:])}")
    if values.device != flags.device:
        raise ValueError(f"{name}: values and flags on different devices")
    return (vshape[0] if len(vshape) == 3 else 1), vshape[-2], vshape[-1]


def masked_compact_plain(
    values: torch.Tensor, mask: torch.Tensor, capacity: int
) -> torch.Tensor:
    """Plain version of K1 (same contract as ``masked_compact``)."""
    c, n = values.shape[-2:]
    vals = values.reshape(-1, c, n)
    live = mask.reshape(-1, n)
    rank = torch.cumsum(live, -1) - 1
    b, col = torch.nonzero(live & (rank < capacity), as_tuple=True)
    out = torch.zeros((vals.shape[0], c, capacity), dtype=values.dtype, device=values.device)
    out[b, :, rank[b, col]] = vals[b, :, col]
    return out.reshape(values.shape[:-1] + (capacity,))


def masked_compact(
    values: torch.Tensor, mask: torch.Tensor, capacity: Optional[int] = None
) -> torch.Tensor:
    """Stable stream compaction of channel rows by a live mask.

    ``out[..., :, r]`` holds the columns of the r-th live column (in
    column order) for r < min(live count, capacity); the columns after the
    last live one are zero. Values are copied bit for bit, so dead columns
    may hold anything (NaN included) and int32 rows pass unchanged. With a
    batch axis every scan compacts on its own (one launch for the batch).

    Args:
        values: float32 or int32 [C<=8, N] or [B, C<=8, N].
        mask: bool[N] or [B, N] live flags.
        capacity: output columns (default N); live columns past it drop.
    Returns:
        [..., C, capacity] of ``values``' dtype.
    """
    batch, c, n = _check_rows("masked_compact", values, mask, (torch.float32, torch.int32))
    capacity = n if capacity is None else int(capacity)
    if not 0 < capacity <= n:
        raise ValueError(f"masked_compact: capacity {capacity} not in (0, {n}]")
    if values.device.type == "cpu":
        return masked_compact_plain(values, mask, capacity)
    _build.require_cuda("masked_compact", values, mask)
    lib = _build.load_library()
    dev = values.device
    out = torch.zeros(values.shape[:-1] + (capacity,), dtype=values.dtype, device=dev)
    tiles = -(-n // _TILE)
    scratch = torch.empty(batch * (2 * tiles + 1), dtype=torch.int32, device=dev)
    err = lib.apc_masked_compact(
        values.data_ptr(), mask.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        batch, c, n, capacity, _build.stream_handle(dev),
    )
    _build.check(err, "masked_compact")
    _build.LAUNCHES["masked_compact"] += 1
    return out


def run_ids(run_start: torch.Tensor) -> torch.Tensor:
    """Run index of every column (int64, same shape): column 0 of each scan
    opens its run 0 whatever its flag."""
    flags = run_start.clone()
    flags[..., 0] = False
    return torch.cumsum(flags, -1)


def segmented_sums_plain(values: torch.Tensor, run_start: torch.Tensor) -> torch.Tensor:
    """Plain version of K2 (same contract as ``segmented_sums``).

    On the CPU ``index_add_`` adds in column order, as the kernel does;
    each scan's runs go to its own columns.
    """
    c, n = values.shape[-2:]
    ids = run_ids(run_start).reshape(-1, n)
    batch = ids.shape[0]
    ids = ids + torch.arange(batch, device=ids.device)[:, None] * n
    flat = values.reshape(batch, c, n).transpose(0, 1).reshape(c, batch * n)
    out = torch.zeros_like(flat).index_add_(1, ids.reshape(-1), flat)
    return out.reshape(c, batch, n).transpose(0, 1).reshape(values.shape)


def segmented_sums(values: torch.Tensor, run_start: torch.Tensor) -> torch.Tensor:
    """Per-run sums of ``values`` over contiguous runs.

    Args:
        values: float32[C<=8, N] or [B, C<=8, N] channel rows.
        run_start: bool[N] or [B, N]; True where a new run begins (each
            scan's column 0 always opens its run 0, whatever its flag).
    Returns:
        float32[..., C, N]: column s of a scan holds the sum of its run s,
        each summed in column order; columns past its last run are zero.
    """
    batch, c, n = _check_rows("segmented_sums", values, run_start, (torch.float32,))
    if n == 0:
        return values.clone()
    if not values.is_cuda:
        if values.device.type == "cpu":
            return segmented_sums_plain(values, run_start)
        raise ValueError("segmented_sums: tensors must be on the CPU or one CUDA device")
    if not (values.is_contiguous() and run_start.is_contiguous()):
        raise ValueError("segmented_sums: tensors must be contiguous")
    lib = _build.load_library()
    out = torch.empty_like(values)  # the kernel writes every column
    err = lib.apc_segmented_sums(
        values.data_ptr(), run_start.data_ptr(), out.data_ptr(),
        batch, c, n, _build.stream_handle(values.device),
    )
    _build.check(err, "segmented_sums")
    _build.LAUNCHES["segmented_sums"] += 1
    return out
