"""K1 masked compaction and K2 segmented sums: CUDA kernels and plain versions.

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/pallas_segmean.py``
(``masked_compact_pallas`` and ``segmented_sums_pallas``, one TPU kernel
in two modes). The CUDA kernels are in ``csrc/segmean.cu``; each function
here launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors. There is no other path: a tensor on another
device raises. Both take an optional leading batch axis (the reference's
``custom_vmap`` rule), launched as one kernel for the batch. K1 takes a
table of row pointers, so ``compact_rows`` compacts the rows of several
tensors (a scan buffer's positions and attributes) in one launch, and
writes the output mask in the same launch.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build

__all__ = [
    "compact_rows", "compact_rows_plain", "masked_compact", "masked_compact_plain",
    "run_ids", "segmented_sums", "segmented_sums_plain",
]

_MAX_CHANNELS = 8
_MAX_ROWS = 16  # rows of one K1 launch (csrc/segmean.cu kMaxRows)
_K1_DTYPES = (torch.float32, torch.int32)


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


def compact_rows_plain(
    sources: Sequence[torch.Tensor], mask: torch.Tensor, capacity: int
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain version of K1's row-table entry (same contract as
    ``compact_rows``)."""
    n = mask.shape[-1]
    live = mask.reshape(-1, n)
    rank = torch.cumsum(live, -1) - 1
    b, col = torch.nonzero(live & (rank < capacity), as_tuple=True)
    dst = rank[b, col]
    outs = []
    for src in sources:
        vals = src.reshape(live.shape[0], -1, n)
        out = torch.zeros(vals.shape[:-1] + (capacity,), dtype=src.dtype, device=src.device)
        out[b, :, dst] = vals[b, :, col]
        outs.append(out.reshape(src.shape[:-1] + (capacity,)))
    count = live.sum(-1, keepdim=True)
    mask_out = torch.arange(capacity, device=mask.device) < count
    return outs, mask_out.reshape(mask.shape[:-1] + (capacity,))


def masked_compact_plain(
    values: torch.Tensor, mask: torch.Tensor, capacity: int
) -> torch.Tensor:
    """Plain version of K1 (same contract as ``masked_compact``)."""
    return compact_rows_plain([values], mask, capacity)[0][0]


def _launch_k1(entries: List[int], mask: torch.Tensor, mask_out: Optional[torch.Tensor],
               batch: int, n: int, capacity: int) -> None:
    """Launch K1 over the row table ``entries`` (4 ints a row: source row
    pointer, its stride between scans in words, output row pointer, its
    stride), 16 rows a launch; the first launch writes ``mask_out``."""
    out_ptr = 0 if mask_out is None else mask_out.data_ptr()
    for start in range(0, len(entries), 4 * _MAX_ROWS):
        chunk = entries[start : start + 4 * _MAX_ROWS]
        rows = len(chunk) // 4
        _build.launch(
            "masked_compact", mask.device, struct.pack(f"{4 * rows}q", *chunk), rows,
            mask.data_ptr(), out_ptr if start == 0 else 0, batch, n, capacity,
        )


def _table_entries(src: torch.Tensor, out: torch.Tensor, batch: int, n: int,
                   capacity: int) -> List[int]:
    """Row-table entries of the contiguous rows of ``src`` [..., N] and of
    ``out`` [..., capacity] (4-byte words)."""
    rows = src.numel() // (batch * n)
    sp, dp = src.data_ptr(), out.data_ptr()
    src_stride, dst_stride = rows * n, rows * capacity
    entries = []
    for r in range(rows):
        entries += (sp + 4 * n * r, src_stride, dp + 4 * capacity * r, dst_stride)
    return entries


def compact_rows(
    sources: Sequence[torch.Tensor], mask: torch.Tensor, capacity: int
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Stable stream compaction of several tensors' rows by one live mask.

    Every row of every source rides one K1 launch (up to 16 rows a launch)
    as 32-bit words, straight from the source tensors into the outputs: no
    stacked copy. Row ``r`` of an output holds the r-th live column of its
    source row for r < min(live count, capacity), zeros after. With a batch
    axis every scan compacts on its own.

    Args:
        sources: float32 or int32 tensors ``lead + rows + (N,)``, ``lead``
            the mask's leading shape (``()`` or ``(B,)``) and ``rows`` any
            shape; contiguous on a CUDA device (a non-contiguous source
            raises).
        mask: bool ``lead + (N,)`` live flags.
        capacity: output columns, in (0, N].
    Returns:
        (outputs ``lead + rows + (capacity,)`` of each source's dtype,
        bool ``lead + (capacity,)`` output mask: r < min(live, capacity)).
    """
    lead, n = mask.shape[:-1], mask.shape[-1]
    if mask.dtype != torch.bool or len(lead) > 1:
        raise ValueError(f"compact_rows: mask must be bool[N] or [B, N], got {tuple(mask.shape)}")
    if not sources:
        raise ValueError("compact_rows: no source tensors")
    if not 0 < capacity <= n:
        raise ValueError(f"compact_rows: capacity {capacity} not in (0, {n}]")
    for src in sources:
        if src.dtype not in _K1_DTYPES:
            raise ValueError(f"compact_rows: dtype {src.dtype} not in {_K1_DTYPES}")
        if src.shape[: len(lead)] != lead or src.shape[-1] != n or src.dim() <= len(lead):
            raise ValueError(
                f"compact_rows: source {tuple(src.shape)} does not match the mask {tuple(mask.shape)}"
            )
    if mask.device.type == "cpu":
        if any(src.device != mask.device for src in sources):
            raise ValueError("compact_rows: sources and mask on different devices")
        return compact_rows_plain(sources, mask, capacity)
    _build.require_cuda("compact_rows", mask, *sources)
    batch = mask.numel() // n
    outs, entries = [], []
    for src in sources:
        out = torch.empty(src.shape[:-1] + (capacity,), dtype=src.dtype, device=src.device)
        entries += _table_entries(src, out, batch, n, capacity)
        outs.append(out)
    mask_out = torch.empty(lead + (capacity,), dtype=torch.bool, device=mask.device)
    _launch_k1(entries, mask, mask_out, batch, n, capacity)
    return outs, mask_out


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
    batch, c, n = _check_rows("masked_compact", values, mask, _K1_DTYPES)
    capacity = n if capacity is None else int(capacity)
    if not 0 < capacity <= n:
        raise ValueError(f"masked_compact: capacity {capacity} not in (0, {n}]")
    if values.device.type == "cpu":
        return masked_compact_plain(values, mask, capacity)
    _build.require_cuda("masked_compact", values, mask)
    out = torch.empty(values.shape[:-1] + (capacity,), dtype=values.dtype, device=values.device)
    _launch_k1(_table_entries(values, out, batch, n, capacity), mask, None, batch, n, capacity)
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
    return _launch_k2(values, run_start, batch, c, n)


def _launch_k2(values: torch.Tensor, run_start: torch.Tensor, batch: int, c: int,
               n: int) -> torch.Tensor:
    """Launch K2 on contiguous device tensors; returns the sums."""
    out = torch.empty_like(values)  # the kernel writes every column
    _build.launch("segmented_sums", values.device, values.data_ptr(), run_start.data_ptr(),
                  out.data_ptr(), batch, c, n)
    return out
