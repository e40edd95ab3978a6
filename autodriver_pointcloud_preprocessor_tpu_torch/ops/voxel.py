"""Voxel-grid downsampling: quantize, sort by voxel key, segment means (K2).

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/voxel.py``. One
output point per occupied voxel at the mean of its live points; float
attributes are averaged, narrow integer attributes (ring, return_type)
take the segment's first row's value. Survivors are compacted to the
front of the same-capacity buffer, in voxel-key order (x-major), or in
Hilbert-curve order of the voxel cells with ``curve_order``.

``dedup_exact`` excludes exact duplicate coordinates from the segment
statistics (bit-exact coordinate keys ride as secondary sort keys), which
equals ``remove_duplicates`` followed by the voxel stage.
``compact_keys`` drops the voxel-index keys: the Hilbert key alone
identifies the voxel, which holds while the live points span at most 1008
cells per axis (``'box'``, one 30-bit key) or 2**20 - 64 cells (``'wide'``,
a 60-bit key as an (hi, lo) int32 pair, two 32-bit keys of the int64
sort passes), the caller's promise. The sort is stable, so among
exact duplicates the first copy in buffer order donates the attributes:
the reference's ``first_attrs=True``. Its ``first_attrs=False`` lets any
copy donate, so this is one of its allowed outcomes too; the keyword is
taken, and neither it nor the setting (``voxel_first_attrs``) changes
anything here. Integer attributes wider
than 16 bits on the host (not exact in float32) take the value of the
segment's first row by a gather: the row's index rides K2 as one more
channel.

A batched buffer sorts and reduces each scan on its own: the sorts run
along the last axis and K2 takes the batch in one launch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.scan import ATTR_HOST_DTYPES, ScanBuffer
from .dedup import _coordinate_keys, lexsort, signed_key
from .segmean import segmented_sums
from .compact import check_backend, gather_columns
from .window import _SENTINEL, hilbert_cell_codes, hilbert_cell_codes_wide

__all__ = ["sorted_voxel_channels", "voxel_downsample"]

_MAX_CHANNELS = 8  # rows per K2 launch
_BIG = 1 << 30  # voxel index of invalid rows


def voxel_downsample(
    buf: ScanBuffer,
    voxel_size: torch.Tensor | float,
    dedup_exact: bool = False,
    curve_order: bool = False,
    compact_keys: bool | str = False,
    backend: str = "auto",
    first_attrs: bool = True,
) -> ScanBuffer:
    """Average live points within each cubic voxel of edge ``voxel_size``.

    Every ``backend`` of the reference takes K2: its ``"xla"`` route
    (``segment_sum``) gives the same voxel means up to the float32
    summation order, so the kernel computes that function too.
    ``first_attrs``: see the module docstring.
    """
    check_backend(backend)
    channels, run_start, mean_rows, first_rows, gathered = sorted_voxel_channels(
        buf, voxel_size, dedup_exact, curve_order, compact_keys
    )
    sums = torch.cat([
        segmented_sums(channels[..., s : s + _MAX_CHANNELS, :].contiguous(), run_start)
        for s in range(0, channels.shape[-2], _MAX_CHANNELS)
    ], dim=-2)
    counts = sums[..., 0, :]
    denom = torch.clamp(counts, min=1.0).unsqueeze(-2)
    attrs = {}
    ch = 4
    for name, nrows in mean_rows:
        orig = buf.attributes[name]
        rows = sums[..., ch : ch + nrows, :] / denom
        attrs[name] = rows.reshape(orig.shape).to(orig.dtype)
        ch += nrows
    for name, nrows in first_rows:
        orig = buf.attributes[name]
        rows = torch.round(sums[..., ch : ch + nrows, :])
        attrs[name] = rows.reshape(orig.shape).to(orig.dtype)
        ch += nrows
    if gathered:
        # the first row's input index (exact in float32 below 2**24 slots)
        first_idx = torch.clamp((sums[..., ch, :] + 0.5).to(torch.int64), 0, buf.capacity - 1)
        for name in gathered:
            attrs[name] = gather_columns(buf.attributes[name], first_idx)
    return ScanBuffer(positions=sums[..., 1:4, :] / denom, mask=counts > 0, attributes=attrs)


def sorted_voxel_channels(
    buf: ScanBuffer,
    voxel_size: torch.Tensor | float,
    dedup_exact: bool = False,
    curve_order: bool = False,
    compact_keys: bool | str = False,
):
    """The voxel sort: the K2 input of ``voxel_downsample``.

    Returns ``(channels float32[..., C, N], run_start bool[..., N],
    mean_rows, first_rows, gathered)``: channels are [w, x*w, y*w, z*w]
    followed by the float attribute rows times w, the narrow integer rows
    times the run-start flag and, when any attribute is ``gathered``, the
    input index times the run-start flag, all in sort order (w = 1 on
    included rows); ``mean_rows`` and ``first_rows`` list (attribute name,
    row count) in channel order, ``gathered`` the names of the wide
    integer attributes. Invalid rows sort last with all-zero channels;
    each is its own run, so the voxel sums are unchanged and no K2 thread
    walks the dead tail.
    """
    if compact_keys is True:
        compact_keys = "box"
    if compact_keys not in (False, "box", "wide"):
        raise ValueError(f"unknown compact_keys tier {compact_keys!r}")
    if compact_keys and not curve_order:
        raise ValueError("compact_keys requires curve_order")
    n = buf.capacity
    lead = buf.batch_shape
    dev = buf.device
    valid = buf.mask
    x, y, z = buf.x, buf.y, buf.z
    vs = torch.as_tensor(voxel_size, dtype=x.dtype, device=dev)
    inv = torch.div(torch.ones_like(vs), vs)

    # quantize: floor() is Open3D's voxel index convention; multiply and
    # floor stay separate ops (no fused multiply-add)
    big = torch.full((), _BIG, dtype=torch.int32, device=dev)
    vx, vy, vz = (
        torch.where(valid, torch.floor(c * inv).to(torch.int32), big)
        for c in (x, y, z)
    )

    mean_rows, first_rows, gathered = [], [], []  # (name, row tensors); names
    for name, arr in sorted(buf.attributes.items()):
        if arr.dtype.is_floating_point:
            mean_rows.append((name, arr.reshape(lead + (-1, n)).to(torch.float32).unbind(-2)))
        elif np.dtype(ATTR_HOST_DTYPES.get(name, np.int64)).itemsize <= 2:
            first_rows.append((name, arr.reshape(lead + (-1, n)).to(torch.float32).unbind(-2)))
        else:
            gathered.append(name)

    keys = []
    if curve_order:
        half = 1 << 19 if compact_keys == "wide" else 512
        cells = []
        for v in (vx, vy, vz):
            lo = torch.where(valid, v, big).amin(-1, keepdim=True)
            hi = torch.where(valid, v, -big).amax(-1, keepdim=True)
            center = lo + (hi - lo) // 2
            cells.append(torch.clamp(v - center + half, 0, 2 * half - 1))
        if compact_keys == "wide":
            hkeys = hilbert_cell_codes_wide(cells, valid)
        else:
            hkeys = (hilbert_cell_codes(cells, valid),)
        keys += [signed_key(h) for h in hkeys]
    if not compact_keys:
        keys += [signed_key(v) for v in (vx, vy, vz)]
    if dedup_exact:
        kx, ky, kz = _coordinate_keys(buf.positions, valid)
        keys += [kx, ky, kz]
    order = lexsort(keys)

    def by_order(v):
        return v.gather(-1, order)

    if curve_order:
        svalid = by_order(hkeys[0]) < _SENTINEL
    else:
        svalid = by_order(vx) < _BIG
    ident = hkeys if compact_keys else (vx, vy, vz)

    def repeats(keys_):
        """True where a sorted row's keys all equal the previous row's."""
        same = torch.zeros(lead + (n,), dtype=torch.bool, device=dev)
        same[..., 1:] = True
        for key in keys_:
            sk = by_order(key)
            same[..., 1:] &= sk[..., 1:] == sk[..., :-1]
        return same

    new_group = ~repeats(ident) & svalid
    included = svalid
    if dedup_exact:
        included = svalid & ~repeats((kx, ky, kz))
    w = included.to(torch.float32)
    flag_f = new_group.to(torch.float32)

    # NaN discipline: excluded rows keep NaN coordinates; zero them before
    # they meet a weight (NaN * 0 = NaN would poison the segment)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    channels = [w] + [
        torch.where(included, by_order(buf.positions[..., c, :]), zero) * w for c in range(3)
    ]
    for _, rows in mean_rows:
        channels += [torch.where(included, by_order(r), zero) * w for r in rows]
    for _, rows in first_rows:
        channels += [torch.where(included, by_order(r), zero) * flag_f for r in rows]
    if gathered:
        channels.append(order.to(torch.float32) * flag_f)
    return (
        torch.stack(channels, dim=-2),
        new_group | ~svalid,
        [(name, len(rows)) for name, rows in mean_rows],
        [(name, len(rows)) for name, rows in first_rows],
        gathered,
    )
