"""Space-filling-curve window neighbourhoods (the main path's variant).

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/window.py``: points
are ordered along a 3-D Hilbert curve, and each 128-point block of the
curve takes its neighbourhood statistics over a window of nearby blocks
(kernel K3, ``ops/window_stats.py``). Several passes over axis-permuted,
origin-shifted curves are min-merged, because a window only ever
overestimates the kNN distance.

Ported: the curve codes, the per-pass curve sort, and the fused
neighbourhood of the presorted pipeline mode
(``fused_neighborhood_stats_reordered`` with ``presorted=True`` and
normals from pass 0). Not ported yet (ROADMAP item 8): the standalone
window ops, the unsorting ``fused_neighborhood_stats``, pass-merged
normals, the second radius, and the non-presorted entry.

Sorts here are stable; the reference's pass-1 re-sort is not, so the two
order ties (distinct points in one curve cell) differently.

Everything takes an optional leading batch axis (positions [B, 3, N], mask
[B, N]): bounds, sorts and windows are per scan, and each kernel launch
covers the batch.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .normals import _normals_from_entries
from .window_stats import window_stats

__all__ = [
    "fused_neighborhood_stats_reordered",
    "hilbert_cell_codes",
    "hilbert_codes",
]

_BITS = 10  # per-axis quantization bits (30-bit curve index)
_SENTINEL = 0x7FFFFFFF  # curve code of invalid rows: they sort last

#: per-pass axis permutations: distinct curve orientations
_PASS_PERMS = ((0, 1, 2), (1, 2, 0), (2, 0, 1), (0, 2, 1))


def _spread_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 v so consecutive bits are 3 apart."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _quantize_axes(positions, mask, origin_shift: float):
    """Per-axis 10-bit quantization over the live bounding box.

    ``origin_shift`` (cells) compresses the range into [shift, 1023] so
    later passes' curve hierarchies land elsewhere. The multiply and add
    stay separate ops: a fused multiply-add can move a point by one cell.
    The scale is a true division (``scalar / tensor`` in torch multiplies
    by a rounded reciprocal instead).
    """
    big = 3.4e38
    out = []
    for c in range(3):
        v = positions[..., c, :]
        lo = torch.where(mask, v, big).amin(-1, keepdim=True)
        hi = torch.where(mask, v, -big).amax(-1, keepdim=True)
        scale = torch.div(
            torch.full_like(hi, 1023.0 - origin_shift), torch.clamp(hi - lo, min=1e-12)
        )
        q = torch.clamp((v - lo) * scale + origin_shift, 0.0, 1023.0)
        out.append(q.to(torch.int32))
    return out


def _hilbert_transpose(cells: Sequence[torch.Tensor], bits: int):
    """Skilling: int32 coordinates in [0, 2**bits) -> transposed Hilbert index."""
    X = list(cells)
    M = 1 << (bits - 1)
    Q = M
    while Q > 1:
        P = Q - 1
        for i in range(3):
            hit = (X[i] & Q) != 0
            t = (X[0] ^ X[i]) & P
            x0_inv = X[0] ^ P
            x0_swp = X[0] ^ t
            xi_swp = X[i] ^ t
            X[0] = torch.where(hit, x0_inv, x0_swp)
            if i != 0:
                X[i] = torch.where(hit, X[i], xi_swp)
        Q >>= 1
    # Gray encode
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    Q = M
    while Q > 1:
        t = torch.where((X[2] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    return [x ^ t for x in X]


def hilbert_cell_codes(cells, mask: torch.Tensor) -> torch.Tensor:
    """30-bit Hilbert index (int32) from cells in [0, 1023]; invalid last."""
    X = _hilbert_transpose(cells, _BITS)
    code = (
        (_spread_bits_10(X[0]) << 2)
        | (_spread_bits_10(X[1]) << 1)
        | _spread_bits_10(X[2])
    )
    return torch.where(mask, code, _SENTINEL)


def hilbert_codes(positions, mask, origin_shift: float = 0.0) -> torch.Tensor:
    """30-bit Hilbert-curve index per point, invalid rows last."""
    return hilbert_cell_codes(_quantize_axes(positions, mask, origin_shift), mask)


def _pass_shift(pass_idx: int) -> float:
    """Origin jitter (cells) of pass ``pass_idx``: 0, 128, 256, ... <= 512."""
    return float(min(128 * pass_idx, 512))


def _sorted_rows(positions, mask, pass_idx: int, extra=()):
    """Stable curve sort of x/y/z (+ ``extra`` rows) for pass ``pass_idx``.

    Returns (sx, sy, sz, sv, *extra) in curve order; validity comes from
    the sorted code (invalid rows carry the sentinel).
    """
    perm = _PASS_PERMS[pass_idx % len(_PASS_PERMS)]
    codes = hilbert_codes(positions[..., list(perm), :], mask, _pass_shift(pass_idx))
    codes, order = torch.sort(codes, dim=-1, stable=True)
    return (
        *(positions[..., c, :].gather(-1, order) for c in range(3)),
        codes < _SENTINEL,
        *(r.gather(-1, order) for r in extra),
    )


def _entries_from_moments(mom):
    """Centered covariance entries [..., 6, N] from raw moment rows
    [..., 10, N]."""
    m = mom.unbind(-2)
    nw = torch.clamp(m[0], min=1.0)
    mx, my, mz = m[1] / nw, m[2] / nw, m[3] / nw
    return torch.stack([
        m[4] - nw * mx * mx,
        m[5] - nw * my * my,
        m[6] - nw * mz * mz,
        m[7] - nw * mx * my,
        m[8] - nw * mx * mz,
        m[9] - nw * my * mz,
    ], dim=-2)


def _oct_encode(nx, ny, nz):
    """Unit vector -> octahedral (u, v)."""
    s = torch.abs(nx) + torch.abs(ny) + torch.abs(nz)
    s = torch.where(s > 0, s, torch.ones_like(s))
    u, v = nx / s, ny / s
    down = nz < 0
    su = torch.where(u >= 0, 1.0, -1.0)
    sv = torch.where(v >= 0, 1.0, -1.0)
    return (
        torch.where(down, (1.0 - torch.abs(v)) * su, u),
        torch.where(down, (1.0 - torch.abs(u)) * sv, v),
    )


def _oct_pack(u, v) -> torch.Tensor:
    """Octahedral (u, v) -> one int32 row, 16 bits per component."""
    qu = torch.clamp(torch.round((u * 0.5 + 0.5) * 65535.0), 0.0, 65535.0)
    qv = torch.clamp(torch.round((v * 0.5 + 0.5) * 65535.0), 0.0, 65535.0)
    return ((qu.to(torch.int64) << 16) | qv.to(torch.int64)).to(torch.int32)


def _oct_unpack(p):
    qu = (p >> 16) & 0xFFFF
    qv = p & 0xFFFF
    u = qu.to(torch.float32) * (2.0 / 65535.0) - 1.0
    v = qv.to(torch.float32) * (2.0 / 65535.0) - 1.0
    return u, v


def _oct_decode(u, v):
    z = 1.0 - torch.abs(u) - torch.abs(v)
    down = z < 0
    su = torch.where(u >= 0, 1.0, -1.0)
    sv = torch.where(v >= 0, 1.0, -1.0)
    x = torch.where(down, (1.0 - torch.abs(v)) * su, u)
    y = torch.where(down, (1.0 - torch.abs(u)) * sv, v)
    nrm = torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-30))
    return x / nrm, y / nrm, z / nrm


def _thin_sort_slice(px, py, pz, m, carry, shrink_to: int):
    """Overflow path of the presorted shrink: a deterministic binomial
    thin (hash of the slot index) to ~``shrink_to`` live points per scan,
    the pass-0 curve sort, and a prefix slice."""
    n = px.shape[-1]
    n_live = m.sum(-1, keepdim=True)
    slot = torch.arange(n, dtype=torch.int64, device=px.device)
    # the reference's int32 wraparound product, reinterpreted as uint32
    pri = (slot * -1640531527) & 0xFFFFFFFF
    p = torch.div(
        torch.full((), float(shrink_to), device=px.device),
        torch.clamp(n_live.to(torch.float32), min=1.0),
    )
    keep = pri.to(torch.float32) < p * 2.0**32
    m = m & ((n_live <= shrink_to) | keep)
    rows = _sorted_rows(torch.stack([px, py, pz], dim=-2), m, 0, extra=carry)
    return [r[..., :shrink_to] for r in rows]


def _fused_passes(positions, mask, carry, *, k, radius, window_blocks, passes,
                  kmode, shrink_to=0):
    """Sort-chained multi-pass neighbourhood of the presorted pipeline mode.

    The caller promises live points front-compacted and in pass-0 curve
    order (the curve-ordered voxel stage), so pass 0 needs no sort and
    ``shrink_to`` is a prefix slice. When more than ``shrink_to`` points
    are live, a binomial thin and a pass-0 sort run instead; deciding that
    reads the live counts on the host (one device sync for a whole batch).
    When any scan of a batch overflows, the thin runs for the batch and
    each scan takes its own branch by a select, as the reference's
    ``lax.cond`` does under ``vmap``. Each later pass
    re-sorts the rows, the ``carry`` rows and the pass statistics along
    its own curve. Normals and the in-radius count come from pass 0 (the
    normal rides the re-sorts as one octahedral-packed int32 row); the kNN
    means are min-merged.

    Returns ``(sx, sy, sz, sv, carry_rows, mean, count, nx, ny, nz)`` in
    the last pass's curve order.
    """
    wbs = (window_blocks,) * passes if isinstance(window_blocks, int) else tuple(window_blocks)
    if len(wbs) != passes:
        raise ValueError(f"window_blocks {wbs} does not match passes={passes}")

    def one_pass(px, py, pz, pv, direction, wb, moments=True):
        mean_s, _cnt, mom_s = window_stats(
            px, py, pz, pv, radius, k=k, window_blocks=wb, kmode=kmode,
            direction=direction, moments=moments,
        )
        return mean_s, mom_s

    n = positions.shape[-1]
    px, py, pz = (positions[..., c, :] for c in range(3))
    rows = [px, py, pz, mask, *carry]
    if shrink_to and shrink_to < n:
        live = mask.sum(-1)
        prefix = [r[..., :shrink_to] for r in rows]
        if int(live.max()) > shrink_to:  # one host read for the batch
            thin = _thin_sort_slice(px, py, pz, mask, carry, shrink_to)
            over = (live > shrink_to)[..., None]
            rows = [torch.where(over, t, p) for t, p in zip(thin, prefix)]
        else:
            rows = prefix
    sx, sy, sz, sv, *carry = (r.contiguous() for r in rows)

    mean, mom = one_pass(sx, sy, sz, sv, 0, wbs[0])
    count = mom[..., 0, :]
    nrm0 = _normals_from_entries(*_entries_from_moments(mom).unbind(-2), count)
    stat_n = _oct_pack(*_oct_encode(*nrm0.unbind(-2)))
    for p_i in range(1, passes):
        sx, sy, sz, sv, *rest = _sorted_rows(
            torch.stack([sx, sy, sz], dim=-2), sv, p_i, extra=(*carry, mean, count, stat_n)
        )
        carry, (mean, count, stat_n) = rest[:-3], rest[-3:]
        m2, _ = one_pass(sx, sy, sz, sv, p_i % 2, wbs[p_i], moments=False)
        mean = torch.minimum(mean, m2)
    nrm = _oct_decode(*_oct_unpack(stat_n))
    return (sx, sy, sz, sv, tuple(carry), mean, count, nrm[0], nrm[1], nrm[2])


def fused_neighborhood_stats_reordered(
    positions: torch.Tensor,
    mask: torch.Tensor,
    attrs: dict,
    k: int,
    radius: torch.Tensor | float,
    window_blocks: int | tuple = 2,
    passes: int = 2,
    kmode: str = "sweep",
    shrink_to: int = 0,
):
    """Shared neighbourhood sweep (kNN mean distance + normals) that
    reorders the buffer instead of unsorting the statistics; the
    reference's ``presorted=True`` mode with normals from pass 0
    (``entries_merge=False``).

    The input must be front-compacted and in pass-0 curve order, as the
    curve-ordered voxel stage leaves it. Positions, mask and attributes
    ride the curve sorts and come back in the last pass's curve order,
    statistics aligned (the pipeline has no point-order contract after the
    voxel stage). ``shrink_to`` (multiple of 128, 0 = off) shrinks the
    buffer to that capacity. Positions [..., 3, N], mask [..., N] and
    attributes [..., N] / [..., C, N] may carry a batch axis.

    Returns ``(positions, mask, attrs, mean_knn, normals, count)``; the
    mean and count are zero on invalid rows.
    """
    n = positions.shape[-1]
    lead = mask.shape[:-1]
    flat, specs = [], []
    for name, v in attrs.items():
        rows = v.reshape(lead + (-1, n)).unbind(-2)
        specs.append((name, v.shape, len(rows)))
        flat.extend(rows)

    sx, sy, sz, sv, flat, mean, count, nx, ny, nz = _fused_passes(
        positions, mask, flat, k=k, radius=radius, window_blocks=window_blocks,
        passes=passes, kmode=kmode, shrink_to=shrink_to,
    )
    n_out = sx.shape[-1]
    out_attrs, i = {}, 0
    for name, shape, nrows in specs:
        out_attrs[name] = torch.stack(flat[i : i + nrows], dim=-2).reshape(shape[:-1] + (n_out,))
        i += nrows
    zero = torch.zeros((), dtype=mean.dtype, device=mean.device)
    return (
        torch.stack([sx, sy, sz], dim=-2),
        sv,
        out_attrs,
        torch.where(sv, mean, zero),
        torch.stack([nx, ny, nz], dim=-2),
        torch.where(sv, count, zero),
    )
