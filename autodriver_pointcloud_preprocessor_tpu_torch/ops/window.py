"""Space-filling-curve window neighbourhoods: the kernel route and the XLA route.

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/window.py``: points
are ordered along a 3-D Hilbert curve, and each 128-point block of the
curve takes its neighbourhood statistics over a window of nearby blocks.
Several passes over axis-permuted, origin-shifted curves are merged (the
kNN means by their minimum, because a window only ever overestimates the
kNN distance; the covariances by the pass that found more neighbours).

The reference's whole surface: the curve codes (Hilbert and Morton), the
standalone window ops (``window_mean_knn_dist``, ``window_normal_stats``)
and the fused neighbourhood in its unsorting
(``fused_neighborhood_stats``) and reordering
(``fused_neighborhood_stats_reordered``) forms. Each takes the
reference's ``backend``, which names one of two routes that compute two
different functions:

* the kernel route (``"auto"``, ``"pallas"``, ``"pallas_interpret"``):
  kernel K3 (``ops/window_stats.py``) on a card, its plain version on the
  CPU. The fused forms chain their passes through the curve sorts, take
  the presorted input and the capacity shrink, the second radius's count,
  pass-merged or pass-0 normals;
* the XLA route (``"xla"``): the reference's plain fallback, plain
  PyTorch on the tensors' device. Each pass sorts the input along its own
  curve; a block's candidates are whole blocks, ``window_blocks`` each
  side (0 widens to 1), gathered by rolls, so the window wraps from the
  first block to the last; the kNN mean is an exact top-k over the
  window and the covariance is centered over the in-radius candidates.
  ``chunk_blocks`` bounds its working set and nothing else.

The reference's ``"auto"`` takes the XLA route off the TPU; here it is
the kernel route on every device (``default_backend``), so the XLA route
runs only where a caller asks for it (``PipelineSettings(pallas_ok=False)``
among them). Every curve sort takes an optional quantization box
``bounds=(lo, hi)`` (float32 [..., 3] each, one per scan): the sharded
pipeline passes the global live box, so that every rank quantizes into
the grid one device would use (``parallel/sharding.py``).

Sorts here are stable; the reference's re-sorts of later kernel-route
passes are not, so the two order ties (distinct points in one curve cell)
differently there.

Everything takes an optional leading batch axis (positions [B, 3, N], mask
[B, N]): bounds, sorts and windows are per scan, and each kernel launch
covers the batch.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.scan import ScanBuffer
from .compact import check_backend, subsample_to
from .linalg import normals_from_entries as _normals_from_entries
from .window_stats import window_stats

__all__ = [
    "default_backend",
    "fused_neighborhood_stats",
    "fused_neighborhood_stats_reordered",
    "hilbert_cell_codes",
    "hilbert_cell_codes_wide",
    "hilbert_codes",
    "morton_codes",
    "window_mean_knn_dist",
    "window_normal_stats",
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


def _quantize_axes(positions, mask, origin_shift: float, bounds=None):
    """Per-axis 10-bit quantization over the live bounding box, or over
    ``bounds=(lo, hi)`` (float32 [..., 3] each, aligned with the rows of
    ``positions``) when given.

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
        if bounds is None:
            lo = torch.where(mask, v, big).amin(-1, keepdim=True)
            hi = torch.where(mask, v, -big).amax(-1, keepdim=True)
        else:
            lo, hi = bounds[0][..., c : c + 1], bounds[1][..., c : c + 1]
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


def hilbert_cell_codes_wide(cells, mask: torch.Tensor):
    """60-bit Hilbert index as an (hi, lo) int32 pair from cells in
    [0, 2**20); invalid rows get the sentinel in both.

    ``hi`` interleaves each axis's top 10 transposed bits, ``lo`` the low
    10: the lexicographic order of (hi, lo) is the 60-bit index's, and the
    pair identifies the cell. Every intermediate stays below 2**20, so the
    int32 arithmetic cannot wrap.
    """
    X = _hilbert_transpose(cells, 20)

    def interleave(shift):
        return (
            (_spread_bits_10((X[0] >> shift) & 0x3FF) << 2)
            | (_spread_bits_10((X[1] >> shift) & 0x3FF) << 1)
            | _spread_bits_10((X[2] >> shift) & 0x3FF)
        )

    return torch.where(mask, interleave(10), _SENTINEL), torch.where(mask, interleave(0), _SENTINEL)


def morton_codes(positions, mask, origin_shift: float = 0.0, bounds=None) -> torch.Tensor:
    """30-bit Morton (Z-order) code per point, invalid rows last; ``bounds``
    as in ``_quantize_axes``."""
    qx, qy, qz = _quantize_axes(positions, mask, origin_shift, bounds)
    code = _spread_bits_10(qx) | (_spread_bits_10(qy) << 1) | (_spread_bits_10(qz) << 2)
    return torch.where(mask, code, _SENTINEL)


def hilbert_codes(positions, mask, origin_shift: float = 0.0, bounds=None) -> torch.Tensor:
    """30-bit Hilbert-curve index per point, invalid rows last; ``bounds``
    as in ``_quantize_axes``."""
    return hilbert_cell_codes(_quantize_axes(positions, mask, origin_shift, bounds), mask)


def _pass_shift(pass_idx: int) -> float:
    """Origin jitter (cells) of pass ``pass_idx``: 0, 128, 256, ... <= 512."""
    return float(min(128 * pass_idx, 512))


def _permute_bounds(bounds, perm):
    """Reorder a (lo [..., 3], hi [..., 3]) bounds pair by a pass's axis
    permutation."""
    if bounds is None:
        return None
    lo, hi = bounds
    return (torch.stack([lo[..., a] for a in perm], -1),
            torch.stack([hi[..., a] for a in perm], -1))


def _curve_order(positions, mask, pass_idx: int, bounds=None):
    """Stable curve sort for pass ``pass_idx``: (sorted codes, order), the
    order being each sorted row's input index. ``bounds`` (in the axis
    order of ``positions``) is the quantization box, else the live box."""
    perm = _PASS_PERMS[pass_idx % len(_PASS_PERMS)]
    # rows stacked from views: a list index would first copy the index
    # to the device (a host transfer, which a captured program cannot hold)
    codes = hilbert_codes(
        torch.stack([positions[..., a, :] for a in perm], -2), mask, _pass_shift(pass_idx),
        _permute_bounds(bounds, perm),
    )
    return torch.sort(codes, dim=-1, stable=True)


def _sorted_rows(positions, mask, pass_idx: int, extra=(), bounds=None):
    """Stable curve sort of x/y/z (+ ``extra`` rows) for pass ``pass_idx``.

    Returns (sx, sy, sz, sv, *extra) in curve order; validity comes from
    the sorted code (invalid rows carry the sentinel).
    """
    codes, order = _curve_order(positions, mask, pass_idx, bounds)
    return (
        *(positions[..., c, :].gather(-1, order) for c in range(3)),
        codes < _SENTINEL,
        *(r.gather(-1, order) for r in extra),
    )


def _unsort(order, rows):
    """Rows in curve order -> input order, ``order`` being the sort's
    input index per sorted row (a permutation along the last axis)."""
    return [torch.empty_like(r).scatter_(-1, order, r) for r in rows]


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


def _thin_sort_slice(px, py, pz, m, carry, shrink_to: int, bounds=None):
    """The shrink's thin: a deterministic binomial thin (hash of the slot
    index) to ~``shrink_to`` live points per scan when more are live, the
    pass-0 curve sort, and a prefix slice. The entry of a non-presorted
    shrink, and the overflow path of the presorted one."""
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
    rows = _sorted_rows(torch.stack([px, py, pz], dim=-2), m, 0, extra=carry, bounds=bounds)
    return [r[..., :shrink_to] for r in rows]


def _masked(v, mask):
    """``v`` where ``mask``, else 0."""
    return torch.where(mask, v, torch.zeros((), dtype=v.dtype, device=v.device))


def _wb_per_pass(window_blocks, passes: int) -> tuple:
    """``window_blocks`` (an int or a per-pass tuple) -> one per pass."""
    wbs = (window_blocks,) * passes if isinstance(window_blocks, int) else tuple(window_blocks)
    if len(wbs) != passes:
        raise ValueError(f"per-pass window_blocks tuple length {len(wbs)} != passes {passes}")
    return wbs


def default_backend() -> str:
    """The route ``backend="auto"`` takes: ``"pallas"``, the kernel route
    (K3 on a card, its plain version on the CPU), on every device.

    The reference picks by platform (its kernel on a TPU, the XLA route
    elsewhere) and lets ``APC_WINDOW_BACKEND`` force a route, a switch its
    tests use to run the kernel in interpret mode on a CPU mesh. The port
    makes no platform pick and reads no environment variable: the XLA
    route runs only where a caller asks for ``backend="xla"``.
    """
    return "pallas"


def _xla_route(backend: str) -> bool:
    """True for ``backend="xla"``, False for the kernel route's names;
    anything else raises."""
    return check_backend(backend) == "xla"


# ---------------------------------------------------------------------------
# the XLA route
# ---------------------------------------------------------------------------

def _window(blocks: torch.Tensor, num_rolls: int) -> torch.Tensor:
    """[..., NB, B] -> [..., NB, (2R+1) * B]: each block's candidates, its
    own block and ``num_rolls`` whole blocks each side, gathered by rolls
    along the block axis (so the window wraps from the first block to the
    last). ``num_rolls == 0`` is widened to one block a side: the route
    has no sub-block window."""
    num_rolls = max(num_rolls, 1)
    return torch.cat(
        [torch.roll(blocks, -r, dims=-2) for r in range(-num_rolls, num_rolls + 1)], dim=-1
    )


def _hilbert_order(positions, mask, pass_idx: int, bounds=None) -> torch.Tensor:
    """Stable sort permutation of pass ``pass_idx``'s axis-permuted,
    jittered curve: each sorted row's input index."""
    return _curve_order(positions, mask, pass_idx, bounds)[1]


def _sorted_window_arrays(positions, mask, block_size: int, window_blocks: int,
                          pass_idx: int, bounds=None):
    """Pass ``pass_idx``'s curve order, the sorted x/y/z/valid rows as
    [..., NB, block_size] blocks and their candidate windows (``_window``):
    ``(order, (sx, sy, sz, sv), (wx, wy, wz, wv))``."""
    order = _hilbert_order(positions, mask, pass_idx, bounds)

    def blocks(row):
        return row.gather(-1, order).unflatten(-1, (-1, block_size))

    rows = (*(blocks(positions[..., c, :]) for c in range(3)), blocks(mask))
    return order, rows, tuple(_window(r, window_blocks) for r in rows)


def _chunk_size(num_blocks: int, chunk_blocks: int) -> int:
    """Largest divisor of ``num_blocks`` that is <= ``chunk_blocks``: the
    chunks must cover every block (a halo-extended slab of 136 blocks
    against 64-block chunks, for one)."""
    cb = min(chunk_blocks, num_blocks)
    while num_blocks % cb:
        cb -= 1
    return cb


def _map_chunks(fn, num_blocks: int, chunk_blocks: int):
    """``fn(ci)`` for each chunk of ``chunk_blocks`` blocks, its outputs
    (a tensor or a tuple of them, blocks on axis -2) concatenated along
    the block axis: the reference's ``lax.map``, which bounds the working
    set and nothing else."""
    assert num_blocks % chunk_blocks == 0, (num_blocks, chunk_blocks)
    outs = [fn(ci) for ci in range(max(num_blocks // chunk_blocks, 1))]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=-2) for parts in zip(*outs))
    return torch.cat(outs, dim=-2)


def _squared_radius(radius, mask) -> torch.Tensor:
    """``radius ** 2`` in float32 on the mask's device, shaped to broadcast
    over [..., chunk, B, W] distance blocks (one radius, or one per scan).
    A tensor radius stays on the device; nothing is read back."""
    rad = torch.as_tensor(radius, dtype=torch.float32, device=mask.device)
    r2 = rad * rad
    if r2.numel() == 1:
        return r2.reshape(())
    return r2.reshape(mask.shape[:-1] + (1, 1, 1))


def _xla_knn_pass(positions, mask, k, block_size, window_blocks, chunk_blocks, pass_idx,
                  bounds):
    """One XLA-route pass of the kNN mean: each query's mean distance to
    its ``k`` nearest valid window candidates (an exact top-k; self
    included), back in input order."""
    order, (sx, sy, sz, _sv), (wx, wy, wz, wv) = _sorted_window_arrays(
        positions, mask, block_size, window_blocks, pass_idx, bounds
    )
    nb = sx.shape[-2]
    cb = _chunk_size(nb, chunk_blocks)
    kk = min(k, wx.shape[-1])
    inf = torch.full((), float("inf"), dtype=torch.float32, device=sx.device)
    zero = torch.zeros((), dtype=torch.float32, device=sx.device)

    def chunk_fn(ci):
        s = slice(ci * cb, (ci + 1) * cb)
        dx = sx[..., s, :, None] - wx[..., s, None, :]
        dy = sy[..., s, :, None] - wy[..., s, None, :]
        dz = sz[..., s, :, None] - wz[..., s, None, :]
        d = torch.where(wv[..., s, None, :], dx * dx + dy * dy + dz * dz, inf)
        top = torch.topk(d, kk, dim=-1, largest=False).values
        finite = torch.isfinite(top)
        cnt = torch.clamp(finite.sum(-1), min=1)
        return torch.where(finite, torch.sqrt(top), zero).sum(-1) / cnt

    return _unsort(order, [_map_chunks(chunk_fn, nb, cb).flatten(-2)])[0]


def _xla_normal_pass(positions, mask, r2, block_size, window_blocks, chunk_blocks, pass_idx,
                     bounds):
    """One XLA-route pass of the normal statistics: the centered covariance
    entries [..., 6, N] (a00, a11, a22, a01, a02, a12) of each query's
    in-radius valid window candidates (self included) and their count,
    back in input order."""
    order, (sx, sy, sz, _sv), (wx, wy, wz, wv) = _sorted_window_arrays(
        positions, mask, block_size, window_blocks, pass_idx, bounds
    )
    nb = sx.shape[-2]
    cb = _chunk_size(nb, chunk_blocks)

    def chunk_fn(ci):
        s = slice(ci * cb, (ci + 1) * cb)
        cx, cy, cz = (w[..., s, None, :] for w in (wx, wy, wz))
        dx = cx - sx[..., s, :, None]
        dy = cy - sy[..., s, :, None]
        dz = cz - sz[..., s, :, None]
        d2 = dx * dx + dy * dy + dz * dz
        w = (wv[..., s, None, :] & (d2 <= r2)).to(torch.float32)
        cnt = w.sum(-1)
        denom = torch.clamp(cnt, min=1.0)
        ex, ey, ez = (c - ((w * c).sum(-1) / denom)[..., None] for c in (cx, cy, cz))
        entries = torch.stack([
            (w * a * b).sum(-1)
            for a, b in ((ex, ex), (ey, ey), (ez, ez), (ex, ey), (ex, ez), (ey, ez))
        ], dim=-3)
        return entries, cnt

    entries, cnt = _map_chunks(chunk_fn, nb, cb)
    count, *rows = _unsort(order, [cnt.flatten(-2), *entries.flatten(-2).unbind(-2)])
    return torch.stack(rows, dim=-2), count


def _kernel_pass(positions, mask, pass_idx, k, radius, window_blocks,
                 kmode="sweep", moments=True, bounds=None):
    """One curve pass through K3: the reference's ``_pallas_pass``.

    A stable curve sort whose order is the carried index, K3, and the
    unsort. Returns (mean_knn [..., N], cov_entries [..., 6, N], count
    [..., N]) in input order; count is the in-radius count (zero, like the
    entries, with ``moments=False``).
    """
    codes, order = _curve_order(positions, mask, pass_idx, bounds)
    mean_s, _cnt, mom_s = window_stats(
        *(positions[..., c, :].gather(-1, order) for c in range(3)), codes < _SENTINEL,
        radius, k=k, window_blocks=window_blocks, kmode=kmode, direction=pass_idx % 2,
        moments=moments,
    )
    mean, count, *entry_rows = _unsort(
        order, (mean_s, mom_s[..., 0, :], *_entries_from_moments(mom_s).unbind(-2))
    )
    return mean, torch.stack(entry_rows, dim=-2), count


def window_mean_knn_dist(positions, mask, k: int, window_blocks: int | tuple = 2,
                         passes: int = 2, kmode: str = "sweep", bounds=None,
                         block_size: int = 128, chunk_blocks: int = 64,
                         backend: str = "auto") -> torch.Tensor:
    """Mean distance to the k nearest window candidates (self included),
    min-merged over ``passes`` curve passes; float32[..., N] in input
    order, 0 on masked-out rows. Backs statistical outlier removal.

    ``backend``: ``"xla"`` takes the XLA route (an exact top-k over whole
    ``block_size``-row blocks, ``chunk_blocks`` blocks at a time; ``kmode``
    is ignored), any other of the reference's names the kernel route (K3,
    which ignores ``block_size`` and ``chunk_blocks``; see the module
    docstring). ``bounds``: the curve sorts' quantization box
    (``_quantize_axes``)."""
    wbs = _wb_per_pass(window_blocks, passes)
    best = None
    if _xla_route(backend):
        block_size = min(block_size, positions.shape[-1])
        for p_i in range(passes):
            mean = _xla_knn_pass(positions, mask, k, block_size, wbs[p_i], chunk_blocks, p_i,
                                 bounds)
            best = mean if best is None else torch.minimum(best, mean)
        return _masked(best, mask)
    # no moments, so any radius: a device zero (a host scalar's copy would
    # synchronise the stream)
    radius = torch.zeros((), dtype=torch.float32, device=positions.device)
    for p_i in range(passes):
        mean, _, _ = _kernel_pass(
            positions, mask, p_i, k, radius, wbs[p_i], kmode, moments=False, bounds=bounds
        )
        best = mean if best is None else torch.minimum(best, mean)
    return _masked(best, mask)


def window_normal_stats(positions, mask, radius, window_blocks: int | tuple = 2,
                        passes: int = 2, bounds=None, block_size: int = 128,
                        chunk_blocks: int = 64, backend: str = "auto"):
    """In-radius covariance entries over the curve window, per point.

    Returns ``(cov_entries float32[..., 6, N], count float32[..., N])`` in
    input order: entries (a00, a11, a22, a01, a02, a12) of the centered
    covariance of the in-radius candidates (self included); each point
    keeps the pass that found more of them. Count is 0 on masked-out rows.
    Backs normal estimation and radius outlier removal. ``backend``,
    ``block_size`` and ``chunk_blocks`` as in ``window_mean_knn_dist``;
    ``bounds``: the curve sorts' quantization box (``_quantize_axes``).

    Deliberate deviation on the XLA route: a non-finite invalid row makes
    the reference's entries NaN on every live row whose window holds it;
    here invalid rows are zeroed first, so every live row's entries are
    finite, and the others are unchanged.
    """
    wbs = _wb_per_pass(window_blocks, passes)
    if _xla_route(backend):
        block_size = min(block_size, positions.shape[-1])
        r2 = _squared_radius(radius, mask)
        # invalid rows zeroed: the route weights every candidate by 0 or 1,
        # and the reference's NaN rows poison each live row whose window
        # holds one (0 * NaN); zeros change no finite result
        positions = torch.where(mask.unsqueeze(-2), positions, 0.0)
        passes_out = (
            _xla_normal_pass(positions, mask, r2, block_size, wbs[p_i], chunk_blocks, p_i, bounds)
            for p_i in range(passes)
        )
    else:
        passes_out = (
            _kernel_pass(positions, mask, p_i, 1, radius, wbs[p_i], bounds=bounds)[1:]
            for p_i in range(passes)
        )
    entries = counts = None
    for e2, c2 in passes_out:
        if entries is None:
            entries, counts = e2, c2
        else:
            better = c2 > counts
            entries = torch.where(better.unsqueeze(-2), e2, entries)
            counts = torch.where(better, c2, counts)
    return entries, _masked(counts, mask)


def _fused_passes(positions, mask, carry, *, k, radius, window_blocks, passes,
                  kmode, shrink_to=0, radius2=None, presorted=False,
                  entries_merge=True, carry_count=True, bounds=None):
    """Sort-chained multi-pass neighbourhood: the shared core of the fused
    ops.

    Entry: with ``presorted`` the caller promises live points
    front-compacted and in pass-0 curve order (the curve-ordered voxel
    stage), so pass 0 needs no sort and ``shrink_to`` is a prefix slice;
    when more than ``shrink_to`` points are live, a binomial thin and a
    pass-0 sort take its place. Both run, and each scan selects its own
    on the device (the reference's ``lax.cond``, as it runs under
    ``vmap``), so no live count is read on the host. Without ``presorted``
    pass 0 sorts, and with ``shrink_to`` it thins, sorts and slices.

    Each later pass re-sorts the rows, the ``carry`` rows and the
    statistics along its own curve. The kNN means are min-merged; with
    ``radius2`` the in-radius2 counts are max-merged (windows only
    undercount). Normals: with ``entries_merge`` the 6 covariance-entry
    rows and the in-radius count ride the re-sorts, the higher-count pass
    wins per point and one eigensolve runs after the merge; without it the
    normal comes from pass 0 as one octahedral-packed int32 row, later
    passes skip the moments, and ``carry_count=False`` drops the count row
    too (the count comes back zero).

    ``bounds`` is every curve sort's quantization box (``_quantize_axes``).

    Returns ``(sx, sy, sz, sv, carry_rows, mean, count, normals [..., 3,
    N], count2 or None)`` in the last pass's curve order.
    """
    wbs = _wb_per_pass(window_blocks, passes)
    use_r2 = radius2 is not None

    def one_pass(px, py, pz, pv, direction, wb, moments=True):
        out = window_stats(
            px, py, pz, pv, radius, k=k, window_blocks=wb, kmode=kmode,
            direction=direction, moments=moments, radius2=radius2,
        )
        mom = out[2]
        return out[0], mom[..., 0, :], _entries_from_moments(mom), out[3] if use_r2 else None

    n = positions.shape[-1]
    px, py, pz = (positions[..., c, :] for c in range(3))
    if presorted:
        rows = [px, py, pz, mask, *carry]
        if shrink_to and shrink_to < n:
            # both branches run and each scan selects its own on the
            # device, with no host read: the reference's lax.cond
            over = (mask.sum(-1) > shrink_to)[..., None]
            thin = _thin_sort_slice(px, py, pz, mask, carry, shrink_to, bounds)
            rows = [torch.where(over, t, r[..., :shrink_to]) for t, r in zip(thin, rows)]
    elif shrink_to and shrink_to < n:
        rows = _thin_sort_slice(px, py, pz, mask, carry, shrink_to, bounds)
    else:
        rows = _sorted_rows(positions, mask, 0, extra=carry, bounds=bounds)
    sx, sy, sz, sv, *carry = (r.contiguous() for r in rows)

    mean, count, ent, cnt2 = one_pass(sx, sy, sz, sv, 0, wbs[0])
    drop_count = not entries_merge and not carry_count
    if not entries_merge:
        # solve pass 0's normals now; one packed row rides the re-sorts
        nrm0 = _normals_from_entries(*ent.unbind(-2), count)
        stat_n = _oct_pack(*_oct_encode(*nrm0.unbind(-2)))
    for p_i in range(1, passes):
        # the statistic rows riding this re-sort, in this order: the mean,
        # the count, the 6 entries or the packed normal, the count2
        stats = [mean]
        stats += [] if drop_count else [count]
        stats += list(ent.unbind(-2)) if entries_merge else [stat_n]
        stats += [cnt2] if use_r2 else []
        sx, sy, sz, sv, *rest = _sorted_rows(
            torch.stack([sx, sy, sz], dim=-2), sv, p_i, extra=(*carry, *stats), bounds=bounds
        )
        carry, stats = rest[: len(carry)], rest[len(carry) :]
        mean = stats.pop(0)
        count = torch.zeros_like(mean) if drop_count else stats.pop(0)
        if entries_merge:
            ent = torch.stack(stats[:6], dim=-2)
            del stats[:6]
        else:
            stat_n = stats.pop(0)
        if use_r2:
            cnt2 = stats.pop(0)
        m2, c2, ent2, cnt2b = one_pass(sx, sy, sz, sv, p_i % 2, wbs[p_i], moments=entries_merge)
        mean = torch.minimum(mean, m2)
        if entries_merge:
            better = c2 > count
            ent = torch.where(better.unsqueeze(-2), ent2, ent)
            count = torch.where(better, c2, count)
        if use_r2:
            cnt2 = torch.maximum(cnt2, cnt2b)
    if entries_merge:
        nrm = _normals_from_entries(*ent.unbind(-2), count)
    else:
        nrm = torch.stack(_oct_decode(*_oct_unpack(stat_n)), dim=-2)
    return sx, sy, sz, sv, tuple(carry), mean, count, nrm, cnt2


def fused_neighborhood_stats(
    positions: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    radius: torch.Tensor | float,
    window_blocks: int | tuple = 2,
    passes: int = 2,
    kmode: str = "sweep",
    radius2: torch.Tensor | float | None = None,
    entries_merge: bool = True,
    carry_count: bool = True,
    bounds=None,
    backend: str = "auto",
):
    """One shared neighbourhood sweep for statistical outliers and normals,
    statistics back in input order.

    The kernel route: the passes of ``_fused_passes`` with the input index
    carried, then one unsort. The XLA route (``backend="xla"``) composes
    ``window_mean_knn_dist`` and ``window_normal_stats`` (and a second
    ``window_normal_stats`` for ``radius2``), as the reference does; it
    ignores ``kmode``, ``entries_merge`` and ``carry_count``. Returns
    ``(mean_knn [..., N], normals [..., 3, N], count [..., N][, count2
    [..., N]])``; mean, count and count2 are 0 on masked-out rows.
    ``count2`` (with ``radius2``) is the in-radius2 count, max-merged
    across the kernel route's passes. ``bounds``: the curve sorts'
    quantization box (``_quantize_axes``; the sharded pipeline's global box).
    """
    if _xla_route(backend):
        kw = dict(window_blocks=window_blocks, passes=passes, bounds=bounds, backend="xla")
        mean = window_mean_knn_dist(positions, mask, k=k, **kw)
        entries, count = window_normal_stats(positions, mask, radius, **kw)
        out = (mean, _normals_from_entries(*entries.unbind(-2), count), count)
        if radius2 is None:
            return out
        return out + (window_normal_stats(positions, mask, radius2, **kw)[1],)
    n = positions.shape[-1]
    idx = torch.arange(n, device=positions.device).expand(mask.shape)
    _sx, _sy, _sz, _sv, (order,), mean, count, nrm, cnt2 = _fused_passes(
        positions, mask, (idx,), k=k, radius=radius, window_blocks=window_blocks,
        passes=passes, kmode=kmode, radius2=radius2, entries_merge=entries_merge,
        carry_count=carry_count, bounds=bounds,
    )
    rows = (mean, count, *nrm.unbind(-2)) + ((cnt2,) if radius2 is not None else ())
    mean, count, nx, ny, nz, *rest = _unsort(order, rows)
    out = (_masked(mean, mask), torch.stack([nx, ny, nz], dim=-2), _masked(count, mask))
    return out + tuple(_masked(r, mask) for r in rest)


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
    radius2: torch.Tensor | float | None = None,
    presorted: bool = False,
    entries_merge: bool = True,
    carry_count: bool = True,
    bounds=None,
    backend: str = "auto",
):
    """``fused_neighborhood_stats`` that reorders the buffer instead of
    unsorting the statistics.

    The kernel route: positions, mask and attributes ride the curve sorts
    and come back in the last pass's curve order, statistics aligned (the
    pipeline has no point-order contract after the voxel stage).
    ``presorted``: the input is front-compacted and in pass-0 curve order
    (the curve-ordered voxel stage), so pass 0 needs no sort. ``shrink_to``
    (multiple of 128, 0 = off) shrinks the buffer to that capacity.

    The XLA route (``backend="xla"``), as the reference's: ``shrink_to``
    is ``subsample_to`` first, then ``fused_neighborhood_stats`` on its
    route and, with ``radius2``, a second ``window_normal_stats`` for the
    count; the buffer comes back in its own order and ``presorted`` is
    ignored.

    Positions [..., 3, N], mask [..., N] and attributes [..., N] /
    [..., C, N] may carry a batch axis. ``bounds``: the curve sorts'
    quantization box (``_quantize_axes``). Returns ``(positions, mask,
    attrs, mean_knn, normals, count[, count2])``; mean, count and count2
    are zero on invalid rows.
    """
    n = positions.shape[-1]
    if _xla_route(backend):
        if shrink_to and shrink_to < n:
            b = subsample_to(ScanBuffer(positions=positions, mask=mask, attributes=attrs),
                             shrink_to)
            positions, mask, attrs = b.positions, b.mask, dict(b.attributes)
        out = (positions, mask, attrs) + fused_neighborhood_stats(
            positions, mask, k=k, radius=radius, window_blocks=window_blocks, passes=passes,
            bounds=bounds, backend="xla",
        )
        if radius2 is None:
            return out
        return out + (window_normal_stats(
            positions, mask, radius2, window_blocks=window_blocks, passes=passes, bounds=bounds,
            backend="xla",
        )[1],)
    lead = mask.shape[:-1]
    flat, specs = [], []
    for name, v in attrs.items():
        rows = v.reshape(lead + (-1, n)).unbind(-2)
        specs.append((name, v.shape, len(rows)))
        flat.extend(rows)

    sx, sy, sz, sv, flat, mean, count, normals, cnt2 = _fused_passes(
        positions, mask, flat, k=k, radius=radius, window_blocks=window_blocks,
        passes=passes, kmode=kmode, shrink_to=shrink_to, radius2=radius2,
        presorted=presorted, entries_merge=entries_merge, carry_count=carry_count,
        bounds=bounds,
    )
    n_out = sx.shape[-1]
    out_attrs, i = {}, 0
    for name, shape, nrows in specs:
        out_attrs[name] = torch.stack(flat[i : i + nrows], dim=-2).reshape(shape[:-1] + (n_out,))
        i += nrows
    out = (
        torch.stack([sx, sy, sz], dim=-2), sv, out_attrs, _masked(mean, sv), normals,
        _masked(count, sv),
    )
    return out if cnt2 is None else out + (_masked(cnt2, sv),)
