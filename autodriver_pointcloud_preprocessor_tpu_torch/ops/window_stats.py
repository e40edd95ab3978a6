"""K3 windowed neighbourhood statistics: CUDA kernel and plain version.

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/pallas_window.py``
(``window_stats_pallas``). The CUDA kernel is ``csrc/window_stats.cu``;
``window_stats`` launches it for CUDA tensors and runs the plain PyTorch
version for CPU tensors, and raises on anything else.

Semantics (the reference's): rows are curve-sorted; each 128-row query
block sees a candidate window of ``window_blocks`` blocks each side, or
for ``window_blocks == 0`` its own block plus the next (``direction`` 0)
or previous (1) one. Non-finite or invalid rows are no candidates.
Distances are taken about a per-block origin (the mean of the block's 128
sanitized rows); the sweep and csel selects compare them with the low 11
mantissa bits cleared, ties broken by window row, and bisect compares them
untruncated. Every mode of the reference is here: 'sweep', 'csel' and
'bisect', the moments on or off, and the second radius's count.

Deliberate deviation: the reference computes d2 with an MXU matmul in
'highest' or 'fast3' precision (``knn_d2mode``); here d2 is the plain f32
sum of squared coordinate differences for both. Rows may carry a leading
batch axis with a squared radius (and second radius) per scan (the
reference's ``custom_vmap`` rule); each scan's windows stop at its own
ends.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

__all__ = ["window_stats", "window_stats_plain"]

B = 128  # query block
_HALF_BIG = 5e29  # the reference's _BIG / 2
_INVALID_KEY = 0x7F800000  # +inf bits: sorts after every finite d2
_TRUNC = ~2047  # clears the 11 low mantissa bits
_CSEL_ITERS = 2
_BISECT_ITERS = 13
_KMODES = {"sweep": 0, "csel": 1, "bisect": 2}
_MAX_K = 64
#: plain version: blocks per chunk, bounding its [blocks, span, 128] temporaries
_PLAIN_CHUNK_ELEMS = 1 << 22


def _window_geometry(window_blocks: int, direction: int) -> Tuple[int, int]:
    """(candidate span, query offset within it) in rows."""
    if window_blocks > 0:
        return (2 * window_blocks + 1) * B, window_blocks * B
    return 2 * B, (0 if direction == 0 else B)


def _tree_sum_128(q: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (128) pairing (t, t + s) for s = 64 .. 1 — the
    kernel's fixed reduction order."""
    s = q.shape[-1] // 2
    while s > 0:
        q = q[..., :s] + q[..., s : 2 * s]
        s //= 2
    return q[..., 0]


def _trunc(d2: torch.Tensor) -> torch.Tensor:
    return (d2.view(torch.int32) & _TRUNC).view(torch.float32)


def window_stats_plain(
    x, y, z, valid, r2: torch.Tensor, k: int, window_blocks: int,
    kmode: str, direction: int, moments: bool, r2b: torch.Tensor | None = None,
):
    """Plain version of K3 (same contract as ``window_stats``, which
    validates the arguments). Rows are [N] or [B, N]; ``r2`` holds the
    squared radius, float32[1] or one per scan [B], and ``r2b``, when
    given, the squared second radius in the same form (a 4th output, the
    in-radius2 count, comes back). A batch runs scan by scan, each with its
    own windows and radii."""
    if x.dim() == 2:
        r2 = r2.reshape(-1).expand(x.shape[0])
        r2b_all = None if r2b is None else r2b.reshape(-1).expand(x.shape[0])
        outs = [
            window_stats_plain(x[i], y[i], z[i], valid[i], r2[i : i + 1], k,
                               window_blocks, kmode, direction, moments,
                               None if r2b_all is None else r2b_all[i : i + 1])
            for i in range(x.shape[0])
        ]
        return tuple(torch.stack(o) for o in zip(*outs))
    n = x.numel()
    dev = x.device
    span, qoff = _window_geometry(window_blocks, direction)
    finite = torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    coords = torch.stack([torch.where(finite, c, zero) for c in (x, y, z)])
    ok = valid & finite

    nb = n // B
    mean = torch.empty(n, dtype=torch.float32, device=dev)
    cnt = torch.empty(n, dtype=torch.float32, device=dev)
    mom = torch.zeros((10, n), dtype=torch.float32, device=dev)
    cnt2 = None if r2b is None else torch.empty(n, dtype=torch.float32, device=dev)
    rows = torch.arange(span, device=dev)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (span * B))
    for b0 in range(0, nb, chunk):
        b1 = min(nb, b0 + chunk)
        g = (torch.arange(b0, b1, device=dev) * B - qoff)[:, None] + rows[None, :]
        inb = (g >= 0) & (g < n)
        gi = g.clamp(0, n - 1)
        cand = torch.where(inb[None], coords[:, gi], zero)  # [3, nbc, span]
        cv = inb & ok[gi]  # [nbc, span]
        c0 = _tree_sum_128(cand[:, :, qoff : qoff + B]) * (1.0 / B)
        cand = cand - c0[:, :, None]
        q = cand[:, :, qoff : qoff + B]
        d = cand[:, :, :, None] - q[:, :, None, :]  # [3, nbc, span, 128]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        del d
        cv3 = cv[:, :, None].expand_as(d2)
        key = (d2.view(torch.int32) & _TRUNC) | rows.to(torch.int32)[None, :, None]
        key = torch.where(cv3, key, torch.full_like(key, _INVALID_KEY))
        if cnt2 is not None:
            cnt2[b0 * B : b1 * B] = (cv3 & (d2 <= r2b)).sum(1).to(torch.float32).reshape(-1)
        if moments:
            w = (cv3 & (d2 <= r2)).to(torch.float32)
            cx, cy, cz = (cand[i][:, :, None] for i in range(3))
            terms = (
                None, cx, cy, cz, cx * cx, cy * cy, cz * cz,
                cx * cy, cx * cz, cy * cz,
            )
            mom[0, b0 * B : b1 * B] = w.sum(1).reshape(-1)
            for i in range(1, 10):  # float terms, double sums (as the kernel)
                s = (w * terms[i]).to(torch.float64).sum(1)
                mom[i, b0 * B : b1 * B] = s.to(torch.float32).reshape(-1)
        if kmode == "sweep":
            top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
            hit = top.view(torch.float32) < _HALF_BIG
            dist = torch.sqrt(torch.clamp((top & _TRUNC).view(torch.float32), min=0.0))
            acc = torch.zeros_like(dist[:, 0])
            hits = torch.zeros_like(acc)
            for j in range(k):  # ascending order, as the kernel adds
                acc = acc + torch.where(hit[:, j], dist[:, j], zero)
                hits = hits + hit[:, j].to(torch.float32)
            m_chunk, c_chunk = acc / torch.clamp(hits, min=1.0), hits
        else:
            # threshold select: csel starts from the own block's k-th
            # (truncated compares), bisect from the own block's max, or
            # the window's when the own block has fewer than k valid rows
            # (untruncated compares)
            hi_full = torch.where(cv3, d2, zero).amax(dim=1)
            if kmode == "csel":
                own = key[:, qoff : qoff + B]
                kth = torch.topk(own, k, dim=1, largest=False, sorted=True).values[:, k - 1]
                sparse = kth.view(torch.float32) >= _HALF_BIG
                hi = torch.where(sparse, hi_full, (kth & _TRUNC).view(torch.float32))
                d2cmp = _trunc(d2)
                iters = _CSEL_ITERS
            else:
                own_ok = cv3[:, qoff : qoff + B]
                hi_own = torch.where(own_ok, d2[:, qoff : qoff + B], zero).amax(dim=1)
                hi = torch.where(own_ok.sum(1) >= k, hi_own, hi_full)
                sparse = torch.zeros_like(hi, dtype=torch.bool)
                d2cmp = d2
                iters = _BISECT_ITERS
            lo = torch.zeros_like(hi)
            for _ in range(iters):
                mid = 0.5 * (lo + hi)
                c = (cv3 & (d2cmp <= mid[:, None, :])).sum(1)
                enough = c >= k
                lo = torch.where(enough, lo, mid)
                hi = torch.where(enough, mid, hi)
            inside = cv3 & (d2cmp <= hi[:, None, :])
            cntf = inside.sum(1).to(torch.float32)
            dist = torch.where(inside, torch.sqrt(torch.clamp(d2, min=0.0)), zero)
            sum_d = dist.to(torch.float64).sum(1).to(torch.float32)
            extra = torch.clamp(cntf - k, min=0.0)
            thr_d = torch.sqrt(torch.clamp(hi, min=0.0))
            mid_d = 0.5 * (thr_d + torch.sqrt(torch.clamp(lo, min=0.0)))
            stand_in = torch.where(sparse, mid_d, thr_d)
            m_chunk = torch.where(
                cntf >= k,
                (sum_d - extra * stand_in) / k,
                sum_d / torch.clamp(cntf, min=1.0),
            )
            m_chunk = torch.clamp(m_chunk, min=0.0)
            c_chunk = torch.clamp(cntf, max=float(k))
        mean[b0 * B : b1 * B] = m_chunk.reshape(-1)
        cnt[b0 * B : b1 * B] = c_chunk.reshape(-1)
    return (mean, cnt, mom) if cnt2 is None else (mean, cnt, mom, cnt2)


def window_stats(
    sorted_x: torch.Tensor,
    sorted_y: torch.Tensor,
    sorted_z: torch.Tensor,
    sorted_valid: torch.Tensor,
    radius: torch.Tensor | float,
    k: int = 20,
    window_blocks: int = 2,
    kmode: str = "sweep",
    direction: int = 0,
    moments: bool = True,
    radius2: torch.Tensor | float | None = None,
) -> Tuple[torch.Tensor, ...]:
    """Windowed stats over curve-sorted planar rows.

    Args:
        sorted_x/y/z: float32[N] or [B, N] positions in curve order
            (N % 128 == 0); a leading axis is a batch of scans.
        sorted_valid: bool, the rows' shape.
        radius: in-radius threshold for the moments: a float, a 0-d
            tensor, or one per scan [B].
        k: neighbour count of the mean-distance statistic (1..64).
        window_blocks: candidate radius in 128-row blocks (0..7); 0 is the
            one-sided window chosen by ``direction``.
        kmode: 'sweep' (exact k-select), 'csel' (own-block threshold
            select, 2 refinements and the at-threshold correction) or
            'bisect' (13 bisections of the untruncated distance from the
            own block's max, and the same correction).
        direction: for ``window_blocks == 0``: 0 = next block, 1 = previous.
        moments: False skips the moments (their rows come back zero).
        radius2: optional second radius (a float, a 0-d tensor, or one per
            scan [B]); when given, a 4th output comes back.
    Returns:
        (mean_knn_dist float32[..., N], knn_count float32[..., N], moments
        float32[..., 10, N][, count2 float32[..., N]]); moments rows are
        [n, Sx, Sy, Sz, Sxx, Syy, Szz, Sxy, Sxz, Syz] over in-radius valid
        candidates (self included) about the block origin; count2 counts
        the valid candidates within ``radius2`` (self included). Entries of
        invalid queries are meaningless.
    """
    if kmode not in _KMODES:
        raise ValueError(f"kmode must be 'sweep', 'csel' or 'bisect', got {kmode!r}")
    if not 0 <= window_blocks <= 7:
        raise ValueError(f"window_blocks={window_blocks} not in 0..7")
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"k={k} not in 1..{_MAX_K}")
    if direction not in (0, 1):
        raise ValueError(f"direction={direction} not in (0, 1)")
    direction = direction if window_blocks == 0 else 0
    rows = (sorted_x, sorted_y, sorted_z)
    shape = sorted_x.shape
    if len(shape) not in (1, 2) or shape[-1] % B or any(
        r.shape != shape or r.dtype != torch.float32 for r in rows
    ):
        raise ValueError("window_stats: x/y/z must be float32[N] or [B, N] with N % 128 == 0")
    if sorted_valid.shape != shape or sorted_valid.dtype != torch.bool:
        raise ValueError(f"window_stats: valid must be bool{list(shape)}")
    batch, n = (shape[0] if len(shape) == 2 else 1), shape[-1]
    dev = sorted_x.device
    if not sorted_x.is_cuda:
        if dev.type != "cpu":
            raise ValueError("window_stats: tensors must be on the CPU or one CUDA device")
        rad = _per_scan(radius, batch, dev)
        rad2 = None if radius2 is None else _per_scan(radius2, batch, dev)
        return window_stats_plain(
            *rows, sorted_valid, rad * rad, k, window_blocks, kmode, direction, moments,
            None if rad2 is None else rad2 * rad2,
        )
    _build.require_cuda("window_stats", *rows, sorted_valid)
    # one radius, or one per scan: the kernel squares it (no host scalar
    # goes to the device here: its copy would synchronise the stream)
    rad = _per_scan(radius, batch, dev)
    rad2 = None if radius2 is None else _per_scan(radius2, batch, dev)
    return _launch_k3(rows, sorted_valid, rad, rad2, k, window_blocks, direction, kmode, moments)


def _launch_k3(rows, valid, rad, rad2, k, window_blocks, direction, kmode, moments):
    """Launch K3 on contiguous device tensors (radii as ``_per_scan``
    gives them); returns its outputs as ``window_stats`` does."""
    shape, dev = rows[0].shape, rows[0].device
    batch, n = (shape[0] if len(shape) == 2 else 1), shape[-1]
    mean = torch.empty(shape, dtype=torch.float32, device=dev)
    cnt = torch.empty(shape, dtype=torch.float32, device=dev)
    mom = torch.empty(shape[:-1] + (10, n), dtype=torch.float32, device=dev)
    cnt2 = None if rad2 is None else torch.empty(shape, dtype=torch.float32, device=dev)
    _build.launch(
        "window_stats", dev, *(r.data_ptr() for r in rows), valid.data_ptr(),
        rad.data_ptr(), int(rad.numel() > 1),
        None if rad2 is None else rad2.data_ptr(), int(rad2 is not None and rad2.numel() > 1),
        mean.data_ptr(), cnt.data_ptr(), mom.data_ptr(),
        None if cnt2 is None else cnt2.data_ptr(),
        batch, n, k, window_blocks, direction, _KMODES[kmode], int(moments),
    )
    return (mean, cnt, mom) if cnt2 is None else (mean, cnt, mom, cnt2)


def _per_scan(radius, batch: int, dev) -> torch.Tensor:
    """A radius (float, 0-d tensor or one per scan) -> float32[1] or
    [batch] on ``dev``."""
    rad = torch.as_tensor(radius, dtype=torch.float32, device=dev).reshape(-1)
    if rad.numel() not in (1, batch):
        raise ValueError(f"window_stats: {rad.numel()} radii for {batch} scans")
    return rad
