"""Port kernels (plain PyTorch versions, CPU) against the reference Pallas
kernels run in interpret mode: K1 masked compaction, K2 segmented sums,
K3 window statistics (every kmode, the moments and the second radius's
count), single-scan and with a batch axis (the reference under
``jax.vmap``). The same numpy inputs, made from a seed, go to both.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodriver_pointcloud_preprocessor_tpu.core import from_soa as ref_from_soa
from autodriver_pointcloud_preprocessor_tpu.ops import window as ref_window
from autodriver_pointcloud_preprocessor_tpu.ops.compact import (
    stream_compact_to as ref_stream_compact_to,
)
from autodriver_pointcloud_preprocessor_tpu.ops.pallas_segmean import (
    masked_compact_pallas,
    segmented_sums_pallas,
)
from autodriver_pointcloud_preprocessor_tpu.ops.pallas_window import (
    window_stats_pallas,
)
from autodriver_pointcloud_preprocessor_tpu_torch.convert import scan_from_reference
from autodriver_pointcloud_preprocessor_tpu_torch.ops import window as port_window
from autodriver_pointcloud_preprocessor_tpu_torch.ops.compact import stream_compact_to
from autodriver_pointcloud_preprocessor_tpu_torch.ops.segmean import (
    masked_compact,
    segmented_sums,
)
from autodriver_pointcloud_preprocessor_tpu_torch.ops.window_stats import window_stats


# ---------------------------------------------------------------- K1 ----

@pytest.mark.parametrize("n", [512, 4096])
@pytest.mark.parametrize("c", [1, 5, 8])
def test_masked_compact_matches_reference(n, c):
    rng = np.random.default_rng(100 * c + n)
    vals = rng.normal(0, 10, (c, n)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.4
    vals[:, ~mask] = np.nan  # dead rows hold NaN, as in the pipeline
    ref = np.asarray(
        masked_compact_pallas(jnp.asarray(vals), jnp.asarray(mask), interpret=True)
    )
    out = masked_compact(torch.from_numpy(vals), torch.from_numpy(mask)).numpy()
    live = int(mask.sum())
    np.testing.assert_array_equal(out[:, :live], ref[:, :live])
    assert (out[:, live:] == 0).all()
    # a smaller capacity keeps the first live columns
    cap = live // 2
    small = masked_compact(torch.from_numpy(vals), torch.from_numpy(mask), cap)
    np.testing.assert_array_equal(small.numpy(), ref[:, :cap])


def test_stream_compact_to_bit_exact(rng):
    n, cap = 4096, 2048
    pts = rng.normal(0, 20, (n, 3)).astype(np.float32)
    pts[::37] = np.nan
    buf, _ = ref_from_soa(
        {
            "positions": pts,
            "intensity": rng.uniform(0, 255, n).astype(np.float32),
            "ring": rng.integers(0, 32, n).astype(np.uint16),
        },
        capacity=n,
    )
    keep = rng.uniform(size=n) < 0.45
    buf = buf.with_mask(jnp.asarray(keep) & jnp.isfinite(buf.positions[0]))
    ref = ref_stream_compact_to(buf, cap, backend="pallas_interpret")
    port = stream_compact_to(
        scan_from_reference(
            np.asarray(buf.positions), np.asarray(buf.mask),
            {k: np.asarray(v) for k, v in buf.attributes.items()},
            device="cpu",
        ),
        cap,
    )
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(port.positions.numpy(), np.asarray(ref.positions))
    for name in ("intensity", "ring"):
        np.testing.assert_array_equal(
            port.attributes[name].numpy(), np.asarray(ref.attributes[name])
        )
        assert port.attributes[name].dtype == buf_dtype(buf, name)
    dead = ~port.mask.numpy()
    assert dead.any() and (port.positions.numpy()[:, dead] == 0).all()


def buf_dtype(buf, name):
    return {np.float32: torch.float32, np.int32: torch.int32}[
        np.asarray(buf.attributes[name]).dtype.type
    ]


# ---------------------------------------------------------------- K2 ----

def _run_flags(kind, n, rng):
    flags = np.zeros(n, bool)
    if kind == "random":
        flags = rng.uniform(size=n) < 0.13
    elif kind == "block_crossing":
        flags[[0, 500, 512, 513, 1023, 1024, 1536, 2047, 3000]] = True
    elif kind == "singletons":
        flags[:] = True
    flags[0] = True
    return flags


@pytest.mark.parametrize("kind", ["random", "block_crossing", "single", "singletons"])
def test_segmented_sums_matches_reference(kind):
    rng = np.random.default_rng(7)
    n = 4096
    flags = _run_flags(kind, n, rng)
    vals = rng.normal(0, 3, (6, n)).astype(np.float32)
    ref = np.asarray(
        segmented_sums_pallas(jnp.asarray(vals), jnp.asarray(flags), interpret=True)
    )
    out = segmented_sums(torch.from_numpy(vals), torch.from_numpy(flags)).numpy()
    runs = int(flags[1:].sum()) + 1
    seg = np.cumsum(flags) - 1
    abs_sums = np.zeros((6, n), np.float64)
    for c in range(6):
        np.add.at(abs_sums[c], seg, np.abs(vals[c]))
    err = np.abs(out[:, :runs] - ref[:, :runs])
    assert (err <= 1e-6 * np.abs(ref[:, :runs]) + 1e-6 * abs_sums[:, :runs]).all()
    assert (out[:, runs:] == 0).all() and (ref[:, runs:] == 0).all()


# ---------------------------------------------------------------- K3 ----

_N = 4096


def _curve_sorted_cloud(seed):
    """Clustered scene in pass-0 curve order, with invalid and NaN rows and
    one query block holding fewer than k valid rows (sparse own block)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-8, 8, (12, 3))
    pts = (centers[rng.integers(0, 12, _N)] + rng.normal(0, 0.6, (_N, 3))).astype(np.float32)
    valid = np.ones(_N, bool)
    codes = np.asarray(ref_window.hilbert_codes(jnp.asarray(pts.T), jnp.asarray(valid)))
    order = np.argsort(codes, kind="stable")
    pts, valid = pts[order], valid[order]
    valid[rng.uniform(size=_N) < 0.03] = False
    pts[rng.integers(0, _N, 20)] = np.nan  # NaN rows (valid flag kept)
    valid[5 * 128 : 6 * 128] = False
    valid[5 * 128 : 5 * 128 + 5] = True  # sparse own block: 5 valid < k
    valid[-200:] = False  # dead tail, as after compaction
    return pts, valid


def _windows(wb, direction):
    if wb > 0:
        return (2 * wb + 1) * 128, wb * 128
    return 256, (0 if direction == 0 else 128)


def _window_span(pts, valid, wb, direction):
    """Per-query largest coordinate extent of its block's valid window."""
    span, qoff = _windows(wb, direction)
    ok = valid & np.isfinite(pts).all(1)
    out = np.zeros(_N)
    for b in range(_N // 128):
        lo, hi = max(0, b * 128 - qoff), min(_N, b * 128 - qoff + span)
        p = pts[lo:hi][ok[lo:hi]]
        out[b * 128 : (b + 1) * 128] = (p.max(0) - p.min(0)).max() if len(p) else 0.0
    return out


def _oracle(pts, valid, wb, direction, k, r2):
    """Float64 window oracle: per query, the exact mean distance to the k
    nearest valid candidates, the in-radius count, and whether a candidate
    lies within 1e-5 of r^2 (where f32 rounding may move it across)."""
    span, qoff = _windows(wb, direction)
    ok = valid & np.isfinite(pts).all(1)
    p64 = np.where(np.isfinite(pts), pts, 0).astype(np.float64)
    mean, count, boundary = np.zeros(_N), np.zeros(_N), np.zeros(_N, bool)
    for q in range(_N):
        b = q // 128
        lo, hi = max(0, b * 128 - qoff), min(_N, b * 128 - qoff + span)
        d2 = ((p64[lo:hi][ok[lo:hi]] - p64[q]) ** 2).sum(1)
        mean[q] = np.sqrt(np.sort(d2)[:k]).mean() if len(d2) else 0.0
        count[q] = (d2 <= r2).sum()
        boundary[q] = (np.abs(d2 - r2) <= 1e-5 * r2).any()
    return mean, count, boundary


def _both(pts, valid, radius, k, wb, direction, kmode, d2mode):
    ref = window_stats_pallas(
        *(jnp.asarray(pts[:, i]) for i in range(3)), jnp.asarray(valid), radius,
        k=k, window_blocks=wb, interpret=True, kmode=kmode, direction=direction,
        d2mode=d2mode,
    )
    port = window_stats(
        *(torch.from_numpy(np.ascontiguousarray(pts[:, i])) for i in range(3)),
        torch.from_numpy(valid), radius, k=k, window_blocks=wb, kmode=kmode,
        direction=direction,
    )
    return [np.asarray(a) for a in ref], [a.numpy() for a in port]


@pytest.mark.parametrize(
    "wb,direction,k", [(0, 0, 8), (0, 1, 20), (1, 0, 20), (2, 0, 8)]
)
def test_window_stats_sweep_matches_reference(wb, direction, k):
    pts, valid = _curve_sorted_cloud(seed=wb * 10 + direction + k)
    radius = 0.35
    r2 = float(np.float32(radius) ** 2)
    ref, port = _both(pts, valid, radius, k, wb, direction, "sweep", "highest")
    _check_sweep(pts, valid, ref, port, wb, direction, k, r2)


def _check_sweep(pts, valid, ref, port, wb, direction, k, r2):
    """The sweep criteria: port and reference (mean, count, moments) of
    one scan against each other and a float64 oracle."""
    live = valid & np.isfinite(pts).all(1)
    exact, exact_count, boundary = _oracle(pts, valid, wb, direction, k, r2)
    # the port is exact up to the 11-bit d2 truncation (2^-13 of a distance)
    err_port = np.abs(port[0] - exact) / np.maximum(exact, 1e-9)
    assert (err_port[live] <= 2.0**-10).all(), err_port[live].max()
    # against the reference: within 2^-10 for >= 99% of queries (measured
    # 99.67% or more); the rest are queries whose window spans two
    # clusters, where the reference's |c|^2 + |q|^2 - 2 c.q distance
    # cancels, and on every one of them the port is the one closer to the
    # exact value (ROADMAP, faults found)
    rel = np.abs(port[0] - ref[0]) / np.maximum(ref[0], 1e-6)
    far = live & (rel > 2.0**-10)
    assert far.sum() <= 1e-2 * live.sum(), far.sum()
    err_ref = np.abs(ref[0] - exact) / np.maximum(exact, 1e-9)
    assert (err_port[far] < err_ref[far]).all()
    np.testing.assert_array_equal(port[1][live], ref[1][live])  # k-select hits
    # in-radius counts: exact except next to the radius, and equal to the
    # reference's on >= 99.9% of queries
    cnt = port[2][0]
    assert (cnt == exact_count)[live & ~boundary].all()
    diff = cnt != ref[2][0]
    assert diff[live].mean() <= 1e-3
    # moments, compared as centered covariance entries
    agree = live & ~diff
    e_ref = np.asarray(ref_window._entries_from_moments(jnp.asarray(ref[2])))
    e_port = port_window._entries_from_moments(torch.from_numpy(port[2])).numpy()
    tol = 1e-4 * _window_span(pts, valid, wb, direction) ** 2
    assert (np.abs(e_port - e_ref)[:, agree] <= tol[agree]).all()


@pytest.mark.parametrize("wb,direction", [(1, 0), (0, 1)])
def test_window_stats_csel_matches_reference(wb, direction):
    pts, valid = _curve_sorted_cloud(seed=3 + wb)
    ref_hi, port = _both(pts, valid, 0.35, 20, wb, direction, "csel", "highest")
    ref_f3, _ = _both(pts, valid, 0.35, 20, wb, direction, "csel", "fast3")
    sparse = np.zeros(_N, bool)
    sparse[5 * 128 : 5 * 128 + 5] = True
    _check_csel(pts, valid, ref_hi, ref_f3, port, sparse)


def _check_csel(pts, valid, ref_hi, ref_f3, port, sparse):
    """The csel criteria for one scan; ``sparse`` marks the queries of the
    block with fewer than k valid rows."""
    live = valid & np.isfinite(pts).all(1)
    assert np.isfinite(port[0]).all() and (port[0] >= 0).all()
    np.testing.assert_array_equal(port[1][live], ref_hi[1][live])
    # same select on (nearly) the same distances: within 1e-3 for >= 99%
    rel = np.abs(port[0] - ref_hi[0]) / np.maximum(ref_hi[0], 1e-6)
    assert (rel[live] <= 1e-3).mean() >= 0.99
    # the shipped 'fast3' distances carry ~2^-16 of the window span^2, which
    # moves csel's threshold band: within 1e-2 for >= 99% (measured 1e-3
    # for only 90.7% .. 94.8%; ROADMAP, faults found)
    rel = np.abs(port[0] - ref_f3[0]) / np.maximum(ref_f3[0], 1e-6)
    assert (rel[live] <= 1e-2).mean() >= 0.99
    # the sparse own block's queries take the band-midpoint stand-in
    np.testing.assert_allclose(port[0][sparse], ref_hi[0][sparse], rtol=1e-3)


# ------------------------------------------------------- batch axis ----
#
# The batched plain versions against the reference's kernels under
# jax.vmap (its custom_vmap rule: a batch grid axis), element by element,
# and against the same scan run alone.

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_masked_compact_batch_matches_reference_vmap():
    rng = np.random.default_rng(21)
    b, c, n = 3, 5, 2048
    vals = rng.normal(0, 10, (b, c, n)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) < np.array([[0.4], [0.9], [0.0]])  # scan 2: none live
    vals[np.broadcast_to(~mask[:, None, :], vals.shape)] = np.nan
    ref = np.asarray(jax.vmap(functools.partial(masked_compact_pallas, interpret=True))(
        jnp.asarray(vals), jnp.asarray(mask)))
    for cap in (n, 700):
        out = masked_compact(_t(vals), _t(mask), cap).numpy()
        assert out.shape == (b, c, cap)
        for i in range(b):
            # ranks count within each scan: scan i's first live column
            # lands in its own column 0
            live = min(int(mask[i].sum()), cap)
            np.testing.assert_array_equal(out[i, :, :live].view(np.int32),
                                          ref[i, :, :live].view(np.int32))
            assert (out[i, :, live:] == 0).all()
            alone = masked_compact(_t(vals[i]), _t(mask[i]), cap).numpy()
            np.testing.assert_array_equal(out[i].view(np.int32), alone.view(np.int32))


def test_segmented_sums_batch_matches_reference_vmap():
    rng = np.random.default_rng(22)
    n = 4096
    flags = np.stack([_run_flags(k, n, rng) for k in ("random", "block_crossing", "singletons")])
    flags[1, 0] = False  # each scan's column 0 opens its run 0 whatever its flag
    vals = rng.normal(0, 3, (3, 6, n)).astype(np.float32)
    ref = np.asarray(jax.vmap(functools.partial(segmented_sums_pallas, interpret=True))(
        jnp.asarray(vals), jnp.asarray(flags)))
    out = segmented_sums(_t(vals), _t(flags)).numpy()
    for i in range(3):
        runs = int(flags[i, 1:].sum()) + 1
        seg = np.cumsum(np.r_[False, flags[i, 1:]])
        abs_sums = np.zeros((6, n), np.float64)
        for ch in range(6):
            np.add.at(abs_sums[ch], seg, np.abs(vals[i, ch]))
        err = np.abs(out[i, :, :runs] - ref[i, :, :runs])
        assert (err <= 1e-6 * np.abs(ref[i, :, :runs]) + 1e-6 * abs_sums[:, :runs]).all()
        assert (out[i, :, runs:] == 0).all() and (ref[i, :, runs:] == 0).all()
        alone = segmented_sums(_t(vals[i]), _t(flags[i])).numpy()
        np.testing.assert_array_equal(out[i], alone)


def _batched_clouds():
    """Two scans in one batch: scan 0 is a clustered cloud whose last rows
    are live, scan 1 the same rows reversed. Were the batch one flat row,
    scan 0's last blocks would see their own points (scan 1's first rows)
    through the window edge."""
    pts, valid = _curve_sorted_cloud(seed=41)
    valid[-200:] = True
    return np.stack([pts, pts[::-1]]), np.stack([valid, valid[::-1]])


@pytest.mark.parametrize("kmode", ["sweep", "csel"])
def test_window_stats_batch_matches_reference_vmap(kmode):
    wb, direction, k = (2, 0, 8) if kmode == "sweep" else (1, 0, 20)
    pts, valid = _batched_clouds()
    radius = np.float32([0.3, 0.4])  # one radius per scan

    def ref(d2mode):
        fn = functools.partial(window_stats_pallas, k=k, window_blocks=wb, interpret=True,
                               kmode=kmode, direction=direction, d2mode=d2mode)
        out = jax.vmap(fn)(*(jnp.asarray(pts[..., c]) for c in range(3)),
                           jnp.asarray(valid), jnp.asarray(radius))
        return [np.asarray(a) for a in out]

    args = dict(k=k, window_blocks=wb, kmode=kmode, direction=direction)
    rows = [_t(pts[..., c]) for c in range(3)]
    port = [a.numpy() for a in window_stats(*rows, _t(valid), _t(radius), **args)]
    ref_hi = ref("highest")
    ref_f3 = ref("fast3") if kmode == "csel" else None
    for i in range(2):
        r_i, p_i = [a[i] for a in ref_hi], [a[i] for a in port]
        if kmode == "sweep":
            _check_sweep(pts[i], valid[i], r_i, p_i, wb, direction, k, float(radius[i]) ** 2)
        else:
            sparse = np.zeros(_N, bool)
            sparse[5 * 128 : 5 * 128 + 5] = True
            _check_csel(pts[i], valid[i], r_i, [a[i] for a in ref_f3], p_i,
                        sparse if i == 0 else sparse[::-1])
        alone = window_stats(*(r[i] for r in rows), _t(valid[i]), float(radius[i]), **args)
        for got, want in zip(p_i, alone):
            np.testing.assert_array_equal(got, want.numpy())
    # one flat row would reach across the element edge: scan 0's last
    # block comes out differently
    flat = window_stats(*(r.reshape(-1) for r in rows), _t(valid).reshape(-1),
                        float(radius[0]), **args)[0].numpy()
    edge = slice(_N - 128, _N)
    assert not np.array_equal(flat[edge], port[0][0][edge])


# ------------------------------------------- K3 bisect and radius2 ----
#
# One reference call per window gives both: kmode='bisect' with radius2.

_R, _R2, _K = 0.35, 0.5, 20


@functools.lru_cache(maxsize=None)
def _bisect_r2_case(wb, direction):
    """(pts, valid, reference outputs, port bisect outputs, port sweep mean)
    of one clustered cloud."""
    pts, valid = _curve_sorted_cloud(seed=60 + wb * 10 + direction)
    ref = window_stats_pallas(
        *(jnp.asarray(pts[:, i]) for i in range(3)), jnp.asarray(valid), _R,
        k=_K, window_blocks=wb, interpret=True, kmode="bisect", direction=direction,
        radius2=_R2,
    )
    rows = [_t(pts[:, i]) for i in range(3)]
    args = dict(k=_K, window_blocks=wb, direction=direction)
    port = window_stats(*rows, _t(valid), _R, kmode="bisect", radius2=_R2, **args)
    sweep = window_stats(*rows, _t(valid), _R, kmode="sweep", **args)[0]
    return pts, valid, [np.asarray(a) for a in ref], [a.numpy() for a in port], sweep.numpy()


_BISECT_CASES = [(0, 1), (1, 0), (2, 0)]


def _check_radius2(pts, valid, ref, port, wb, direction):
    """count2 against the reference's row 12 and a float64 window oracle."""
    live = valid & np.isfinite(pts).all(1)
    _, exact_count2, _ = _oracle(pts, valid, wb, direction, _K, float(np.float32(_R2) ** 2))
    # equal to the float64 oracle on every valid query
    np.testing.assert_array_equal(port[3][live], exact_count2[live])
    # and to the reference's matmul-distance count on >= 99.5% of them
    # (its d2 may move a candidate across the radius; measured 100%)
    assert (port[3] == ref[3])[live].mean() >= 0.995


@pytest.mark.parametrize("wb,direction", _BISECT_CASES)
def test_window_stats_radius2_matches_reference(wb, direction):
    pts, valid, ref, port, _ = _bisect_r2_case(wb, direction)
    assert len(port) == len(ref) == 4
    _check_radius2(pts, valid, ref, port, wb, direction)
    # the second radius leaves the other outputs as they were
    rows = [_t(pts[:, i]) for i in range(3)]
    plain = window_stats(*rows, _t(valid), _R, k=_K, window_blocks=wb, kmode="bisect",
                         direction=direction)
    assert len(plain) == 3
    for got, want in zip(port[:3], plain):
        np.testing.assert_array_equal(got, want.numpy())


def _check_bisect(pts, valid, ref, port, sweep, sparse):
    """The bisect criteria for one scan; ``sparse`` marks the queries of
    the block with fewer than k valid rows (window-max start)."""
    live = valid & np.isfinite(pts).all(1)
    assert np.isfinite(port[0]).all() and (port[0] >= 0).all()
    np.testing.assert_array_equal(port[1][live], ref[1][live])
    # the same bisection on (nearly) the same distances: within 1e-3 for
    # >= 99% of valid queries and 1e-2 for all (measured <= 4e-4 for all)
    rel = np.abs(port[0] - ref[0]) / np.maximum(ref[0], 1e-6)
    assert (rel[live] <= 1e-3).mean() >= 0.99
    assert (rel[live] <= 1e-2).all(), rel[live].max()
    # 13 bisections land within 1e-2 of the exact sweep for >= 99%
    rel = np.abs(port[0] - sweep) / np.maximum(sweep, 1e-6)
    assert (rel[live] <= 1e-2).mean() >= 0.99
    # the sparse own block's queries start from the window max
    np.testing.assert_allclose(port[0][sparse], ref[0][sparse], rtol=1e-3)


@pytest.mark.parametrize("wb,direction", _BISECT_CASES)
def test_window_stats_bisect_matches_reference(wb, direction):
    pts, valid, ref, port, sweep = _bisect_r2_case(wb, direction)
    sparse = np.zeros(_N, bool)
    sparse[5 * 128 : 5 * 128 + 5] = True
    assert valid[sparse].all() and valid[5 * 128 : 6 * 128].sum() < _K
    _check_bisect(pts, valid, ref, port, sweep, sparse)


def test_window_stats_bisect_radius2_batch_matches_reference_vmap():
    wb, direction = 1, 0
    pts, valid = _batched_clouds()
    radius, radius2 = np.float32([0.3, 0.4]), np.float32([0.45, 0.6])  # one each per scan
    fn = functools.partial(window_stats_pallas, k=_K, window_blocks=wb, interpret=True,
                           kmode="bisect", direction=direction)
    ref = jax.vmap(lambda x, y, z, v, r, r2: fn(x, y, z, v, r, radius2=r2))(
        *(jnp.asarray(pts[..., c]) for c in range(3)), jnp.asarray(valid),
        jnp.asarray(radius), jnp.asarray(radius2),
    )
    ref = [np.asarray(a) for a in ref]
    rows = [_t(pts[..., c]) for c in range(3)]
    args = dict(k=_K, window_blocks=wb, direction=direction)
    port = [a.numpy() for a in window_stats(*rows, _t(valid), _t(radius), kmode="bisect",
                                            radius2=_t(radius2), **args)]
    sweep = window_stats(*rows, _t(valid), _t(radius), kmode="sweep", **args)[0].numpy()
    sparse = np.zeros(_N, bool)
    sparse[5 * 128 : 5 * 128 + 5] = True
    for i in range(2):
        r_i, p_i = [a[i] for a in ref], [a[i] for a in port]
        live = valid[i] & np.isfinite(pts[i]).all(1)
        _, exact_count2, _ = _oracle(pts[i], valid[i], wb, direction, _K,
                                     float(radius2[i]) ** 2)
        np.testing.assert_array_equal(p_i[3][live], exact_count2[live])
        assert (p_i[3] == r_i[3])[live].mean() >= 0.995
        _check_bisect(pts[i], valid[i], r_i, p_i, sweep[i], sparse if i == 0 else sparse[::-1])
        alone = window_stats(*(r[i] for r in rows), _t(valid[i]), float(radius[i]),
                             kmode="bisect", radius2=float(radius2[i]), **args)
        for got, want in zip(p_i, alone):
            np.testing.assert_array_equal(got, want.numpy())


def test_window_stats_rejects_unported_modes():
    x = torch.zeros(256)
    v = torch.ones(256, dtype=torch.bool)
    with pytest.raises(ValueError):
        window_stats(x, x, x, v, 0.1, kmode="nope")
    with pytest.raises(ValueError):
        window_stats(x, x, x, v, 0.1, window_blocks=8)
    with pytest.raises(ValueError):
        window_stats(x[:200], x[:200], x[:200], v[:200], 0.1)
    with pytest.raises(ValueError):
        window_stats(x, x, x, v, 0.1, radius2=torch.ones(3))
