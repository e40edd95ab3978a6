"""The port's neighbourhood ops against the reference, on the CPU: exact
kNN, the hash-priority cap, the standalone window ops, the fused
neighbourhood in its unsorting and reordering forms, and the three
filters built on them (statistical outliers, radius outliers, normals).

The same numpy inputs, made from a seed, go to both packages. The
reference's window kernel runs in Pallas interpret mode, as its own tests
run it. Where a test compares outputs in the last pass's curve order, the
points are matched by position: the port's re-sorts are stable and the
reference's are not, so the two may order ties differently.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodriver_pointcloud_preprocessor_tpu.core.scan import ScanBuffer as RefScanBuffer
from autodriver_pointcloud_preprocessor_tpu.ops.compact import shrink_front as ref_shrink_front
from autodriver_pointcloud_preprocessor_tpu.ops.compact import subsample_to as ref_subsample_to
from autodriver_pointcloud_preprocessor_tpu.ops import knn as ref_knn
from autodriver_pointcloud_preprocessor_tpu.ops import normals as ref_normals
from autodriver_pointcloud_preprocessor_tpu.ops import outliers as ref_outliers
from autodriver_pointcloud_preprocessor_tpu.ops import radius_outliers as ref_radius
from autodriver_pointcloud_preprocessor_tpu.ops import window as ref_window
from autodriver_pointcloud_preprocessor_tpu_torch import core
from autodriver_pointcloud_preprocessor_tpu_torch.ops import (
    knn, normals, outliers, radius_outliers, window,
)
from autodriver_pointcloud_preprocessor_tpu_torch.ops.compact import shrink_front, subsample_to

_N = 4096
_INTERP = "pallas_interpret"
_R, _R2, _K = 0.3, 0.45, 20


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _cloud(seed, n=_N, spread=4.0):
    """Clustered cloud (positions [3, n], mask [n]) with dead rows, NaN
    dead rows among them, and a few isolated points."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (10, 3))
    pts = centers[rng.integers(0, 10, n)] + rng.normal(0, 0.35, (n, 3))
    pts[rng.integers(0, n, 40)] = rng.uniform(-2 * spread, 2 * spread, (40, 3))
    pts = pts.astype(np.float32).T.copy()
    mask = rng.uniform(size=n) < 0.9
    nan_rows = rng.integers(0, n, 15)
    pts[:, nan_rows] = np.nan
    mask[nan_rows] = False
    return pts, mask


def _ref_buf(pts, mask):
    return RefScanBuffer(positions=jnp.asarray(pts), mask=jnp.asarray(mask), attributes={})


def _port_buf(pts, mask):
    return core.ScanBuffer(positions=_t(pts), mask=_t(mask), attributes={})


def _normal_agreement(a, b, sel):
    """Share of the selected points whose unit normals (rows [3, N]) agree
    within 2 degrees, sign-agnostic."""
    cos = np.abs((np.asarray(a) * np.asarray(b)).sum(0))[sel]
    return float((cos >= np.cos(np.deg2rad(2.0))).mean())


# ------------------------------------------------------------- knn_exact ----

def test_knn_exact_matches_reference():
    pts, mask = _cloud(1, n=2048, spread=2.0)
    pts = np.nan_to_num(pts)  # the reference forms |q|^2 + |c|^2 - 2 q.c
    k = 12
    ref_d, ref_i = (np.asarray(a) for a in ref_knn.knn_exact(jnp.asarray(pts), jnp.asarray(mask), k + 1))
    d, i = knn.knn_exact(_t(pts), _t(mask), k + 1, query_tile=256)
    d, i = d.numpy(), i.numpy()
    assert d.shape == (2048, k + 1) and (np.diff(d, axis=1) >= 0).all()
    # squared distances within 1e-5 (the reference's cancellation at this
    # scale, measured 5e-6)
    np.testing.assert_allclose(d[mask, :k], ref_d[mask, :k], rtol=0, atol=1e-5)
    # the same neighbours wherever the k + 1 distances are distinct
    gaps = np.diff(ref_d[mask], axis=1).min(1) > 1e-4
    same = [set(a[:k]) == set(b[:k]) for a, b in zip(i[mask][gaps], ref_i[mask][gaps])]
    assert gaps.mean() > 0.5 and all(same)
    # too few live points: the missing neighbours are +inf
    few = np.zeros(2048, bool)
    few[:5] = True
    d_few = knn.knn_exact(_t(pts), _t(few), 8)[0].numpy()
    assert np.isinf(d_few[:, 5:]).all() and np.isfinite(d_few[:, :5]).all()
    # a batch: each scan finds its neighbours among its own points
    both_d, both_i = knn.knn_exact(_t(np.stack([pts, pts[:, ::-1]])),
                                   _t(np.stack([mask, mask[::-1]])), k + 1)
    np.testing.assert_array_equal(both_d[0].numpy(), d)
    np.testing.assert_array_equal(both_i[0].numpy(), i)
    np.testing.assert_array_equal(both_d[1].numpy()[::-1], d)


# ----------------------------------------------------------- subsample_to ----

@pytest.mark.parametrize("cap", [1024, 3584])
def test_subsample_to_bit_exact_against_reference(cap):
    rng = np.random.default_rng(cap)
    pts, mask = _cloud(2)
    attrs = {"intensity": rng.uniform(0, 255, _N).astype(np.float32),
             "normals": rng.normal(size=(3, _N)).astype(np.float32)}
    ref = ref_subsample_to(
        RefScanBuffer(positions=jnp.asarray(pts), mask=jnp.asarray(mask),
                      attributes={k: jnp.asarray(v) for k, v in attrs.items()}), cap)
    port = subsample_to(
        core.ScanBuffer(positions=_t(pts), mask=_t(mask),
                        attributes={k: _t(v) for k, v in attrs.items()}), cap)
    live = np.asarray(ref.mask)
    np.testing.assert_array_equal(port.mask.numpy(), live)
    assert port.capacity == cap and live.sum() == min(cap, mask.sum())
    # the live prefix bit for bit (the reference's unstable sort leaves the
    # order of its dead tail open)
    np.testing.assert_array_equal(port.positions.numpy()[:, live].view(np.int32),
                                  np.asarray(ref.positions)[:, live].view(np.int32))
    for k in attrs:
        np.testing.assert_array_equal(port.attributes[k].numpy()[..., live],
                                      np.asarray(ref.attributes[k])[..., live])
    # a batch: each scan subsamples on its own, as it does alone
    pts2, mask2 = _cloud(3)
    both = subsample_to(
        core.stack_buffers([_port_buf(pts, mask), _port_buf(pts2, mask2)]), cap)
    for got, (p, m) in zip(core.unstack_buffer(both), ((pts, mask), (pts2, mask2))):
        alone = subsample_to(_port_buf(p, m), cap)
        assert torch.equal(got.mask, alone.mask)
        assert torch.equal(got.positions.view(torch.int32), alone.positions.view(torch.int32))


def test_shrink_front_keeps_each_scans_prefix():
    pts, mask = _cloud(4)
    both = core.stack_buffers([_port_buf(pts, mask), _port_buf(pts[:, ::-1].copy(), mask[::-1].copy())])
    out = shrink_front(both, 1024)
    assert out.positions.shape == (2, 3, 1024) and out.mask.shape == (2, 1024)
    ref = ref_shrink_front(_ref_buf(pts, mask), 1024)
    np.testing.assert_array_equal(out.mask[0].numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(out.mask[1].numpy(), mask[::-1][:1024])


# ------------------------------------------------------ standalone window ----

@functools.lru_cache(maxsize=None)
def _ref_mean_knn(seed):
    pts, mask = _cloud(seed)
    return np.asarray(ref_window.window_mean_knn_dist(
        jnp.asarray(pts), jnp.asarray(mask), k=_K, window_blocks=1, passes=2, backend=_INTERP))


@functools.lru_cache(maxsize=None)
def _ref_normal_stats(seed):
    pts, mask = _cloud(seed)
    ent, cnt = ref_window.window_normal_stats(
        jnp.asarray(pts), jnp.asarray(mask), _R, window_blocks=(1, 0), passes=2, backend=_INTERP)
    return np.asarray(ent), np.asarray(cnt)


def test_window_mean_knn_dist_matches_reference():
    pts, mask = _cloud(5)
    ref = _ref_mean_knn(5)
    port = window.window_mean_knn_dist(_t(pts), _t(mask), k=_K, window_blocks=1, passes=2).numpy()
    assert (port[~mask] == 0).all() and (ref[~mask] == 0).all()
    # the sweep on (nearly) the same distances: within 2^-10 for >= 99%
    # of live points (the rest: the reference's matmul distance cancels,
    # ROADMAP fault 1)
    rel = np.abs(port - ref) / np.maximum(ref, 1e-6)
    assert (rel[mask] <= 2.0**-10).mean() >= 0.99
    assert (rel[mask] <= 1e-2).all()


def test_window_normal_stats_matches_reference():
    pts, mask = _cloud(6)
    ref_e, ref_c = _ref_normal_stats(6)
    ent, cnt = window.window_normal_stats(_t(pts), _t(mask), _R, window_blocks=(1, 0), passes=2)
    ent, cnt = ent.numpy(), cnt.numpy()
    assert ent.shape == (6, _N) and (cnt[~mask] == 0).all()
    # in-radius counts equal but next to the radius (>= 99.9%)
    same = cnt == ref_c
    assert same[mask].mean() >= 0.999
    # covariance entries of the points whose count agrees: within 1e-4 of
    # the window's squared extent (float sums in another order)
    sel = mask & same
    assert np.abs(ent - ref_e)[:, sel].max() <= 1e-4 * 10.0**2
    nrm = ref_normals._normals_from_entries(*map(jnp.asarray, ref_e), jnp.asarray(ref_c))
    port_n = normals._normals_from_entries(*map(_t, ent), _t(cnt)).numpy()
    assert _normal_agreement(port_n, nrm, sel) >= 0.99


# ------------------------------------------------------- the three filters ----

def test_remove_statistical_outliers_matches_reference():
    pts, mask = _cloud(5)
    for method in ("window", "exact"):
        port = outliers.remove_statistical_outliers(
            _port_buf(pts, mask), _K, 2.0, method=method, window_blocks=1, passes=2)
        if method == "window":  # the reference filter is this mean and its threshold
            ref_keep = mask & np.asarray(_stat_keep(jnp.asarray(_ref_mean_knn(5)), mask))
        else:
            ref_keep = np.asarray(ref_outliers.remove_statistical_outliers(
                _ref_buf(np.nan_to_num(pts), mask), _K, 2.0, method="exact").mask)
        keep = port.mask.numpy()
        assert not keep[~mask].any() and keep.sum() < mask.sum()
        # the threshold moves a boundary point at most (<= 0.5% of live)
        assert (keep != ref_keep)[mask].mean() <= 5e-3, method


def _stat_keep(mean_d, mask):
    """The reference's statistical threshold (ops/outliers.py:63-69)."""
    valid = jnp.asarray(mask)
    n_live = jnp.maximum(jnp.sum(valid), 1)
    mu = jnp.sum(jnp.where(valid, mean_d, 0.0)) / n_live
    var = jnp.sum(jnp.where(valid, (mean_d - mu) ** 2, 0.0)) / n_live
    return mean_d <= mu + 2.0 * jnp.sqrt(var)


def test_remove_radius_outliers_matches_reference():
    pts, mask = _cloud(6)
    nb = 12
    for method in ("window", "exact"):
        port = radius_outliers.remove_radius_outliers(
            _port_buf(pts, mask), nb, _R, method=method, window_blocks=(1, 0), passes=2)
        if method == "window":
            ref_keep = mask & (_ref_normal_stats(6)[1] >= nb)
        else:
            ref_keep = np.asarray(ref_radius.remove_radius_outliers(
                _ref_buf(np.nan_to_num(pts), mask), nb, _R, method="exact").mask)
        keep = port.mask.numpy()
        assert not keep[~mask].any() and 0 < keep.sum() < mask.sum()
        assert (keep != ref_keep)[mask].mean() <= 2e-3, method


def test_estimate_normals_matches_reference():
    pts, mask = _cloud(6)
    for method in ("window", "exact"):
        port = normals.estimate_normals(_port_buf(pts, mask), _R, 30, method=method,
                                        window_blocks=(1, 0), passes=2)
        if method == "window":
            ent, cnt = _ref_normal_stats(6)
            ref_n = ref_normals._normals_from_entries(*map(jnp.asarray, ent), jnp.asarray(cnt))
        else:
            ref_n = ref_normals.estimate_normals(
                _ref_buf(np.nan_to_num(pts), mask), _R, 30, method="exact").attributes["normals"]
        got = port.attributes["normals"].numpy()
        assert got.shape == (3, _N)
        assert _normal_agreement(got, ref_n, mask) >= 0.98, method


def test_filters_take_a_batch():
    (p0, m0), (p1, m1) = _cloud(7, n=1024), _cloud(8, n=1024)
    both = core.stack_buffers([_port_buf(p0, m0), _port_buf(p1, m1)])
    for fn in (
        lambda b: outliers.remove_statistical_outliers(b, 8, 1.5, method="exact"),
        lambda b: outliers.remove_statistical_outliers(b, 8, 1.5, method="window", passes=2),
        lambda b: radius_outliers.remove_radius_outliers(b, 6, 0.4, method="exact"),
        lambda b: radius_outliers.remove_radius_outliers(b, 6, 0.4, method="window"),
        lambda b: normals.estimate_normals(b, 0.4, 16, method="exact"),
        lambda b: normals.estimate_normals(b, 0.4, 16, method="window"),
    ):
        out = core.unstack_buffer(fn(both))
        for got, (p, m) in zip(out, ((p0, m0), (p1, m1))):
            alone = fn(_port_buf(p, m))
            assert torch.equal(got.mask, alone.mask)
            for k, v in alone.attributes.items():
                assert torch.equal(got.attributes[k], v)
    with pytest.raises(ValueError):
        outliers.remove_statistical_outliers(both, method="kd-tree")


# ---------------------------------------------------- fused neighbourhood ----

def test_fused_neighborhood_stats_matches_reference():
    pts, mask = _cloud(9)
    ref = ref_window.fused_neighborhood_stats(
        jnp.asarray(pts), jnp.asarray(mask), k=_K, radius=_R, window_blocks=(1, 0), passes=2,
        backend=_INTERP, kmode="csel", radius2=_R2)
    ref = [np.asarray(a) for a in ref]
    port = window.fused_neighborhood_stats(
        _t(pts), _t(mask), k=_K, radius=_R, window_blocks=(1, 0), passes=2, kmode="csel",
        radius2=_R2)
    port = [a.numpy() for a in port]
    assert len(port) == len(ref) == 4
    _check_fused(mask, port[0], port[1], port[2], port[3], ref[0], ref[1], ref[2], ref[3])
    # no radius2: the 3-tuple, the same statistics
    three = window.fused_neighborhood_stats(
        _t(pts), _t(mask), k=_K, radius=_R, window_blocks=(1, 0), passes=2, kmode="csel")
    assert len(three) == 3
    for got, want in zip(three, port):
        np.testing.assert_array_equal(got.numpy(), want)


def _check_fused(live, mean, nrm, cnt, cnt2, r_mean, r_nrm, r_cnt, r_cnt2, count_zero=False):
    """Fused-neighbourhood criteria on aligned points: kNN means within
    1e-3 for >= 99% of live points, in-radius(2) counts equal for >= 99%,
    normals within 2 degrees for >= 98%."""
    rel = np.abs(mean - r_mean) / np.maximum(r_mean, 1e-6)
    assert (rel[live] <= 1e-3).mean() >= 0.99
    assert (cnt2 == r_cnt2)[live].mean() >= 0.99
    if count_zero:
        assert (cnt == 0).all() and (r_cnt == 0).all()
    else:
        assert (cnt == r_cnt)[live].mean() >= 0.99
    assert _normal_agreement(nrm, r_nrm, live) >= 0.98


def _presorted(pts, mask):
    """Live points front-compacted in pass-0 curve order, as the
    curve-ordered voxel stage leaves them (dead rows zeroed)."""
    codes = np.asarray(ref_window.hilbert_codes(jnp.asarray(pts), jnp.asarray(mask)))
    order = np.argsort(codes, kind="stable")
    pts, mask = pts[:, order], mask[order]
    return np.where(mask, pts, 0.0).astype(np.float32), mask


@pytest.mark.parametrize(
    "entries_merge,presorted,carry_count,kmode",
    [(True, False, True, "sweep"), (True, True, False, "csel"),
     (False, True, False, "sweep"), (False, False, True, "bisect")],
)
def test_fused_reordered_matches_reference(entries_merge, presorted, carry_count, kmode):
    pts, mask = _cloud(10 + 2 * entries_merge + presorted)
    if presorted:
        pts, mask = _presorted(pts, mask)
    ring = np.arange(_N, dtype=np.int32)  # an attribute: the input slot
    common = dict(k=_K, radius=_R, window_blocks=(1, 0), passes=2, kmode=kmode, radius2=_R2,
                  presorted=presorted, entries_merge=entries_merge, carry_count=carry_count)
    ref = ref_window.fused_neighborhood_stats_reordered(
        jnp.asarray(pts), jnp.asarray(mask), {"ring": jnp.asarray(ring)}, backend=_INTERP,
        **common)
    port = window.fused_neighborhood_stats_reordered(_t(pts), _t(mask), {"ring": _t(ring)},
                                                     **common)
    assert len(port) == len(ref) == 7
    # match the points by their slot: the attribute rides the re-sorts
    r_slot, p_slot = np.asarray(ref[2]["ring"]), port[2]["ring"].numpy()
    r_valid, p_valid = np.asarray(ref[1]), port[1].numpy()
    assert sorted(r_slot[r_valid]) == sorted(p_slot[p_valid]) == sorted(np.flatnonzero(mask))
    r_at, p_at = np.argsort(r_slot), np.argsort(p_slot)

    def by_slot(x, at):
        return np.asarray(x)[..., at]

    live = mask
    np.testing.assert_array_equal(by_slot(port[0].numpy(), p_at)[:, live], pts[:, live])
    np.testing.assert_array_equal(by_slot(ref[0], r_at)[:, live], pts[:, live])
    _check_fused(
        live, *(by_slot(a.numpy(), p_at) for a in (port[3], port[4], port[5], port[6])),
        *(by_slot(a, r_at) for a in (ref[3], ref[4], ref[5], ref[6])),
        count_zero=not (entries_merge or carry_count),
    )
