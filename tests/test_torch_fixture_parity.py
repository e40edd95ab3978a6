"""The port against the repo's committed fixtures, with the reference's tolerances.

No JAX runs here: the goldens in ``tests/fixtures/`` stand for the
reference, and the exact oracles are scipy's KD-tree, as in the
reference's own fixture tests:

* ``parity_scan.npz`` / ``parity_golden.npz`` (``tests/test_golden_parity.py
  :43-120``): non-finite and duplicate masks, crop in both polarities, the
  voxel position set, exact statistical outliers, exact normal angles and
  the RANSAC plane, under SURVEY.md §7.2's definitions;
* ``ring_scene.npz``: the full pipeline, window path against exact kNN
  (``test_golden_parity.py:121``), on the XLA route as the reference ran
  it there and on the kernel route; the window floor
  (``tests/test_ops_window.py:303``) on both routes and the presorted floor
  (``:439``) on the kernel route;
* ``hdl32_scene.npz``: the multi-revolution floor (``:650``) on both
  routes.

Each check is a function of the device: the tests run it on the CPU
(the kernel route through K3's plain version), and ``chip_smoke.py``
phase (z) on the card. RANSAC takes draws made from a numpy seed, not the
reference's. Two goldens carry reference-side faults, and their checks
say how they hold the port (the normals, ROADMAP fault 16; the plane,
fault 3).
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from autodriver_pointcloud_preprocessor_tpu_torch import ops
from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa
from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
    PipelineParams,
    PipelineSettings,
    build_pipeline,
)
from autodriver_pointcloud_preprocessor_tpu_torch.ops.window import (
    fused_neighborhood_stats,
    fused_neighborhood_stats_reordered,
)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

VOXEL, ROI_MIN, ROI_MAX = 0.2, (-25.0, -25.0, -3.0), (25.0, 25.0, 6.0)
NB_NEIGHBORS, STD_RATIO = 16, 2.0
RADIUS, MAX_NN = 0.35, 24
DIST_THRESH, RANSAC_N, NUM_ITER = 0.08, 3, 128
#: the two window routes: the kernel route's name and the XLA route's
ROUTES = ["pallas", "xla"]
CPU = torch.device("cpu")


def _load(name):
    return np.load(os.path.join(FIXDIR, name))


def _uniforms(shape, dev, seed=0):
    """RANSAC draws from a numpy seed, on ``dev``."""
    return torch.from_numpy(np.random.default_rng(seed).uniform(size=shape).astype(np.float32)).to(dev)


def _host(t):
    return t.cpu().numpy()


def golden_fixture(dev):
    """(points, the non-finite-masked buffer on ``dev``, the goldens)."""
    pts = _load("parity_scan.npz")["points"]
    golden = _load("parity_golden.npz")
    buf, _ = from_soa({"positions": pts}, capacity=32_768, device=dev)
    return pts, ops.mask_non_finite(buf, True, True), golden


def _keep_idx(buf, n):
    return np.flatnonzero(_host(buf.mask)[:n])


def check_nonfinite_and_dedup(fx):
    pts, clean, golden = fx
    n = len(pts)
    np.testing.assert_array_equal(_keep_idx(clean, n), golden["nonfinite_keep_idx"])
    np.testing.assert_array_equal(_keep_idx(ops.remove_duplicates(clean), n),
                                  golden["dedup_keep_idx"])


def check_crop(fx, invert):
    pts, clean, golden = fx
    dev = clean.device
    out = ops.crop_box(clean, torch.tensor(ROI_MIN, device=dev), torch.tensor(ROI_MAX, device=dev),
                       torch.tensor(invert, device=dev))
    key = "crop_invert_keep_idx" if invert else "crop_keep_idx"
    np.testing.assert_array_equal(_keep_idx(out, len(pts)), golden[key])


def check_voxel_position_set(fx):
    _pts, clean, golden = fx
    vox = ops.voxel_downsample(clean, VOXEL)
    got = _host(vox.positions).T[_host(vox.mask)]
    want = golden["voxel_positions"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got[np.lexsort(got.T)], want[np.lexsort(want.T)], rtol=0,
                               atol=1e-5)


def check_statistical_outliers(fx):
    pts, clean, golden = fx
    out = ops.remove_statistical_outliers(clean, NB_NEIGHBORS, STD_RATIO, method="exact")
    np.testing.assert_array_equal(_keep_idx(out, len(pts)), golden["outlier_keep_idx"])


#: the largest |n . v| of the port's normal against the line direction v
#: of a line-like neighbourhood: sin 2 degrees, the bar that holds the
#: card's normals against the CPU's (chip_smoke.py phase (y))
LINE_PERP = float(np.sin(np.deg2rad(2.0)))


def _oracle(live_pts, p):
    """The exact hybrid neighbourhood of point ``p`` (the ``MAX_NN``
    nearest of the live points, a KD-tree over them, within ``RADIUS``)
    and the float64 eigenvalues (ascending) and eigenvectors of its
    centered covariance; the normal is the first eigenvector, the
    direction of a line the last."""
    dist, j = live_pts.query(p, k=MAX_NN)
    q = live_pts.data[j[dist <= RADIUS]]
    ev, vec = np.linalg.eigh((q - q.mean(0)).T @ (q - q.mean(0)))
    return q, ev, vec


def check_normals_angles(fx):
    """The reference's bar: more than 99.9% of live rows within 0.9999 in
    cosine of the golden normal. The golden's exact kNN forms
    |q|^2 + |c|^2 - 2 q.c, which cancels; the port sums squared
    differences (ops/knn.py), so rows whose neighbourhood edge is a near
    tie differ, and another device's float32 eigensolve differs on
    ill-conditioned rows (ROADMAP fault 16). So a row that misses the
    golden is held to the float64 oracle of its exact neighbourhood, and
    passes through the first of these clauses that holds:

    * "oracle": the port's normal is at least as close as the golden's to
      the oracle's normal, or within 0.9999 of it;
    * "line": the neighbourhood is a line (its second eigenvalue under
      1e-3 of its largest: a duplicated pair, or nearly collinear points),
      where every direction perpendicular to the line is a normal (the
      goldens there miss the oracle's pick too), and the port's normal is
      perpendicular to the oracle's line direction v: |n . v| <=
      ``LINE_PERP``;
    * "duplicates": every neighbour lies on one position, so the
      covariance is zero and no normal is determined. Only these rows
      are exempt.

    More than 99.9% of live rows must pass. Returns the live rows, the
    rows within 0.9999 of the golden, the rows through each clause, the
    rows failing, and the largest |n . v| of the line rows."""
    pts, clean, golden = fx
    nrm = ops.estimate_normals(clean, RADIUS, MAX_NN, method="exact")
    n = len(pts)
    got = _host(nrm.attributes["normals"]).T[:n].astype(np.float64)
    want = golden["normals"].astype(np.float64)
    live = _host(clean.mask)[:n]
    ok = np.abs((got * want).sum(1)) > 0.9999
    counts = {"live": int(live.sum()), "golden": int(ok[live].sum()), "oracle": 0, "line": 0,
              "duplicates": 0, "failing": 0, "line_max_dot": 0.0}
    tree = cKDTree(pts[live].astype(np.float64))
    for i in np.flatnonzero(live & ~ok):
        q, ev, vec = _oracle(tree, pts[i].astype(np.float64))
        truth, line_dir = vec[:, 0], vec[:, -1]
        if len(np.unique(q, axis=0)) == 1:
            clause = "duplicates"
        elif abs(got[i] @ truth) >= min(abs(want[i] @ truth), 0.9999):
            clause = "oracle"
        elif ev[1] < 1e-3 * ev[2]:
            dot = abs(got[i] @ line_dir)
            counts["line_max_dot"] = max(counts["line_max_dot"], float(dot))
            clause = "line" if dot <= LINE_PERP else "failing"
        else:
            clause = "failing"
        counts[clause] += 1
    assert counts["failing"] < 0.001 * counts["live"], counts
    return counts


def check_ground_plane(fx):
    """The golden plane is the reference's best 3-point hypothesis,
    unrefined: its refit is NaN-poisoned on this scan (ROADMAP fault 3;
    three returns lie on it within 3e-7 m). So the port's refit plane is
    held, at the golden's 1e-3, to the float64 least-squares plane of the
    golden's own ground set, and the two ground sets differ only where a
    point's distance to the golden plane is within the planes' gap of the
    threshold. Returns the points whose side differs."""
    pts, clean, golden = fx
    n = len(pts)
    gnd, plane = ops.remove_ground(clean, None, DIST_THRESH, RANSAC_N, NUM_ITER,
                                   uniforms=_uniforms((NUM_ITER, RANSAC_N), clean.device))
    plane, want = _host(plane).astype(np.float64), golden["plane"].astype(np.float64)
    live = _host(clean.mask)[:n]
    ground = np.setdiff1d(np.flatnonzero(live), golden["ground_keep_idx"])
    g = pts[ground].astype(np.float64)
    normal = np.linalg.svd(g - g.mean(0), full_matrices=False)[2][-1]
    normal *= np.sign(normal @ want[:3])
    refit = np.append(normal, -normal @ g.mean(0))
    if np.dot(plane[:3], want[:3]) < 0:
        plane = -plane
    np.testing.assert_allclose(plane, refit, atol=1e-3)
    finite = pts[live].astype(np.float64)
    gap = np.abs(finite @ (plane[:3] - want[:3]) + plane[3] - want[3]).max()
    got_idx, want_idx = _keep_idx(gnd, n), golden["ground_keep_idx"]
    differ = np.setxor1d(got_idx, want_idx)
    to_golden = np.abs(pts[differ].astype(np.float64) @ want[:3] + want[3])
    assert (np.abs(to_golden - DIST_THRESH) <= gap).all()
    assert len(differ) < 0.002 * len(np.union1d(got_idx, want_idx))
    return len(differ)


def _ring():
    return _load("ring_scene.npz")["positions"]


def check_ring_pipeline(dev, route):
    """test_golden_parity.py:121: the full pipeline (voxel, fused outliers
    and normals, RANSAC) window against exact; the reference's "auto" ran
    its XLA route there, the port's pallas_ok=False. Returns the smaller
    survivor overlap."""
    pts = _ring()[::2]  # 7.5k, as the reference
    buf, _ = from_soa({"positions": pts}, capacity=8192, device=dev)
    base = dict(
        remove_statistical_outliers=True, nb_neighbors=12, estimate_normals=True,
        max_neighbors=12, remove_ground=True, ransac_n=3, num_iterations=64,
        pallas_ok=route != "xla",
    )
    params = PipelineParams.make(voxel_size=0.15, distance_threshold=0.1, std_ratio=1.5,
                                 search_radius=0.6, device=dev)
    u = _uniforms((64, 3), dev)
    out_w, plane_w = build_pipeline(PipelineSettings(knn_method="window", **base))(
        buf, params, None, u)
    out_e, plane_e = build_pipeline(PipelineSettings(knn_method="exact", **base))(
        buf, params, None, u)
    pw, pe = _host(plane_w), _host(plane_e)
    assert abs(pw[2]) > 0.99 and abs(pe[2]) > 0.99
    assert abs(abs(pw[3]) - 1.8) < 0.1, pw
    a = _host(out_w.positions).T[_host(out_w.mask)]
    b = _host(out_e.positions).T[_host(out_e.mask)]
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    fwd, bwd = (d2.min(axis=1) < 1e-8).mean(), (d2.min(axis=0) < 1e-8).mean()
    assert min(fwd, bwd) > 0.97, (fwd, bwd, len(a), len(b))
    return float(min(fwd, bwd))


def _class_agreement(exact, window):
    """Share of points whose outlier class (mean + std cut) agrees."""
    ce = exact <= exact.mean() + exact.std()
    cw = window <= window.mean() + window.std()
    return float((ce == cw).mean())


def _window_floor(pts, capacity, dev, route, floor):
    buf, _ = from_soa({"positions": pts}, capacity=capacity, device=dev)
    k = 20
    exact = cKDTree(pts).query(pts, k=k)[0].mean(axis=1)
    mean, _, _ = fused_neighborhood_stats(buf.positions, buf.mask, k=k, radius=0.1,
                                          window_blocks=1, passes=2, backend=route)
    agree = _class_agreement(exact, _host(mean)[_host(buf.mask)][: len(pts)])
    assert agree > floor, agree
    return agree


def check_ring_floor(dev, route):
    """test_ops_window.py:303 (its call at :327 takes the XLA route)."""
    return _window_floor(_ring(), 16384, dev, route, 0.97)


def check_presorted_ring_floor(dev):
    """test_ops_window.py:439, on the kernel route as the reference runs it."""
    pts = _ring()
    buf, _ = from_soa({"positions": pts}, capacity=16384, device=dev)
    vox = ops.voxel_downsample(buf, 0.12, curve_order=True, compact_keys=True)
    live = _host(vox.mask)
    vp = _host(vox.positions)[:, live].T
    k = 20
    exact = cKDTree(vp).query(vp, k=k)[0].mean(axis=1)
    out = fused_neighborhood_stats_reordered(vox.positions, vox.mask, {}, k=k, radius=0.1,
                                             window_blocks=1, passes=2, presorted=True)
    m = _host(out[1])
    pr, mw = _host(out[0])[:, m].T, _host(out[3])[m]
    oa, ob = np.lexsort(vp.T), np.lexsort(pr.T)
    np.testing.assert_allclose(vp[oa], pr[ob], atol=0)
    ce = exact[oa] <= exact.mean() + exact.std()
    cw = mw[ob] <= mw[ob].mean() + mw[ob].std()
    agree = float((ce == cw).mean())
    assert agree > 0.97, agree
    return agree


def check_hdl32_floor(dev, route):
    """test_ops_window.py:650 (its call at :683 takes the XLA route): three
    dual-return revolutions, deduplicated first."""
    d = _load("hdl32_scene.npz")
    raw = d["positions"]
    pts = np.unique(raw, axis=0)
    assert len(pts) < 0.6 * len(raw)
    assert len(np.unique(d["ring"])) >= 30
    return _window_floor(pts, 65536, dev, route, 0.98)


# ---------------------------------------------------------------- tests ----

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the test workers share the
    cores, and oversubscribed thread pools slow these large elementwise
    blocks twentyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture():
    return golden_fixture(CPU)


def test_golden_nonfinite_and_dedup(fixture):
    check_nonfinite_and_dedup(fixture)


@pytest.mark.parametrize("invert", [False, True])
def test_golden_crop(fixture, invert):
    check_crop(fixture, invert)


def test_golden_voxel_position_set(fixture):
    check_voxel_position_set(fixture)


def test_golden_statistical_outliers(fixture):
    check_statistical_outliers(fixture)


def test_golden_normals_angles(fixture):
    check_normals_angles(fixture)


def test_golden_ground_plane(fixture):
    check_ground_plane(fixture)


@pytest.mark.parametrize("route", ROUTES)
def test_ring_scene_pipeline_window_vs_exact(route):
    check_ring_pipeline(CPU, route)


@pytest.mark.parametrize("route", ROUTES)
def test_window_quality_floor_ring_structured_scan(route):
    check_ring_floor(CPU, route)


def test_presorted_quality_floor_ring_structured_scan():
    check_presorted_ring_floor(CPU)


@pytest.mark.parametrize("route", ROUTES)
def test_window_quality_floor_hdl32_multirev_scan(route):
    check_hdl32_floor(CPU, route)
