"""The port's XLA window route (``backend="xla"``) against the reference's.

The reference computes this route in plain XLA, so it runs natively here
(no interpret mode). Inputs are clouds made from a numpy seed, 2,048 to
8,192 rows: clustered points with invalid rows (some of them NaN), or a
buffer with every row live, so that the rolled window wraps real points
from the last blocks into block 0's window.

Tolerances:
* in-radius counts equal on >= 99.9% of live rows;
* kNN means within 1e-5 relative on >= 99.9% of live rows;
* covariance entries within 1e-5 of the row's largest entry on >= 99.9%
  of live rows (the small off-diagonal entries cancel, so they are held
  to their row's scale);
* normals within 0.5 degrees (sign-agnostic) on >= 99.9% of live rows;
* curve orders, windows and compaction bit-equal.

The reference's covariance entries are NaN on live rows whose window
holds a NaN invalid row (0 * NaN); the port zeroes invalid rows first.
So the reference gets each cloud with its invalid rows zeroed, the port
gets the NaN rows, and ``test_nan_invalid_rows_change_nothing`` shows
that the port's result does not depend on them.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodriver_pointcloud_preprocessor_tpu import ops as rops
from autodriver_pointcloud_preprocessor_tpu.core import from_soa as ref_from_soa
from autodriver_pointcloud_preprocessor_tpu.ops import window as rw
from autodriver_pointcloud_preprocessor_tpu_torch import ops as pops
from autodriver_pointcloud_preprocessor_tpu_torch.convert import scan_from_reference
from autodriver_pointcloud_preprocessor_tpu_torch.ops import window as pw

SHARE = 0.999
REL = 1e-5
DEGREES = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the test workers share the
    cores, and oversubscribed thread pools slow these large elementwise
    blocks twentyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n, seed=0, dead=0.1, full=False):
    """(positions float32[3, n], mask bool[n]): 16 clusters and a uniform
    background; ``dead`` of the rows invalid, a third of those NaN; with
    ``full`` every row is live."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-8, 8, (16, 3))
    pts = centers[rng.integers(0, 16, n)] + rng.normal(0, 0.6, (n, 3))
    pts[: n // 8] = rng.uniform(-10, 10, (n // 8, 3))
    pts = pts[rng.permutation(n)].astype(np.float32).T.copy()
    mask = np.ones(n, bool)
    if not full:
        off = rng.choice(n, int(n * dead), replace=False)
        mask[off] = False
        pts[:, off[: len(off) // 3]] = np.nan
    return pts, mask


def _port(pts, mask):
    return torch.from_numpy(pts), torch.from_numpy(mask)


def _ref(pts, mask):
    """The reference's inputs: invalid rows zeroed (module docstring)."""
    return jnp.asarray(np.where(mask, pts, 0.0)), jnp.asarray(mask)


def _share(ok, mask):
    return float(np.asarray(ok)[np.asarray(mask)].mean())


def _assert_means(port, ref, mask):
    port, ref = np.asarray(port), np.asarray(ref)
    rel = np.abs(port - ref) / np.maximum(np.abs(ref), 1e-12)
    assert _share(rel <= REL, mask) >= SHARE, np.sort(rel[mask])[-5:]
    assert (port[~mask] == 0).all()


def _assert_counts(port, ref, mask):
    port, ref = np.asarray(port), np.asarray(ref)
    assert _share(port == ref, mask) >= SHARE
    assert (port[~mask] == 0).all()


def _assert_entries(port, ref, mask):
    port, ref = np.asarray(port), np.asarray(ref)
    scale = np.maximum(np.abs(ref).max(0), 1e-30)
    rel = np.abs(port - ref).max(0) / scale
    assert _share(rel <= REL, mask) >= SHARE, np.sort(rel[mask])[-5:]


def _assert_normals(port, ref, mask):
    cos = np.abs((np.asarray(port) * np.asarray(ref)).sum(0))
    assert _share(cos >= np.cos(np.deg2rad(DEGREES)), mask) >= SHARE


#: (window_blocks, passes, block_size): wb 0 widened to 1, wb 1 and 2, a
#: per-pass tuple, 64-row blocks, one pass
WINDOWS = [(0, 2, 128), (1, 2, 128), (2, 2, 128), ((1, 0), 2, 128), (1, 2, 64), (2, 1, 64)]


@pytest.mark.parametrize("wb,passes,block", WINDOWS)
def test_window_mean_knn_dist_matches_reference(wb, passes, block):
    pts, mask = _cloud(4096, seed=1)
    kw = dict(k=12, window_blocks=wb, passes=passes, block_size=block, backend="xla")
    ref = rw.window_mean_knn_dist(*_ref(pts, mask), **kw)
    port = pw.window_mean_knn_dist(*_port(pts, mask), **kw)
    _assert_means(port.numpy(), ref, mask)


@pytest.mark.parametrize("wb,passes,block", WINDOWS)
def test_window_normal_stats_matches_reference(wb, passes, block):
    pts, mask = _cloud(4096, seed=2)
    kw = dict(window_blocks=wb, passes=passes, block_size=block, backend="xla")
    r_entries, r_count = rw.window_normal_stats(*_ref(pts, mask), 0.8, **kw)
    p_entries, p_count = pw.window_normal_stats(*_port(pts, mask), 0.8, **kw)
    _assert_counts(p_count.numpy(), r_count, mask)
    _assert_entries(p_entries.numpy(), r_entries, mask)


@pytest.mark.parametrize("radius2", [None, 0.5])
@pytest.mark.parametrize("full", [False, True])
def test_fused_neighborhood_stats_matches_reference(radius2, full):
    # a full buffer: the roll wraps live points of the last blocks into
    # block 0's window
    pts, mask = _cloud(8192 if full else 2048, seed=3, full=full)
    kw = dict(k=16, radius=0.9, window_blocks=(1, 0), passes=2, radius2=radius2, backend="xla")
    ref = rw.fused_neighborhood_stats(*_ref(pts, mask), **kw)
    port = pw.fused_neighborhood_stats(*_port(pts, mask), kmode="csel", **kw)
    assert len(port) == len(ref) == (3 if radius2 is None else 4)
    _assert_means(port[0].numpy(), ref[0], mask)
    _assert_normals(port[1].numpy(), ref[1], mask)
    _assert_counts(port[2].numpy(), ref[2], mask)
    if radius2 is not None:
        _assert_counts(port[3].numpy(), ref[3], mask)


@pytest.mark.parametrize("shrink_to,radius2", [(0, None), (2048, 0.5)])
def test_fused_reordered_matches_reference(shrink_to, radius2):
    # the route subsamples to the shrink first and keeps its own order
    pts, mask = _cloud(4096, seed=4)
    ring = np.random.default_rng(4).integers(0, 32, 4096).astype(np.float32)
    kw = dict(k=16, radius=0.9, window_blocks=1, passes=2, shrink_to=shrink_to,
              radius2=radius2, backend="xla")
    ref = rw.fused_neighborhood_stats_reordered(
        *_ref(pts, mask), {"ring": jnp.asarray(ring)}, presorted=True, **kw)
    port = pw.fused_neighborhood_stats_reordered(
        *_port(pts, mask), {"ring": torch.from_numpy(ring)}, presorted=True, **kw)
    m = np.asarray(ref[1])
    assert port[0].shape[-1] == (shrink_to or 4096)
    np.testing.assert_array_equal(port[1].numpy(), m)
    np.testing.assert_array_equal(port[0].numpy()[:, m], np.asarray(ref[0])[:, m])
    np.testing.assert_array_equal(port[2]["ring"].numpy()[m], np.asarray(ref[2]["ring"])[m])
    _assert_means(port[3].numpy(), ref[3], m)
    _assert_normals(port[4].numpy(), ref[4], m)
    for got, want in zip(port[5:], ref[5:]):
        _assert_counts(got.numpy(), want, m)


def test_batch_of_two_matches_each_scan():
    # one call over [2, 3, N] equals each scan's own reference result
    clouds = [_cloud(2048, seed=s) for s in (5, 6)]
    pos = torch.from_numpy(np.stack([c[0] for c in clouds]))
    mask = torch.from_numpy(np.stack([c[1] for c in clouds]))
    radius = torch.tensor([0.8, 1.1])
    mean, normals, count = pw.fused_neighborhood_stats(
        pos, mask, k=12, radius=radius, window_blocks=2, passes=2, backend="xla")
    for i, (p, m) in enumerate(clouds):
        ref = rw.fused_neighborhood_stats(*_ref(p, m), k=12, radius=float(radius[i]),
                                          window_blocks=2, passes=2, backend="xla")
        _assert_means(mean[i].numpy(), ref[0], m)
        _assert_normals(normals[i].numpy(), ref[1], m)
        _assert_counts(count[i].numpy(), ref[2], m)


def test_nan_invalid_rows_change_nothing():
    # the reference's entries go NaN on live rows near a NaN invalid row;
    # the port's equal its result on the zeroed cloud, bit for bit
    pts, mask = _cloud(4096, seed=2)
    kw = dict(window_blocks=1, passes=2, backend="xla")
    r_entries, _ = rw.window_normal_stats(jnp.asarray(pts), jnp.asarray(mask), 0.8, **kw)
    poisoned = mask & ~np.isfinite(np.asarray(r_entries)).all(0)
    assert poisoned.sum() > 0
    nan = pw.fused_neighborhood_stats(*_port(pts, mask), k=12, radius=0.8, radius2=0.5, **kw)
    zeroed = pw.fused_neighborhood_stats(*_port(np.where(mask, pts, 0.0), mask), k=12,
                                         radius=0.8, radius2=0.5, **kw)
    for got, want in zip(nan, zeroed):
        np.testing.assert_array_equal(got.numpy()[..., mask], want.numpy()[..., mask])
    assert np.isfinite(nan[1].numpy()[:, mask]).all()


def _bufs(pts, mask):
    rbuf, _ = ref_from_soa({"positions": pts.T[mask]}, capacity=pts.shape[1])
    pbuf = scan_from_reference(np.asarray(rbuf.positions), np.asarray(rbuf.mask), {},
                               device="cpu")
    return rbuf, pbuf


@pytest.mark.parametrize("op", ["outliers", "radius", "normals"])
def test_window_ops_match_reference(op):
    pts, mask = _cloud(8192, seed=7)
    rbuf, pbuf = _bufs(pts, mask)
    kw = dict(method="window", window_backend="xla", window_blocks=1, passes=2)
    if op == "outliers":
        ref = rops.remove_statistical_outliers(rbuf, 16, 1.5, **kw)
        port = pops.remove_statistical_outliers(pbuf, 16, 1.5, **kw)
    elif op == "radius":
        ref = rops.remove_radius_outliers(rbuf, 6, 0.5, **kw)
        port = pops.remove_radius_outliers(pbuf, 6, 0.5, **kw)
    else:
        ref = rops.estimate_normals(rbuf, 0.9, 24, **kw)
        port = pops.estimate_normals(pbuf, 0.9, 24, **kw)
    live = np.asarray(rbuf.mask)
    assert _share(port.mask.numpy() == np.asarray(ref.mask), live) >= SHARE
    if op == "normals":
        _assert_normals(port.attributes["normals"].numpy(), ref.attributes["normals"], live)


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
def test_stream_compact_to_equals_the_reference_xla_route(backend):
    # every backend keeps K1 (its plain version here): the reference's XLA
    # route (compact_to) gives the same survivors in the same order
    pts, mask = _cloud(8192, seed=8, dead=0.6)
    rng = np.random.default_rng(8)
    soa = {"positions": np.nan_to_num(pts.T), "intensity": rng.uniform(0, 255, 8192)
           .astype(np.float32)}
    rbuf, _ = ref_from_soa(soa, capacity=8192)
    rbuf = rbuf.with_mask(jnp.asarray(mask))
    pbuf = scan_from_reference(np.asarray(rbuf.positions), mask,
                               {k: np.asarray(v) for k, v in rbuf.attributes.items()},
                               device="cpu")
    ref = rops.stream_compact_to(rbuf, 4096, backend="xla")
    port = pops.stream_compact_to(pbuf, 4096, backend=backend)
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(port.mask.numpy(), m)
    np.testing.assert_array_equal(port.positions.numpy()[:, m], np.asarray(ref.positions)[:, m])
    np.testing.assert_array_equal(port.attributes["intensity"].numpy()[m],
                                  np.asarray(ref.attributes["intensity"])[m])


@pytest.mark.parametrize("backend,first_attrs", [("auto", True), ("xla", True), ("xla", False)])
def test_voxel_downsample_equals_the_reference_xla_route(backend, first_attrs):
    # K2's plain version against segment_sum: the same voxels, means up to
    # the float32 summation order
    pts, mask = _cloud(8192, seed=9)
    rbuf, pbuf = _bufs(pts, mask)
    ref = rops.voxel_downsample(rbuf, 0.3, backend="xla", first_attrs=first_attrs)
    port = pops.voxel_downsample(pbuf, 0.3, backend=backend, first_attrs=first_attrs)
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(port.mask.numpy(), m)
    np.testing.assert_allclose(port.positions.numpy()[:, m], np.asarray(ref.positions)[:, m],
                               rtol=1e-6, atol=1e-6)


def test_chunk_blocks_changes_nothing():
    # 136 blocks against 64-block chunks: the chunk is 34 blocks (the
    # largest divisor), and the result is the one-chunk result
    pts, mask = _cloud(136 * 128, seed=10, dead=0.01)
    pos, m = _port(pts, mask)
    kw = dict(window_blocks=2, passes=1, backend="xla")
    one = pw.window_mean_knn_dist(pos, m, k=8, chunk_blocks=136, **kw)
    np.testing.assert_array_equal(pw.window_mean_knn_dist(pos, m, k=8, chunk_blocks=64, **kw), one)
    e1, c1 = pw.window_normal_stats(pos, m, 0.7, chunk_blocks=136, **kw)
    e2, c2 = pw.window_normal_stats(pos, m, 0.7, chunk_blocks=7, **kw)
    np.testing.assert_array_equal(c2, c1)
    np.testing.assert_array_equal(e2, e1)
    ref = rw.window_mean_knn_dist(*_ref(pts, mask), k=8, chunk_blocks=64, **kw)
    _assert_means(one.numpy(), ref, mask)
    assert [pw._chunk_size(nb, 64) for nb in (136, 64, 400, 8, 97)] == [
        rw._chunk_size(nb, 64) for nb in (136, 64, 400, 8, 97)] == [34, 64, 50, 8, 1]


@pytest.mark.parametrize("pass_idx", [0, 1, 3])
def test_curve_order_and_windows_are_bit_equal(pass_idx):
    pts, mask = _cloud(2048, seed=11)
    pts = np.where(mask, pts, 0.0).astype(np.float32)
    ref = rw._sorted_window_arrays(*_ref(pts, mask), 64, 0, pass_idx)
    port = pw._sorted_window_arrays(*_port(pts, mask), 64, 0, pass_idx)
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))
    for got, want in zip(port[1] + port[2], ref[1] + ref[2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # wb 0 widens to one whole block a side, wrapping at both ends
    assert port[2][0].shape == (32, 3 * 64)
    np.testing.assert_array_equal(port[2][0][0, :64].numpy(), port[1][0][-1].numpy())


def test_morton_codes_with_bounds_are_bit_equal():
    pts, mask = _cloud(2048, seed=12)
    lo = np.nanmin(np.where(mask, pts, np.nan), 1) - 1.5
    hi = np.nanmax(np.where(mask, pts, np.nan), 1) + 0.5
    for shift in (0.0, 128.0):
        ref = rw.morton_codes(*_ref(pts, mask), shift, (jnp.asarray(lo), jnp.asarray(hi)))
        port = pw.morton_codes(*_port(pts, mask), shift,
                               (torch.from_numpy(lo), torch.from_numpy(hi)))
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
        assert not np.array_equal(port.numpy(), pw.morton_codes(*_port(pts, mask), shift).numpy())


def test_backend_names():
    # "auto" is the kernel route on every device; the kernel route's three
    # names give one result, and an unknown name raises
    assert pw.default_backend() == "pallas"
    pts, mask = _cloud(2048, seed=13)
    pos, m = _port(pts, mask)
    outs = [pw.fused_neighborhood_stats(pos, m, k=8, radius=0.8, window_blocks=1, backend=b)
            for b in ("auto", "pallas", "pallas_interpret")]
    for out in outs[1:]:
        for got, want in zip(out, outs[0]):
            assert torch.equal(got, want)
    xla = pw.fused_neighborhood_stats(pos, m, k=8, radius=0.8, window_blocks=1, backend="xla")
    assert not torch.equal(xla[0], outs[0][0])
    with pytest.raises(ValueError, match="not one of"):
        pw.window_mean_knn_dist(pos, m, k=8, backend="mosaic")
    with pytest.raises(ValueError, match="not one of"):
        pops.voxel_downsample(scan_from_reference(pts, mask, {}, device="cpu"), 0.3,
                              backend="cuda")
