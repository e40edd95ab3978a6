"""The port's ops of the configuration surface against the reference: the
height cut, the random, uniform and farthest-point downsamplers, the
Morton and wide Hilbert codes, ``compact``, RANSAC's ``live_prefix`` and
``score_subsample``, the 'wide' voxel key tier and integer attributes
wider than 16 bits. Inputs are made from a seed with numpy and given to
both packages; each op also runs on a batch of 3 scans, which must equal
each scan run alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodriver_pointcloud_preprocessor_tpu import core as ref_core
from autodriver_pointcloud_preprocessor_tpu.ops.compact import compact as ref_compact
from autodriver_pointcloud_preprocessor_tpu.ops import downsample as ref_downsample
from autodriver_pointcloud_preprocessor_tpu.ops import finite as ref_finite
from autodriver_pointcloud_preprocessor_tpu.ops import ground as ref_ground
from autodriver_pointcloud_preprocessor_tpu.ops import height_ground as ref_height
from autodriver_pointcloud_preprocessor_tpu.ops import voxel as ref_voxel
from autodriver_pointcloud_preprocessor_tpu.ops import window as ref_window
from autodriver_pointcloud_preprocessor_tpu_torch import core, ops
from autodriver_pointcloud_preprocessor_tpu_torch.convert import scan_from_reference

CAPACITY = 4096


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port(buf):
    return scan_from_reference(
        np.asarray(buf.positions), np.asarray(buf.mask),
        {k: np.asarray(v) for k, v in buf.attributes.items()},
        device="cpu",
    )


def _ref_buf(rng, n=3500, spread=8.0, capacity=CAPACITY, live=0.85):
    """A reference buffer: uniform points with intensity and ring, some
    NaN rows, and a random live mask over the rest."""
    pts = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    pts[::37] = np.nan
    soa = {
        "positions": pts,
        "intensity": rng.uniform(0, 255, n).astype(np.float32),
        "ring": rng.integers(0, 32, n).astype(np.uint16),
    }
    rbuf, _ = ref_core.from_soa(soa, capacity=capacity)
    rbuf = ref_finite.mask_non_finite(rbuf)
    return rbuf.with_mask(jnp.asarray(rng.uniform(size=capacity) < live))


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, want):
    assert torch.equal(got.mask, want.mask)
    assert torch.equal(_bits(got.positions), _bits(want.positions))
    assert got.attributes.keys() == want.attributes.keys()
    for k, v in want.attributes.items():
        assert torch.equal(_bits(got.attributes[k]), _bits(v)), k


def _assert_ref_equal(port, ref):
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(port.positions.numpy(), np.asarray(ref.positions))
    for k, v in ref.attributes.items():
        np.testing.assert_array_equal(port.attributes[k].numpy(), np.asarray(v))


def _batch(rng, **kw):
    rbufs = [_ref_buf(rng, **kw) for _ in range(3)]
    pbufs = [_port(b) for b in rbufs]
    return rbufs, pbufs, core.stack_buffers(pbufs)


def _assert_batched(batched, singles):
    for got, want in zip(core.unstack_buffer(batched), singles):
        _assert_same(got, want)


# ---------------------------------------------------------- height ----

@pytest.mark.parametrize("signed", [False, True])
def test_height_ground_bit_equal(rng, signed):
    rbufs, pbufs, stacked = _batch(rng)
    plane = np.array([0.1, -0.2, 0.97, 0.4], np.float32)
    singles = []
    for rbuf, pbuf in zip(rbufs, pbufs):
        ref = ref_height.remove_ground_by_height(rbuf, jnp.asarray(plane), 0.5, signed=signed)
        port = ops.remove_ground_by_height(pbuf, _t(plane), torch.tensor(0.5), signed=signed)
        np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
        assert 0 < int(port.mask.sum()) < int(pbuf.mask.sum())
        singles.append(port)
    _assert_batched(ops.remove_ground_by_height(stacked, _t(plane), 0.5, signed=signed), singles)
    # one plane per scan
    planes = np.stack([plane, plane * [1, 1, 1, 0], plane * [0, 0, 1, 1]]).astype(np.float32)
    per_scan = ops.remove_ground_by_height(stacked, _t(planes), 0.5, signed=signed)
    for got, pbuf, p in zip(core.unstack_buffer(per_scan), pbufs, planes):
        _assert_same(got, ops.remove_ground_by_height(pbuf, _t(p), 0.5, signed=signed))


# ----------------------------------------------------- downsamplers ----

@pytest.mark.parametrize("every_k", [1, 3, 7])
def test_uniform_downsample_bit_equal(rng, every_k):
    rbufs, pbufs, stacked = _batch(rng)
    singles = []
    for rbuf, pbuf in zip(rbufs, pbufs):
        ref = ref_downsample.uniform_downsample(rbuf, jnp.int32(every_k))
        port = ops.uniform_downsample(pbuf, torch.tensor(every_k, dtype=torch.int32))
        np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
        singles.append(port)
    _assert_batched(ops.uniform_downsample(stacked, torch.tensor(every_k, dtype=torch.int32)),
                    singles)


def test_random_downsample_with_reference_uniforms(rng):
    rbufs, pbufs, stacked = _batch(rng)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    draws = np.stack([np.asarray(jax.random.uniform(k, (CAPACITY,))) for k in keys])
    singles = []
    for rbuf, pbuf, key, u in zip(rbufs, pbufs, keys, draws):
        ref = ref_downsample.random_downsample(rbuf, 0.3, key)
        port = ops.random_downsample(pbuf, torch.tensor(0.3), uniforms=_t(u))
        np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
        singles.append(port)
    _assert_batched(ops.random_downsample(stacked, torch.tensor(0.3), uniforms=_t(draws)), singles)
    # the generator's draws keep about the ratio
    live = int(pbufs[0].mask.sum())
    kept = int(ops.random_downsample(pbufs[0], 0.3, torch.Generator().manual_seed(0)).mask.sum())
    assert abs(kept - 0.3 * live) < 5 * np.sqrt(0.3 * 0.7 * live)
    with pytest.raises(ValueError):
        ops.random_downsample(pbufs[0], 0.3, uniforms=torch.zeros(CAPACITY // 2))


@pytest.mark.parametrize("num_samples,live", [(200, 0.85), (400, 0.08)])
def test_farthest_point_bit_equal(rng, num_samples, live):
    # 400 samples exceed every sparse scan's ~250 live points: all stay
    rbufs, pbufs, stacked = _batch(rng, live=live)
    singles = []
    for rbuf, pbuf in zip(rbufs, pbufs):
        ref = jax.jit(ref_downsample.farthest_point_downsample, static_argnums=1)(
            rbuf, num_samples)
        port = ops.farthest_point_downsample(pbuf, num_samples)
        np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
        assert int(port.mask.sum()) == min(num_samples, int(pbuf.mask.sum()))
        singles.append(port)
    _assert_batched(ops.farthest_point_downsample(stacked, num_samples), singles)


# ---------------------------------------------------------- curves ----

def test_morton_codes_bit_exact(rng):
    pts = rng.normal(0, 20, (3, 5000)).astype(np.float32)
    mask = rng.uniform(size=5000) < 0.9
    for shift in (0.0, 128.0):
        ref = ref_window.morton_codes(jnp.asarray(pts), jnp.asarray(mask), shift)
        port = ops.morton_codes(_t(pts), _t(mask), shift)
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    # batched: each scan quantizes over its own bounds
    pts3 = np.stack([pts, pts * 2, pts[:, ::-1]])
    got = ops.morton_codes(_t(pts3), _t(np.stack([mask] * 3)))
    for g, p in zip(got, pts3):
        assert torch.equal(g, ops.morton_codes(_t(p), _t(mask)))


def test_hilbert_cell_codes_wide_bit_exact(rng):
    cells = rng.integers(0, 1 << 20, (3, 6000)).astype(np.int32)
    cells[:, :8] = [0, (1 << 20) - 1, 1 << 19, (1 << 19) - 1, 1, 2, 3, 4]  # box corners, centre
    mask = rng.uniform(size=6000) < 0.9
    ref_hi, ref_lo = ref_window.hilbert_cell_codes_wide(
        [jnp.asarray(c) for c in cells], jnp.asarray(mask))
    hi, lo = ops.hilbert_cell_codes_wide([_t(c) for c in cells], _t(mask))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(ref_hi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(ref_lo))
    live = hi[_t(mask)]
    assert int(live.max()) < 0x7FFFFFFF and int(lo[_t(mask)].max()) < 0x7FFFFFFF
    # the pair identifies the cell
    key = (hi.to(torch.int64) << 31) | lo.to(torch.int64)
    ids = {tuple(c) for c in cells.T[mask].tolist()}
    assert len(torch.unique(key[_t(mask)])) == len(ids)
    # batched: elementwise, one row of cells per scan
    bcells = [_t(np.stack([c, c[::-1], c])) for c in cells]
    bhi, blo = ops.hilbert_cell_codes_wide(bcells, _t(np.stack([mask] * 3)))
    assert torch.equal(bhi[0], hi) and torch.equal(blo[2], lo)


# --------------------------------------------------------- compact ----

def test_compact_bit_equal(rng):
    rbufs, pbufs, stacked = _batch(rng)
    singles = []
    for rbuf, pbuf in zip(rbufs, pbufs):
        port = ops.compact(pbuf)
        _assert_ref_equal(port, ref_compact(rbuf))
        singles.append(port)
    _assert_batched(ops.compact(stacked), singles)


# ---------------------------------------------------------- RANSAC ----

def _ground_scene(rng, n=3600):
    g = np.column_stack([rng.uniform(-10, 10, (2, 2400)).T, rng.normal(0, 0.03, 2400)])
    obj = rng.normal(0, 2.0, (n - 2400, 3)) + [0, 0, 3]
    return np.vstack([g, obj]).astype(np.float32)[rng.permutation(n)]


def test_segment_plane_live_prefix_bit_equal(rng):
    rbuf, _ = ref_core.from_soa({"positions": _ground_scene(rng)}, capacity=CAPACITY)
    key = jax.random.PRNGKey(11)
    H, n = 64, 3
    u = _t(np.asarray(jax.random.uniform(key, (H, n))))
    pbuf = _port(rbuf)  # front-compacted: 3600 live slots, then dead ones
    assert bool(pbuf.mask[:3600].all()) and not bool(pbuf.mask[3600:].any())
    ref_plane, ref_inl = ref_ground.segment_plane(rbuf, key, 0.12, n, H, live_prefix=True)
    plane, inl = ops.segment_plane(pbuf, None, 0.12, n, H, uniforms=u, live_prefix=True)
    general = ops.segment_plane(pbuf, None, 0.12, n, H, uniforms=u)
    # the draws index the same slots: the same plane and inliers, bit for bit
    assert torch.equal(_bits(plane), _bits(general[0])) and torch.equal(inl, general[1])
    np.testing.assert_allclose(plane.numpy(), np.asarray(ref_plane), atol=1e-5)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(ref_inl))
    # batched, a scan of three with its own draws each
    bufs = [pbuf, ops.compact(pbuf.with_mask(torch.arange(CAPACITY) % 3 > 0)), pbuf]
    draws = torch.stack([u, u.flip(0), u.flip(1)])
    bplane, binl = ops.segment_plane(core.stack_buffers(bufs), None, 0.12, n, H, uniforms=draws,
                                     live_prefix=True)
    for b, d, p, m in zip(bufs, draws, bplane, binl):
        sp, sm = ops.segment_plane(b, None, 0.12, n, H, uniforms=d, live_prefix=True)
        assert torch.equal(_bits(p), _bits(sp)) and torch.equal(m, sm)


def test_segment_plane_score_subsample_matches_reference(rng):
    pts = _ground_scene(rng, 7000)
    rbuf, _ = ref_core.from_soa({"positions": pts}, capacity=8192)
    rbuf = rbuf.with_mask(jnp.asarray(rng.uniform(size=8192) < 0.9))
    key = jax.random.PRNGKey(5)
    H, n = 64, 3
    u = _t(np.asarray(jax.random.uniform(key, (H, n))))
    pbuf = _port(rbuf)
    for sub in (1024, 3000):
        ref_plane, ref_inl = ref_ground.segment_plane(rbuf, key, 0.12, n, H, score_subsample=sub)
        plane, inl = ops.segment_plane(pbuf, None, 0.12, n, H, uniforms=u, score_subsample=sub)
        np.testing.assert_allclose(plane.numpy(), np.asarray(ref_plane), atol=1e-5)
        np.testing.assert_array_equal(inl.numpy(), np.asarray(ref_inl))
        out, gplane = ops.remove_ground(pbuf, None, 0.12, n, H, uniforms=u, score_subsample=sub)
        assert torch.equal(out.mask, pbuf.mask & ~inl) and torch.equal(gplane, plane)
    bplane, binl = ops.segment_plane(core.stack_buffers([pbuf] * 3), None, 0.12, n, H,
                                     uniforms=u, score_subsample=1024)
    sp, sm = ops.segment_plane(pbuf, None, 0.12, n, H, uniforms=u, score_subsample=1024)
    for p, m in zip(bplane, binl):
        assert torch.equal(_bits(p), _bits(sp)) and torch.equal(m, sm)


# ----------------------------------------------------------- voxel ----

def _wide_input(rng, n=7000, label=False):
    """A scene 2 x 60 m wide at voxel 0.05: 2400 cells, beyond the 1008 of
    the 'box' tier, with clusters dense enough to merge, exact duplicates
    and NaN rows."""
    centers = rng.uniform(-60, 60, (40, 3)) * [1, 1, 0.1]
    pts = (centers[rng.integers(0, 40, n)] + rng.normal(0, 0.08, (n, 3))).astype(np.float32)
    dup = rng.integers(0, n, 300)
    pts[dup[:150]] = pts[dup[150:]]
    pts[::53] = np.nan
    soa = {
        "positions": pts,
        "intensity": rng.uniform(0, 255, n).astype(np.float32),
        "ring": rng.integers(0, 32, n).astype(np.uint16),
    }
    rbuf, _ = ref_core.from_soa(soa, capacity=8192)
    rbuf = ref_finite.mask_non_finite(rbuf)
    if label:  # an int32 attribute with values far beyond float32's 2**24
        attrs = dict(rbuf.attributes)
        attrs["label"] = jnp.asarray(rng.integers(-(1 << 30), 1 << 30, 8192).astype(np.int32))
        rbuf = rbuf.replace(attributes=attrs)
    return rbuf


@pytest.mark.parametrize("dedup_exact", [True, False])
def test_voxel_wide_tier_matches_reference(rng, dedup_exact):
    rbuf = _wide_input(rng)
    kw = dict(dedup_exact=dedup_exact, curve_order=True, compact_keys="wide")
    ref = ref_voxel.voxel_downsample(rbuf, 0.05, backend="pallas_interpret", **kw)
    pbuf = _port(rbuf)
    port = ops.voxel_downsample(pbuf, torch.tensor(0.05), **kw)
    live = np.asarray(ref.mask)
    assert 1000 < live.sum() < int(pbuf.mask.sum())  # voxels merge
    np.testing.assert_array_equal(port.mask.numpy(), live)  # front-compacted, same count
    # the same voxels in the same curve order; means within a few ulp
    np.testing.assert_allclose(port.positions.numpy()[:, live], np.asarray(ref.positions)[:, live],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(port.attributes["ring"].numpy()[live],
                                  np.asarray(ref.attributes["ring"])[live])
    # 'wide' groups exactly as the exact voxel-index keys do
    exact = ops.voxel_downsample(pbuf, torch.tensor(0.05), dedup_exact=dedup_exact)
    assert int(exact.mask.sum()) == int(live.sum())
    wide_set = {tuple(p) for p in np.round(port.positions.numpy()[:, live].T, 4).tolist()}
    exact_set = {tuple(p) for p in np.round(exact.positions.numpy()[:, live].T, 4).tolist()}
    assert wide_set == exact_set
    # batched: each scan on its own
    pbufs = [pbuf, _port(_wide_input(rng)), pbuf.with_mask(torch.arange(8192) % 2 == 0)]
    got = ops.voxel_downsample(core.stack_buffers(pbufs), torch.tensor(0.05), **kw)
    _assert_batched(got, [ops.voxel_downsample(b, torch.tensor(0.05), **kw) for b in pbufs])


@pytest.mark.parametrize("curve_order,compact_keys", [(False, False), (True, "wide")])
def test_voxel_wide_int_attribute_bit_equal(rng, curve_order, compact_keys):
    rbuf = _wide_input(rng, label=True)
    kw = dict(dedup_exact=True, curve_order=curve_order, compact_keys=compact_keys)
    ref = ref_voxel.voxel_downsample(rbuf, 0.05, backend="pallas_interpret", **kw)
    pbuf = _port(rbuf)
    port = ops.voxel_downsample(pbuf, torch.tensor(0.05), **kw)
    live = np.asarray(ref.mask)
    np.testing.assert_array_equal(port.mask.numpy(), live)
    assert port.attributes["label"].dtype == torch.int32
    np.testing.assert_array_equal(port.attributes["label"].numpy()[live],
                                  np.asarray(ref.attributes["label"])[live])
    # the label is the first row's of its voxel, a value of the input
    assert set(port.attributes["label"].numpy()[live].tolist()) <= set(
        np.asarray(rbuf.attributes["label"]).tolist())
    pbufs = [pbuf, pbuf.with_mask(torch.arange(8192) % 3 == 0), pbuf]
    got = ops.voxel_downsample(core.stack_buffers(pbufs), torch.tensor(0.05), **kw)
    _assert_batched(got, [ops.voxel_downsample(b, torch.tensor(0.05), **kw) for b in pbufs])
