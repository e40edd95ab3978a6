"""Port ops without a kernel of their own, against the reference: the scan
buffer, the front masks, the eigensolver, the curve codes, RANSAC ground,
duplicates and the voxel stage. Inputs are made from a seed with numpy and
given to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodriver_pointcloud_preprocessor_tpu import core as ref_core
from autodriver_pointcloud_preprocessor_tpu.ops.compact import (
    compact_to as ref_compact_to,
    shrink_front as ref_shrink_front,
)
from autodriver_pointcloud_preprocessor_tpu.ops import crop as ref_crop
from autodriver_pointcloud_preprocessor_tpu.ops import dedup as ref_dedup
from autodriver_pointcloud_preprocessor_tpu.ops import finite as ref_finite
from autodriver_pointcloud_preprocessor_tpu.ops import ground as ref_ground
from autodriver_pointcloud_preprocessor_tpu.ops import linalg as ref_linalg
from autodriver_pointcloud_preprocessor_tpu.ops import normals as ref_normals
from autodriver_pointcloud_preprocessor_tpu.ops import voxel as ref_voxel
from autodriver_pointcloud_preprocessor_tpu.ops import window as ref_window
from autodriver_pointcloud_preprocessor_tpu_torch import core
from autodriver_pointcloud_preprocessor_tpu_torch.convert import scan_from_reference
from autodriver_pointcloud_preprocessor_tpu_torch.ops import (
    crop, dedup, finite, ground, linalg, normals, voxel, window,
)
from autodriver_pointcloud_preprocessor_tpu_torch.ops.compact import compact_to, shrink_front


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port(buf):
    return scan_from_reference(
        np.asarray(buf.positions), np.asarray(buf.mask),
        {k: np.asarray(v) for k, v in buf.attributes.items()},
        device="cpu",
    )


def _soa(rng, n, spread=5.0):
    return {
        "positions": rng.uniform(-spread, spread, (n, 3)).astype(np.float32),
        "intensity": rng.uniform(0, 255, n).astype(np.float32),
        "ring": rng.integers(0, 32, n).astype(np.uint16),
        "time": 1.7e9 + rng.uniform(0, 0.1, n),
        "return_type": rng.integers(0, 3, n).astype(np.uint8),
    }


# ------------------------------------------------------------ scan ----

def test_scan_roundtrip_bit_equal_across_packages(rng):
    soa = _soa(rng, 777)
    rbuf, rmeta = ref_core.from_soa(soa)
    pbuf, pmeta = core.from_soa(soa, device="cpu")
    assert pbuf.capacity == rbuf.capacity == core.bucket_capacity(777)
    np.testing.assert_array_equal(pbuf.positions.numpy(), np.asarray(rbuf.positions))
    np.testing.assert_array_equal(pbuf.mask.numpy(), np.asarray(rbuf.mask))
    for name, v in rbuf.attributes.items():
        np.testing.assert_array_equal(pbuf.attributes[name].numpy(), np.asarray(v))
    ref_out, port_out = ref_core.to_soa(rbuf, rmeta), core.to_soa(pbuf, pmeta)
    assert ref_out.keys() == port_out.keys()
    for name in ref_out:
        assert port_out[name].dtype == ref_out[name].dtype, name
        np.testing.assert_array_equal(port_out[name], ref_out[name])
    grown = core.pad_to_capacity(pbuf, 2048)
    assert grown.capacity == 2048 and int(core.valid_count(grown)) == 777


# ----------------------------------------------------- front masks ----

def test_non_finite_and_crop_masks_equal(rng):
    soa = _soa(rng, 2000, spread=8.0)
    soa["positions"][::17, 0] = np.nan
    soa["positions"][::29, 2] = np.inf
    soa["positions"][5] = [4.0, -4.0, 2.0]  # on the ROI faces
    rbuf, _ = ref_core.from_soa(soa)
    pbuf, _ = core.from_soa(soa, device="cpu")
    for nan, inf in ((True, True), (True, False), (False, True)):
        np.testing.assert_array_equal(
            finite.mask_non_finite(pbuf, nan, inf).mask.numpy(),
            np.asarray(ref_finite.mask_non_finite(rbuf, nan, inf).mask),
        )
    lo, hi = np.float32([-4, -4, -3]), np.float32([4, 4, 2])
    for invert in (False, True):
        np.testing.assert_array_equal(
            crop.crop_box(pbuf, _t(lo), _t(hi), torch.tensor(invert)).mask.numpy(),
            np.asarray(ref_crop.crop_box(rbuf, jnp.asarray(lo), jnp.asarray(hi), invert).mask),
        )


# --------------------------------------------------------- linalg ----

def test_smallest_eigvec_matches_reference(rng):
    a = rng.normal(size=(500, 3, 3)).astype(np.float32)
    mats = a @ np.swapaxes(a, 1, 2)
    mats[:5] = 0.0  # degenerate: falls back to (0, 0, 1)
    mats[5:10] = np.eye(3, dtype=np.float32) * 2.0  # isotropic
    ref_vec, ref_val = ref_linalg.smallest_eigenvector_sym3x3(jnp.asarray(mats))
    vec, val = linalg.smallest_eigenvector_sym3x3(_t(mats))
    np.testing.assert_allclose(val.numpy(), np.asarray(ref_val), rtol=1e-4, atol=1e-5)
    dots = np.abs((vec.numpy() * np.asarray(ref_vec)).sum(-1))
    assert (dots > 1 - 1e-5).all()
    entries = [mats[:, i, j] for i, j in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))]
    count = rng.integers(0, 6, 500).astype(np.float32)
    ref_n = np.asarray(ref_normals._normals_from_entries(*map(jnp.asarray, entries), jnp.asarray(count)))
    port_n = normals._normals_from_entries(*map(_t, entries), _t(count)).numpy()
    np.testing.assert_allclose(port_n, ref_n, atol=2e-5)


def _neighbourhood_entries(rng, noise, n_rows=400):
    """Covariance entries (float32, centered) of ``n_rows`` neighbourhoods
    of 3-11 points 0.3 m along a random direction, 25 m from the origin,
    with Gaussian noise of std ``noise`` across it; and each one's float64
    eigenvectors (ascending)."""
    ents, vecs = [], []
    for _ in range(n_rows):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        k = int(rng.integers(3, 12))
        q = (rng.uniform(-25, 25, 3) + rng.uniform(-0.3, 0.3, (k, 1)) * d
             + rng.normal(size=(k, 3)) * noise).astype(np.float32)
        e = q - q.mean(0)
        a = e.T @ e
        ents.append([a[i, j] for i, j in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))])
        e64 = e.astype(np.float64)
        vecs.append(np.linalg.eigh(e64.T @ e64)[1])
    return np.array(ents, np.float32).T, np.array(vecs)


@pytest.mark.parametrize("noise", [1e-6, 1e-5, 1e-4])
def test_line_neighbourhood_normals_are_off_the_line(rng, noise):
    # nearly collinear points: the cross products of the smallest
    # eigenvalue's rows cancel in float32 and the closed form's normal
    # leans on the line; normals_from_entries takes that component off
    # (ROADMAP fault 16). Tolerance: |n . v| <= 1e-5 against the float64
    # line direction v, where the closed form alone leans further
    ent, vecs = _neighbourhood_entries(rng, noise)
    count = np.full(ent.shape[1], 8.0, np.float32)
    n = normals._normals_from_entries(*map(_t, ent), _t(count)).numpy().T
    lean = np.abs((torch.stack(linalg.smallest_eigvec_entries(*map(_t, ent)), -1).numpy()
                   * vecs[:, :, 2]).sum(-1))
    dots = np.abs((n * vecs[:, :, 2]).sum(-1))
    assert dots.max() <= 1e-5, dots.max()
    assert lean.max() > 10 * max(dots.max(), 1e-7), lean.max()


def test_planar_neighbourhood_normals_keep_the_closed_form(rng):
    # away from lines (a plane 0.1 m wide across the line, rows of 3-11
    # points) the normal is the reference's closed form's within rounding
    ent, _ = _neighbourhood_entries(rng, 0.1)
    count = np.full(ent.shape[1], 8.0, np.float32)
    port_n = normals._normals_from_entries(*map(_t, ent), _t(count)).numpy()
    ref_n = np.asarray(ref_normals._normals_from_entries(*map(jnp.asarray, ent),
                                                          jnp.asarray(count)))
    np.testing.assert_allclose(port_n, ref_n, atol=2e-5)


# ---------------------------------------------------- curve codes ----

def test_curve_codes_bit_exact(rng):
    v = rng.integers(0, 1 << 10, 4096).astype(np.int32)
    np.testing.assert_array_equal(
        window._spread_bits_10(_t(v)).numpy(), np.asarray(ref_window._spread_bits_10(jnp.asarray(v)))
    )
    cells = [rng.integers(0, 1024, 4096).astype(np.int32) for _ in range(3)]
    mask = rng.uniform(size=4096) < 0.9
    np.testing.assert_array_equal(
        window.hilbert_cell_codes([_t(c) for c in cells], _t(mask)).numpy(),
        np.asarray(ref_window.hilbert_cell_codes([jnp.asarray(c) for c in cells], jnp.asarray(mask))),
    )
    pos = rng.normal(0, 7, (3, 4096)).astype(np.float32)
    pos[:, ~mask] = np.nan
    for pass_idx in range(3):
        perm = list(ref_window._PASS_PERMS[pass_idx])
        shift = window._pass_shift(pass_idx)
        assert shift == ref_window._pass_shift(pass_idx)
        ref_codes = ref_window.hilbert_codes(jnp.asarray(pos[perm]), jnp.asarray(mask), shift)
        codes = window.hilbert_codes(_t(pos[perm]), _t(mask), shift)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))


# --------------------------------------------------------- ground ----

def _ground_scene(rng, n=6000):
    n_ground = int(n * 0.6)
    g = np.column_stack([rng.uniform(-10, 10, (n_ground, 2)), rng.normal(0, 0.03, n_ground)])
    o = rng.normal(0, 2, (n - n_ground, 3)) + [0, 0, 2]
    pts = np.vstack([g, o]).astype(np.float32)
    rng.shuffle(pts)
    return pts


def test_segment_plane_with_reference_draws(rng):
    pts = _ground_scene(rng)
    rbuf, _ = ref_core.from_soa({"positions": pts}, capacity=8192)
    rbuf = rbuf.with_mask(jnp.asarray(rng.uniform(size=8192) < 0.8))
    key = jax.random.PRNGKey(3)
    H, n = 64, 3
    ref_plane, ref_inl = ref_ground.segment_plane(rbuf, key, 0.12, n, H)
    u = np.asarray(jax.random.uniform(key, (H, n)))
    pbuf = _port(rbuf)
    plane, inl = ground.segment_plane(pbuf, None, 0.12, n, H, uniforms=_t(u))
    # identical sample indices (the reference's rank lookup, ground.py:118-134)
    csum = jnp.cumsum(rbuf.mask.astype(jnp.int32))
    cnt = jnp.maximum(csum[-1], 1)
    draw = jnp.minimum((jnp.asarray(u) * cnt).astype(jnp.int32), cnt - 1)
    ref_idx = np.asarray(jnp.searchsorted(csum, draw + 1, side="left"))
    pcsum = torch.cumsum(pbuf.mask.to(torch.int32), 0, dtype=torch.int32)
    pdraw = torch.minimum((_t(u) * pcsum[-1]).to(torch.int32), pcsum[-1] - 1)
    np.testing.assert_array_equal(torch.searchsorted(pcsum, pdraw + 1).numpy(), ref_idx)
    np.testing.assert_allclose(plane.numpy(), np.asarray(ref_plane), atol=1e-5)
    live = np.asarray(rbuf.mask)
    assert (inl.numpy() != np.asarray(ref_inl))[live].mean() <= 1e-3
    out, gplane = ground.remove_ground(pbuf, None, 0.12, n, H, uniforms=_t(u))
    np.testing.assert_array_equal(out.mask.numpy(), pbuf.mask.numpy() & ~inl.numpy())
    # the generator path draws its own samples and still finds the ground
    gen_plane, _ = ground.segment_plane(pbuf, torch.Generator().manual_seed(0), 0.12, n, H)
    assert abs(float(gen_plane[2])) > 0.99


# ----------------------------------------------------- compaction ----

def test_compact_to_and_shrink_front_match_reference(rng):
    soa = _soa(rng, 3000)
    soa.pop("time")
    rbuf, _ = ref_core.from_soa(soa, capacity=4096)
    rbuf = rbuf.with_mask(jnp.asarray(rng.uniform(size=4096) < 0.5))
    pbuf = _port(rbuf)
    for ref, port in (
        (ref_compact_to(rbuf, 2048), compact_to(pbuf, 2048)),
        (ref_shrink_front(rbuf, 1024), shrink_front(pbuf, 1024)),
    ):
        np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
        np.testing.assert_array_equal(port.positions.numpy(), np.asarray(ref.positions))
        for name, v in ref.attributes.items():
            np.testing.assert_array_equal(port.attributes[name].numpy(), np.asarray(v))
    with pytest.raises(ValueError):
        compact_to(pbuf, 8192)


# ---------------------------------------------------------- dedup ----

def test_duplicate_mask_matches_reference(rng):
    pts = rng.integers(-3, 3, (3000, 3)).astype(np.float32) * 0.5
    pts[::7] = -pts[::7]  # -0.0 must dedup with +0.0
    mask = rng.uniform(size=3000) < 0.9
    ref = ref_dedup.duplicate_mask(jnp.asarray(pts.T), jnp.asarray(mask))
    port = dedup.duplicate_mask(_t(pts.T), _t(mask))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    for r, p in zip(
        ref_dedup._coordinate_keys(jnp.asarray(pts.T), jnp.asarray(mask)),
        dedup._coordinate_keys(_t(pts.T), _t(mask)),
    ):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r).astype(np.int64))


def test_lexsort_orders_signed_and_unsigned_keys(rng):
    a = rng.integers(-(1 << 31), (1 << 31) - 1, 2000, dtype=np.int64).astype(np.int32)
    a[::3] = a[0]  # ties on the first key
    b = rng.integers(0, 1 << 32, 2000, dtype=np.uint64).astype(np.uint32)
    b[::5] = b[1]
    c = rng.integers(-5, 5, 2000).astype(np.int32)
    order = dedup.lexsort([
        dedup.signed_key(_t(a)), dedup.unsigned_key(_t(b.view(np.int32))), dedup.signed_key(_t(c)),
    ])
    np.testing.assert_array_equal(order.numpy(), np.lexsort((c, b, a)))


# ---------------------------------------------------------- voxel ----

def _voxel_input(rng, n=6000):
    soa = _soa(rng, n, spread=3.0)
    soa.pop("time"), soa.pop("return_type")
    soa["positions"][::11] = np.nan
    dup = rng.integers(0, n, 300)  # exact duplicates with their own ring
    soa["positions"][dup[:150]] = soa["positions"][dup[150:]]
    rbuf, _ = ref_core.from_soa(soa, capacity=8192)
    rbuf = ref_finite.mask_non_finite(rbuf)
    return rbuf


@pytest.mark.parametrize(
    "dedup_exact,curve_order,compact_keys,first_attrs",
    [
        (True, True, "box", False),  # the production path
        (True, True, "box", True),
        (False, False, False, True),
        (True, False, False, True),
        (False, True, "box", True),
    ],
)
def test_voxel_matches_reference(rng, dedup_exact, curve_order, compact_keys, first_attrs):
    rbuf = _voxel_input(rng)
    kw = dict(dedup_exact=dedup_exact, curve_order=curve_order, compact_keys=compact_keys)
    ref = ref_voxel.voxel_downsample(
        rbuf, 0.25, backend="pallas_interpret", first_attrs=first_attrs, **kw
    )
    port = voxel.voxel_downsample(_port(rbuf), torch.tensor(0.25), **kw)
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    live = np.asarray(ref.mask)
    assert live.sum() > 500 and live[: live.sum()].all()  # front-compacted
    np.testing.assert_allclose(
        port.positions.numpy()[:, live], np.asarray(ref.positions)[:, live],
        rtol=1e-6, atol=1e-6,
    )
    intensity = port.attributes["intensity"].numpy()[live]
    ref_intensity = np.asarray(ref.attributes["intensity"])[live]
    ring, ref_ring = port.attributes["ring"].numpy()[live], np.asarray(ref.attributes["ring"])[live]
    assert port.attributes["ring"].dtype == torch.int32
    if first_attrs or not dedup_exact:
        np.testing.assert_allclose(intensity, ref_intensity, rtol=1e-5)
        np.testing.assert_array_equal(ring, ref_ring)
        return
    # any exact-duplicate copy may stand for its coordinate (the reference's
    # unstable sort): a voxel may differ only where it holds a duplicated
    # coordinate, and a differing ring must be one of its copies' rings
    valid = np.asarray(rbuf.mask)
    pos = np.asarray(rbuf.positions).T[valid]
    rings = np.asarray(rbuf.attributes["ring"])[valid]
    copies = {}
    for p, r in zip(map(tuple, pos), rings):
        copies.setdefault(p, []).append(int(r))
    by_cell = {}
    for p, rs in copies.items():
        if len(rs) > 1:
            cell = tuple(np.floor(np.float32(p) * np.float32(4.0)).astype(int))
            by_cell.setdefault(cell, []).append(rs)
    means = port.positions.numpy()[:, live].T
    differ = np.nonzero(
        (ring != ref_ring) | ~np.isclose(intensity, ref_intensity, rtol=1e-5)
    )[0]
    assert len(differ) <= 150
    for j in differ:
        groups = by_cell.get(tuple(np.floor(means[j] * np.float32(4.0)).astype(int)), [])
        assert groups, j
        if ring[j] != ref_ring[j]:
            assert any(ring[j] in rs and ref_ring[j] in rs for rs in groups), j


def test_voxel_rejects_unported_tiers(rng):
    # every tier of the reference runs: 'wide' matches it; compact keys
    # without the curve order and unknown tiers are refused
    rbuf = _voxel_input(rng, 500)
    pbuf = _port(rbuf)
    kw = dict(dedup_exact=True, curve_order=True, compact_keys="wide")
    ref = ref_voxel.voxel_downsample(rbuf, 0.25, backend="pallas_interpret", **kw)
    port = voxel.voxel_downsample(pbuf, torch.tensor(0.25), **kw)
    live = np.asarray(ref.mask)
    np.testing.assert_array_equal(port.mask.numpy(), live)
    np.testing.assert_allclose(port.positions.numpy()[:, live], np.asarray(ref.positions)[:, live],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(port.attributes["ring"].numpy()[live],
                                  np.asarray(ref.attributes["ring"])[live])
    with pytest.raises(ValueError):
        voxel.voxel_downsample(pbuf, 0.25, compact_keys="box")
    with pytest.raises(ValueError):
        voxel.voxel_downsample(pbuf, 0.25, curve_order=True, compact_keys="huge")
