"""The reference's stage orders in the port, end to end at 8192 capacity:
``bench_suite.py`` config 3 (RANSAC on the raw cloud, no voxel stage),
config 7 (the production preset in the reference's order, ground last)
and ground removal right after the voxel stage with a post-downsample
bucket, through ``build_pipeline`` and through ``Preprocessor``, against
the reference with its own draws. The reference runs its Pallas kernels
in interpret mode, as its own tests do.

The scene is tests/test_e2e_quality.py's density-matched 8000-point scene,
in a spinning sensor's firing order (by azimuth) unless a test says
otherwise: config 7's pre-voxel bucket then keeps half the azimuth range
with its objects, where in the scene's own order (every ground point
first) it keeps ground points only (ROADMAP fault 10), which
``test_config7_scene_order_keeps_ground_only`` holds both packages to.
"""
import jax
import numpy as np
import pytest
import torch

from autodriver_pointcloud_preprocessor_tpu.core import from_soa as ref_from_soa
from autodriver_pointcloud_preprocessor_tpu.models import pipeline as ref_pipeline
from autodriver_pointcloud_preprocessor_tpu.models import preprocessor as ref_preprocessor
from autodriver_pointcloud_preprocessor_tpu.models.presets import PRODUCTION_128K_CONFIG
from autodriver_pointcloud_preprocessor_tpu_torch import core
from autodriver_pointcloud_preprocessor_tpu_torch.models import pipeline
from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor

N_POINTS, CAPACITY = 8000, 8192
KEY = jax.random.PRNGKey(0)
#: bench_suite.py config 3 (:162-188): settings and parameters
CONFIG3 = dict(
    remove_duplicates=False, crop_to_roi=False, voxel_downsample=False,
    estimate_normals=False, remove_ground=True, ransac_n=3, num_iterations=100,
)
#: the same under the reference's parameter names, for the engine
CONFIG3_NAMED = {
    "remove_duplicates": False, "crop_to_roi": False, "voxel_size": 0.0,
    "estimate_normals": False, "remove_ground": True, "remove_ground.ransac_number": 3,
    "remove_ground.num_iterations": 100, "remove_ground.distance_threshold": 0.12,
}
#: bench_suite.py config 7 (:420-463), its pre-voxel bucket cut as the scan
CONFIG7 = {
    **PRODUCTION_128K_CONFIG,
    "remove_ground.before_voxel": False,
    "downsample.max_points": 0,
    "downsample.pre_voxel_capacity": 4096,
}
#: ground right after the voxel stage, before the neighbourhood, with the
#: post-downsample bucket folded into its first curve sort
GROUND_FIRST = {
    **PRODUCTION_128K_CONFIG,
    "remove_ground.before_voxel": False,
    "remove_ground.before_neighborhood": True,
    "downsample.pre_voxel_capacity": 4096,
    "downsample.max_points": 2048,
}


@pytest.fixture
def pallas_interpret(monkeypatch):
    # the backend is resolved while tracing: drop executables traced under
    # another backend in this worker, before and after
    monkeypatch.setenv("APC_WINDOW_BACKEND", "pallas_interpret")

    def clear():
        jax.clear_caches()
        ref_pipeline.build_pipeline.cache_clear()
        ref_preprocessor._stage_jit.cache_clear()

    clear()
    yield
    clear()


def _soa(seed=0, sensor_order=True):
    """The density-matched scene (bench._scene at +-10 m, NaN sprinkle
    included) with intensity and ring; by azimuth unless ``sensor_order``
    is False."""
    rng = np.random.default_rng(seed)
    n_ground = int(N_POINTS * 0.6)
    n_obj = N_POINTS - n_ground
    ground = np.column_stack(
        [rng.uniform(-10, 10, (2, n_ground)).T, rng.normal(0, 0.03, n_ground)]
    )
    centers = rng.uniform(-7.5, 7.5, (24, 3)) * [1, 1, 0] + [0, 0, 1.5]
    obj = centers[rng.integers(0, len(centers), n_obj)] + rng.normal(0, 0.8, (n_obj, 3))
    pts = np.vstack([ground, obj]).astype(np.float32)
    pts[:: N_POINTS // 200] = np.nan
    attr = np.random.default_rng(seed + 1)
    soa = {
        "positions": pts,
        "intensity": attr.uniform(0, 255, N_POINTS).astype(np.float32),
        "ring": attr.integers(0, 32, N_POINTS).astype(np.uint16),
    }
    if sensor_order:
        order = np.argsort(np.arctan2(pts[:, 1], pts[:, 0]), kind="stable")
        soa = {k: v[order] for k, v in soa.items()}
    return soa


def _ground_draws(settings, key=KEY):
    return torch.from_numpy(np.array(
        jax.random.uniform(key, (settings.num_iterations, settings.ransac_n))))


def _survivors(positions, mask, normals=None):
    pos = np.asarray(positions)[:, np.asarray(mask)].T
    keys = [tuple(p) for p in np.round(pos, 5).tolist()]
    if normals is None:
        return dict.fromkeys(keys)
    return dict(zip(keys, np.asarray(normals)[:, np.asarray(mask)].T))


def _assert_close(port, ref, normals=True):
    """Survivor jaccard >= 0.99 and, with normals, >= 98% of the common
    survivors' normals within 2 degrees (sign-agnostic)."""
    common = port.keys() & ref.keys()
    jaccard = len(common) / max(len(port.keys() | ref.keys()), 1)
    assert len(common) > 300, (len(port), len(ref))
    assert jaccard >= 0.99, jaccard
    if normals:
        cos = np.array([abs(float(np.dot(port[p], ref[p]))) for p in common])
        share = float((cos >= np.cos(np.deg2rad(2.0))).mean())
        assert share >= 0.98, share


def _ref_run(settings, params, soa, key=KEY):
    rbuf, _ = ref_from_soa(soa, capacity=CAPACITY)
    return ref_pipeline.build_pipeline(settings)(rbuf, params, key)


# ------------------------------------------------------------ config 3 ----

def test_config3_raw_ransac_matches_reference(pallas_interpret):
    rsettings = ref_pipeline.PipelineSettings(**CONFIG3)
    settings = pipeline.PipelineSettings(**CONFIG3)
    assert [n for n, _ in pipeline.stage_functions(settings)] == [
        n for n, _ in ref_pipeline.stage_functions(rsettings)] == ["non_finite", "ground"]
    soa = _soa()
    ref_out, ref_plane = _ref_run(
        rsettings, ref_pipeline.PipelineParams.make(distance_threshold=0.12), soa)
    pbuf, _ = core.from_soa(soa, capacity=CAPACITY, device="cpu")
    out, plane = pipeline.build_pipeline(settings)(
        pbuf, pipeline.PipelineParams.make(distance_threshold=0.12, device="cpu"), None,
        _ground_draws(settings))
    # the reference's refit is NaN-poisoned on a scene with non-finite
    # rows (ROADMAP fault 3): its plane is rounded, the inliers agree
    assert abs(float(plane[2])) > 0.999 and abs(float(ref_plane[2])) > 0.999
    live = pbuf.mask.numpy()
    assert (out.mask.numpy() != np.asarray(ref_out.mask))[live].mean() <= 1e-3
    _assert_close(_survivors(out.positions, out.mask),
                  _survivors(ref_out.positions, ref_out.mask), normals=False)
    # the engine, from the reference-named config, gives the same scan
    engine = Preprocessor(CONFIG3_NAMED, device="cpu")
    assert engine.settings == settings
    eout, eplane = engine.process_buffer(pbuf, ground_uniforms=_ground_draws(settings))
    assert torch.equal(eout.mask, out.mask) and torch.equal(eplane, plane)
    # batched: each scan equals its lone run
    bufs = [core.from_soa(_soa(s), capacity=CAPACITY, device="cpu")[0] for s in range(3)]
    draws = torch.stack([_ground_draws(settings, k) for k in jax.random.split(KEY, 3)])
    params = pipeline.PipelineParams.make(distance_threshold=0.12, device="cpu")
    run = pipeline.build_pipeline(settings)
    bout, bplanes = run(core.stack_buffers(bufs), params, None, draws)
    for b, d, got, p in zip(bufs, draws, core.unstack_buffer(bout), bplanes):
        want, wplane = run(b, params, None, d)
        assert torch.equal(got.mask, want.mask) and torch.equal(p, wplane)


# ------------------------------------------------------------ config 7 ----

def test_config7_reference_order_matches_reference(pallas_interpret):
    settings = ref_pipeline.settings_from_config(CONFIG7)
    port_settings = pipeline.settings_from_config(CONFIG7)
    assert [n for n, _ in pipeline.stage_functions(port_settings)] == [
        n for n, _ in ref_pipeline.stage_functions(settings)] == [
        "non_finite", "crop", "pre_compact", "voxel", "neighborhood", "ground"]
    soa = _soa()
    ref_out, ref_plane = _ref_run(settings, ref_pipeline.params_from_config(CONFIG7), soa)
    pbuf, _ = core.from_soa(soa, capacity=CAPACITY, device="cpu")
    out, plane = pipeline.build_pipeline(port_settings)(
        pbuf, pipeline.params_from_config(CONFIG7, device="cpu"), None,
        _ground_draws(settings))
    # ground runs last, on the voxel means: no dead row is NaN any more
    np.testing.assert_allclose(plane.numpy(), np.asarray(ref_plane), atol=1e-5)
    _assert_close(
        _survivors(out.positions, out.mask, out.attributes["normals"]),
        _survivors(ref_out.positions, ref_out.mask, ref_out.attributes["normals"]),
    )
    # no shrink: the neighbourhood keeps the voxel stage's 4096 capacity
    assert out.capacity == ref_out.capacity == 4096
    # the engine gives the same scan
    eout, eplane = Preprocessor(CONFIG7, device="cpu").process_buffer(
        pbuf, ground_uniforms=_ground_draws(settings))
    assert torch.equal(eout.mask, out.mask) and torch.equal(eout.positions, out.positions)
    assert torch.equal(eout.attributes["normals"], out.attributes["normals"])
    assert torch.equal(eplane, plane)


def test_config7_scene_order_keeps_ground_only(pallas_interpret):
    # ground points first: the 4096 bucket ahead of ground removal holds
    # ground points only, and both packages drop all of the scan's objects
    # (ROADMAP fault 10, the reference's capped-output semantics)
    settings = ref_pipeline.settings_from_config(CONFIG7)
    soa = _soa(sensor_order=False)
    ref_out, _ = _ref_run(settings, ref_pipeline.params_from_config(CONFIG7), soa)
    engine = Preprocessor(CONFIG7, device="cpu")
    pbuf, _ = core.from_soa(soa, capacity=CAPACITY, device="cpu")
    out, plane = engine.process_buffer(pbuf, ground_uniforms=_ground_draws(settings))
    stages = dict(pipeline.stage_functions(engine.settings))
    params = engine.params
    kept = pbuf
    for name in ("non_finite", "crop", "pre_compact"):
        kept, _ = stages[name](kept, params)
    assert float(kept.positions[2, kept.mask].abs().max()) < 0.2  # only ground
    assert int(out.mask.sum()) == int(np.asarray(ref_out.mask).sum()) < 10
    assert abs(float(plane[2])) > 0.999


# ---------------------------------------------------- ground first ----

def test_ground_before_neighborhood_with_bucket_matches_reference(pallas_interpret):
    settings = ref_pipeline.settings_from_config(GROUND_FIRST)
    engine = Preprocessor(GROUND_FIRST, seed=0, device="cpu")
    assert [n for n, _ in pipeline.stage_functions(engine.settings)] == [
        n for n, _ in ref_pipeline.stage_functions(settings)] == [
        "non_finite", "crop", "pre_compact", "voxel", "ground", "neighborhood"]
    soa = _soa()
    # the reference engine's first scan draws from fold_in(PRNGKey(0), 0)
    ref_engine = ref_preprocessor.Preprocessor(GROUND_FIRST, seed=0)
    ref_soa, ref_meta = ref_engine.process_soa(soa, capacity=CAPACITY)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    pbuf, meta = core.from_soa(soa, capacity=CAPACITY, device="cpu")
    out, plane = engine.process_buffer(pbuf, ground_uniforms=_ground_draws(settings, key))
    assert out.capacity == 2048  # the bucket, folded into the neighbourhood
    np.testing.assert_allclose(plane.numpy(), ref_meta["ground_plane_estimate"], atol=1e-5)
    port_soa = core.to_soa(out, meta)
    ref_map = dict(zip(map(tuple, np.round(ref_soa["positions"], 5).tolist()), ref_soa["normals"]))
    _assert_close(dict(zip(map(tuple, np.round(port_soa["positions"], 5).tolist()),
                           port_soa["normals"])), ref_map)
    # the same through build_pipeline, and batched scans equal lone runs
    run = pipeline.build_pipeline(engine.settings)
    direct, _ = run(pbuf, engine.params, None, _ground_draws(settings, key))
    assert torch.equal(direct.mask, out.mask) and torch.equal(direct.positions, out.positions)
    bufs = [core.from_soa(_soa(s), capacity=CAPACITY, device="cpu")[0] for s in range(3)]
    draws = torch.stack([_ground_draws(settings, k) for k in jax.random.split(KEY, 3)])
    outs, planes = engine.process_batch(bufs, ground_uniforms=draws)
    for b, d, got, p in zip(bufs, draws, outs, planes):
        want, wplane = run(b, engine.params, None, d)
        assert torch.equal(got.mask, want.mask) and torch.equal(p, wplane)
        assert torch.equal(got.attributes["normals"], want.attributes["normals"])


def test_profile_mode_emits_ground_at_its_position():
    # the reference order times ground last, the ground-first order right
    # after the voxel stage: the keys in the reference's order of its
    # profile-mode stages
    for cfg in (CONFIG7, GROUND_FIRST):
        engine = Preprocessor(cfg, profile=True, device="cpu")
        ref_stages = ref_pipeline.stage_functions(
            ref_pipeline.settings_from_config(cfg), separate_stages=True)
        engine.process_soa(_soa(1), capacity=CAPACITY)
        want = dict.fromkeys(
            ["tensor_transfer"]
            + [ref_pipeline.STAGE_TIMING_KEYS[name] for name, _ in ref_stages]
            + ["preprocessing_time", "device_to_host"])
        keys = list(engine.processing_times)
        assert keys == list(want)
        ground, voxel = keys.index("ground_segmentation"), keys.index("voxel_downsampling")
        assert ground > voxel + (1 if cfg is CONFIG7 else 0)
        assert ("remove_statistical_outliers" in keys[ground:]) == (cfg is GROUND_FIRST)
