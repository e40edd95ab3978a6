"""The other downsamplers and the reference's defaults in the port, end to
end at 8192 capacity: random, uniform and farthest-point downsampling
with a post-downsample bucket that caps their survivors, and
``Preprocessor({})`` (the configuration a bare node runs), through
``build_pipeline`` and through ``Preprocessor``, against the reference's
engine with its own draws. The reference runs its Pallas kernels in
interpret mode, as its own tests do. The scene is
tests/test_e2e_quality.py's density-matched 8000-point scene in a spinning
sensor's firing order (by azimuth).
"""
import jax
import numpy as np
import pytest
import torch

from autodriver_pointcloud_preprocessor_tpu.models import pipeline as ref_pipeline
from autodriver_pointcloud_preprocessor_tpu.models import preprocessor as ref_preprocessor
from autodriver_pointcloud_preprocessor_tpu.models.presets import PRODUCTION_128K_CONFIG
from autodriver_pointcloud_preprocessor_tpu_torch import core
from autodriver_pointcloud_preprocessor_tpu_torch.models import pipeline
from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor

N_POINTS, CAPACITY = 8000, 8192
PRE_VOXEL = 4096
#: the production preset with another downsampler and a 512-point bucket
#: below every downsampler's survivor count, so the capped shrink runs
BUCKET = 512
DOWNSAMPLERS = {
    "random": {"downsample_method": "random", "downsample.sampling_ratio": 0.6},
    "uniform": {"downsample_method": "uniform", "downsample.every_k_points": 2},
    "farthest_point": {"downsample_method": "farthest_point", "downsample.num_samples": 600},
}


def _cfg(name):
    return {
        **PRODUCTION_128K_CONFIG,
        "downsample.pre_voxel_capacity": PRE_VOXEL,
        "downsample.max_points": BUCKET,
        **DOWNSAMPLERS[name],
    }


@pytest.fixture
def pallas_interpret(monkeypatch):
    # the backend is resolved while tracing: drop executables traced under
    # another backend in this worker, before and after
    monkeypatch.setenv("APC_WINDOW_BACKEND", "pallas_interpret")

    def clear():
        jax.clear_caches()
        ref_pipeline.build_pipeline.cache_clear()

    clear()
    yield
    clear()


def _soa(seed=0):
    """The density-matched scene (bench._scene at +-10 m, NaN sprinkle
    included) with intensity and ring, by azimuth."""
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
    order = np.argsort(np.arctan2(pts[:, 1], pts[:, 0]), kind="stable")
    return {k: v[order] for k, v in soa.items()}


def _by_position(soa):
    return dict(zip(map(tuple, np.round(soa["positions"], 5).tolist()), soa["normals"]))


def _assert_close(port, ref):
    """Survivor jaccard >= 0.99 and >= 98% of the common survivors'
    normals within 2 degrees (sign-agnostic)."""
    common = port.keys() & ref.keys()
    jaccard = len(common) / max(len(port.keys() | ref.keys()), 1)
    assert len(common) > 300, (len(port), len(ref))
    assert jaccard >= 0.99, jaccard
    cos = np.array([abs(float(np.dot(port[p], ref[p]))) for p in common])
    share = float((cos >= np.cos(np.deg2rad(2.0))).mean())
    assert share >= 0.98, share


def _same(a, b):
    assert torch.equal(a.mask, b.mask) and torch.equal(a.positions, b.positions)
    for k, v in b.attributes.items():
        assert torch.equal(a.attributes[k], v), k


@pytest.mark.parametrize("method", list(DOWNSAMPLERS))
def test_downsampler_with_shrink_matches_reference(pallas_interpret, method):
    cfg = _cfg(method)
    settings = ref_pipeline.settings_from_config(cfg)
    engine = Preprocessor(cfg, seed=0, device="cpu")
    names = [n for n, _ in pipeline.stage_functions(engine.settings)]
    assert names == [n for n, _ in ref_pipeline.stage_functions(settings)] == [
        "remove_duplicates", "non_finite", "crop", "ground", "pre_compact", "voxel", "shrink",
        "neighborhood"]
    soa = _soa()
    ref_soa, ref_meta = ref_preprocessor.Preprocessor(cfg, seed=0).process_soa(
        soa, capacity=CAPACITY)
    # the reference engine's first scan: one key, fold_in(PRNGKey(0), 0),
    # for RANSAC and for the downsampler (at the pre-voxel bucket's capacity)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    ground = torch.from_numpy(np.array(
        jax.random.uniform(key, (settings.num_iterations, settings.ransac_n))))
    draws = torch.from_numpy(np.array(jax.random.uniform(key, (PRE_VOXEL,))))
    buf, meta = core.from_soa(soa, capacity=CAPACITY, device="cpu")
    out, plane = engine.process_buffer(buf, ground_uniforms=ground, downsample_uniforms=draws)
    assert out.capacity == BUCKET
    assert abs(float(plane[2])) > 0.999  # the reference's refit: fault 3
    _assert_close(_by_position(core.to_soa(out, meta)), _by_position(ref_soa))
    # build_pipeline gives the engine's scan
    run = pipeline.build_pipeline(engine.settings)
    direct, _ = run(buf, engine.params, None, ground, draws)
    _same(direct, out)
    # batched: each scan equals its lone run with its own draws
    bufs = [core.from_soa(_soa(s), capacity=CAPACITY, device="cpu")[0] for s in range(3)]
    gen = torch.Generator().manual_seed(1)
    gdraws = torch.rand((3, settings.num_iterations, settings.ransac_n), generator=gen)
    ddraws = torch.rand((3, PRE_VOXEL), generator=gen)
    for sequential in (False, True):
        outs, planes = engine.process_batch(bufs, sequential=sequential, ground_uniforms=gdraws,
                                            downsample_uniforms=ddraws)
        for b, g, d, got, p in zip(bufs, gdraws, ddraws, outs, planes):
            want, wplane = run(b, engine.params, None, g, d)
            _same(got, want)
            assert torch.equal(p, wplane)


def test_random_downsampler_draws_from_the_generator():
    # without draws, the engine's generator gives every scan its own
    cfg = _cfg("random")
    buf, _ = core.from_soa(_soa(), capacity=CAPACITY, device="cpu")
    a = Preprocessor(cfg, seed=3, device="cpu")
    first, second = a.process_buffer(buf)[0], a.process_buffer(buf)[0]
    again = Preprocessor(cfg, seed=3, device="cpu").process_buffer(buf)[0]
    _same(again, first)
    assert not torch.equal(first.mask, second.mask)


def test_defaults_match_reference(pallas_interpret):
    # the configuration a bare node runs: dedup fused into a voxel stage at
    # 1 cm (no compact keys: nothing consumes the curve order), crop, and
    # standalone normals
    settings = ref_pipeline.settings_from_config({})
    engine = Preprocessor({}, device="cpu")
    assert engine.settings.voxel_compact_keys == settings.voxel_compact_keys == "wide"
    assert [n for n, _ in pipeline.stage_functions(engine.settings)] == [
        n for n, _ in ref_pipeline.stage_functions(settings)] == [
        "non_finite", "crop", "voxel", "normals"]
    soa = _soa()
    ref_soa, ref_meta = ref_preprocessor.Preprocessor({}).process_soa(soa, capacity=CAPACITY)
    port_soa, meta = engine.process_soa(soa, capacity=CAPACITY)
    assert meta.keys() == ref_meta.keys() and meta["ground_plane_estimate"] is None
    assert port_soa.keys() == ref_soa.keys()
    _assert_close(_by_position(port_soa), _by_position(ref_soa))
    # build_pipeline, and a batch of 3 against lone runs
    run = pipeline.build_pipeline(engine.settings)
    bufs = [core.from_soa(_soa(s), capacity=CAPACITY, device="cpu")[0] for s in range(3)]
    direct, plane = run(bufs[0], engine.params, None)
    assert torch.isnan(plane).all()
    np.testing.assert_array_equal(core.to_soa(direct)["positions"], port_soa["positions"])
    outs, _ = engine.process_batch(bufs)
    for b, got in zip(bufs, outs):
        _same(got, run(b, engine.params, None)[0])
