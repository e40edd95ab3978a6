"""The outlier pipelines against the reference, at 8192 capacity:
``bench_suite.py`` config 2 (voxel, then statistical and radius outliers
in one fused sweep, or the radius stage on its own in profile mode) with
the sweep and bisect k-selects, and ``PRODUCTION_128K_QUALITY_CONFIG``
(pass-merged normals), through ``build_pipeline``, ``Preprocessor`` and
``process_batch``.

The scene is tests/test_torch_pipeline.py's density-matched 8000-point
scene; the QUALITY preset is cut to a 4096-point pre-voxel bucket and a
3584-point neighbourhood bucket, as the production preset is there. The
reference runs its Pallas kernels in interpret mode, as its own tests do.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from autodriver_pointcloud_preprocessor_tpu.core import from_soa as ref_from_soa
from autodriver_pointcloud_preprocessor_tpu.models import pipeline as ref_pipeline
from autodriver_pointcloud_preprocessor_tpu.models import preprocessor as ref_preprocessor
from autodriver_pointcloud_preprocessor_tpu.models.presets import (
    PRODUCTION_128K_QUALITY_CONFIG,
)
from autodriver_pointcloud_preprocessor_tpu_torch import core
from autodriver_pointcloud_preprocessor_tpu_torch.models import pipeline
from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor

N_POINTS, CAPACITY = 8000, 8192
KEY = jax.random.PRNGKey(0)

#: bench_suite.py config 2 (:141-156), as settings and as parameters
CONFIG2_SETTINGS = dict(
    remove_duplicates=False, crop_to_roi=False, voxel_downsample=True,
    remove_statistical_outliers=True, nb_neighbors=20, remove_radius_outliers=True,
    estimate_normals=False, knn_method="window", voxel_compact_keys=True,
)
CONFIG2_PARAMS = dict(voxel_size=0.08, std_ratio=2.0, radius_nb_points=8,
                      radius_search_radius=0.4)
#: the same configuration as the reference-named dict of the engine
CONFIG2 = {
    "remove_duplicates": False, "crop_to_roi": False, "voxel_size": 0.08,
    "remove_statistical_outliers": True, "remove_statistical_outliers.nb_neighbors": 20,
    "remove_statistical_outliers.std_ratio": 2.0, "remove_radius_outliers": True,
    "remove_radius_outliers.nb_points": 8, "remove_radius_outliers.search_radius": 0.4,
    "estimate_normals": False, "knn_method": "window",
}
QUALITY = {
    **PRODUCTION_128K_QUALITY_CONFIG,
    "downsample.pre_voxel_capacity": 4096,
    "downsample.max_points": 3584,
}


@pytest.fixture
def pallas_interpret(monkeypatch):
    # the backend is resolved while tracing: drop executables traced under
    # another backend in this worker, before and after
    monkeypatch.setenv("APC_WINDOW_BACKEND", "pallas_interpret")

    def clear():
        jax.clear_caches()
        ref_pipeline.build_pipeline.cache_clear()
        ref_preprocessor._batched_pipeline.cache_clear()
        ref_preprocessor._stage_jit.cache_clear()

    clear()
    yield
    clear()


def _scene(n, seed=0):
    """tests/test_e2e_quality.py's density-matched scene (bench._scene at
    +-10 m), NaN sprinkle included."""
    rng = np.random.default_rng(seed)
    n_ground = int(n * 0.6)
    n_obj = n - n_ground
    ground = np.column_stack(
        [rng.uniform(-10, 10, (2, n_ground)).T, rng.normal(0, 0.03, n_ground)]
    )
    centers = rng.uniform(-7.5, 7.5, (24, 3)) * [1, 1, 0] + [0, 0, 1.5]
    obj = centers[rng.integers(0, len(centers), n_obj)] + rng.normal(0, 0.8, (n_obj, 3))
    pts = np.vstack([ground, obj]).astype(np.float32)
    pts[:: max(n // 200, 1)] = np.nan
    return pts


def _soa(seed=0):
    rng = np.random.default_rng(seed + 1)
    return {
        "positions": _scene(N_POINTS, seed),
        "intensity": rng.uniform(0, 255, N_POINTS).astype(np.float32),
        "ring": rng.integers(0, 32, N_POINTS).astype(np.uint16),
    }


def _positions(positions, mask):
    pos = np.asarray(positions)[..., np.asarray(mask)].T
    return {tuple(p) for p in np.round(pos, 5).tolist()}


def _jaccard(a, b):
    return len(a & b) / max(len(a | b), 1)


def _normals_by_position(positions, mask, normals):
    pos = np.asarray(positions)[:, np.asarray(mask)].T
    nrm = np.asarray(normals)[:, np.asarray(mask)].T
    return {tuple(p): n for p, n in zip(np.round(pos, 5).tolist(), nrm)}


def _normals_ok(port, ref):
    """Share of common survivors whose normals agree within 2 degrees,
    sign-agnostic."""
    common = port.keys() & ref.keys()
    cos = np.array([abs(float(np.dot(port[p], ref[p]))) for p in common])
    return float((cos >= np.cos(np.deg2rad(2.0))).mean())


def _config2(kmode):
    return (pipeline.PipelineSettings(**CONFIG2_SETTINGS, knn_kmode=kmode),
            ref_pipeline.PipelineSettings(**CONFIG2_SETTINGS, knn_kmode=kmode))


# ---------------------------------------------------------- config 2 ----

def test_config2_stage_table_follows_the_reference():
    port_s, ref_s = _config2("sweep")
    for separate, names in ((False, ["non_finite", "voxel", "neighborhood"]),
                            (True, ["non_finite", "voxel", "neighborhood", "radius_outliers"])):
        assert [n for n, _ in pipeline.stage_functions(port_s, separate)] == names
        assert [n for n, _ in ref_pipeline.stage_functions(ref_s, separate)] == names
    # statistical outliers without a second window consumer, and exact
    # kNN, run the standalone stages
    for change, names in (
        ({"remove_radius_outliers": False}, ["non_finite", "voxel", "outliers"]),
        ({"knn_method": "exact"}, ["non_finite", "voxel", "outliers", "radius_outliers"]),
        ({"knn_method": "exact", "estimate_normals": True},
         ["non_finite", "voxel", "outliers", "radius_outliers", "normals"]),
    ):
        port = pipeline.stage_functions(dataclasses.replace(port_s, **change))
        ref = ref_pipeline.stage_functions(dataclasses.replace(ref_s, **change))
        assert [n for n, _ in port] == [n for n, _ in ref] == names


@pytest.mark.parametrize("kmode", ["sweep", "bisect"])
def test_config2_matches_reference(pallas_interpret, kmode):
    port_s, ref_s = _config2(kmode)
    rbuf, _ = ref_from_soa({"positions": _scene(N_POINTS)}, capacity=CAPACITY)
    ref_out, ref_plane = ref_pipeline.pipeline_runner(ref_s)(
        rbuf, ref_pipeline.PipelineParams.make(**CONFIG2_PARAMS), KEY)
    pbuf, _ = core.from_soa({"positions": _scene(N_POINTS)}, capacity=CAPACITY, device="cpu")
    out, plane = pipeline.build_pipeline(port_s)(
        pbuf, pipeline.PipelineParams.make(**CONFIG2_PARAMS, device="cpu"), None)
    assert np.isnan(plane.numpy()).all() and np.isnan(np.asarray(ref_plane)).all()
    assert out.capacity == CAPACITY and "normals" not in out.attributes
    survivors = _positions(out.positions, out.mask)
    jaccard = _jaccard(survivors, _positions(ref_out.positions, ref_out.mask))
    assert jaccard >= 0.99, jaccard
    # the filters bite: fewer survivors than voxels
    b = pbuf
    for _, fn in pipeline.stage_functions(port_s)[:2]:
        b = fn(b, pipeline.PipelineParams.make(**CONFIG2_PARAMS, device="cpu"), None, None)[0]
    assert 1000 < len(survivors) < int(b.mask.sum())


@pytest.mark.parametrize("profile", [False, True])
def test_config2_engine_keys_and_metadata_match_reference(pallas_interpret, profile):
    soa = _soa()
    ref_engine = ref_preprocessor.Preprocessor(CONFIG2, profile=profile)
    ref_out, ref_meta = ref_engine.process_soa(soa, capacity=CAPACITY)
    engine = Preprocessor(CONFIG2, profile=profile, device="cpu")
    out, meta = engine.process_soa(soa, capacity=CAPACITY)
    # compact voxel keys are off without the crop, as in the reference
    assert engine.settings.voxel_compact_keys is False
    assert engine.processing_times.keys() == ref_engine.processing_times.keys()
    if profile:  # the radius filter as its own stage
        assert {"voxel_downsampling", "remove_statistical_outliers",
                "remove_radius_outliers"} <= engine.processing_times.keys()
    assert meta.keys() == ref_meta.keys()
    assert "has_normals" not in meta and "has_normals" not in ref_meta
    assert meta["ground_plane_estimate"] is None and ref_meta["ground_plane_estimate"] is None
    assert out.keys() == ref_out.keys() and "normals" not in out
    jaccard = _jaccard(
        {tuple(p) for p in np.round(out["positions"], 5).tolist()},
        {tuple(p) for p in np.round(ref_out["positions"], 5).tolist()},
    )
    assert jaccard >= 0.99, jaccard


def test_config2_batched_equals_single_scans():
    settings, _ = _config2("sweep")
    params = pipeline.PipelineParams.make(**CONFIG2_PARAMS, device="cpu")
    bufs = [core.from_soa(_soa(seed), capacity=CAPACITY, device="cpu")[0] for seed in range(3)]
    run = pipeline.build_pipeline(settings)
    singles = [run(b, params, None)[0] for b in bufs]
    out, _ = run(core.stack_buffers(bufs), params, None)
    for got, want in zip(core.unstack_buffer(out), singles):
        assert torch.equal(got.mask, want.mask)
        assert torch.equal(got.positions.view(torch.int32), want.positions.view(torch.int32))
        for k in want.attributes:
            assert torch.equal(got.attributes[k], want.attributes[k])
    # profile mode's standalone radius stage too
    engine = Preprocessor(CONFIG2, profile=True, device="cpu")
    stages = pipeline.stage_functions(engine.settings, separate_stages=True)
    batch = core.stack_buffers(bufs)
    alone = list(bufs)
    for _, fn in stages:
        batch = fn(batch, engine.params, None, None)[0]
        alone = [fn(b, engine.params, None, None)[0] for b in alone]
    for got, want in zip(core.unstack_buffer(batch), alone):
        assert torch.equal(got.mask, want.mask)


# ---------------------------------------------------- the QUALITY preset ----

def test_quality_preset_matches_reference(pallas_interpret):
    settings = ref_pipeline.settings_from_config(QUALITY)
    assert settings.normals_merge_passes and settings.window_blocks == (2, 0)
    uniforms = np.array(jax.random.uniform(KEY, (settings.num_iterations, settings.ransac_n)))
    rbuf, _ = ref_from_soa(_soa(), capacity=CAPACITY)
    ref_out, ref_plane = ref_pipeline.pipeline_runner(settings)(
        rbuf, ref_pipeline.params_from_config(QUALITY), KEY)
    pbuf, _ = core.from_soa(_soa(), capacity=CAPACITY, device="cpu")
    port_settings = pipeline.settings_from_config(QUALITY)
    assert [n for n, _ in pipeline.stage_functions(port_settings)] == [
        n for n, _ in ref_pipeline.stage_functions(settings)]
    out, plane = pipeline.build_pipeline(port_settings)(
        pbuf, pipeline.params_from_config(QUALITY, device="cpu"), None, torch.from_numpy(uniforms))
    assert abs(float(plane[2])) > 0.999 and abs(float(ref_plane[2])) > 0.999
    port = _normals_by_position(out.positions, out.mask, out.attributes["normals"])
    ref = _normals_by_position(ref_out.positions, ref_out.mask, ref_out.attributes["normals"])
    jaccard = _jaccard(port.keys(), ref.keys())
    assert jaccard >= 0.99, jaccard
    assert _normals_ok(port, ref) >= 0.98
    assert out.capacity == 3584 and len(port) > 1000


def test_quality_process_batch_matches_reference(pallas_interpret):
    ref_engine = ref_preprocessor.Preprocessor(QUALITY, seed=0)
    ref_bufs = [ref_from_soa(_soa(seed), capacity=CAPACITY)[0] for seed in range(2)]
    ref_outs, ref_planes = ref_engine.process_batch(ref_bufs)
    # the reference's draws: scan i of the first batch uses
    # split(fold_in(key, frame 0), B)[i]
    settings = ref_pipeline.settings_from_config(QUALITY)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0), 2)
    draws = torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(k, (settings.num_iterations, settings.ransac_n)))
        for k in keys
    ]))
    engine = Preprocessor(QUALITY, seed=0, device="cpu")
    bufs = [core.from_soa(_soa(seed), capacity=CAPACITY, device="cpu")[0] for seed in range(2)]
    outs, planes = engine.process_batch(bufs, ground_uniforms=draws)
    for i, (out, ref_out) in enumerate(zip(outs, ref_outs)):
        assert abs(float(planes[i, 2])) > 0.999 and abs(float(np.asarray(ref_planes)[i, 2])) > 0.999
        port = _normals_by_position(out.positions, out.mask, out.attributes["normals"])
        ref = _normals_by_position(ref_out.positions, ref_out.mask, ref_out.attributes["normals"])
        assert _jaccard(port.keys(), ref.keys()) >= 0.99
        assert _normals_ok(port, ref) >= 0.98
    # the batch equals its scans run alone, bit for bit
    seq, _ = engine.process_batch(bufs, sequential=True, ground_uniforms=draws)
    for a, b in zip(outs, seq):
        assert torch.equal(a.mask, b.mask)
        assert torch.equal(a.attributes["normals"].view(torch.int32),
                           b.attributes["normals"].view(torch.int32))
