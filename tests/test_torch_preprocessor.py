"""The port's ``Preprocessor`` engine and its batched runs, at 8192 capacity.

The batched pipeline is held bit for bit against the port's own
single-scan pipeline, and ``process_batch`` against the reference's
vmapped ``process_batch`` with the reference's per-scan RANSAC draws. The
scenes are tests/test_e2e_quality.py's density-matched scene with 60%,
40% and 20% ground, so that one scan stays under the 3584-point
neighbourhood bucket and two overflow it. The reference runs its Pallas
kernels in interpret mode, as its own tests do.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from autodriver_pointcloud_preprocessor_tpu.core import from_soa as ref_from_soa
from autodriver_pointcloud_preprocessor_tpu.models import pipeline as ref_pipeline
from autodriver_pointcloud_preprocessor_tpu.models import preprocessor as ref_preprocessor
from autodriver_pointcloud_preprocessor_tpu.models.presets import PRODUCTION_128K_CONFIG
from autodriver_pointcloud_preprocessor_tpu.ops import transform as ref_transform
from autodriver_pointcloud_preprocessor_tpu_torch import convert, core
from autodriver_pointcloud_preprocessor_tpu_torch.models import pipeline
from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor
from autodriver_pointcloud_preprocessor_tpu_torch.ops import transform

CFG = {
    **PRODUCTION_128K_CONFIG,
    "downsample.pre_voxel_capacity": 4096,
    "downsample.max_points": 3584,
}
N_POINTS, CAPACITY = 8000, 8192
GROUND_SHARES = (0.6, 0.4, 0.2)  # voxels ~3050 (under 3584), ~4090, ~4080


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


def _soa(seed, ground):
    """bench._scene at +-10 m with ``ground`` of the points on the ground
    plane, NaN sprinkle included."""
    rng = np.random.default_rng(seed)
    n_ground = int(N_POINTS * ground)
    n_obj = N_POINTS - n_ground
    g = np.column_stack([rng.uniform(-10, 10, (2, n_ground)).T, rng.normal(0, 0.03, n_ground)])
    centers = rng.uniform(-7.5, 7.5, (24, 3)) * [1, 1, 0] + [0, 0, 1.5]
    obj = centers[rng.integers(0, len(centers), n_obj)] + rng.normal(0, 0.8, (n_obj, 3))
    pts = np.vstack([g, obj]).astype(np.float32)
    pts[:: N_POINTS // 200] = np.nan
    attr = np.random.default_rng(seed + 100)
    return {
        "positions": pts,
        "intensity": attr.uniform(0, 255, N_POINTS).astype(np.float32),
        "ring": attr.integers(0, 32, N_POINTS).astype(np.uint16),
    }


def _port_bufs(shares=GROUND_SHARES):
    return [core.from_soa(_soa(i, g), capacity=CAPACITY, device="cpu")[0]
            for i, g in enumerate(shares)]


def _draws(settings, batch, seed=5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.uniform(size=(batch, settings.num_iterations, settings.ransac_n)).astype(np.float32)
    )


def _bits_equal(a, b):
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _assert_same_scan(got, want):
    assert _bits_equal(got.positions, want.positions)
    assert torch.equal(got.mask, want.mask)
    assert got.attributes.keys() == want.attributes.keys()
    for k in want.attributes:
        assert _bits_equal(got.attributes[k], want.attributes[k]), k


def _survivors(positions, mask, normals):
    pos = np.asarray(positions)[:, np.asarray(mask)].T
    nrm = np.asarray(normals)[:, np.asarray(mask)].T
    return {tuple(p): n for p, n in zip(np.round(pos, 5).tolist(), nrm)}


def _compare_survivors(port, ref):
    common = port.keys() & ref.keys()
    jaccard = len(common) / max(len(port.keys() | ref.keys()), 1)
    cos = np.array([abs(float(np.dot(port[p], ref[p]))) for p in common])
    return jaccard, float((cos >= np.cos(np.deg2rad(2.0))).mean())


# ------------------------------------------------- batched == single ----

def test_batched_pipeline_equals_single_scans():
    settings = pipeline.settings_from_config(CFG)
    params = pipeline.params_from_config(CFG, device="cpu")
    bufs = _port_bufs()
    draws = _draws(settings, len(bufs))
    # one scan under the neighbourhood bucket and two over it
    stages = dict(pipeline.stage_functions(settings))
    voxels = []
    for buf, u in zip(bufs, draws):
        for name in ("non_finite", "crop", "ground", "pre_compact", "voxel"):
            buf, _ = stages[name](buf, params, None, u)
        voxels.append(int(buf.mask.sum()))
    bucket = CFG["downsample.max_points"]
    assert min(voxels) < bucket < max(voxels), voxels

    run = pipeline.build_pipeline(settings)
    singles = [run(b, params, None, u) for b, u in zip(bufs, draws)]
    out, planes = run(core.stack_buffers(bufs), params, None, draws)
    assert planes.shape == (len(bufs), 4) and out.mask.shape == (len(bufs), bucket)
    for (want, want_plane), got, plane in zip(singles, core.unstack_buffer(out), planes):
        _assert_same_scan(got, want)
        assert _bits_equal(plane, want_plane)
        assert "normals" in got.attributes and int(got.mask.sum()) > 1000

    # the engine: one batched run and a loop of single-scan runs agree too
    engine = Preprocessor(CFG, device="cpu")
    for sequential in (False, True):
        outs, eplanes = engine.process_batch(bufs, sequential=sequential, ground_uniforms=draws)
        assert eplanes.shape == (len(bufs), 4)
        for (want, want_plane), got, plane in zip(singles, outs, eplanes):
            _assert_same_scan(got, want)
            assert _bits_equal(plane, want_plane)
    assert engine.process_batch([])[1].shape == (0, 4)


def test_batched_buffers_round_trip_and_convert():
    bufs = _port_bufs()
    stacked = core.stack_buffers(bufs)
    assert stacked.positions.shape == (3, 3, CAPACITY)
    assert stacked.batch_shape == (3,) and stacked.x.shape == (3, CAPACITY)
    for got, want in zip(core.unstack_buffer(stacked), bufs):
        _assert_same_scan(got, want)
    np.testing.assert_array_equal(
        core.valid_count(stacked).numpy(), [int(b.mask.sum()) for b in bufs]
    )
    # the reference's batched arrays (a leading axis, as vmap gives them)
    ref = [ref_from_soa(_soa(i, g), capacity=CAPACITY)[0] for i, g in enumerate(GROUND_SHARES)]
    batched = convert.scan_from_reference(
        np.stack([np.asarray(b.positions) for b in ref]),
        np.stack([np.asarray(b.mask) for b in ref]),
        {k: np.stack([np.asarray(b.attributes[k]) for b in ref]) for k in ref[0].attributes},
        device="cpu",
    )
    _assert_same_scan(batched, stacked)
    with pytest.raises(ValueError):
        convert.scan_from_reference(
            np.zeros((2, 3, 64), np.float32), np.ones((3, 64), bool), {}, device="cpu"
        )


# ---------------------------------------------------- vs reference ----

def test_process_batch_matches_reference(pallas_interpret):
    shares = GROUND_SHARES[:2]
    ref_engine = ref_preprocessor.Preprocessor(CFG, seed=0)
    ref_bufs = [ref_from_soa(_soa(i, g), capacity=CAPACITY)[0] for i, g in enumerate(shares)]
    ref_outs, ref_planes = ref_engine.process_batch(ref_bufs)
    # the reference's draws: scan i of the first batch uses
    # split(fold_in(key, frame 0), B)[i]
    settings = ref_pipeline.settings_from_config(CFG)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0), len(shares))
    draws = torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(k, (settings.num_iterations, settings.ransac_n)))
        for k in keys
    ]))
    engine = Preprocessor(CFG, seed=0, device="cpu")
    outs, planes = engine.process_batch(_port_bufs(shares), ground_uniforms=draws)
    for out, plane, ref_out, ref_plane in zip(outs, planes, ref_outs, np.asarray(ref_planes)):
        # the reference's refit is NaN-poisoned on these scenes (ROADMAP,
        # faults found): the planes differ slightly, both find the ground
        assert abs(float(plane[2])) > 0.999 and abs(float(ref_plane[2])) > 0.999
        jaccard, normals_ok = _compare_survivors(
            _survivors(out.positions.numpy(), out.mask.numpy(),
                       out.attributes["normals"].numpy()),
            _survivors(ref_out.positions, ref_out.mask, ref_out.attributes["normals"]),
        )
        assert jaccard >= 0.99, jaccard
        assert normals_ok >= 0.98, normals_ok


@pytest.mark.parametrize("profile", [False, True])
def test_process_soa_keys_and_metadata_match_reference(pallas_interpret, profile):
    soa = _soa(0, 0.6)
    ref_engine = ref_preprocessor.Preprocessor(CFG, profile=profile)
    ref_out, ref_meta = ref_engine.process_soa(soa, capacity=CAPACITY)
    engine = Preprocessor(CFG, profile=profile, device="cpu")
    out, meta = engine.process_soa(soa, capacity=CAPACITY)
    assert engine.processing_times.keys() == ref_engine.processing_times.keys()
    assert all(v >= 0 for v in engine.processing_times.values())
    if profile:  # every stage, duplicates as their own stage
        assert {"remove_duplicate_points", "voxel_downsampling",
                "remove_statistical_outliers"} <= engine.processing_times.keys()
    assert meta.keys() == ref_meta.keys()
    assert meta["has_normals"] is True and ref_meta["has_normals"] is True
    for plane in (meta["ground_plane_estimate"], ref_meta["ground_plane_estimate"]):
        assert plane.shape == (4,) and abs(float(plane[2])) > 0.999
    assert out.keys() == ref_out.keys()
    n = out["positions"].shape[0]
    assert n > 1000 and out["normals"].shape == (n, 3) and out["ring"].dtype == np.uint16
    assert abs(n - ref_out["positions"].shape[0]) <= 0.02 * n


def test_process_soa_async_resolves_to_process_soa():
    soa = _soa(1, 0.4)
    engine = Preprocessor(CFG, seed=3, device="cpu")
    resolve = engine.process_soa_async(soa, capacity=CAPACITY)
    out_a, meta_a = resolve()
    engine = Preprocessor(CFG, seed=3, device="cpu")
    out_b, meta_b = engine.process_soa(soa, capacity=CAPACITY)
    assert out_a.keys() == out_b.keys()
    for k in out_a:
        np.testing.assert_array_equal(out_a[k], out_b[k])
    np.testing.assert_array_equal(meta_a["ground_plane_estimate"], meta_b["ground_plane_estimate"])
    assert engine.count(core.from_soa(soa, capacity=CAPACITY, device="cpu")[0]) == N_POINTS


# ------------------------------------------- reconfigure and transform ----

def test_update_config_rolls_back_like_the_reference():
    engine = Preprocessor(CFG, device="cpu")
    ref_engine = ref_preprocessor.Preprocessor(CFG)
    for bad in ({"knn_kmode": "nope"}, {"window_blocks": 9}):
        for eng in (engine, ref_engine):
            with pytest.raises(ValueError):
                eng.update_config(bad)
        assert engine.config == ref_engine.config == CFG
        assert engine.settings == pipeline.settings_from_config(CFG)
    # the height cut: both engines take it, with equal settings
    for eng in (engine, ref_engine):
        eng.update_config({"remove_ground.method": "height"})
    assert engine.config == ref_engine.config
    assert engine.settings.ground_method == "height"
    assert engine.settings == pipeline.PipelineSettings(
        **dataclasses.asdict(ref_engine.settings))
    np.testing.assert_array_equal(engine.params.ground_plane.numpy(),
                                  np.asarray(ref_engine.params.ground_plane))
    engine.update_config({"voxel_size": 0.1})
    ref_engine.update_config({"voxel_size": 0.1})
    assert engine.config == ref_engine.config
    assert float(engine.params.voxel_size) == float(ref_engine.params.voxel_size)


def test_set_tf_matrix_applies_the_transform():
    # the reference's test_pipeline.py::test_preprocessor_tf_applied
    pts = np.zeros((10, 3), np.float32)
    cfg = {"voxel_size": 0.0, "estimate_normals": False,
           "remove_duplicates": False, "crop_to_roi": False}
    engine = Preprocessor(cfg, device="cpu")
    tf = np.eye(4, dtype=np.float32)
    tf[:3, 3] = [1.0, 2.0, 3.0]
    engine.set_tf_matrix(tf)
    assert [n for n, _ in pipeline.stage_functions(engine.settings)] == ["non_finite", "transform"]
    out, _ = engine.process_soa({"positions": pts})
    np.testing.assert_allclose(out["positions"], np.tile([1, 2, 3], (10, 1)), atol=1e-6)
    engine.set_tf_matrix(None)
    out, _ = engine.process_soa({"positions": pts})
    np.testing.assert_array_equal(out["positions"], pts)


def test_transform_stage_matches_reference():
    # an offset matrix in the lidar frame, then the robot transform and
    # the offset again in the robot frame: the stage of each package
    offset = np.eye(4, dtype=np.float32)
    offset[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    offset[:3, 3] = [0.5, -0.25, 1.5]
    tf = np.eye(4, dtype=np.float32)
    tf[:3, 3] = [10.0, 0.0, -2.0]
    soa = _soa(0, 0.6)
    for frame, tf_matrix in (("lidar", None), ("robot", tf)):
        cfg = {**CFG, "offset_pointcloud_matrix": offset.ravel().tolist(),
               "offset_pointcloud_frame": frame, "_has_tf": tf_matrix is not None}
        ref_settings = ref_pipeline.settings_from_config(cfg)
        port_settings = pipeline.settings_from_config(cfg)
        ref_stages = dict(ref_pipeline.stage_functions(ref_settings))
        port_stages = dict(pipeline.stage_functions(port_settings))
        assert "transform" in ref_stages and "transform" in port_stages
        rbuf, _ = ref_from_soa(soa, capacity=CAPACITY)
        ref_out, _ = ref_stages["transform"](
            rbuf, ref_pipeline.params_from_config(cfg, tf_matrix), jax.random.PRNGKey(0))
        pbuf, _ = core.from_soa(soa, capacity=CAPACITY, device="cpu")
        port_out, _ = port_stages["transform"](
            pbuf, pipeline.params_from_config(cfg, tf_matrix, device="cpu"), None, None)
        np.testing.assert_allclose(port_out.positions.numpy(), np.asarray(ref_out.positions),
                                   rtol=1e-6, atol=1e-5)


def test_se3_transform_matches_reference(rng):
    a = rng.normal(size=(3, 3))
    rot, _ = np.linalg.qr(a)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3], m[:3, 3] = rot, rng.normal(0, 5, 3)
    soa = {"positions": rng.normal(0, 20, (500, 3)).astype(np.float32),
           "normals": rng.normal(size=(500, 3)).astype(np.float32)}
    rbuf, _ = ref_from_soa(soa)
    ref = ref_transform.se3_transform(rbuf, jnp.asarray(m))
    pbuf, _ = core.from_soa(soa, device="cpu")
    port = transform.se3_transform(pbuf, torch.from_numpy(m))
    np.testing.assert_allclose(port.positions.numpy(), np.asarray(ref.positions), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(port.attributes["normals"].numpy(),
                               np.asarray(ref.attributes["normals"]), atol=1e-6, rtol=1e-6)
    # a batch transforms each scan alike
    both = transform.se3_transform(core.stack_buffers([pbuf, pbuf]), torch.from_numpy(m))
    for got in core.unstack_buffer(both):
        _assert_same_scan(got, port)


# ---------------------------------------------------- device default ----

ENTRY_POINTS = (
    "from_soa", "PipelineParams.make", "params_from_config",
    "scan_from_reference", "params_from_reference", "Preprocessor",
)


def _entry_points():
    soa = _soa(0, 0.6)
    fields = {f: np.zeros(3, np.float32) for f in pipeline.PipelineParams.__dataclass_fields__}
    return {
        "from_soa": lambda: core.from_soa(soa),
        "PipelineParams.make": lambda: pipeline.PipelineParams.make(),
        "params_from_config": lambda: pipeline.params_from_config(CFG),
        "scan_from_reference": lambda: convert.scan_from_reference(
            np.zeros((3, 64), np.float32), np.ones(64, bool), {}),
        "params_from_reference": lambda: convert.params_from_reference(fields),
        "Preprocessor": lambda: Preprocessor(CFG),
    }


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_need_a_card_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
