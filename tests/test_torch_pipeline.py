"""The port's production pipeline against the reference, at 8192 capacity.

The scene is the density-matched 8000-point scene of
tests/test_e2e_quality.py; ``PRODUCTION_128K_CONFIG`` is cut to a
4096-point pre-voxel bucket and a 3584-point neighbourhood bucket so that
the stream compaction (K1) and the shrink both engage. The reference runs
its Pallas kernels in interpret mode, as its own tests do.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodriver_pointcloud_preprocessor_tpu.core import from_soa as ref_from_soa
from autodriver_pointcloud_preprocessor_tpu.models import pipeline as ref_pipeline
from autodriver_pointcloud_preprocessor_tpu.models.presets import PRODUCTION_128K_CONFIG
from autodriver_pointcloud_preprocessor_tpu_torch.convert import (
    params_from_reference,
    scan_from_reference,
)
from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa, to_soa
from autodriver_pointcloud_preprocessor_tpu_torch.models import pipeline
from autodriver_pointcloud_preprocessor_tpu_torch.models.presets import (
    PRODUCTION_128K_CONFIG as PORT_PRODUCTION_128K_CONFIG,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {
    **PRODUCTION_128K_CONFIG,
    "downsample.pre_voxel_capacity": 4096,
    "downsample.max_points": 3584,
}
N_POINTS, CAPACITY = 8000, 8192
KEY = jax.random.PRNGKey(0)


@pytest.fixture
def pallas_interpret(monkeypatch):
    # the backend is resolved while tracing: drop executables traced under
    # another backend in this worker, before and after
    monkeypatch.setenv("APC_WINDOW_BACKEND", "pallas_interpret")
    jax.clear_caches()
    ref_pipeline.build_pipeline.cache_clear()
    yield
    jax.clear_caches()
    ref_pipeline.build_pipeline.cache_clear()


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


def _soa():
    rng = np.random.default_rng(1)
    return {
        "positions": _scene(N_POINTS),
        "intensity": rng.uniform(0, 255, N_POINTS).astype(np.float32),
        "ring": rng.integers(0, 32, N_POINTS).astype(np.uint16),
    }


def _sensor_order(soa):
    """The scene's points in a spinning sensor's firing order (by azimuth,
    non-finite rows last): ground and objects interleave, as in a real
    scan. In the scene's own order every ground point comes first, and a
    pre-voxel bucket ahead of ground removal (the reference's stage order)
    holds ground points only (ROADMAP fault 10)."""
    pts = soa["positions"]
    order = np.argsort(np.arctan2(pts[:, 1], pts[:, 0]), kind="stable")
    return {k: v[order] for k, v in soa.items()}


def _to_port(buf):
    return scan_from_reference(
        np.asarray(buf.positions), np.asarray(buf.mask),
        {k: np.asarray(v) for k, v in buf.attributes.items()},
        device="cpu",
    )


def _uniforms(settings):
    return torch.from_numpy(np.array(
        jax.random.uniform(KEY, (settings.num_iterations, settings.ransac_n))
    ))


def _survivors(positions, mask, normals):
    pos = np.asarray(positions)[:, np.asarray(mask)].T
    nrm = np.asarray(normals)[:, np.asarray(mask)].T
    return {tuple(p): n for p, n in zip(np.round(pos, 5).tolist(), nrm)}


def _compare_survivors(port, ref, degrees=2.0):
    """(jaccard of the rounded survivor positions, share of common
    survivors whose normals agree within ``degrees``, sign-agnostic)."""
    common = port.keys() & ref.keys()
    jaccard = len(common) / max(len(port.keys() | ref.keys()), 1)
    cos = np.array([abs(float(np.dot(port[p], ref[p]))) for p in common])
    return jaccard, float((cos >= np.cos(np.deg2rad(degrees))).mean())


def test_presets_are_the_reference_presets():
    assert PORT_PRODUCTION_128K_CONFIG == PRODUCTION_128K_CONFIG
    assert pipeline.settings_from_config(CFG) == dataclasses.replace(
        pipeline.PipelineSettings(), **dataclasses.asdict(ref_pipeline.settings_from_config(CFG))
    )


def test_stage_by_stage_matches_reference(pallas_interpret):
    settings = ref_pipeline.settings_from_config(CFG)
    rparams = ref_pipeline.params_from_config(CFG)
    pparams = params_from_reference(
        {f.name: np.asarray(getattr(rparams, f.name)) for f in dataclasses.fields(rparams)},
        device="cpu",
    )
    ref_stages = ref_pipeline.stage_functions(settings)
    port_stages = pipeline.stage_functions(pipeline.settings_from_config(CFG))
    names = [name for name, _ in ref_stages]
    assert names == [name for name, _ in port_stages] == [
        "non_finite", "crop", "ground", "pre_compact", "voxel", "neighborhood",
    ]
    uniforms = _uniforms(settings)
    rbuf, _ = ref_from_soa(_soa(), capacity=CAPACITY)
    for (name, ref_fn), (_, port_fn) in zip(ref_stages, port_stages):
        if name == "ground":
            # zero the dead rows' NaN coordinates for the reference: its
            # refit sums NaN * 0 otherwise and skips the refit (the port
            # zeroes them itself; ROADMAP, faults found)
            rbuf = rbuf.replace(positions=jnp.where(rbuf.mask, rbuf.positions, 0.0))
        ref_out, ref_aux = ref_fn(rbuf, rparams, KEY)
        port_out, port_aux = port_fn(_to_port(rbuf), pparams, None, uniforms)
        rmask, pmask = np.asarray(ref_out.mask), port_out.mask.numpy()
        if name in ("non_finite", "crop"):
            np.testing.assert_array_equal(pmask, rmask)
        elif name == "ground":
            np.testing.assert_allclose(port_aux.numpy(), np.asarray(ref_aux), atol=1e-5)
            live = np.asarray(rbuf.mask)
            assert (pmask != rmask)[live].mean() <= 1e-3
            # no live point is dropped by the 4096 pre-voxel bucket
            assert rmask.sum() <= CFG["downsample.pre_voxel_capacity"]
        elif name == "pre_compact":
            assert port_out.capacity == ref_out.capacity == 4096
            np.testing.assert_array_equal(pmask, rmask)
            np.testing.assert_array_equal(port_out.positions.numpy(), np.asarray(ref_out.positions))
            for k, v in ref_out.attributes.items():
                np.testing.assert_array_equal(port_out.attributes[k].numpy(), np.asarray(v))
        elif name == "voxel":
            np.testing.assert_array_equal(pmask, rmask)
            # no live point is dropped by the 3584 neighbourhood bucket
            assert rmask.sum() <= CFG["downsample.max_points"]
            np.testing.assert_allclose(
                port_out.positions.numpy()[:, rmask], np.asarray(ref_out.positions)[:, rmask],
                rtol=1e-6, atol=1e-6,
            )
            # the random scene has no exact duplicates: the donors are exact
            np.testing.assert_array_equal(
                port_out.attributes["ring"].numpy()[rmask],
                np.asarray(ref_out.attributes["ring"])[rmask],
            )
        else:  # neighborhood: the pass-1 re-sort orders ties differently
            assert port_out.capacity == ref_out.capacity == 3584
            jaccard, normals_ok = _compare_survivors(
                _survivors(port_out.positions.numpy(), pmask, port_out.attributes["normals"].numpy()),
                _survivors(ref_out.positions, rmask, ref_out.attributes["normals"]),
            )
            assert jaccard >= 0.99, jaccard
            assert normals_ok >= 0.98, normals_ok
        rbuf = ref_out


def test_chained_pipeline_matches_reference(pallas_interpret):
    settings = ref_pipeline.settings_from_config(CFG)
    rbuf, _ = ref_from_soa(_soa(), capacity=CAPACITY)
    ref_out, ref_plane = ref_pipeline.build_pipeline(settings)(
        rbuf, ref_pipeline.params_from_config(CFG), KEY
    )
    pbuf, meta = from_soa(_soa(), capacity=CAPACITY, device="cpu")
    port_settings = pipeline.settings_from_config(CFG)
    run = pipeline.build_pipeline(port_settings)
    assert run is pipeline.build_pipeline(port_settings)
    port_out, port_plane = run(
        pbuf, pipeline.params_from_config(CFG, device="cpu"), None, ground_uniforms=_uniforms(settings)
    )
    # the reference's refit is NaN-poisoned on this scene (ROADMAP, faults
    # found), so the planes differ slightly; both find the ground
    assert abs(float(port_plane[2])) > 0.999 and abs(float(ref_plane[2])) > 0.999
    jaccard, normals_ok = _compare_survivors(
        _survivors(port_out.positions.numpy(), port_out.mask.numpy(),
                   port_out.attributes["normals"].numpy()),
        _survivors(ref_out.positions, ref_out.mask, ref_out.attributes["normals"]),
    )
    assert jaccard >= 0.99, jaccard
    assert normals_ok >= 0.98, normals_ok
    soa = to_soa(port_out, meta)
    n = int(port_out.mask.sum())
    assert n > 1000 and soa["positions"].shape == (n, 3)
    assert soa["normals"].shape == (n, 3) and soa["ring"].dtype == np.uint16
    assert np.isfinite(soa["positions"]).all()


def test_production_xla_route_matches_reference():
    # PipelineSettings(pallas_ok=False) on the production preset: the
    # reference's XLA window route, which it runs natively on the CPU
    settings = dataclasses.replace(ref_pipeline.settings_from_config(CFG), pallas_ok=False)
    rbuf, _ = ref_from_soa(_soa(), capacity=CAPACITY)
    ref_out, ref_plane = ref_pipeline.build_pipeline(settings)(
        rbuf, ref_pipeline.params_from_config(CFG), KEY
    )
    port_settings = dataclasses.replace(pipeline.settings_from_config(CFG), pallas_ok=False)
    pbuf, _ = from_soa(_soa(), capacity=CAPACITY, device="cpu")
    port_out, port_plane = pipeline.build_pipeline(port_settings)(
        pbuf, pipeline.params_from_config(CFG, device="cpu"), None, _uniforms(settings)
    )
    assert port_out.capacity == ref_out.capacity == CFG["downsample.max_points"]
    assert abs(float(port_plane[2])) > 0.999 and abs(float(ref_plane[2])) > 0.999
    jaccard, normals_ok = _compare_survivors(
        _survivors(port_out.positions.numpy(), port_out.mask.numpy(),
                   port_out.attributes["normals"].numpy()),
        _survivors(ref_out.positions, ref_out.mask, ref_out.attributes["normals"]),
        degrees=1.0,
    )
    assert int(port_out.mask.sum()) > 1000
    assert jaccard >= 0.995, jaccard
    assert normals_ok >= 0.99, normals_ok


def test_engine_pallas_ok_false_runs_the_xla_route():
    # Preprocessor(pallas_ok=False): the engine's settings keep the XLA
    # window route through update_config and set_tf_matrix, and its scan
    # is build_pipeline's with those settings, bit for bit
    from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor

    engine = Preprocessor(CFG, device="cpu", pallas_ok=False)
    settings = dataclasses.replace(pipeline.settings_from_config(CFG), pallas_ok=False)
    assert engine.settings == settings
    assert Preprocessor(CFG, device="cpu").settings.pallas_ok
    buf, _ = from_soa(_soa(), capacity=CAPACITY, device="cpu")
    u = _uniforms(settings)
    got, got_plane = engine.process_buffer(buf, u)
    want, want_plane = pipeline.build_pipeline(settings)(buf, engine.params, None, u)
    assert torch.equal(got.mask, want.mask) and torch.equal(got.positions, want.positions)
    assert torch.equal(got_plane, want_plane)
    assert torch.equal(got.attributes["normals"], want.attributes["normals"])
    engine.update_config({"voxel_size": 0.08})
    engine.set_tf_matrix(np.eye(4))
    engine.set_tf_matrix(np.eye(4))
    assert engine.settings == dataclasses.replace(
        pipeline.settings_from_config({**CFG, "voxel_size": 0.08, "_has_tf": True}),
        pallas_ok=False)


def test_neighborhood_overflow_thin_matches_reference(pallas_interpret):
    # a 2048 bucket below the ~3000 voxels: the binomial thin and the
    # pass-0 sort replace the prefix slice (a host-side branch in the port)
    cfg = {**CFG, "downsample.max_points": 2048}
    settings = ref_pipeline.settings_from_config(cfg)
    rparams = ref_pipeline.params_from_config(cfg)
    rbuf, _ = ref_from_soa(_soa(), capacity=CAPACITY)
    stages = dict(ref_pipeline.stage_functions(settings))
    for name in ("non_finite", "crop", "ground", "pre_compact", "voxel"):
        rbuf, _ = stages[name](rbuf, rparams, KEY)
    assert int(rbuf.mask.sum()) > 2048
    ref_out, _ = stages["neighborhood"](rbuf, rparams, KEY)
    port_stage = dict(pipeline.stage_functions(pipeline.settings_from_config(cfg)))["neighborhood"]
    port_out, _ = port_stage(_to_port(rbuf), pipeline.params_from_config(cfg, device="cpu"), None, None)
    assert port_out.capacity == 2048
    # the thin keeps the same points: the union of kept and outlier rows
    kept_ref = _survivors(ref_out.positions, np.ones(2048, bool), ref_out.attributes["normals"])
    kept_port = _survivors(port_out.positions.numpy(), np.ones(2048, bool),
                           port_out.attributes["normals"].numpy())
    assert kept_ref.keys() == kept_port.keys()
    jaccard, normals_ok = _compare_survivors(
        _survivors(port_out.positions.numpy(), port_out.mask.numpy(),
                   port_out.attributes["normals"].numpy()),
        _survivors(ref_out.positions, ref_out.mask, ref_out.attributes["normals"]),
    )
    assert jaccard >= 0.99 and normals_ok >= 0.98, (jaccard, normals_ok)


def test_front_only_pipeline_matches_reference(pallas_interpret):
    # voxel and neighbourhood off: duplicates run as their own stage
    cfg = {**CFG, "voxel_size": 0.0, "remove_statistical_outliers": False,
           "estimate_normals": False}
    settings = ref_pipeline.settings_from_config(cfg)
    soa = _soa()
    soa["positions"] = np.nan_to_num(soa["positions"])  # finite: the refit runs
    soa["positions"][100:140] = soa["positions"][:40]  # exact duplicates
    rbuf, _ = ref_from_soa(soa, capacity=CAPACITY)
    ref_stages = ref_pipeline.stage_functions(settings)
    port_stages = pipeline.stage_functions(pipeline.settings_from_config(cfg))
    assert [n for n, _ in port_stages] == [n for n, _ in ref_stages] == [
        "remove_duplicates", "non_finite", "crop", "ground",
    ]
    run = pipeline.build_pipeline(pipeline.settings_from_config(cfg))
    out, plane = run(_to_port(rbuf), pipeline.params_from_config(cfg, device="cpu"), None,
                     _uniforms(settings))
    rb, rplane = rbuf, None
    for _, fn in ref_stages:
        rb, aux = fn(rb, ref_pipeline.params_from_config(cfg), KEY)
        rplane = aux if aux is not None else rplane
    np.testing.assert_allclose(plane.numpy(), np.asarray(rplane), atol=1e-5)
    live = np.asarray(rbuf.mask)
    assert (out.mask.numpy() != np.asarray(rb.mask))[live].mean() <= 1e-3
    assert out.capacity == CAPACITY


@pytest.mark.parametrize(
    "override",
    [
        {"remove_ground.method": "height"},
        {"remove_ground.before_voxel": False},
        {"downsample_method": "uniform"},
        {"downsample_method": "random"},
        {"downsample_method": "farthest_point"},
        {"remove_ground.score_subsample": 16384},
        {"remove_ground.before_voxel": False, "remove_ground.before_neighborhood": True},
        {"roi_min": [-500.0, -500.0, -20.0], "roi_max": [500.0, 500.0, 20.0]},
        {"pallas_ok": False},
    ],
)
def test_unported_settings_raise(pallas_interpret, override):
    # the settings the port once refused now run and match the reference
    # (ground by height, ground last or before the neighbourhood, the other
    # downsamplers, the subsampled vote, the 'wide' voxel keys, and the XLA
    # window route of pallas_ok=False, a settings field that no config key
    # reaches); the name is kept from when they raised
    direct = {k: v for k, v in override.items() if k == "pallas_ok"}
    cfg = {**CFG, **{k: v for k, v in override.items() if k not in direct}}
    port_settings = dataclasses.replace(pipeline.settings_from_config(cfg), **direct)
    settings = dataclasses.replace(ref_pipeline.settings_from_config(cfg), **direct)
    assert port_settings == dataclasses.replace(
        pipeline.PipelineSettings(), **dataclasses.asdict(settings))
    assert [n for n, _ in pipeline.stage_functions(port_settings)] == [
        n for n, _ in ref_pipeline.stage_functions(settings)]
    soa = _sensor_order(_soa())
    rbuf, _ = ref_from_soa(soa, capacity=CAPACITY)
    rparams = ref_pipeline.params_from_config(cfg)
    ref_out, ref_plane = ref_pipeline.build_pipeline(settings)(rbuf, rparams, KEY)
    # the random downsampler's draws: the reference's, at the capacity its
    # stage sees (after the pre-voxel bucket)
    cap = min(settings.pre_voxel_compact_capacity or CAPACITY, CAPACITY)
    draws = torch.from_numpy(np.array(jax.random.uniform(KEY, (cap,))))
    pbuf, _ = from_soa(soa, capacity=CAPACITY, device="cpu")
    # the reference's own parameter arrays (ground_plane, sampling_ratio,
    # every_k_points among them) through convert
    pparams = params_from_reference(
        {f.name: np.asarray(getattr(rparams, f.name)) for f in dataclasses.fields(rparams)},
        device="cpu",
    )
    port_out, port_plane = pipeline.build_pipeline(port_settings)(
        pbuf, pparams, None, _uniforms(settings), draws)
    assert port_out.capacity == ref_out.capacity
    if settings.ground_method == "height":
        np.testing.assert_array_equal(port_plane.numpy(), np.asarray(ref_plane))
    else:  # the reference's refit is NaN-poisoned on the raw scene (fault 3)
        assert abs(float(port_plane[2])) > 0.999 and abs(float(ref_plane[2])) > 0.999
    jaccard, normals_ok = _compare_survivors(
        _survivors(port_out.positions.numpy(), port_out.mask.numpy(),
                   port_out.attributes["normals"].numpy()),
        _survivors(ref_out.positions, ref_out.mask, ref_out.attributes["normals"]),
    )
    assert int(port_out.mask.sum()) > 300
    assert jaccard >= 0.99, jaccard
    assert normals_ok >= 0.98, normals_ok


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.convert\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.ops.knn\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.ops.outliers\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.ops.radius_outliers\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.ops.normals\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.ops.downsample\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.ops.height_ground\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.ops.voxel\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.ops.compact\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.io\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.io.streaming\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.io.compressor\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.io.pcap\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.io.pcd\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.io.loader\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.core.codec\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.core.msg\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.core.fields\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.runtime.bus\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.runtime.node\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.runtime.tf\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.runtime.params\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.parallel\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.parallel.concat\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.parallel.sharding\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.cli\n"
        "import autodriver_pointcloud_preprocessor_tpu_torch.native\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m.startswith('autodriver_pointcloud_preprocessor_tpu.')"
        " or m == 'autodriver_pointcloud_preprocessor_tpu' for m in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
