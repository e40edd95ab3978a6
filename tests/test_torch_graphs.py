"""The port's one-program-per-scan execution, on the CPU.

On a CUDA card the engine and the streaming path replay captured programs
(``models/graphs.py``). What makes that possible, and what the replay
plumbing does, is checked here at the 8192-point slice:

- a ``TorchDispatchMode`` probe finds no host read of a device value (no
  ``_local_scalar_dense``, ``nonzero``, ``masked_select``, ``unique`` or
  boolean-index op) on any configuration's path nor on the streaming
  decode and quantizer; only K1's plain version, which a card replaces by
  the kernel, is exempt;
- the device-side selects that replaced the two host reads are bit-equal
  to both former branches, per scan of a batch that mixes them, and match
  the reference's ``lax.cond`` run (its window kernel in interpret mode);
- drawing a run's uniforms ahead is bit-equal to drawing them inside;
- the program cache's key separates capacity, attribute schema, batch and
  mode;
- with the capture replaced by an eager stand-in (a CPU has no CUDA
  graph), the engine and the streaming path give what eager runs give,
  honour a reconfigure and a new TF after capture, keep results a caller
  holds, credit launches and evict the least recently used program, by
  count and by the graph pools' bytes; the concatenator's merge replays
  one program a set of capacities and attribute schemas, and profile mode
  one program a stage, each equal to its eager run;
- every kernel launch, capture and replay runs under the device guard of
  its tensors' device (the launch and capture calls patched).
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from autodriver_pointcloud_preprocessor_tpu.core.scan import ScanBuffer as RefScanBuffer
from autodriver_pointcloud_preprocessor_tpu.models import pipeline as ref_pipeline
from autodriver_pointcloud_preprocessor_tpu.ops import window as ref_window
from autodriver_pointcloud_preprocessor_tpu_torch import ops
from autodriver_pointcloud_preprocessor_tpu_torch.core import (
    ScanBuffer,
    from_soa,
    stack_buffers,
    to_soa,
    unstack_buffer,
)
from autodriver_pointcloud_preprocessor_tpu_torch.io import streaming
from autodriver_pointcloud_preprocessor_tpu_torch.io.compressor import device_quantizer
from autodriver_pointcloud_preprocessor_tpu_torch.models import graphs, pipeline
from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor
from autodriver_pointcloud_preprocessor_tpu_torch.models.presets import (
    PRODUCTION_128K_CONFIG,
    PRODUCTION_128K_QUALITY_CONFIG,
)
from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build, window

segmean = importlib.import_module("autodriver_pointcloud_preprocessor_tpu_torch.ops.segmean")

N_POINTS, CAPACITY = 8000, 8192
CPU = torch.device("cpu")
_INTERP = "pallas_interpret"
#: the production preset cut to the slice: a 4096 pre-voxel bucket, a
#: 3584 neighbourhood bucket
CUT = {"downsample.pre_voxel_capacity": 4096, "downsample.max_points": 3584}
PRODUCTION = {**PRODUCTION_128K_CONFIG, **CUT}
#: bench_suite.py configs 1, 2 and 3 as settings and parameters
CONFIG1 = (dict(remove_duplicates=False, crop_to_roi=True, voxel_downsample=True,
                estimate_normals=False), dict(voxel_size=0.08))
CONFIG2 = (dict(remove_duplicates=False, crop_to_roi=False, voxel_downsample=True,
                remove_statistical_outliers=True, nb_neighbors=20, remove_radius_outliers=True,
                estimate_normals=False, knn_method="window", voxel_compact_keys=True),
           dict(voxel_size=0.08, std_ratio=2.0, radius_nb_points=8, radius_search_radius=0.4))
CONFIG3 = (dict(remove_duplicates=False, crop_to_roi=False, voxel_downsample=False,
                estimate_normals=False, remove_ground=True, ransac_n=3, num_iterations=100),
           dict(distance_threshold=0.12))
#: every path the probe walks: a reference-named config or (settings,
#: parameters)
PATHS = {
    "production": PRODUCTION,
    "production_overflow": {**PRODUCTION, "downsample.max_points": 2048},
    "config2": CONFIG2,
    "quality": {**PRODUCTION_128K_QUALITY_CONFIG, **CUT},
    "config1": CONFIG1,
    "config3": CONFIG3,
    "config7": {**PRODUCTION, "remove_ground.before_voxel": False, "downsample.max_points": 0},
    "defaults": {},
    "random": {**PRODUCTION, "downsample_method": "random"},
    "uniform": {**PRODUCTION, "downsample_method": "uniform"},
    "farthest_point": {**PRODUCTION, "downsample_method": "farthest_point",
                       "downsample.num_samples": 48},
    "height": {**PRODUCTION, "remove_ground.method": "height",
               "ground_plane": [0.0, 0.0, 1.0, 0.0]},
    # the voxel stage's own shrink (no fused neighbourhood after it)
    "voxel_shrink": {**PRODUCTION, "remove_statistical_outliers": False,
                     "downsample.max_points": 2048},
    "ground_first": {**PRODUCTION, "remove_ground.before_voxel": False,
                     "remove_ground.before_neighborhood": True},
    # pallas_ok=False, a settings field no config key reaches: the XLA
    # window route, fused (config 2's with the radius count) and standalone
    "production_xla": PRODUCTION,
    "config2_xla": CONFIG2,
    "unfused_xla": {**PRODUCTION, "fuse_neighborhood": False},
}


def _settings_params(path):
    spec = PATHS[path]
    if isinstance(spec, tuple):
        settings = pipeline.PipelineSettings(**spec[0])
        params = pipeline.PipelineParams.make(**spec[1], device="cpu")
    else:
        settings = pipeline.settings_from_config(spec)
        params = pipeline.params_from_config(spec, device="cpu")
    if path.endswith("_xla"):
        settings = dataclasses.replace(settings, pallas_ok=False)
    return settings, params


def _scene_soa(seed=0, n=N_POINTS):
    """The density-matched scene (bench._scene at +-10 m, NaN sprinkle) in
    a spinning sensor's azimuth order, with intensity and ring."""
    rng = np.random.default_rng(seed)
    n_ground = int(n * 0.6)
    ground = np.column_stack(
        [rng.uniform(-10, 10, (2, n_ground)).T, rng.normal(0, 0.03, n_ground)])
    centers = rng.uniform(-7.5, 7.5, (24, 3)) * [1, 1, 0] + [0, 0, 1.5]
    obj = centers[rng.integers(0, 24, n - n_ground)] + rng.normal(0, 0.8, (n - n_ground, 3))
    pts = np.vstack([ground, obj]).astype(np.float32)
    pts = pts[np.argsort(np.arctan2(pts[:, 1], pts[:, 0]), kind="stable")]
    pts[:: n // 200] = np.nan
    return {"positions": pts,
            "intensity": rng.uniform(0, 255, n).astype(np.float32),
            "ring": rng.integers(0, 32, n).astype(np.uint16)}


def _buf(seed=0, capacity=CAPACITY, n=N_POINTS):
    return from_soa(_scene_soa(seed, n), capacity=capacity, device="cpu")[0]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_soa(a, b):
    """Equality of two host SoA dicts, NaN payloads included."""
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)


def _same(a, b):
    """Bit-equality of two (nested) outputs: buffers, planes, lists."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


# ---------------------------------------------------------------- the probe ----

_SYNCING = {
    "aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select", "aten::_unique",
    "aten::_unique2", "aten::unique_dim", "aten::unique_consecutive", "aten::equal",
    "aten::is_nonzero",
}
_INDEXING = {"aten::index", "aten::index_put", "aten::index_put_", "aten::_index_put_impl_"}


class _HostReadProbe(TorchDispatchMode):
    """Records every op that would read a device value on the host, or
    copy host data to the device, on a card; ops inside K1's plain version
    are exempt."""

    def __init__(self):
        super().__init__()
        self.found, self.exempt = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        flagged = name in _SYNCING or (
            # a tensor of host data: an index list (a 0-dim scalar set into
            # a slice is a fill on a card)
            name == "aten::lift_fresh" and args[0].dim() > 0) or (
            name in _INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                for i in args[1]))
        if flagged and not self.exempt:
            self.found.append(name)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def probe(monkeypatch):
    p = _HostReadProbe()
    plain = segmean.compact_rows_plain

    def exempt(*args, **kwargs):
        p.exempt += 1
        try:
            return plain(*args, **kwargs)
        finally:
            p.exempt -= 1

    monkeypatch.setattr(segmean, "compact_rows_plain", exempt)
    return p


def test_probe_sees_a_host_read(probe):
    t = torch.arange(5.0)
    with probe:
        int(t.max())
        t[t > 2]
    assert probe.found == ["aten::_local_scalar_dense", "aten::index"]


@pytest.mark.parametrize("batch", [0, 2])
@pytest.mark.parametrize("path", list(PATHS))
def test_pipeline_paths_read_nothing_on_the_host(probe, path, batch):
    settings, params = _settings_params(path)
    buf = stack_buffers([_buf(0), _buf(1)]) if batch else _buf(0)
    draws = pipeline.draw_uniforms(settings, buf.batch_shape, buf.capacity,
                                   torch.Generator().manual_seed(0), CPU)
    run = pipeline.build_pipeline(settings)
    with probe:
        out, plane = run(buf, params, None, *draws)
    assert probe.found == [], f"{path}: host reads {sorted(set(probe.found))}"
    assert out.mask.any()


def test_streaming_decode_and_quantizer_read_nothing_on_the_host(probe):
    rng = np.random.default_rng(3)
    fields = torch.from_numpy(rng.integers(0, 256, (2, 1176, 24), dtype=np.uint8))
    stamps = torch.from_numpy(np.sort(rng.uniform(0, 0.1, (2, 24)).astype(np.float32), -1))
    n_packets = torch.tensor([24, 17], dtype=torch.int32)
    ranges = torch.tensor([0.4, 130.0])
    quantize = device_quantizer(14)
    tables = streaming._laser_tables("HDL32E", CPU)
    scale = torch.tensor(0.5)
    with probe:
        buf = streaming.decode_fields(fields, stamps, n_packets, ranges[0], ranges[1], "HDL32E",
                                      tables)
        packed, meta = quantize(buf, scale)
    assert probe.found == [], sorted(set(probe.found))
    assert packed.shape == (2, 4, 24 * 384) and meta.shape == (2, 7)


# --------------------------------------------- the two device-side selects ----

def _presorted_cloud(seed, live, n=4096):
    """A curve-ordered voxel output: ``live`` points front-compacted in
    pass-0 Hilbert order (clustered), zeros behind, and a slot attribute."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (10, 3))
    pts = (centers[rng.integers(0, 10, live)] + rng.normal(0, 0.35, (live, 3))).T
    pts = pts.astype(np.float32)
    codes = window.hilbert_codes(torch.from_numpy(pts), torch.ones(live, dtype=torch.bool))
    pts = pts[:, np.argsort(codes.numpy(), kind="stable")]
    full = np.zeros((3, n), np.float32)
    full[:, :live] = pts
    mask = np.arange(n) < live
    return full, mask, np.arange(n, dtype=np.int32)


_FUSED = dict(k=20, window_blocks=(1, 0), passes=2, kmode="csel", entries_merge=False,
              carry_count=False)
_SHRINK = 3584


def _port_fused(pts, mask, slot, **kw):
    return window.fused_neighborhood_stats_reordered(
        torch.from_numpy(pts), torch.from_numpy(mask), {"ring": torch.from_numpy(slot)},
        radius=torch.tensor(0.3), **_FUSED, **kw)


def test_presorted_shrink_select_is_bit_equal_to_both_branches():
    under = _presorted_cloud(1, 3000)
    over = _presorted_cloud(2, 3900)
    # live under the bucket: the prefix slice, as the same rows cut ahead
    got = _port_fused(*under, presorted=True, shrink_to=_SHRINK)
    pts, mask, slot = under
    prefix = _port_fused(pts[:, :_SHRINK].copy(), mask[:_SHRINK].copy(), slot[:_SHRINK].copy(),
                         presorted=True)
    assert _same(got, prefix)
    # over it: the thin, sort and slice of the unsorted entry
    got_over = _port_fused(*over, presorted=True, shrink_to=_SHRINK)
    assert _same(got_over, _port_fused(*over, presorted=False, shrink_to=_SHRINK))
    # a batch mixing both: each scan takes its own branch
    stacked = [np.stack([u, o]) for u, o in zip(under, over)]
    both = _port_fused(*stacked, presorted=True, shrink_to=_SHRINK)
    for i, alone in enumerate((got, got_over)):
        assert _same([x[i] for x in tree_leaves(both)], tree_leaves(alone))


@pytest.mark.parametrize("live", [3000, 3900])
def test_presorted_shrink_matches_the_reference_cond(live):
    pts, mask, slot = _presorted_cloud(live, live)
    ref = ref_window.fused_neighborhood_stats_reordered(
        jnp.asarray(pts), jnp.asarray(mask), {"ring": jnp.asarray(slot)}, radius=0.3,
        presorted=True, shrink_to=_SHRINK, backend=_INTERP, **_FUSED)
    port = _port_fused(pts, mask, slot, presorted=True, shrink_to=_SHRINK)
    r_slot, p_slot = np.asarray(ref[2]["ring"]), port[2]["ring"].numpy()
    r_valid, p_valid = np.asarray(ref[1]), port[1].numpy()
    # the same points survive the cap (the thin's hash is exact)
    assert sorted(r_slot[r_valid]) == sorted(p_slot[p_valid])
    assert p_valid.sum() <= _SHRINK
    if live <= _SHRINK:
        assert p_valid.sum() == live
    r_at = {s: i for i, s in enumerate(r_slot) if r_valid[i]}
    both = [(i, r_at[s]) for i, s in enumerate(p_slot) if p_valid[i]]
    pi, ri = np.array(both).T
    mean, r_mean = port[3].numpy()[pi], np.asarray(ref[3])[ri]
    rel = np.abs(mean - r_mean) / np.maximum(r_mean, 1e-6)
    assert (rel <= 1e-3).mean() >= 0.99  # the reference's csel tolerance (fault 2)
    cos = np.abs((port[4].numpy()[:, pi] * np.asarray(ref[4])[:, ri]).sum(0))
    assert (cos >= np.cos(np.deg2rad(2.0))).mean() >= 0.98


def _voxel_out(seed, live, n=4096):
    """A front-compacted buffer (the voxel stage's output) with ``live``
    points and two attributes."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((3, n), np.float32)
    pos[:, :live] = rng.uniform(-10, 10, (3, live))
    return ScanBuffer(
        positions=torch.from_numpy(pos), mask=torch.arange(n) < live,
        attributes={"intensity": torch.from_numpy(rng.uniform(0, 255, n).astype(np.float32)),
                    "ring": torch.from_numpy(rng.integers(0, 32, n).astype(np.int32))})


def _shrink_stage(cfg):
    return dict(pipeline.stage_functions(pipeline.settings_from_config(cfg)))["shrink"]


def test_voxel_shrink_select_is_bit_equal_to_both_branches():
    cfg = PATHS["voxel_shrink"]
    cap = 2048
    params = pipeline.params_from_config(cfg, device="cpu")
    stage = _shrink_stage(cfg)
    under, over = _voxel_out(1, 1500), _voxel_out(2, 3000)
    got_under = stage(under, params)[0]
    got_over = stage(over, params)[0]
    assert _same(got_under, ops.shrink_front(under, cap))
    assert _same(got_over, ops.subsample_to(over, cap))
    both = stage(stack_buffers([under, over]), params)[0]
    for i, alone in enumerate((got_under, got_over)):
        assert _same([x[i] for x in tree_leaves(both)], tree_leaves(alone))


@pytest.mark.parametrize("live", [1500, 3000])
def test_voxel_shrink_matches_the_reference_cond(live):
    cfg = PATHS["voxel_shrink"]
    buf = _voxel_out(live, live)
    ref_stage = dict(ref_pipeline.stage_functions(ref_pipeline.settings_from_config(cfg)))["shrink"]
    rbuf = RefScanBuffer(positions=jnp.asarray(buf.positions.numpy()),
                         mask=jnp.asarray(buf.mask.numpy()),
                         attributes={k: jnp.asarray(v.numpy()) for k, v in buf.attributes.items()})
    ref = ref_stage(rbuf, ref_pipeline.params_from_config(cfg), None)[0]
    got = _shrink_stage(cfg)(buf, pipeline.params_from_config(cfg, device="cpu"))[0]
    # the live prefix is bit-equal (the reference's sort is unstable only
    # among the dead tail)
    live_rows = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.mask.numpy(), live_rows)
    np.testing.assert_array_equal(got.positions.numpy()[:, live_rows],
                                  np.asarray(ref.positions)[:, live_rows])
    for k, v in got.attributes.items():
        np.testing.assert_array_equal(v.numpy()[live_rows], np.asarray(ref.attributes[k])[live_rows])


# ------------------------------------------------------------ drawing ahead ----

@pytest.mark.parametrize("cfg", [
    PRODUCTION,
    {**PRODUCTION, "downsample_method": "random"},  # ground, then the downsampler
    {**PATHS["config7"], "downsample_method": "random"},  # the downsampler, then ground
])
@pytest.mark.parametrize("batch", [0, 2])
def test_drawing_ahead_equals_drawing_inside(cfg, batch):
    settings = pipeline.settings_from_config(cfg)
    params = pipeline.params_from_config(cfg, device="cpu")
    run = pipeline.build_pipeline(settings)
    buf = stack_buffers([_buf(0), _buf(2)]) if batch else _buf(0)
    inside = torch.Generator().manual_seed(11)
    want = run(buf, params, inside)
    ahead = torch.Generator().manual_seed(11)
    draws = pipeline.draw_uniforms(settings, buf.batch_shape, buf.capacity, ahead, CPU)
    assert _same(run(buf, params, None, *draws), want)
    # and both leave the generator at the same place
    assert torch.equal(torch.rand(3, generator=inside), torch.rand(3, generator=ahead))


def test_draws_keep_what_the_caller_gives():
    settings = pipeline.settings_from_config({**PRODUCTION, "downsample_method": "random"})
    gu = np.random.default_rng(0).uniform(size=(settings.num_iterations, settings.ransac_n))
    g = torch.Generator().manual_seed(0)
    got_gu, got_du = pipeline.draw_uniforms(settings, (), CAPACITY, g, CPU, ground_uniforms=gu)
    assert got_gu.dtype == torch.float32 and np.allclose(got_gu.numpy(), gu)
    # the downsampler draws at the pre-voxel bucket's capacity
    assert got_du.shape == (4096,)
    assert pipeline.draw_uniforms(pipeline.settings_from_config({}), (), CAPACITY, g, CPU) == (
        None, None)


# --------------------------------------------------------- the program key ----

def test_program_key_separates_capacity_schema_batch_and_mode():
    settings, params = _settings_params("production")

    def key(bufs, mode="vmapped", draws=(None, None)):
        return graphs.program_key(("engine", mode, settings), (bufs, params, draws))

    one = [_buf(0)]
    assert key(one) == key([_buf(1)])  # the same program for other data
    assert key(one) != key([_buf(0, capacity=16384)])  # capacity
    no_ring = [ScanBuffer(b.positions, b.mask, {"intensity": b.attributes["intensity"]})
               for b in one]
    assert key(one) != key(no_ring)  # attribute names
    f32_ring = [b.replace(attributes={**b.attributes, "ring": b.attributes["ring"].float()})
                for b in one]
    assert key(one) != key(f32_ring)  # attribute dtypes
    assert key(one) != key(one * 2)  # batch
    assert key(one) != key(one, mode="sequential")  # mode
    u = torch.zeros(settings.num_iterations, settings.ransac_n)
    assert key(one) != key(one, draws=(u, None))  # which draws are inputs
    other = dataclasses.replace(settings, nb_neighbors=16)
    assert key(one) != graphs.program_key(("engine", "vmapped", other), (one, params, (None, None)))


# ------------------------------- the replay plumbing, with an eager capture ----

#: the replay plumbing's slice: 4000 points at 4096, production's buckets
#: cut to 2048 and 1536
SMALL_N, SMALL_CAP = 4000, 4096
SMALL = {**PRODUCTION_128K_CONFIG, "downsample.pre_voxel_capacity": 2048,
         "downsample.max_points": 1536}


def _small(seed=0, capacity=SMALL_CAP):
    return _buf(seed, capacity, SMALL_N)


class _EagerGraph:
    """Stands in for a CUDA graph on the CPU: a replay runs the captured
    function again and writes its results into the captured outputs (a
    real replay recomputes them in place), without counting launches (a
    real replay does not pass through the kernels' wrappers)."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs

    def replay(self):
        saved = dict(_build.LAUNCHES)
        fresh = self.fn()
        _build.LAUNCHES.update(saved)
        for dst, src in zip(tree_leaves(self.outputs), tree_leaves(fresh)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)


#: a card's memory for the cache's byte bound (``torch.cuda.mem_get_info``)
_CARD_BYTES = 80 << 30


@pytest.fixture
def eager_capture(monkeypatch):
    def capture(fn, device):  # no warm-up: nothing is built lazily on the CPU
        outputs = fn()
        return _EagerGraph(fn, outputs), outputs, 0

    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(graphs, "captures", lambda device: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (_CARD_BYTES, _CARD_BYTES))
    graphs.clear()
    yield
    graphs.clear()


def test_engine_programs_equal_eager_runs(eager_capture):
    cfg = {**SMALL, "downsample_method": "random"}
    graphed = Preprocessor(cfg, seed=3, device="cpu")
    settings, params = graphed.settings, graphed.params
    run = pipeline.build_pipeline(settings)
    bufs = [_small(0), _small(1)]
    eager_gen = torch.Generator().manual_seed(3)
    for _ in range(2):  # a capture, then a replay
        got = graphed.process_buffer(bufs[0])
        assert _same(got, run(bufs[0], params, eager_gen))
    got = graphed.process_batch(bufs)
    want, planes = run(stack_buffers(bufs), params, eager_gen)
    assert _same(got, (unstack_buffer(want), planes))
    got = graphed.process_batch(bufs, sequential=True)
    runs = [run(b, params, eager_gen) for b in bufs]
    assert _same(got, ([r[0] for r in runs], torch.stack([r[1] for r in runs])))
    assert len(graphs.programs()) == 3  # scan, vmapped, sequential


def test_engine_program_per_capacity_schema_and_batch(eager_capture):
    engine = Preprocessor(SMALL, device="cpu")
    engine.process_buffer(_small(0))
    engine.process_buffer(_small(1))  # a replay
    assert len(graphs.programs()) == 1 and graphs.programs()[0].replays == 2
    engine.process_buffer(_small(0, capacity=8192))
    b = _small(0)
    engine.process_buffer(b.replace(attributes={"intensity": b.attributes["intensity"]}))
    engine.process_batch([_small(0), _small(1)])
    engine.process_batch([_small(0), _small(1), _small(2)])
    assert len(graphs.programs()) == 5


def test_reconfigure_and_new_tf_after_capture(eager_capture):
    soa = _scene_soa(4, SMALL_N)
    engine = Preprocessor(SMALL, device="cpu")
    engine.process_soa(soa, capacity=SMALL_CAP)
    engine.update_config({"voxel_size": 0.2})  # numeric: the same program
    assert len(graphs.programs()) == 1
    fresh = Preprocessor({**SMALL, "voxel_size": 0.2}, device="cpu")

    def same_scan():  # both generators at the same place: the same draws
        engine.generator.manual_seed(1)
        fresh.generator.manual_seed(1)
        return _same_soa(engine.process_soa(soa, capacity=SMALL_CAP)[0],
                         fresh.process_soa(soa, capacity=SMALL_CAP)[0])

    assert same_scan()
    # one program serves both engines: only their parameters differ
    assert len(graphs.programs()) == 1 and graphs.programs()[0].replays == 3
    tf = np.eye(4, dtype=np.float32)
    tf[:3, 3] = (1.5, -0.5, 0.25)
    for shift in (0.0, 0.75):  # a TF, then another replacing it
        tf[2, 3] = shift
        engine.set_tf_matrix(tf)
        fresh.set_tf_matrix(tf)
        assert same_scan()


def test_results_a_caller_holds_are_not_overwritten(eager_capture):
    engine = Preprocessor(SMALL, device="cpu")
    first = engine.process_soa_async(_scene_soa(5, SMALL_N), capacity=SMALL_CAP)
    second = engine.process_soa_async(_scene_soa(6, SMALL_N), capacity=SMALL_CAP)
    # the same scans through the plain pipeline, drawing as the engine does
    run = pipeline.build_pipeline(engine.settings)
    gen = torch.Generator().manual_seed(0)
    for resolve, seed in ((first, 5), (second, 6)):
        buf, meta = from_soa(_scene_soa(seed, SMALL_N), capacity=SMALL_CAP, device="cpu")
        want = to_soa(run(buf, engine.params, gen)[0], meta)
        assert _same_soa(resolve()[0], want)


def test_streaming_programs_equal_eager_runs(eager_capture, monkeypatch):
    cfg = {"voxel_size": 0.05, "estimate_normals": False, "remove_ground": True,
           "remove_ground.ransac_number": 3, "remove_ground.num_iterations": 16}
    rng = np.random.default_rng(2)
    scans = []
    for i in range(3):
        payloads = rng.integers(0, 256, (12, 1206), dtype=np.uint8)
        scans.append((payloads, np.arange(12) * 1e-3 + i))
    graphed = streaming.StreamingEngine(cfg, packet_bucket=12, seed=4, device="cpu")
    single = [graphed.process_scan_packets(p, s, intensity_scale=0.5) for p, s in scans]
    batch = graphed.process_scan_batch(scans, intensity_scale=0.5)
    monkeypatch.setattr(graphs, "captures", lambda device: False)
    eager = streaming.StreamingEngine(cfg, packet_bucket=12, seed=4, device="cpu")
    assert single == [eager.process_scan_packets(p, s, intensity_scale=0.5) for p, s in scans]
    assert batch == eager.process_scan_batch(scans, intensity_scale=0.5)
    assert len(graphs.programs()) == 2  # one a (bucket, batch)


def test_replays_credit_the_launches_of_the_capture(eager_capture):
    def fn(x):
        _build.LAUNCHES["segmented_sums"] += 1  # a kernel launch the capture records
        return x * 2

    x = torch.arange(4.0)
    _build.reset_launches()
    prog = graphs.program("toy", lambda: fn, x)
    assert _build.LAUNCHES["segmented_sums"] == 0  # the warm-up and capture: set-up
    assert prog.credits == {"masked_compact": 0, "segmented_sums": 1, "window_stats": 0}
    for i in range(3):
        assert torch.equal(prog(x + i), (x + i) * 2)
    assert _build.LAUNCHES["segmented_sums"] == 3


def test_least_recently_used_program_is_evicted(eager_capture, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_PROGRAMS", 2)
    made = []

    def make(tag):
        def fn(x):
            return x + len(tag)
        made.append(tag)
        return fn

    x = torch.zeros(3)
    for tag in ("a", "bb", "a", "ccc", "a", "bb"):
        assert torch.equal(graphs.program(tag, lambda t=tag: make(t), x)(x), x + len(tag))
    # "bb" left when "ccc" came ("a" was used more recently) and came back
    assert made == ["a", "bb", "ccc", "bb"]
    assert len(graphs.programs()) == 2


def test_least_used_programs_are_evicted_by_pool_bytes(eager_capture, monkeypatch):
    # a card of 400 bytes: the pools may hold POOL_FRACTION of it together
    total = 400
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (total, total))
    pools = {"a": 40, "bb": 40, "ccc": 40, "huge": 500}
    emptied = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(len(graphs.programs())))

    def capture(fn, device):
        outputs = fn()
        return _EagerGraph(fn, outputs), outputs, pools[tag]

    monkeypatch.setattr(graphs, "_capture", capture)
    x = torch.zeros(3)
    budget = graphs.POOL_FRACTION * total
    assert 2 * 40 <= budget < 3 * 40
    for tag in ("a", "bb", "a", "ccc"):
        assert torch.equal(graphs.program(tag, lambda t=tag: lambda y: y + len(t), x)(x),
                           x + len(tag))
    # "bb" was least recently used when "ccc" took the pools past the bound
    held = graphs.programs()
    assert [graphs.lookup(t, (x,)) is not None for t in ("a", "bb", "ccc")] == [True, False, True]
    assert sum(p.pool_bytes for p in held) <= budget and emptied == [2]
    # a program over the bound alone evicts every other and stays
    tag = "huge"
    graphs.program(tag, lambda: lambda y: y, x)
    assert [p.pool_bytes for p in graphs.programs()] == [500] and emptied == [2, 1]
    assert len(graphs.programs()) <= graphs.MAX_PROGRAMS


# ------------------------------------------------ the merge and profile mode ----

def _merge_inputs(capacities, with_ring=(True, True)):
    rng = np.random.default_rng(len(capacities) + sum(capacities))
    bufs = []
    for cap, ring in zip(capacities, with_ring):
        n = cap - cap // 8
        soa = {"positions": rng.normal(0, 5, (n, 3)).astype(np.float32),
               "intensity": rng.uniform(0, 255, n).astype(np.float32)}
        if ring:
            soa["ring"] = rng.integers(0, 32, n).astype(np.uint16)
        bufs.append(from_soa(soa, capacity=cap, device="cpu")[0])
    exts = [torch.from_numpy(np.eye(4, dtype=np.float32)) for _ in capacities]
    exts[-1][0, 3] = 10.0
    return bufs, exts


def test_merge_reads_nothing_on_the_host(probe):
    from autodriver_pointcloud_preprocessor_tpu_torch.parallel.concat import concatenate_buffers

    bufs, exts = _merge_inputs((1024, 2048), (True, False))
    with probe:
        merged = concatenate_buffers(bufs, exts)
    assert probe.found == [] and merged.capacity == 3072


def test_merge_programs_keyed_by_capacity_and_schema(eager_capture):
    from autodriver_pointcloud_preprocessor_tpu_torch.parallel.concat import (
        PointcloudConcatenatorNode,
        concatenate_buffers,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.runtime import TopicBus

    node = PointcloudConcatenatorNode(TopicBus(), ["/a", "/b"], device="cpu")
    for caps, rings in (((1024, 1024), (True, True)), ((1024, 1024), (True, True)),
                        ((1024, 2048), (True, True)), ((1024, 1024), (True, False))):
        bufs, exts = _merge_inputs(caps, rings)
        assert _same(node._merge(bufs, exts), concatenate_buffers(bufs, exts))
    # one program a (capacities, attribute schemas): the second set replayed
    assert [p.replays for p in graphs.programs()] == [2, 1, 1]


def test_graphed_merge_publishes_the_eager_merge_clouds(eager_capture, monkeypatch):
    from autodriver_pointcloud_preprocessor_tpu_torch.io.loader import soa_to_pointcloud2
    from autodriver_pointcloud_preprocessor_tpu_torch.parallel.concat import (
        PointcloudConcatenatorNode,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.core.msg import Time
    from autodriver_pointcloud_preprocessor_tpu_torch.runtime import TopicBus

    def round_of(graphed):
        bus, outs = TopicBus(), []
        monkeypatch.setattr(graphs, "captures", lambda device: graphed)
        PointcloudConcatenatorNode(bus, ["/a", "/b", "/c"], extrinsics={"/b": np.diag(
            [1.0, -1.0, -1.0, 1.0])}, mode="sync", slop=0.05, device="cpu")
        bus.create_subscription("/points/concatenated", outs.append)
        for r in range(2):
            for i, topic in enumerate(("/a", "/b", "/c")):
                rng = np.random.default_rng(10 * r + i)
                n = 300 + 50 * i
                t = 5.0 + r + 0.013 * i  # a time base of each sensor's own
                soa = {"positions": rng.normal(0, 3, (n, 3)).astype(np.float32),
                       "time": t + np.sort(rng.uniform(0, 0.05, n))}
                bus.create_publisher(topic).publish(
                    soa_to_pointcloud2(soa, frame_id="s", stamp=Time.from_float(t)))
        return outs

    graphed, eager = round_of(True), round_of(False)
    assert len(graphed) == len(eager) == 2
    assert all(a.data == b.data for a, b in zip(graphed, eager))
    assert len(graphs.programs()) == 1 and graphs.programs()[0].replays == 2


@pytest.mark.parametrize("path", ["production", "config2"])
def test_profile_mode_stages_read_nothing_on_the_host(probe, path):
    settings, params = _settings_params(path)
    buf = _buf(0)
    gu, du = pipeline.draw_uniforms(settings, (), buf.capacity, torch.Generator().manual_seed(0),
                                    CPU)
    with probe:
        for _, fn in pipeline.stage_functions(settings, separate_stages=True):
            buf, _ = fn(buf, params, None, gu, du)
    assert probe.found == [], f"{path}: host reads {sorted(set(probe.found))}"


#: config 2 under the reference's parameter names (the engine's surface)
CONFIG2_NAMED = {
    "remove_duplicates": False, "crop_to_roi": False, "voxel_size": 0.08,
    "remove_statistical_outliers": True, "remove_statistical_outliers.nb_neighbors": 20,
    "remove_statistical_outliers.std_ratio": 2.0, "remove_radius_outliers": True,
    "remove_radius_outliers.nb_points": 8, "remove_radius_outliers.search_radius": 0.4,
    "estimate_normals": False, "knn_method": "window",
}


@pytest.mark.parametrize("cfg", [SMALL, {**SMALL, "downsample_method": "random"}, CONFIG2_NAMED])
def test_profile_mode_stage_programs_equal_eager_stages(eager_capture, cfg):
    engine = Preprocessor(cfg, profile=True, seed=3, device="cpu")
    stages = pipeline.stage_functions(engine.settings, separate_stages=True)
    gen = torch.Generator().manual_seed(3)
    for seed in (0, 1):  # the capture of each stage, then its replay
        buf = _small(seed)
        got = engine.process_buffer(buf)
        want, plane = buf, torch.full((4,), float("nan"))
        for _, fn in stages:  # the eager profile run, drawing inside
            want, aux = fn(want, engine.params, gen)
            plane = plane if aux is None else aux
        assert _same(got, (want, plane))
    assert set(engine.processing_times) == {
        pipeline.STAGE_TIMING_KEYS[name] for name, _ in stages} | {"preprocessing_time"}
    # one program a stage, each replayed once after its capture
    assert len(graphs.programs()) == len(stages)
    assert all(p.replays == 2 for p in graphs.programs())


# ------------------------------------------------- the device guard (fault 14) ----

class _GuardLog:
    """Stands in for ``_build.device_guard``: records each guard entered
    and which one is active."""

    def __init__(self):
        self.entered, self.active = [], []

    def __call__(self, device):
        log = self

        class _Guard:
            def __enter__(self):
                log.entered.append(device)
                log.active.append(device)

            def __exit__(self, *exc):
                log.active.pop()

        return _Guard()


def test_device_guard_names_the_tensors_card():
    guard = _build.device_guard(torch.device("cuda:1"))
    assert isinstance(guard, torch.cuda.device) and guard.idx == 1
    with _build.device_guard(CPU):  # nothing to switch on the CPU
        pass


def test_kernel_launches_run_under_their_tensors_device(monkeypatch):
    log, calls = _GuardLog(), []

    class _Lib:
        def __getattr__(self, name):
            def entry(*args):  # the C entry: where it runs, on which stream
                calls.append((name, log.active[-1] if log.active else None, args[-1]))
                return 0
            return entry

    monkeypatch.setattr(_build, "device_guard", log)
    monkeypatch.setattr(_build, "load_library", lambda: _Lib())
    monkeypatch.setattr(_build, "stream_handle", lambda device: f"stream of {device}")
    window_stats = importlib.import_module(
        "autodriver_pointcloud_preprocessor_tpu_torch.ops.window_stats")
    _build.reset_launches()
    mask = torch.ones(2, 256, dtype=torch.bool)
    segmean._launch_k1([0] * 4 * 20, mask, torch.empty_like(mask), 2, 256, 128)  # 2 launches
    segmean._launch_k2(torch.zeros(2, 4, 256), mask, 2, 4, 256)
    rows = [torch.zeros(2, 256) for _ in range(3)]
    window_stats._launch_k3(rows, mask, torch.ones(1), None, 8, 1, 0, "csel", True)
    on_cpu = (CPU, f"stream of {CPU}")
    assert [(c[0], c[1:]) for c in calls] == [
        ("apc_masked_compact", on_cpu), ("apc_masked_compact", on_cpu),
        ("apc_segmented_sums", on_cpu), ("apc_window_stats", on_cpu)]
    assert dict(_build.LAUNCHES) == {"masked_compact": 2, "segmented_sums": 1, "window_stats": 1}


def test_capture_and_replay_run_under_the_programs_device(monkeypatch):
    log, seen = _GuardLog(), []
    monkeypatch.setattr(_build, "device_guard", log)
    card = torch.device("cuda:1")

    class _Stream:
        def __init__(self, device=None, priority=0):
            self.device = device
            seen.append(("stream", device, list(log.active)))

        def wait_stream(self, other):
            pass

    class _Capture:
        def __init__(self, graph, pool=None, stream=None, capture_error_mode="global"):
            seen.append(("capture", stream.device, capture_error_mode, list(log.active)))

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass

    class _SideStream:
        def __init__(self, stream):
            seen.append(("warm-up on", stream.device, list(log.active)))

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream(device))
    monkeypatch.setattr(torch.cuda, "stream", _SideStream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: "graph")
    monkeypatch.setattr(torch.cuda, "graph", _Capture)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)

    def fn():
        seen.append(("run", list(log.active)))
        return torch.zeros(1)

    graph, _, pool = graphs._capture(fn, card)
    assert graph == "graph" and pool == 0 and log.entered == [card]
    # every stream, the warm-up, the capture (thread-local) and both runs
    # on the program's card, inside its guard
    assert seen and all(e[-1] == [card] for e in seen)
    assert all(e[1] == card for e in seen if e[0] != "run")
    assert [e for e in seen if e[0] == "capture"] == [("capture", card, "thread_local", [card])]
    assert [e[0] for e in seen].count("run") == 2

    # a replay fills its inputs and replays inside the guard of its device
    monkeypatch.setattr(graphs, "_capture", lambda f, device: (
        _EagerGraph(f, f()), f(), 0))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (_CARD_BYTES, _CARD_BYTES))
    graphs.clear()
    replayed = []
    x = torch.arange(3.0)
    prog = graphs.program("toy", lambda: lambda y: replayed.append(list(log.active)) or y * 2, x)
    replayed.clear()
    log.entered.clear()
    assert torch.equal(prog(x), x * 2)
    assert replayed == [[CPU]] and log.entered == [CPU] and prog.device == CPU
    graphs.clear()
