"""The port's PointcloudPreprocessorNode against the reference's, on the CPU.

One case for each test of tests/test_runtime_node.py. Every case builds
the same node in both packages (the port's with ``device='cpu'``, the
reference with its window kernels in interpret mode), sends both the same
messages, and holds the port to the reference test's assertions and to the
reference node's own results: published schema, header, ``frame_count``
and ``processing_times`` keys equal, ``SetParametersResult`` equal,
survivors by jaccard >= 0.99 with >= 98% of normals within 2 degrees, PCD
files and organised clouds equal.
"""
import importlib
import logging
import os

import jax
import numpy as np
import pytest

import autodriver_pointcloud_preprocessor_tpu as ref
import autodriver_pointcloud_preprocessor_tpu_torch as port
from autodriver_pointcloud_preprocessor_tpu.models import pipeline as ref_pipeline

PKGS = {"ref": ref, "port": port}


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    # the backend is resolved while tracing: drop executables traced under
    # another backend in this worker, before and after
    monkeypatch.setenv("APC_WINDOW_BACKEND", "pallas_interpret")
    jax.clear_caches()
    ref_pipeline.build_pipeline.cache_clear()
    yield
    jax.clear_caches()
    ref_pipeline.build_pipeline.cache_clear()


def _velodyne_msg(pkg, n=512, frame="velodyne", seed=0):
    core = pkg.core
    rng = np.random.default_rng(seed)
    fields, step = core.build_pointfields(
        ["x", "y", "z", "intensity", "ring"],
        [core.PointFieldType.FLOAT32] * 4 + [core.PointFieldType.UINT16],
    )
    arr = np.zeros(n, dtype=core.structured_dtype_from_fields(fields, step))
    arr["x"], arr["y"], arr["z"] = rng.normal(0, 5, (3, n)).astype(np.float32)
    arr["intensity"] = rng.uniform(0, 255, n).astype(np.float32)
    arr["ring"] = rng.integers(0, 16, n).astype(np.uint16)
    return core.make_pointcloud2(arr, fields, header=core.Header(core.Time(10, 0), frame))


def _xyz_msg(pkg, seed, nan_every=0):
    """An 8 x 8 organised x/y/z cloud (tests/test_runtime_node.py's)."""
    core = pkg.core
    rng = np.random.default_rng(seed)
    fields, step = core.build_pointfields(["x", "y", "z"], [core.PointFieldType.FLOAT32] * 3)
    arr = np.zeros(64, dtype=core.structured_dtype_from_fields(fields, step))
    arr["x"] = rng.normal(size=64).astype(np.float32)
    if nan_every:
        arr["y"] = rng.normal(size=64).astype(np.float32)
        arr["y"][::nan_every] = np.nan
    return core.make_pointcloud2(arr, fields, header=core.Header(core.Time(1, 0), "cam"),
                                 height=8, is_dense=not nan_every)


class Side:
    def __init__(self, name, subscribe, pipelined, namespace, overrides):
        self.pkg = PKGS[name]
        self.bus = self.pkg.runtime.TopicBus()
        kw = {"device": "cpu"} if name == "port" else {}
        self.node = self.pkg.runtime.PointcloudPreprocessorNode(
            bus=self.bus, overrides=dict(overrides), pipelined=pipelined,
            parameter_namespace=namespace, **kw)
        self.outputs = []
        if subscribe:
            self.bus.create_subscription(self.node.output_topic, self.outputs.append)

    def publish(self, make, topic=None):
        self.bus.create_publisher(topic or self.node.input_topic).publish(make(self.pkg))

    def set(self, *params):
        Parameter = self.pkg.runtime.Parameter
        return self.node.set_parameters([Parameter(n, v) for n, v in params])

    def points(self, i=-1):
        return self.pkg.core.read_points(self.outputs[i])


class Pair:
    """The same node in both packages (``voxel_size`` 0 and no normals
    unless overridden, as the reference test's ``_make_node``)."""

    def __init__(self, subscribe=True, pipelined=False, namespace="", **overrides):
        overrides.setdefault("voxel_size", 0.0)
        overrides.setdefault("estimate_normals", False)
        self.ref, self.port = (Side(n, subscribe, pipelined, namespace, overrides) for n in PKGS)
        self.sides = (self.ref, self.port)

    def publish(self, make, topic=None):
        for side in self.sides:
            side.publish(make, topic)
        self.check()

    def set(self, *params):
        """Both nodes' SetParametersResults, equal; the port's returned."""
        a, b = (side.set(*params) for side in self.sides)
        assert [(r.successful, r.reason) for r in b] == [(r.successful, r.reason) for r in a]
        return b

    def check(self):
        """Equal frame counts, output counts, timing keys, schemas and
        headers; survivors by jaccard, normals by angle."""
        r, p = self.ref, self.port
        assert p.node.frame_count == r.node.frame_count
        assert len(p.outputs) == len(r.outputs)
        assert set(p.node.processing_times) == set(r.node.processing_times)
        for a, b in zip(r.outputs, p.outputs):
            fields = lambda m: [(f.name, f.offset, f.datatype, f.count) for f in m.fields]  # noqa: E731
            assert fields(b) == fields(a)
            assert (b.point_step, b.is_dense, b.is_bigendian) == (a.point_step, a.is_dense, a.is_bigendian)
            assert b.header.frame_id == a.header.frame_id
            if not r.node.override_header:
                assert (b.header.stamp.sec, b.header.stamp.nanosec) == (
                    a.header.stamp.sec, a.header.stamp.nanosec)
            _assert_survivors_agree(r.pkg.core.read_points(a), p.pkg.core.read_points(b))


def _survivors(pts):
    xyz = np.stack([pts["x"], pts["y"], pts["z"]], -1).reshape(-1, 3)
    keys = [tuple(k) for k in np.round(xyz.astype(np.float64), 5).tolist()]
    normals = None
    if "normal_x" in pts.dtype.names:
        normals = np.stack([pts["normal_x"], pts["normal_y"], pts["normal_z"]], -1).reshape(-1, 3)
    return keys, normals


def _assert_survivors_agree(a, b):
    ka, na = _survivors(a)
    kb, nb = _survivors(b)
    sa, sb = set(ka), set(kb)
    jaccard = len(sa & sb) / max(len(sa | sb), 1)
    assert jaccard >= 0.99, jaccard
    if na is not None:
        da, db = dict(zip(ka, na.astype(np.float64))), dict(zip(kb, nb.astype(np.float64)))
        common = sa & sb
        cos = np.array([abs(float(np.dot(da[k], db[k]))) for k in common])
        assert float((cos >= np.cos(np.deg2rad(2.0))).mean()) >= 0.98


def test_end_to_end_publish():
    pair = Pair()
    pair.publish(_velodyne_msg)
    assert len(pair.port.outputs) == 1
    out = pair.port.points()
    assert out.shape[0] > 0
    assert {"x", "y", "z", "intensity", "ring"} <= set(out.dtype.names)
    assert pair.port.node.frame_count == 1
    assert "total_callback_time" in pair.port.node.processing_times
    np.testing.assert_array_equal(out, pair.ref.points())


def test_zero_subscriber_short_circuit():
    pair = Pair(subscribe=False)
    pair.publish(_velodyne_msg)
    assert pair.port.node.frame_count == 0
    assert pair.port.node.processing_times == {}


@pytest.mark.parametrize("case", ["empty", "missing_xyz"])
def test_unusable_cloud_skipped(case):
    def make(pkg):
        if case == "empty":
            return _velodyne_msg(pkg, n=0)
        core = pkg.core
        fields, step = core.build_pointfields(["a", "b"], [core.PointFieldType.FLOAT32] * 2)
        arr = np.zeros(5, dtype=core.structured_dtype_from_fields(fields, step))
        return core.make_pointcloud2(arr, fields)

    pair = Pair()
    pair.publish(make)
    assert pair.port.outputs == [] and pair.port.node.frame_count == 0


def test_normals_appended_to_schema():
    pair = Pair(estimate_normals=True)
    pair.publish(_velodyne_msg)
    out = pair.port.points()
    assert {"normal_x", "normal_y", "normal_z"} <= set(out.dtype.names)
    assert pair.port.node.pointcloud_metadata["has_normals"] is True


def test_tf_transform_and_header_frame_override():
    pair = Pair(robot_frame="base_link")
    tf = np.eye(4, dtype=np.float32)
    tf[:3, 3] = [10.0, 0.0, 0.0]
    for side in pair.sides:
        side.node.tf_buffer.set_transform("base_link", "velodyne", matrix=tf)
    in_pts = port.core.read_points(_velodyne_msg(port))
    pair.publish(_velodyne_msg)
    out = pair.port.points()
    assert pair.port.outputs[0].header.frame_id == "base_link"
    np.testing.assert_allclose(np.sort(out["x"]), np.sort(in_pts["x"] + 10.0), atol=1e-4)
    np.testing.assert_array_equal(pair.port.node.camera_to_robot_tf, pair.ref.node.camera_to_robot_tf)


@pytest.mark.parametrize("case", ["missing", "extrapolation"])
def test_tf_failure_passthrough(case):
    # a TF lookup or extrapolation error -> the scan passes through
    # untransformed (reference :720-728)
    pair = Pair(robot_frame="base_link")
    if case == "extrapolation":
        tf = np.eye(4, dtype=np.float32)
        tf[:3, 3] = [5.0, 0, 0]
        for side in pair.sides:
            side.node.tf_buffer.cache_time = 0.05
            side.node.tf_buffer.set_transform("base_link", "velodyne", matrix=tf, stamp=0.0)
    pair.publish(_velodyne_msg)
    assert len(pair.port.outputs) == 1
    assert pair.port.outputs[0].header.frame_id == "velodyne"
    assert pair.port.node.camera_to_robot_tf is None


def test_dynamic_tf_follows_every_scan():
    # static_camera_to_robot_tf=False: each callback looks the transform up
    # again and the engine takes the new one
    pair = Pair(robot_frame="base_link", static_camera_to_robot_tf=False)
    for shift in (10.0, -3.0):
        tf = np.eye(4, dtype=np.float32)
        tf[:3, 3] = [shift, 0.0, 0.0]
        for side in pair.sides:
            side.node.tf_buffer.set_transform("base_link", "velodyne", matrix=tf)
        pair.publish(_velodyne_msg)
        in_x = port.core.read_points(_velodyne_msg(port))["x"]
        np.testing.assert_allclose(np.sort(pair.port.points()["x"]), np.sort(in_x + shift), atol=1e-4)


def test_transform_buffer_chain_and_errors():
    a_from_b = np.eye(4, dtype=np.float32)
    a_from_b[0, 3] = 1
    b_from_c = np.eye(4, dtype=np.float32)
    b_from_c[1, 3] = 2
    got = {}
    for name, pkg in PKGS.items():
        tf = pkg.runtime.tf
        tfb = tf.TransformBuffer()
        tfb.set_transform("a", "b", matrix=a_from_b)
        tfb.set_transform("b", "c", matrix=b_from_c)
        m, m_inv = tfb.lookup_transform("a", "c"), tfb.lookup_transform("c", "a")
        np.testing.assert_allclose(m[:3, 3], [1, 2, 0], atol=1e-6)
        np.testing.assert_allclose(m_inv @ m, np.eye(4), atol=1e-5)
        with pytest.raises(tf.LookupException):
            tfb.lookup_transform("a", "nope")
        tfb.set_transform("x", "y", matrix=np.eye(4, dtype=np.float32))
        with pytest.raises(tf.ConnectivityException):
            tfb.lookup_transform("a", "y")
        got[name] = (m, m_inv)
    for a, b in zip(got["port"], got["ref"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["roi_length", "unknown", "type_mismatch", "negative_max_points",
                                  "ground_plane_length", "offset_matrix_length"])
def test_reconfigure_rejections(case):
    pair = Pair()
    ns = pair.port.node.parameter_namespace
    bad, good = {
        "roi_length": ((f"{ns}roi_min", [1.0, 2.0]), (f"{ns}roi_min", [-1.0, -1.0, -1.0])),
        "unknown": (("not_a_param", 1), None),
        "type_mismatch": (("voxel_size", "not-a-number"), None),
        "negative_max_points": (("downsample.max_points", -5), ("downsample.max_points", 0)),
        "ground_plane_length": (("ground_plane", [0.0, 1.0]), ("ground_plane", [0.0, 0.0, 1.0, 0.0])),
        "offset_matrix_length": (("offset_pointcloud_matrix", [1.0] * 15),
                                 ("offset_pointcloud_matrix", np.eye(4).ravel().tolist())),
    }[case]
    results = pair.set(bad)
    assert not results[0].successful
    if case == "roi_length":
        assert "length 3" in results[0].reason
    if case == "type_mismatch":
        assert "type mismatch" in results[0].reason
    if good is not None:
        assert pair.set(good)[0].successful
    pair.publish(_velodyne_msg)
    assert len(pair.port.outputs) == 1


def test_reconfigure_topics_rewires():
    pair = Pair()
    ns = pair.port.node.parameter_namespace
    pair.set((f"{ns}input_topic", "/other/points"), (f"{ns}output_topic", "/other/out"))
    new_outputs = {}
    for name, side in zip(PKGS, pair.sides):
        new_outputs[name] = []
        side.bus.create_subscription(side.node.output_topic, new_outputs[name].append)
        side.publish(_velodyne_msg, "/other/points")
    assert len(new_outputs["port"]) == len(new_outputs["ref"]) == 1
    assert pair.port.node.input_topic == "/other/points"
    np.testing.assert_array_equal(port.core.read_points(new_outputs["port"][0]),
                                  ref.core.read_points(new_outputs["ref"][0]))


def test_reconfigure_voxel_size_live():
    pair = Pair()
    ns = pair.port.node.parameter_namespace
    pair.publish(_velodyne_msg)
    n_before = pair.port.points().shape[0]
    assert pair.set((f"{ns}voxel_size", 2.0))[0].successful
    pair.publish(_velodyne_msg)
    assert pair.port.points().shape[0] < n_before  # coarse voxels shrink the cloud
    assert pair.port.node.engine.settings == _port_settings(pair.ref.node.engine.settings)


def test_parameter_namespace_prefixing():
    pair = Pair(namespace="front_lidar")
    node = pair.port.node
    assert node.params.has("input_topic")
    assert node.params.names() == pair.ref.node.params.names()
    assert node.params.names()[0].startswith("front_lidar.")
    assert pair.set(("front_lidar.voxel_size", 0.5))[0].successful
    assert node.engine.config["voxel_size"] == 0.5


def test_override_header_latest_stamp():
    pair = Pair(override_header=True)
    msg = _velodyne_msg(port)
    pair.publish(_velodyne_msg)
    assert pair.port.outputs[0].header.stamp.to_float() > msg.header.stamp.to_float()


def test_dead_params_accepted():
    # ground_plane/use_height: dead in the reference node, live here
    pair = Pair()
    ns = pair.port.node.parameter_namespace
    results = pair.set((f"{ns}ground_plane", [0.0, 0.0, 1.0, 0.0]), (f"{ns}use_height", False))
    assert all(r.successful for r in results)
    assert pair.port.node.engine.config["remove_ground.method"] == "ransac"


@pytest.mark.parametrize("value", [True, False])
def test_reconfigure_use_gpu_accepted(value):
    # accepted and reported; the engine stays where the constructor put it
    pair = Pair()
    assert pair.set(("use_gpu", value), ("cpu_backend", "numpy"), ("gpu_backend", "cupy"))[0].successful
    node = pair.port.node
    assert node.use_gpu is value and node.cpu_backend == "numpy" and node.gpu_backend == "cupy"
    assert node.engine.device.type == "cpu" and node.engine.params.voxel_size.device.type == "cpu"
    pair.publish(_velodyne_msg)
    assert len(pair.port.outputs) == 1


def test_normals_marker_array_published():
    pair = Pair(estimate_normals=True, publish_normals_markers=True)
    markers = {}
    for name, side in zip(PKGS, pair.sides):
        markers[name] = []
        side.bus.create_subscription("/normals_markers", markers[name].append)
    pair.publish(_velodyne_msg)
    assert len(markers["port"]) == len(markers["ref"]) == 1
    arr = markers["port"][0]
    assert len(arr.markers) == len(markers["ref"][0].markers) > 0
    m0 = arr.markers[0]
    assert len(m0.points) == 2
    base, tip = np.array(m0.points[0]), np.array(m0.points[1])
    np.testing.assert_allclose(np.linalg.norm(tip - base), 0.3, atol=1e-5)


@pytest.mark.parametrize("ext", [".pcd", ".ply"])
def test_save_pointcloud_writes_frames(tmp_path, ext):
    dirs = {name: tmp_path / name for name in PKGS}
    pair = Pair(save_pointcloud=True, pointcloud_save_directory=str(tmp_path / "ref"),
                pointcloud_save_extension=ext)
    pair.port.set(("pointcloud_save_directory", str(dirs["port"])))
    os.makedirs(dirs["port"])
    pair.publish(_velodyne_msg)
    pair.publish(lambda pkg: _velodyne_msg(pkg, seed=1))
    files = sorted(os.listdir(dirs["port"]))
    assert files == sorted(os.listdir(dirs["ref"])) == [f"00000000{ext}", f"00000001{ext}"]
    for f in files:
        assert (dirs["port"] / f).read_bytes() == (dirs["ref"] / f).read_bytes(), f
    cloud = port.io.pcd.read_point_cloud(str(dirs["port"] / files[0]))
    assert cloud["positions"].shape[0] > 0


def test_pointcloud_fields_selection():
    pair = Pair(pointcloud_fields=["x", "y", "z"])
    pair.publish(_velodyne_msg)
    out = pair.port.points()
    assert {"x", "y", "z", "intensity", "ring"} <= set(out.dtype.names)
    assert (out["intensity"] == 0).all() and (out["ring"] == 0).all()
    assert not (out["x"] == 0).all()
    np.testing.assert_array_equal(out, pair.ref.points())


@pytest.mark.parametrize("remove_nans", [False, True])
def test_organized_cloud(remove_nans):
    # organize_cloud reshapes to (H, W) on read; NaN rows drop at ingest
    pair = Pair(organize_cloud=True, remove_nans=remove_nans)
    pair.publish(lambda pkg: _xyz_msg(pkg, seed=int(remove_nans), nan_every=9 if remove_nans else 0))
    assert len(pair.port.outputs) == 1
    out = pair.port.points()
    assert out.shape[0] == (64 - 8 if remove_nans else 64)
    assert np.isfinite(out["y"]).all()
    np.testing.assert_array_equal(out, pair.ref.points())


def test_visualizer_saves_png(tmp_path):
    pytest.importorskip("matplotlib")
    pair = Pair(visualize=True, **{"visualize.save_visualizer_image": True,
                                   "visualize.visualizer_image_path": str(tmp_path / "imgs")})
    pair.port.publish(_velodyne_msg)
    assert os.listdir(tmp_path / "imgs") == ["00000000.png"]


def test_visualizer_view_parameters_are_observable():
    pair = Pair(visualize=True, **{"visualize.front": [1.0, 0.0, 0.0], "visualize.up": [0.0, 0.0, 1.0],
                                   "visualize.zoom": 0.5})
    rng = np.random.default_rng(0)
    pos = np.column_stack([rng.uniform(-10, 10, (2, 500)).T, rng.normal(0, 0.02, 500)]).astype(np.float32)
    sx, sy, depth, half = pair.port.node._view_projection(pos)
    assert np.abs(sy).max() < 0.5 and np.abs(sx).max() > 5.0
    for got, want in zip((sx, sy, depth, half), pair.ref.node._view_projection(pos)):
        np.testing.assert_array_equal(got, want)
    pair.port.node.params.set_parameters([port.runtime.Parameter("visualize.zoom", 1.0)])
    half2 = pair.port.node._view_projection(pos)[3]
    assert abs(half2 - 2 * half) / half2 < 1e-6


def test_pipelined_node_overlap():
    pair = Pair(pipelined=True)
    pair.publish(lambda pkg: _velodyne_msg(pkg, seed=0))
    assert pair.port.outputs == []  # first scan in flight
    pair.publish(lambda pkg: _velodyne_msg(pkg, seed=1))
    assert len(pair.port.outputs) == 1
    for side in pair.sides:
        side.node.flush_pipeline()
    pair.check()
    assert len(pair.port.outputs) == 2
    for i in range(2):
        np.testing.assert_array_equal(pair.port.points(i), pair.ref.points(i))
    a, inp = pair.port.points(0), port.core.read_points(_velodyne_msg(port, seed=0))
    np.testing.assert_allclose(np.sort(a["x"]), np.sort(inp["x"]), atol=1e-5)


def test_throttled_missing_field_warning(caplog):
    seen = {}
    for name, pkg in PKGS.items():
        t = {"now": 0.0}
        logger = logging.getLogger(f"throttle-test-{name}")
        w = pkg.core.timing.ThrottledWarner(logger, period=60.0, clock=lambda mono=True: t["now"])
        got = []
        with caplog.at_level(logging.WARNING, logger=logger.name):
            for now, key in ((0.0, "k"), (0.0, "k"), (59.0, "k"), (61.0, "k"), (61.0, "other")):
                t["now"] = now
                got.append(w.warn(key, "msg"))
        seen[name] = got
    assert seen["port"] == seen["ref"] == [True, False, False, True, True]
    assert len(caplog.records) == 6


def test_ros2_adapter_import_guard():
    try:
        import rclpy  # noqa: F401
        pytest.skip("rclpy installed; guard not exercised")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="TopicBus"):
        importlib.import_module("autodriver_pointcloud_preprocessor_tpu_torch.ros2_adapter")


def test_max_points_accepts_any_value_and_rounds_up():
    pair = Pair(voxel_size=0.5)
    for value, cap in ((1000, 1024), (512, 512)):
        assert pair.set(("downsample.max_points", value))[0].successful
        assert pair.port.node.engine.settings.post_downsample_capacity == cap
        assert pair.ref.node.engine.settings.post_downsample_capacity == cap
    pair.publish(_velodyne_msg)
    assert len(pair.port.outputs) == 1


def test_point_clearing_key_emitted():
    pair = Pair()
    pair.publish(_velodyne_msg)
    assert pair.port.node.processing_times["point_clearing"] == 0.0


def test_reconfigure_ground_before_voxel():
    pair = Pair()
    ns = pair.port.node.parameter_namespace
    results = pair.set((f"{ns}remove_ground", True), (f"{ns}remove_ground.before_voxel", True))
    assert all(r.successful for r in results)
    assert pair.port.node.engine.settings.ground_before_voxel
    assert pair.port.node.engine.settings == _port_settings(pair.ref.node.engine.settings)


def _port_settings(ref_settings):
    import dataclasses

    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import PipelineSettings

    return PipelineSettings(**dataclasses.asdict(ref_settings))


def test_atomic_reconfigure_rolls_back_together():
    pair = Pair()
    for side in pair.sides:
        P = side.pkg.runtime.Parameter
        bad = side.node.set_parameters_atomically([P("voxel_size", 0.3), P("roi_max", [1.0, 2.0])])
        assert not bad.successful
        assert side.node.params.get("voxel_size") == 0.0
        good = side.node.set_parameters_atomically(
            [P("neighborhood_passes", 1), P("window_blocks", [2])])
        assert good.successful
    assert pair.port.node.engine.settings == _port_settings(pair.ref.node.engine.settings)


def test_node_defaults_match_reference():
    assert port.runtime.node.PARAMETER_DEFAULTS == ref.runtime.node.PARAMETER_DEFAULTS
    assert port.runtime.node._ENGINE_KEYS == ref.runtime.node._ENGINE_KEYS


def test_set_tf_matrix_swaps_the_matrix_alone():
    """A transform that replaces another (a TF that is not static) keeps
    the settings and the pipeline and copies the matrix alone: the same
    parameters and output as an engine given only the second transform."""
    import dataclasses

    import torch

    from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor

    cfg = {"voxel_size": 0.2, "estimate_normals": False}
    first = port.ops.linalg.se3_matrix((1.0, 2.0, 0.5), (0.0, 0.0, 0.3, 0.95)).numpy()
    second = port.ops.linalg.se3_matrix((-3.0, 0.5, 1.5), (0.1, 0.0, 0.2, 0.97)).numpy()
    a = Preprocessor(cfg, device="cpu")
    a.set_tf_matrix(first)
    settings, run = a.settings, a._run
    a.set_tf_matrix(second)
    assert a.settings is settings and a._run is run and a.settings.apply_tf
    b = Preprocessor(cfg, device="cpu")
    b.set_tf_matrix(second)
    assert b.settings == a.settings
    for f in dataclasses.fields(a.params):
        assert torch.equal(getattr(a.params, f.name), getattr(b.params, f.name)), f.name
    soa = port.core.pointcloud_to_dict(_velodyne_msg(port))[0]
    out_a, out_b = a.process_soa(soa)[0], b.process_soa(soa)[0]
    assert out_a.keys() == out_b.keys()
    for k in out_a:
        np.testing.assert_array_equal(out_a[k], out_b[k], err_msg=k)
    a.set_tf_matrix(None)  # clearing rebuilds: no transform stage
    assert not a.settings.apply_tf
