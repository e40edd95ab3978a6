"""The port's TF graph, SE(3) helpers and parameter store against the
reference's, on the CPU.

``se3_matrix`` and ``quaternion_to_matrix`` are held to the reference's
float32 matrices within 2 ulp (the largest difference measured is printed;
it was 0 ulp on these inputs). ``TransformBuffer`` and ``ParameterStore``
are copies: the same calls give the same results and the same errors. The
reconfigure cases of tests/test_presets.py run on both nodes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autodriver_pointcloud_preprocessor_tpu as ref
import autodriver_pointcloud_preprocessor_tpu_torch as port
from autodriver_pointcloud_preprocessor_tpu.ops import linalg as ref_linalg
from autodriver_pointcloud_preprocessor_tpu_torch.ops import linalg

PKGS = {"ref": ref, "port": port}


def _ulps(a, b):
    """Largest distance in units of the last place between float32 arrays."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)

    def ordered(x):  # float32 bit patterns on one monotonic integer line
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.abs(ordered(a) - ordered(b)).max())


def _quaternions(n=400, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)) * rng.uniform(0.05, 4.0, (n, 1))  # unit and not
    q[:4] = [[0, 0, 0, 1], [1, 0, 0, 0], [0.5, 0.5, 0.5, 0.5], [0, 0, 0, 0]]
    return q, rng.normal(0, 20, (n, 3))


def test_quaternion_and_se3_match_reference_within_2_ulp():
    quats, trans = _quaternions()
    worst_rot = worst_se3 = 0
    for q, t in zip(quats, trans):
        got = linalg.quaternion_to_matrix(*q)
        assert got.dtype == torch.float32 and tuple(got.shape) == (3, 3)
        worst_rot = max(worst_rot, _ulps(got.numpy(), ref_linalg.quaternion_to_matrix(*q)))
        m = linalg.se3_matrix(tuple(t), tuple(q))
        assert tuple(m.shape) == (4, 4) and m.device.type == "cpu"
        worst_se3 = max(worst_se3, _ulps(m.numpy(), ref_linalg.se3_matrix(tuple(t), tuple(q))))
    print(f"quaternion_to_matrix: {worst_rot} ulp, se3_matrix: {worst_se3} ulp "
          f"from the reference over {len(quats)} quaternions")
    assert worst_rot <= 2 and worst_se3 <= 2
    # the zero quaternion gives the identity rotation in both
    np.testing.assert_array_equal(linalg.quaternion_to_matrix(0, 0, 0, 0).numpy(), np.eye(3))
    # jnp scalars in, as a caller holding device values would pass them
    q = quats[5]
    np.testing.assert_array_equal(
        linalg.quaternion_to_matrix(*q).numpy(),
        np.asarray(ref_linalg.quaternion_to_matrix(*(jnp.float32(v) for v in q))))


def test_transform_to_matrix_matches_reference():
    quats, trans = _quaternions(n=50, seed=1)
    for q, t in zip(quats, trans):
        got = port.runtime.tf.transform_to_matrix(
            port.core.TransformStamped(translation=tuple(t), rotation_xyzw=tuple(q)))
        want = ref.runtime.tf.transform_to_matrix(
            ref.core.TransformStamped(translation=tuple(t), rotation_xyzw=tuple(q)))
        assert got.dtype == want.dtype == np.float32
        assert _ulps(got, want) <= 2


def _tree(pkg):
    """base <- lidar (from a TransformStamped) <- sensor; base <- cam;
    an island x <- y; stamps 1.0 except cam's 5.0."""
    rng = np.random.default_rng(3)
    tf = pkg.runtime.tf
    tfb = tf.TransformBuffer()
    q = rng.normal(size=4)
    tfb.set_transform("base", "lidar", transform=pkg.core.TransformStamped(
        translation=(1.0, -2.0, 0.5), rotation_xyzw=tuple(q)), stamp=1.0)
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [0.0, 0.3, 1.2]
    tfb.set_transform("lidar", "sensor", matrix=m, stamp=1.0)
    m2 = np.eye(4, dtype=np.float32)
    m2[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    tfb.set_transform("base", "cam", matrix=m2, stamp=5.0)
    tfb.set_transform("x", "y", matrix=np.eye(4, dtype=np.float32), stamp=1.0)
    return tf, tfb


@pytest.mark.parametrize("target,source", [
    ("base", "sensor"), ("sensor", "base"), ("cam", "sensor"), ("sensor", "cam"),
    ("lidar", "lidar"), ("base", "lidar"),
])
def test_transform_buffer_lookups_match_reference(target, source):
    got = _tree(port)[1].lookup_transform(target, source)
    want = _tree(ref)[1].lookup_transform(target, source)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # a chain composes: target <- source = (target <- base) (base <- source)
    tfb = _tree(port)[1]
    if "base" not in (target, source):
        np.testing.assert_allclose(
            got, tfb.lookup_transform(target, "base") @ tfb.lookup_transform("base", source), atol=1e-5)


@pytest.mark.parametrize("case", ["unknown_frame", "islands", "stale_edge", "fresh_edge", "no_input"])
def test_transform_buffer_errors_match_reference(case):
    outcomes = {}
    for name, pkg in PKGS.items():
        tf, tfb = _tree(pkg)
        tfb.cache_time = 0.5
        call = {
            "unknown_frame": lambda: tfb.lookup_transform("base", "nope"),
            "islands": lambda: tfb.lookup_transform("base", "y"),
            "stale_edge": lambda: tfb.lookup_transform("cam", "sensor", stamp=1.2),
            "fresh_edge": lambda: tfb.lookup_transform("sensor", "lidar", stamp=1.3),
            "no_input": lambda: tfb.set_transform("a", "b"),
        }[case]
        try:
            outcomes[name] = ("ok", np.asarray(call()).tolist())
        except Exception as e:  # noqa: BLE001 - the error's type and text are compared
            outcomes[name] = (type(e).__name__, str(e))
    assert outcomes["port"] == outcomes["ref"]
    want = {"unknown_frame": "LookupException", "islands": "ConnectivityException",
            "stale_edge": "ExtrapolationException", "fresh_edge": "ok", "no_input": "ValueError"}
    assert outcomes["port"][0] == want[case]


def _store_script(pkg):
    """Declare, read and set through a namespaced store; every result."""
    params = pkg.runtime.params
    store = params.ParameterStore("front")
    log = [store.namespace]
    for name, value in (("voxel_size", 0.05), ("passes", 2), ("roi", [-1.0, -1.0, -1.0]),
                        ("view", []), ("mode", "sweep"), ("flag", True), ("blocks", [1, 0])):
        store.declare(name, value)
    log.append(store.names())
    log.append(store.by_prefix(""))
    try:
        store.declare("voxel_size", 1.0)
    except ValueError as e:
        log.append(str(e))
    seen = []

    def cb(ps):
        seen.append([(p.name, p.value) for p in ps])
        ok = all(not (p.name.endswith("passes") and p.value > 3) for p in ps)
        return params.SetParametersResult(ok, "" if ok else "too many passes")

    store.add_on_set_parameters_callback(cb)
    P = params.Parameter
    for batch in ([P("front.voxel_size", 1)],                # int into a double: accepted
                  [P("front.voxel_size", "big")],            # type mismatch
                  [P("front.roi", [1, 2, 3])],               # int array into a double array
                  [P("front.view", ["a", "b"])],             # empty-list declaration: any array
                  [P("front.passes", 5)],                    # the callback refuses
                  [P("front.unknown", 1)],                   # not declared
                  [P("front.flag", False), P("front.mode", "csel")]):
        log.append([(r.successful, r.reason) for r in store.set_parameters(batch)])
    log.append([(r.successful, r.reason) for r in [store.set_parameters_atomically(
        [P("front.passes", 3), P("front.blocks", [1, 0, 0])])]])
    log.append([(r.successful, r.reason) for r in [store.set_parameters_atomically(
        [P("front.passes", 1), P("front.passes", 9)])]])
    log.append({n: store.get(n, namespaced=False) for n in store.names()})
    log.append(seen)
    log.append([(p.name, p.type_.value) for p in (P("a", 1.5), P("b", [True]), P("c", [1, 2.0]),
                                                     P("d", ["s"]), P("e", 3))])
    return log


def test_parameter_store_matches_reference():
    got, want = _store_script(port), _store_script(ref)
    assert got == want
    assert got[-3]["front.voxel_size"] == 1 and got[-3]["front.passes"] == 3


def _node(pkg, name, **overrides):
    kw = {"device": "cpu"} if pkg is port else {}
    return pkg.runtime.PointcloudPreprocessorNode(name, overrides=overrides, **kw)


def _set(node, pkg, name, value):
    (res,) = node.set_parameters([pkg.runtime.Parameter(name, value)])
    return res.successful, res.reason


def _settings_log(pkg):
    """tests/test_presets.py's knob reconfigures on one node: every result
    and the settings after it."""
    node = _node(pkg, "knob_node")
    s = lambda: node.engine.settings  # noqa: E731
    log = []
    for name, value in (("knn_d2mode", "fast3"), ("knn_d2mode", "fast99"), ("window_blocks", [1, 0]),
                        ("window_blocks", [1, 0, 0]), ("window_blocks", [2]), ("knn_kmode", "bisect"),
                        ("knn_kmode", "nope"), ("use_height", True), ("use_height", False)):
        log.append((name, _set(node, pkg, name, value), s().knn_d2mode, s().window_blocks,
                    s().knn_kmode, s().ground_method))
    P = pkg.runtime.Parameter
    res = node.set_parameters_atomically([P("neighborhood_passes", 3), P("window_blocks", [1, 0, 0])])
    log.append((res.successful, s().neighborhood_passes, s().window_blocks))
    before = s()
    res = node.set_parameters_atomically([P("knn_d2mode", "highest"), P("roi_min", [1.0, 2.0])])
    log.append((res.successful, res.reason, s() == before))
    return log


def test_knob_reconfigure_matches_reference():
    got, want = _settings_log(port), _settings_log(ref)
    assert got == want
    assert got[0][1] == (True, "") and not got[1][1][0]


def test_ground_plane_reconfigure_moves_the_cut_live():
    pts = np.zeros((6, 3), np.float32)
    pts[:, 2] = [0.0, 0.01, 0.5, 0.52, 1.0, 2.0]
    kept = {}
    for name, pkg in PKGS.items():
        node = _node(pkg, "plane_node", **{
            "remove_ground": True, "remove_ground.method": "height",
            "ground_plane": [0.0, 0.0, 1.0, 0.0], "remove_ground.distance_threshold": 0.05,
            "remove_statistical_outliers": False, "estimate_normals": False,
            "voxel_size": 0.0, "remove_duplicates": False})
        settings = node.engine.settings
        kept[name] = [sorted(node.engine.process_soa({"positions": pts})[0]["positions"][:, 2].tolist())]
        assert _set(node, pkg, "ground_plane", [0.0, 0.0, 1.0, -0.5])[0]
        assert node.engine.settings == settings  # a parameter change alone
        kept[name].append(sorted(node.engine.process_soa({"positions": pts})[0]["positions"][:, 2].tolist()))
        assert not _set(node, pkg, "ground_plane", [0.0, 0.0, 1.0])[0]
    assert kept["port"] == kept["ref"]
    assert kept["port"][0] == pytest.approx([0.5, 0.52, 1.0, 2.0])
    assert kept["port"][1] == pytest.approx([0.0, 0.01, 1.0, 2.0])
