"""The port's multi-LiDAR concatenator against the reference's, on the CPU.

The four concatenation cases of tests/test_parallel.py, each run through
both packages on the same inputs: ``concatenate_buffers`` (positions
within 1e-6 m after the transform, union-schema zeros and masks
bit-equal), the synchronizer, and the ``sync`` and ``robust`` nodes
(published clouds equal); plus the time re-base, bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autodriver_pointcloud_preprocessor_tpu as ref
import autodriver_pointcloud_preprocessor_tpu.io.loader  # noqa: F401
import autodriver_pointcloud_preprocessor_tpu_torch as port
import autodriver_pointcloud_preprocessor_tpu_torch.io.loader  # noqa: F401
from autodriver_pointcloud_preprocessor_tpu.parallel import concat as ref_concat
from autodriver_pointcloud_preprocessor_tpu_torch.parallel import concat

PKGS = {"ref": ref, "port": port}


def _extrinsic(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    return np.asarray(port.ops.linalg.se3_matrix(tuple(rng.normal(0, 5, 3)), tuple(q)))


def test_concatenate_buffers_transform_and_union_schema():
    rng = np.random.default_rng(0)
    soa_a = {"positions": rng.normal(size=(100, 3)).astype(np.float32),
             "intensity": np.ones(100, np.float32),
             "normals": rng.normal(size=(100, 3)).astype(np.float32)}
    soa_b = {"positions": rng.normal(size=(200, 3)).astype(np.float32),
             "ring": rng.integers(0, 16, 200).astype(np.uint16)}
    ex = [_extrinsic(1), np.eye(4, dtype=np.float32)]
    ex[1][0, 3] = 5.0
    got = concat.concatenate_buffers(
        [port.core.from_soa(s, device="cpu")[0] for s in (soa_a, soa_b)],
        [torch.from_numpy(e) for e in ex])
    want = ref_concat.concatenate_buffers(
        [ref.core.from_soa(s)[0] for s in (soa_a, soa_b)], [jnp.asarray(e) for e in ex])
    assert got.capacity == want.capacity == 1024 + 1024
    assert int(port.core.valid_count(got)) == 300
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.positions.numpy(), np.asarray(want.positions), rtol=0, atol=1e-6)
    assert sorted(got.attributes) == sorted(want.attributes) == ["intensity", "normals", "ring"]
    for k, v in got.attributes.items():
        w = np.asarray(want.attributes[k])
        assert v.numpy().dtype == w.dtype, k
        if k == "normals":
            np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
    out = port.core.to_soa(got)
    assert out["positions"][100:, 0].mean() > 4.0  # sensor b shifted by +5 in x
    assert (out["intensity"][:100] == 1.0).all() and (out["intensity"][100:] == 0.0).all()
    assert (out["ring"][:100] == 0).all() and (out["normals"][100:] == 0).all()


def test_approximate_time_synchronizer():
    hits = {}
    for name, pkg in PKGS.items():
        hits[name] = []
        sync = pkg.parallel.ApproximateTimeSynchronizer(
            3, lambda *m, name=name: hits[name].append([x.header.stamp.to_float() for x in m]),
            slop=0.02)

        class M:
            def __init__(self, t):
                self.header = pkg.core.Header(stamp=pkg.core.Time.from_float(t))

        for slot, t in ((0, 1.000), (1, 1.005), (2, 1.010), (0, 2.0), (1, 2.5), (2, 3.0),
                        (0, 3.01), (1, 2.99), (0, 4.0), (2, 4.005), (1, 4.01)):
            sync.add(slot, M(t))
    assert hits["port"] == hits["ref"]
    # 2.0, 2.5, 3.0 never match; the late 2.99 and 3.01 match the queued 3.0
    assert [h[0] for h in hits["port"]] == [1.0, 3.01, 4.0]


def _cloud_msg(pkg, seed, n, t, x_off=0.0, time_span=0.0):
    rng = np.random.default_rng(seed)
    soa = {
        "positions": (rng.normal(0, 1, (n, 3)) + [x_off, 0, 0]).astype(np.float32),
        "time": t + np.sort(rng.uniform(0, time_span, n)),
    }
    return pkg.io.loader.soa_to_pointcloud2(soa, frame_id="s", stamp=pkg.core.Time.from_float(t))


def _graph(pkg, topics, **kw):
    bus = pkg.runtime.TopicBus()
    if pkg is port:
        kw["device"] = "cpu"
    node = pkg.parallel.PointcloudConcatenatorNode(bus, topics, **kw)
    outs = []
    bus.create_subscription("/points/concatenated", outs.append)
    return bus, node, outs


def _assert_same_clouds(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.header.frame_id, a.header.stamp.sec, a.header.stamp.nanosec) == (
            b.header.frame_id, b.header.stamp.sec, b.header.stamp.nanosec)
        assert [(f.name, f.offset, f.datatype) for f in a.fields] == [
            (f.name, f.offset, f.datatype) for f in b.fields]
        pa, pb = port.core.read_points(a), ref.core.read_points(b)
        for name in pa.dtype.names:
            if name in "xyz":
                np.testing.assert_allclose(pa[name], pb[name], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)


def test_concatenator_node_sync_mode():
    outs = {}
    for name, pkg in PKGS.items():
        bus, node, outs[name] = _graph(pkg, ["/a", "/b"], extrinsics={"/b": np.eye(4)},
                                       mode="sync", slop=0.05)
        node.extrinsics["/b"][0, 3] = 10.0
        bus.create_publisher("/a").publish(_cloud_msg(pkg, 0, 50, 1.00))
        assert not outs[name]
        bus.create_publisher("/b").publish(_cloud_msg(pkg, 1, 60, 1.02))
        assert node.frame_count == 1
    _assert_same_clouds(outs["port"], outs["ref"])
    pts = port.core.read_points(outs["port"][0])
    assert pts.shape[0] == 110 and outs["port"][0].header.frame_id == "base_link"
    assert (pts["x"] > 5).sum() == 60  # sensor b translated by extrinsic


def test_concatenator_node_robust_mode():
    outs = {}
    for name, pkg in PKGS.items():
        bus, node, outs[name] = _graph(pkg, ["/a", "/b", "/c"], mode="robust", timeout=10.0,
                                       extrinsics={"/b": _extrinsic(4)})
        bus.create_publisher("/a").publish(_cloud_msg(pkg, 2, 30, 1.0))
        bus.create_publisher("/b").publish(_cloud_msg(pkg, 3, 40, 1.01))
        assert not outs[name]  # /c missing, timeout not expired
        node.flush()  # timer expiry analog: publish the partial set
        for t in ("/a", "/b", "/c"):  # a complete round publishes at once
            bus.create_publisher(t).publish(_cloud_msg(pkg, 5, 20, 2.0))
        assert node.frame_count == 2
    _assert_same_clouds(outs["port"], outs["ref"])
    assert [port.core.read_points(m).shape[0] for m in outs["port"]] == [70, 60]


@pytest.mark.parametrize("spans", [(0.0, 0.0, 0.0), (0.1, 0.05, 0.08)])
def test_time_rebase_is_bit_equal(spans):
    """Sensors with different time bases: each later sensor's float32
    offsets gain the float32-rounded base difference, bit for bit as the
    reference adds it, and the published absolute times are equal."""
    stamps = (100.0, 100.013, 100.0271)
    outs = {}
    for name, pkg in PKGS.items():
        bus, node, outs[name] = _graph(pkg, ["/a", "/b", "/c"], mode="sync", slop=0.05)
        for i, (t, span) in enumerate(zip(stamps, spans)):
            bus.create_publisher(["/a", "/b", "/c"][i]).publish(
                _cloud_msg(pkg, 10 + i, 40 + i, t, time_span=span))
    _assert_same_clouds(outs["port"], outs["ref"])
    pa, pb = port.core.read_points(outs["port"][0]), ref.core.read_points(outs["ref"][0])
    assert pa["time"].dtype == np.float64
    # float64 times are float32 rows plus the common base: equal bits here
    # mean equal re-based rows
    np.testing.assert_array_equal(pa["time"].view(np.int64), pb["time"].view(np.int64))
    assert np.abs(pa["time"][40:] - pa["time"][:40].min()).max() > 0.01
