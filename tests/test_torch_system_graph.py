"""The three-sensor graph of tests/test_system_graph.py in both packages.

Three namespaced preprocessor nodes -> a ``sync`` concatenator -> the
compressor node, all on one bus per package (the port's on the CPU). Each
round's merged counts are equal, and where the merged clouds are equal the
compressed blobs are byte-equal.
"""
import numpy as np
import pytest

import autodriver_pointcloud_preprocessor_tpu as ref
import autodriver_pointcloud_preprocessor_tpu.io.compressor  # noqa: F401
import autodriver_pointcloud_preprocessor_tpu.parallel  # noqa: F401
import autodriver_pointcloud_preprocessor_tpu_torch as port
import autodriver_pointcloud_preprocessor_tpu_torch.io.compressor  # noqa: F401

SIZES = [200, 300, 250]


def _sensor_scan(pkg, seed, n, x_offset, t):
    rng = np.random.default_rng(seed)
    soa = {
        "positions": (rng.normal(0, 2, (n, 3)) + [x_offset, 0, 0]).astype(np.float32),
        "intensity": rng.uniform(0, 255, n).astype(np.float32),
    }
    return pkg.io.loader.soa_to_pointcloud2(soa, frame_id="sensor", stamp=pkg.core.Time.from_float(t))


def _graph(pkg, overrides):
    kw = {"device": "cpu"} if pkg is port else {}
    bus = pkg.runtime.TopicBus()
    nodes = [
        pkg.runtime.PointcloudPreprocessorNode(
            node_name=f"pre_{i}", parameter_namespace=f"lidar{i}", bus=bus,
            overrides={"input_topic": f"/lidar{i}/points", "output_topic": f"/lidar{i}/processed",
                       **overrides}, **kw)
        for i in range(3)
    ]
    ext = {}
    for i in range(3):
        m = np.eye(4, dtype=np.float32)
        m[1, 3] = 10.0 * i  # separate sensors along y in the target frame
        ext[f"/lidar{i}/processed"] = m
    concat = pkg.parallel.PointcloudConcatenatorNode(
        bus, [f"/lidar{i}/processed" for i in range(3)], output_topic="/merged",
        extrinsics=ext, mode="sync", slop=0.05, **kw)
    comp = pkg.io.compressor.PointcloudCompressorNode(bus, "/merged", "/merged/compressed")
    merged, compressed = [], []
    bus.create_subscription("/merged", merged.append)
    bus.create_subscription("/merged/compressed", compressed.append)
    return bus, nodes, concat, comp, merged, compressed


def _round(pkg, bus, seed, t):
    for i in range(3):
        bus.create_publisher(f"/lidar{i}/points").publish(
            _sensor_scan(pkg, seed + i, SIZES[i], 5.0 * i, t + 0.01 * i))


@pytest.mark.parametrize("overrides", [
    {"voxel_size": 0.0, "estimate_normals": False, "remove_duplicates": False},
    {"voxel_size": 0.2, "estimate_normals": True},
], ids=["passthrough", "voxel_normals"])
def test_three_sensor_graph_matches_reference(overrides):
    graphs = {name: _graph(pkg, overrides) for name, pkg in (("ref", ref), ("port", port))}
    for rnd, (seed, t) in enumerate(((0, 1.0), (10, 2.0))):
        if rnd == 1:  # live reconfigure of one namespaced node
            for name, pkg in (("ref", ref), ("port", port)):
                res = graphs[name][1][1].set_parameters([pkg.runtime.Parameter("lidar1.voxel_size", 1.0)])
                assert res[0].successful
        for name, pkg in (("ref", ref), ("port", port)):
            _round(pkg, graphs[name][0], seed, t)
        for name in graphs:
            _, nodes, concat, comp, merged, compressed = graphs[name]
            assert [n.frame_count for n in nodes] == [rnd + 1] * 3
            assert concat.frame_count == comp.frame_count == len(compressed) == rnd + 1
        (_, pn, _, _, pm, pc), (_, rn, _, _, rm, rc) = graphs["port"], graphs["ref"]
        got, want = port.core.read_points(pm[-1]), ref.core.read_points(rm[-1])
        counts = [port.core.read_points(n.latest_output).shape[0] for n in pn]
        assert got.shape[0] == want.shape[0] == sum(counts)
        assert counts == [ref.core.read_points(n.latest_output).shape[0] for n in rn]
        if got.tobytes() == want.tobytes():
            assert pc[-1].data == rc[-1].data
        else:  # voxel means sum in another order: an ulp or two apart
            assert rnd == 1 or overrides["voxel_size"] > 0
            for f in got.dtype.names:
                np.testing.assert_allclose(got[f], want[f], rtol=1e-6, atol=1e-6, err_msg=f)
        soa = port.io.compressor.decompress_soa(pc[-1].data)
        pts = soa["positions"]
        assert pts.shape[0] == sum(counts)
        for i in range(3):  # sensor i's cluster near y = 10 i (its extrinsic)
            near = np.abs(pts[:, 1] - 10.0 * i) < 6.0
            assert near.sum() >= counts[i] * 0.95
        if rnd == 0:
            first_counts = counts
    assert counts[1] < first_counts[1]  # sensor 1 is voxelized at 1 m now
    if overrides["voxel_size"] == 0.0:  # the other two pass through untouched
        assert first_counts == SIZES and counts[::2] == SIZES[::2]
