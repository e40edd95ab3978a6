"""The port's console commands against the reference's, on the CPU.

The eight cases of tests/test_cli.py, each run through both packages'
commands (the port's with ``--device cpu``): the same lines printed and
output files equal to the reference command's. Also the ROS 2 adapter's
import guard, with the reference's message.
"""
import importlib
import json
import os

import numpy as np
import pytest

from autodriver_pointcloud_preprocessor_tpu import cli as ref_cli
from autodriver_pointcloud_preprocessor_tpu.io.pcd import read_point_cloud, write_point_cloud
from autodriver_pointcloud_preprocessor_tpu_torch import cli


def _write_scans(d, seed=0, count=2, n=300):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for i in range(count):
        write_point_cloud(
            os.path.join(d, f"{i:04d}.pcd"),
            {"positions": rng.normal(0, 5, (n, 3)).astype(np.float32),
             "intensity": rng.uniform(0, 255, n).astype(np.float32)},
        )


def _both(tmp_path, capsys, argv, port_extra=("--device", "cpu")):
    """Run the reference's and the port's command with ``argv`` (OUT in it
    is replaced by a per-package output directory); return both outputs'
    directories and the printed lines."""
    runs = {}
    for name, main in (("ref", argv[0][0]), ("port", argv[0][1])):
        out = str(tmp_path / f"out_{name}")
        args = [out if a == "OUT" else a for a in argv[1:]]
        if name == "port":
            args += list(port_extra)
        assert main(args) == 0
        captured = capsys.readouterr()
        runs[name] = (out, captured.out)
    return runs


def _assert_same_files(a, b):
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and files
    for f in files:
        with open(os.path.join(a, f), "rb") as fa, open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f
    return files


def test_preprocessor_cli(tmp_path, capsys):
    src = str(tmp_path / "in")
    _write_scans(src)
    runs = _both(tmp_path, capsys, [(ref_cli.preprocessor_main, cli.preprocessor_main), src, "-o", "OUT",
                                    "--set", "voxel_size=0.5", "--set", "estimate_normals=false"])
    (ro, rt), (po, pt) = runs["ref"], runs["port"]
    assert _assert_same_files(po, ro) == ["00000000.pcd", "00000001.pcd"]
    assert pt == rt.replace(ro, po)
    cloud = read_point_cloud(os.path.join(po, "00000000.pcd"))
    assert 0 < cloud["positions"].shape[0] <= 300


def test_preprocessor_cli_params_json(tmp_path, capsys):
    src = str(tmp_path / "in")
    _write_scans(src, count=1)
    pfile = str(tmp_path / "p.json")
    with open(pfile, "w") as f:
        json.dump({"voxel_size": 0.0, "estimate_normals": False, "crop_to_roi": False}, f)
    runs = _both(tmp_path, capsys, [(ref_cli.preprocessor_main, cli.preprocessor_main), src, "-o", "OUT",
                                    "--params", pfile, "--profile"])
    (ro, rt), (po, pt) = runs["ref"], runs["port"]
    _assert_same_files(po, ro)
    assert read_point_cloud(os.path.join(po, "00000000.pcd"))["positions"].shape[0] == 300
    assert pt == rt.replace(ro, po)


def test_compressor_cli_roundtrip(tmp_path, capsys):
    src = str(tmp_path / "in")
    _write_scans(src, count=2)
    runs = _both(tmp_path, capsys, [(ref_cli.compressor_main, cli.compressor_main), src, "-o", "OUT",
                                    "-q", "16"], port_extra=())
    (rc, rt), (pc, pt) = runs["ref"], runs["port"]
    assert _assert_same_files(pc, rc) == ["00000000.apcz", "00000001.apcz"]
    assert pt == rt
    runs = _both(tmp_path, capsys, [(ref_cli.compressor_main, cli.compressor_main),
                                    pc + "/00000000.apcz", "-o", "OUT", "-d"], port_extra=())
    _assert_same_files(runs["port"][0], runs["ref"][0])
    orig = read_point_cloud(os.path.join(src, "0000.pcd"))
    back = read_point_cloud(os.path.join(runs["port"][0], "00000000.pcd"))
    np.testing.assert_allclose(np.sort(back["positions"][:, 0]), np.sort(orig["positions"][:, 0]),
                               atol=1e-3)


def test_loader_cli(tmp_path, capsys):
    src = str(tmp_path / "in")
    _write_scans(src, count=3)
    assert ref_cli.loader_main([src, "--rate-hz", "0"]) == 0
    want = capsys.readouterr().out
    assert cli.loader_main([src, "--rate-hz", "0"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.count("scan ") == 3


def test_concatenator_cli(tmp_path, capsys):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _write_scans(a, seed=1, count=2, n=100)
    _write_scans(b, seed=2, count=3, n=150)
    ex = str(tmp_path / "ex.json")
    m = np.eye(4)
    m[:3, 3] = [1.5, -2.0, 0.25]
    with open(ex, "w") as f:
        json.dump({b: m.ravel().tolist()}, f)
    runs = _both(tmp_path, capsys, [(ref_cli.concatenator_main, cli.concatenator_main), a, b,
                                    "-o", "OUT", "--extrinsics", ex])
    (ro, rt), (po, pt) = runs["ref"], runs["port"]
    files = _assert_same_files(po, ro)
    assert len(files) == 3 and pt == rt.replace(ro, po)
    merged = read_point_cloud(os.path.join(po, files[0]))
    assert merged["positions"].shape[0] == 250


def _warmup_lines(text):
    """The bucket lines and the last line's bucket list (times differ)."""
    lines = text.splitlines()
    return ([ln.split(":")[0] + ln[ln.index("(survivors"):] for ln in lines if ln.startswith("warmup bucket")],
            lines[-1].split(" in ")[0])


def test_warmup_cli(tmp_path, capsys):
    argv = ["--buckets", "1024,2048", "--attrs", "intensity", "--cache-dir", str(tmp_path / "cache"),
            "--set", "voxel_size=0.5", "--set", "estimate_normals=false",
            "--set", "remove_statistical_outliers=false"]
    assert ref_cli.warmup_main(argv) == 0
    want = capsys.readouterr().out
    assert cli.warmup_main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "warmup bucket 1024:" in got and "warmup bucket 2048:" in got and "warmed 1024,2048" in got
    buckets, last = _warmup_lines(got)
    want_buckets, want_last = _warmup_lines(want)
    assert last == want_last == "warmed 1024,2048"
    assert buckets == want_buckets  # the same survivors in each bucket
    assert "built kernels and sidecars" in got


def test_warmup_cli_preset(tmp_path, capsys):
    # the preset's buckets (65536, 51200) are above 2048, so no-ops here
    argv = ["--preset", "production_128k", "--buckets", "2048", "--cache-dir", str(tmp_path)]
    assert ref_cli.warmup_main(argv) == 0
    want = capsys.readouterr().out
    assert cli.warmup_main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "warmup bucket 2048:" in got and "warmed 2048 in" in got
    # the preset runs RANSAC, whose draws come from each package's own
    # generator: the survivors differ, the lines do not
    (bucket,), last = _warmup_lines(got)
    (want_bucket,), want_last = _warmup_lines(want)
    assert last == want_last and bucket.split("(")[0] == want_bucket.split("(")[0]
    assert 0 < int(bucket.split()[-1].rstrip(")")) < 2048


@pytest.mark.parametrize("val", ["fast3", "farthest", "true", "-1.5", "[1, 0]", "", "2scans",
                                 '{"a": 1}', "false", "0.05"])
def test_parse_set_value_string_fallback(val):
    got, want = cli._parse_set_value(val), ref_cli._parse_set_value(val)
    assert got == want and type(got) is type(want)


def test_ros2_adapter_import_guard_matches_reference():
    try:
        import rclpy  # noqa: F401
        pytest.skip("rclpy installed; guard not exercised")
    except ImportError:
        pass
    messages = []
    for mod in ("autodriver_pointcloud_preprocessor_tpu.ros2_adapter",
                "autodriver_pointcloud_preprocessor_tpu_torch.ros2_adapter"):
        with pytest.raises(ImportError) as info:
            importlib.import_module(mod)
        messages.append(str(info.value))
    assert messages[0] == messages[1] and "TopicBus" in messages[1]


def test_entry_points_need_a_card_or_a_device(tmp_path):
    """Without a card, every entry point of the node layer raises unless
    it is given a device: none falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults run on it")
    from autodriver_pointcloud_preprocessor_tpu_torch.parallel import PointcloudConcatenatorNode
    from autodriver_pointcloud_preprocessor_tpu_torch.runtime import (
        PointcloudPreprocessorNode,
        TopicBus,
    )

    src = str(tmp_path / "in")
    _write_scans(src, count=1, n=50)
    calls = [
        lambda: PointcloudPreprocessorNode(bus=TopicBus(), overrides={"use_gpu": False}),
        lambda: PointcloudConcatenatorNode(TopicBus(), ["/a"]),
        lambda: cli.preprocessor_main([src, "-o", str(tmp_path / "out")]),
        lambda: cli.concatenator_main([src, "-o", str(tmp_path / "merged")]),
        lambda: cli.warmup_main(["--buckets", "1024"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
