"""The port's host modules against the reference's: the PointCloud2 codec,
the field tables, PCD/PLY/XYZ/KITTI files and LZF, the pcap payload parser
and decode (sidecar and numpy), the APCZ compressor, the loader, the
compressor node on the topic bus, the live UDP source, and the sidecar
build. Every case feeds both packages the same seeded inputs; outputs are
equal bytes or equal arrays (the modules are copies).
"""
import dataclasses
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

import chip_smoke
from autodriver_pointcloud_preprocessor_tpu import core as ref_core
from autodriver_pointcloud_preprocessor_tpu.io import compressor as ref_comp
from autodriver_pointcloud_preprocessor_tpu.io import loader as ref_loader
from autodriver_pointcloud_preprocessor_tpu.io import pcap as ref_pcap
from autodriver_pointcloud_preprocessor_tpu.io import pcd as ref_pcd
from autodriver_pointcloud_preprocessor_tpu_torch import core, native
from autodriver_pointcloud_preprocessor_tpu_torch.io import (
    PointcloudLoader,
    compressor,
    pcap,
    pcd,
    soa_to_pointcloud2,
)
from autodriver_pointcloud_preprocessor_tpu_torch.runtime import TopicBus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = [
    ("x", core.PointFieldType.FLOAT32), ("y", core.PointFieldType.FLOAT32),
    ("z", core.PointFieldType.FLOAT32), ("intensity", core.PointFieldType.FLOAT32),
    ("ring", core.PointFieldType.UINT16), ("time", core.PointFieldType.FLOAT64),
]


def _cloud_arrays(mod, n=64, seed=0, with_nans=False, rgb=False):
    """tests/test_core_codec.py's Velodyne cloud built with ``mod``'s codec
    (rgb: packed rgb in place of time)."""
    rng = np.random.default_rng(seed)
    fields = FIELDS[:5] + ([("rgb", core.PointFieldType.FLOAT32)] if rgb else FIELDS[5:])
    pf, step = mod.build_pointfields([f for f, _ in fields], [t for _, t in fields])
    arr = np.zeros(n, dtype=mod.structured_dtype_from_fields(pf, step))
    for c in "xyz":
        arr[c] = rng.normal(size=n).astype(np.float32)
    arr["intensity"] = rng.uniform(0, 255, size=n).astype(np.float32)
    arr["ring"] = rng.integers(0, 16, size=n).astype(np.uint16)
    if rgb:
        u8 = rng.integers(0, 256, size=(n, 3)).astype(np.uint8)
        arr["rgb"] = mod.merge_rgb_fields(u8[:, 0], u8[:, 1], u8[:, 2])
    else:
        arr["time"] = 1.7e9 + rng.uniform(0, 0.1, size=n)
    if with_nans:
        arr["x"][::7] = np.nan
    return arr, pf


def _assert_soa_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", ["plain", "nans", "rgb"])
def test_cloud_codec_matches_reference(case):
    kw = dict(with_nans=case == "nans", rgb=case == "rgb")
    arr, pf = _cloud_arrays(core, **kw)
    ref_arr, ref_pf = _cloud_arrays(ref_core, **kw)
    assert arr.dtype == ref_arr.dtype and arr.tobytes() == ref_arr.tobytes()
    assert [(f.name, f.offset, f.datatype, f.count) for f in pf] == [
        (f.name, f.offset, f.datatype, f.count) for f in ref_pf]
    header = core.Header(core.Time(1, 2), "velodyne")
    msg = core.create_cloud(header, pf, arr)
    ref_msg = ref_core.create_cloud(ref_core.Header(ref_core.Time(1, 2), "velodyne"), ref_pf, ref_arr)
    assert msg.data == ref_msg.data
    assert (msg.height, msg.width, msg.point_step, msg.row_step, msg.is_dense) == (
        ref_msg.height, ref_msg.width, ref_msg.point_step, ref_msg.row_step, ref_msg.is_dense)
    for names, skip in ((None, False), (["x", "y", "z"], True)):
        got, want = core.read_points(msg, names, skip), ref_core.read_points(ref_msg, names, skip)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        # each package reads the other's message
        assert core.read_points(ref_msg, names, skip).tobytes() == want.tobytes()
    for skip in (False, True):
        soa, meta = core.pointcloud_to_dict(msg, skip_nans=skip)
        ref_soa, ref_meta = ref_core.pointcloud_to_dict(ref_msg, skip_nans=skip)
        _assert_soa_equal(soa, ref_soa)
        # the header is each package's own dataclass: compare its fields
        assert dataclasses.asdict(meta.pop("header")) == dataclasses.asdict(ref_meta.pop("header"))
        assert meta == ref_meta
    structured = core.soa_to_structured(soa, meta, arr.dtype)
    want = ref_core.soa_to_structured(ref_soa, ref_meta, ref_arr.dtype)
    assert structured.dtype == want.dtype and structured.tobytes() == want.tobytes()
    _assert_soa_equal(core.structured_to_soa(arr, meta), ref_core.structured_to_soa(ref_arr, ref_meta))


def test_rgb_codecs_and_field_tables_match_reference():
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, size=(100, 3)).astype(np.uint8)
    packed = core.merge_rgb_fields(u8[:, 0], u8[:, 1], u8[:, 2])
    assert packed.tobytes() == ref_core.merge_rgb_fields(u8[:, 0], u8[:, 1], u8[:, 2]).tobytes()
    np.testing.assert_array_equal(core.extract_rgb_from_packed(packed),
                                  ref_core.extract_rgb_from_packed(packed))
    rgb01 = rng.uniform(0, 1, size=(50, 3)).astype(np.float32)
    assert core.pack_rgb_float(rgb01).tobytes() == ref_core.pack_rgb_float(rgb01).tobytes()
    assert core.rgb_to_intensity(rgb01).tobytes() == ref_core.rgb_to_intensity(rgb01).tobytes()
    inten = rng.uniform(0, 255, 40).astype(np.float32)
    np.testing.assert_array_equal(core.intensity_to_rgb(inten), ref_core.intensity_to_rgb(inten))
    assert {int(k): v for k, v in core.FIELD_DTYPE_MAP.items()} == {
        int(k): v for k, v in ref_core.FIELD_DTYPE_MAP.items()}
    assert core.VENDOR_MAPPINGS == ref_core.VENDOR_MAPPINGS
    for names in (["x", "y", "z", "I", "tag", "timestamp"], ["x", "y", "z", "r", "g", "b"],
                  ["x", "y", "z", "intensity", "ring", "time"], ["x", "y", "z", "line"]):
        assert core.get_pointcloud_metadata(names) == ref_core.get_pointcloud_metadata(names)
    assert core.resolve_field_alias(["C", "ring", "line"], ["x", "line"]) == \
        ref_core.resolve_field_alias(["C", "ring", "line"], ["x", "line"])


@pytest.mark.parametrize("case", ["empty", "one", "repeats", "random", "zeros"])
def test_lzf_matches_reference(case):
    rng = np.random.default_rng(2)
    data = {
        "empty": b"", "one": b"a", "repeats": b"abcabcabcabc" * 100,
        "random": rng.integers(0, 256, 10000).astype(np.uint8).tobytes(),
        "zeros": np.zeros(5000, np.float32).tobytes(),
    }[case]
    comp = pcd.lzf_compress(data)
    assert comp == ref_pcd.lzf_compress(data)
    assert pcd.lzf_decompress(comp, len(data)) == data
    assert ref_pcd.lzf_decompress(comp, len(data)) == data


def _file_soa(fmt, n=200):
    rng = np.random.default_rng(3)
    soa = {"positions": rng.normal(0, 10, (n, 3)).astype(np.float32)}
    if fmt in ("xyz", "xyzn"):
        if fmt == "xyzn":
            nm = rng.normal(size=(n, 3))
            soa["normals"] = (nm / np.linalg.norm(nm, axis=1, keepdims=True)).astype(np.float32)
        return soa
    soa["intensity"] = rng.uniform(0, 255, n).astype(np.float32)
    if fmt == "bin":
        return soa
    soa["ring"] = rng.integers(0, 16, n).astype(np.uint16)
    soa["rgb"] = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    if fmt.startswith("pcd"):
        nm = rng.normal(size=(n, 3))
        soa["normals"] = (nm / np.linalg.norm(nm, axis=1, keepdims=True)).astype(np.float32)
    return soa


@pytest.mark.parametrize("fmt,ascii_mode,compressed", [
    ("pcd", True, False), ("pcd", False, False), ("pcd", False, True),
    ("ply", True, False), ("ply", False, False), ("xyz", False, False),
    ("xyzn", False, False), ("bin", False, False),
])
def test_file_writes_match_reference(tmp_path, fmt, ascii_mode, compressed):
    soa = _file_soa(fmt)
    ext = "pcd" if fmt.startswith("pcd") else fmt
    path, ref_path = str(tmp_path / f"port.{ext}"), str(tmp_path / f"ref.{ext}")
    pcd.write_point_cloud(path, soa, ascii=ascii_mode, compressed=compressed)
    ref_pcd.write_point_cloud(ref_path, soa, ascii=ascii_mode, compressed=compressed)
    with open(path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()
    # each package reads the other's file, as the other reads it
    _assert_soa_equal(pcd.read_point_cloud(ref_path), ref_pcd.read_point_cloud(ref_path))
    _assert_soa_equal(ref_pcd.read_point_cloud(path), pcd.read_point_cloud(path))


def _random_capture(tmp_path, model, packets):
    path = str(tmp_path / f"{model}.pcap")
    chip_smoke.write_pcap(path, *chip_smoke.random_capture(model, packets))
    return path


@pytest.mark.parametrize("model", ["VLP16", "HDL32E"])
@pytest.mark.parametrize("native_parser", [True, False])
def test_payloads_and_decode_match_reference(tmp_path, model, native_parser):
    path = _random_capture(tmp_path, model, 30)
    payloads, stamps = pcap._read_payloads(path, native=native_parser)
    ref_payloads, ref_stamps = ref_pcap._read_payloads(path)
    assert payloads.shape == (30, 1206)
    np.testing.assert_array_equal(payloads, ref_payloads)
    np.testing.assert_array_equal(stamps, ref_stamps)
    soa = pcap.decode_packets(payloads, stamps, model, 0.4, 100.0)
    _assert_soa_equal(soa, ref_pcap.decode_packets(payloads, stamps, model, 0.4, 100.0))
    scans = list(pcap.VelodynePcapReader(path, model=model).scans())
    ref_scans = list(ref_pcap.VelodynePcapReader(path, model=model).scans())
    assert len(scans) == len(ref_scans) == 2
    for a, b in zip(scans, ref_scans):
        _assert_soa_equal(a, b)


def test_i32_streams_sidecar_matches_numpy():
    rng = np.random.default_rng(4)
    for values in (rng.integers(-100000, 100000, 5000).astype(np.int32),
                   np.array([2**31 - 1, -2**31, 0, -1, 2**31 - 1], np.int32),
                   np.zeros(0, np.int32)):
        enc = compressor._encode_i32_stream(values)
        assert enc == compressor._encode_i32_stream(values, native=False)
        assert enc == ref_comp._encode_i32_stream(values)
        for native_decode in (True, False):
            np.testing.assert_array_equal(
                compressor._decode_i32_stream(enc, values.size, native=native_decode), values)
    values = np.array([300, -5, 70000], np.int32)
    enc = compressor._encode_i32_stream(values)
    with pytest.raises(ValueError, match="truncated"):
        compressor._decode_i32_stream(enc[:-1] + bytes([0x80]), values.size)


def _lidar_soa(rng, n=5000):
    """tests/test_pcap_compressor.py's azimuth-ordered LiDAR SoA."""
    az = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(2, 60, n)
    z = rng.uniform(-2, 0.5, n)
    return {
        "positions": np.stack([r * np.cos(az), r * np.sin(az), z], axis=1).astype(np.float32),
        "intensity": rng.uniform(0, 255, n).astype(np.float32),
        "ring": rng.integers(0, 16, n).astype(np.uint16),
        "time": 1.7e9 + az / (2 * np.pi) * 0.1,
    }


@pytest.mark.parametrize("qbits", [14, 12, 0])
def test_compress_soa_matches_reference(qbits):
    soa = _lidar_soa(np.random.default_rng(5))
    blob = compressor.compress_soa(soa, quantization_bits=qbits)
    assert blob == ref_comp.compress_soa(soa, quantization_bits=qbits)
    _assert_soa_equal(compressor.decompress_soa(blob), ref_comp.decompress_soa(blob))


def test_loader_matches_reference(tmp_path):
    rng = np.random.default_rng(6)
    for i in range(3):
        pcd.write_point_cloud(str(tmp_path / f"{i:04d}.pcd"), _lidar_soa(rng, 50 + i))
    path = _random_capture(tmp_path, "VLP16", 30)
    for source in (str(tmp_path), path):
        got = list(PointcloudLoader(source, rate_hz=0).scans())
        want = list(ref_loader.PointcloudLoader(source, rate_hz=0).scans())
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.data == b.data and a.width == b.width and a.point_step == b.point_step
            assert [f.name for f in a.fields] == [f.name for f in b.fields]
    bus = TopicBus()
    received = []
    bus.create_subscription("/loader/points", received.append)
    assert PointcloudLoader(str(tmp_path), bus=bus, rate_hz=0, loop=True).spin(max_scans=7) == 7
    assert [m.width for m in received] == [50, 51, 52, 50, 51, 52, 50]


def test_compressor_node_on_bus():
    soa = _lidar_soa(np.random.default_rng(7), 1000)
    bus = TopicBus()
    compressed, restored = [], []
    node = compressor.PointcloudCompressorNode(bus, "/points", "/points/compressed")
    compressor.PointcloudCompressorNode(bus, "/points/compressed", "/points/restored",
                                        decompress=True)
    bus.create_subscription("/points/compressed", compressed.append)
    bus.create_subscription("/points/restored", restored.append)
    msg = soa_to_pointcloud2(soa)
    bus.create_publisher("/points").publish(msg)
    assert len(compressed) == 1 and len(restored) == 1 and node.last_ratio > 1.5
    assert compressed[0].data == ref_comp.PointCloudCodec().encode(msg).data
    r = core.read_points(restored[0])
    np.testing.assert_allclose(np.sort(r["x"]), np.sort(soa["positions"][:, 0]), atol=2e-2)


def test_udp_live_source_loopback():
    """tests/test_pcap_compressor.py's loopback case on the port's source:
    2.2 revolutions of packets over UDP on 127.0.0.1, read back as scans."""
    src = pcap.VelodyneUdpSource(host="127.0.0.1", port=0, timeout=3.0)
    port = src.port
    payloads, _ = chip_smoke.vlp16_ring_capture(165, dist_m=12.0)

    def sender():
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for payload in payloads:
            s.sendto(payload.tobytes(), ("127.0.0.1", port))
        s.sendto(b"short", ("127.0.0.1", port))  # a non-data datagram: ignored
        s.close()

    t = threading.Thread(target=sender)
    t.start()
    try:
        scans = list(src.scans(max_scans=2))
    finally:
        t.join(timeout=10)
        src.close()
    assert not t.is_alive()
    assert len(scans) == 2
    for soa in scans:
        assert soa["positions"].shape[0] > 10000
        np.testing.assert_allclose(np.linalg.norm(soa["positions"], axis=1), 12.0, atol=1e-2)
        assert "ring" in soa and "time" in soa


def test_sidecar_build_fails_loudly_and_builds_concurrently(tmp_path, monkeypatch):
    """A source that does not compile raises (no numpy fallback); three
    processes building the same sidecar into one directory at once all
    load it."""
    (tmp_path / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load("broken", {})
    assert not (tmp_path / "build" / "libbroken").exists()
    code = (
        "import sys; from pathlib import Path\n"
        "from autodriver_pointcloud_preprocessor_tpu_torch import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path / 'shared')!r})\n"
        "lib = native.load('compressor', {})\n"
        "print(lib._name)\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    built = list((tmp_path / "shared").iterdir())
    assert [p.name for p in built] == [os.path.basename(names.pop())]
