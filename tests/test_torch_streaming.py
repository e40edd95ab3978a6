"""The port's streaming data path against the reference's: the packet
decode, the device quantizer, the host finish of the compressed egress,
and ``StreamingEngine`` replays of captures, on the CPU.

Tolerances, and why:
- decode: mask, ring, intensity, time and distance bit for bit (the
  arithmetic is exact in both packages); positions within 1e-4 m, since
  PyTorch's and XLA's sine and cosine differ by an ulp;
- quantizer: ``meta[0]`` equal, ``lo`` and ``step`` within 1e-6 relative
  (XLA's division differs from an IEEE one by an ulp), packed rows equal
  except one quantum on at most 0.1% of coordinates (a coordinate that sits
  on a rounding edge);
- blobs: byte-equal for the same quantized input (the host encoder is a
  copy), and each package's ``decompress_soa`` reads the other's;
- replays: survivor counts equal, each decompressed survivor within one
  quantum, survivor jaccard >= 0.99 on the quantization grid, intensity
  equal.

The reference's Pallas kernels run in interpret mode, as its own tests do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from autodriver_pointcloud_preprocessor_tpu.core import scan as ref_scan
from autodriver_pointcloud_preprocessor_tpu.io import compressor as ref_comp
from autodriver_pointcloud_preprocessor_tpu.io import streaming as ref_streaming
from autodriver_pointcloud_preprocessor_tpu.models import pipeline as ref_pipeline
from autodriver_pointcloud_preprocessor_tpu_torch import core
from autodriver_pointcloud_preprocessor_tpu_torch.io import compressor, streaming
from autodriver_pointcloud_preprocessor_tpu_torch.io.pcap import _read_payloads
from autodriver_pointcloud_preprocessor_tpu_torch.models.presets import PRODUCTION_128K_CONFIG
from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor

CONFIG5 = chip_smoke.CONFIG5


@pytest.fixture
def pallas_interpret(monkeypatch):
    # the backend is resolved while tracing: drop executables traced under
    # another backend in this worker, before and after
    monkeypatch.setenv("APC_WINDOW_BACKEND", "pallas_interpret")

    def clear():
        jax.clear_caches()
        ref_pipeline.build_pipeline.cache_clear()

    clear()
    yield
    clear()


def _random_packets(model, packets, seed=1):
    """chip_smoke's random capture, stamps in seconds."""
    payloads, stamps_us = chip_smoke.random_capture(model, packets, seed)
    return payloads, stamps_us * 1e-6


def _fields(payloads, stamps, pb):
    p = payloads.shape[0]
    fields = np.zeros((1176, pb), np.uint8)
    fields[:, :p] = streaming._split_packet_fields(payloads)
    stamp_off = np.zeros(pb, np.float32)
    stamp_off[:p] = (stamps - stamps.min()).astype(np.float32)
    return fields, stamp_off


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("model,packets,pb", [("VLP16", 20, 20), ("VLP16", 27, 32),
                                              ("HDL32E", 25, 32)])
def test_decode_matches_reference(model, packets, pb):
    payloads, stamps = _random_packets(model, packets)
    fields, stamp_off = _fields(payloads, stamps, pb)
    ref = ref_streaming._decode_fn(model, pb)(
        jnp.asarray(fields), jnp.asarray(stamp_off), jnp.int32(packets),
        jnp.float32(0.4), jnp.float32(110.0),
    )
    got = streaming.decode_fields(torch.from_numpy(fields), torch.from_numpy(stamp_off),
                                  torch.tensor(packets, dtype=torch.int32), 0.4, 110.0, model)
    mask = np.asarray(ref.mask)
    assert got.capacity == 384 * pb and 0 < mask.sum() < mask.size
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    for k in ("intensity", "ring", "time", "distance"):
        assert got.attributes[k].numpy().dtype == np.asarray(ref.attributes[k]).dtype, k
        np.testing.assert_array_equal(_bits(got.attributes[k]), _bits(ref.attributes[k]), err_msg=k)
    np.testing.assert_allclose(got.attributes["azimuth"].numpy(), np.asarray(ref.attributes["azimuth"]),
                               rtol=0, atol=1e-4)
    diff = np.abs(got.positions.numpy() - np.asarray(ref.positions))[:, mask]
    assert diff.max() <= 1e-4, diff.max()
    # the batched decode equals the single one, scan by scan
    other = _fields(*_random_packets(model, packets, seed=2), pb)
    both = streaming.decode_fields(
        torch.from_numpy(np.stack([fields, other[0]])), torch.from_numpy(np.stack([stamp_off, other[1]])),
        torch.tensor([packets, packets - 3], dtype=torch.int32), 0.4, 110.0, model)
    alone = streaming.decode_fields(torch.from_numpy(other[0]), torch.from_numpy(other[1]),
                                    torch.tensor(packets - 3), 0.4, 110.0, model)
    # contiguous, as the kernels on a card take them
    assert all(t.is_contiguous() for t in (both.positions, both.mask, *both.attributes.values()))
    for i, one in enumerate((got, alone)):
        assert torch.equal(both.mask[i], one.mask) and torch.equal(both.positions[i], one.positions)
        for k, v in one.attributes.items():
            assert torch.equal(both.attributes[k][i], v), k


def _buffers(n_live_share, capacity=8192, seed=0, n=7000):
    """One seeded SoA as a reference and a port buffer, with the same holes
    in the mask."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(0.4, 120, n)
    soa = {
        "positions": np.stack([r * np.cos(az), r * np.sin(az), rng.uniform(-3, 2, n)], 1)
        .astype(np.float32),
        "intensity": rng.integers(0, 256, n).astype(np.float32),
    }
    keep = rng.random(capacity) < n_live_share
    ref, _ = ref_scan.from_soa(soa, capacity=capacity)
    port, _ = core.from_soa(soa, capacity=capacity, device="cpu")
    return ref.replace(mask=ref.mask & jnp.asarray(keep)), port.replace(mask=port.mask & torch.from_numpy(keep))


def _assert_quantized_close(packed, meta, ref_packed, ref_meta):
    assert meta[0] == ref_meta[0]
    np.testing.assert_allclose(meta[1:], ref_meta[1:], rtol=1e-6, atol=0)
    n = int(meta[0])
    diff = np.abs(packed[:3, :n].astype(np.int64) - ref_packed[:3, :n])
    assert diff.max(initial=0) <= 1 and (diff > 0).sum() <= 1e-3 * diff.size
    np.testing.assert_array_equal(packed[3:, :n], ref_packed[3:, :n])


@pytest.mark.parametrize("qbits", [14, 10])
def test_quantizer_matches_reference(qbits, monkeypatch):
    calls, compact_rows = [], compressor.compact_rows
    monkeypatch.setattr(compressor, "compact_rows", lambda *a: calls.append(a) or compact_rows(*a))
    quantize = compressor.device_quantizer(qbits)
    ref_quantize = ref_comp.device_quantizer(qbits)
    bufs = [_buffers(0.7, seed=s) for s in range(2)]
    outs = []
    for ref_buf, buf in bufs:
        packed, meta = quantize(buf, 2.0)
        ref_packed, ref_meta = ref_quantize(ref_buf, jnp.float32(2.0))
        assert packed.dtype == torch.int16 and packed.shape == (4, 8192) and meta.shape == (7,)
        _assert_quantized_close(packed.numpy(), meta.numpy(), np.asarray(ref_packed), np.asarray(ref_meta))
        outs.append((packed, meta))
    assert len(calls) == 2  # one K1 call a scan, through compact_rows
    # a batch: one K1 call, every scan with its own box, equal to its lone run
    packed, meta = quantize(core.stack_buffers([b for _, b in bufs]), 2.0)
    assert len(calls) == 3 and packed.shape == (2, 4, 8192) and meta.shape == (2, 7)
    for i, (p1, m1) in enumerate(outs):
        assert torch.equal(packed[i], p1) and torch.equal(meta[i], m1)
    with pytest.raises(ValueError):
        compressor.device_quantizer(0)


def test_quantizer_empty_scan_matches_reference():
    ref_buf, buf = _buffers(0.0)
    packed, meta = compressor.device_quantizer(14)(buf)
    ref_packed, ref_meta = ref_comp.device_quantizer(14)(ref_buf, jnp.float32(1.0))
    np.testing.assert_array_equal(_bits(meta.numpy()), _bits(ref_meta))
    blob = compressor.encode_device_quantized(packed.numpy(), meta.numpy(), 14)
    assert blob == ref_comp.encode_device_quantized(np.asarray(ref_packed), np.asarray(ref_meta), 14)
    assert _header_count(blob) == 0


def _header_count(blob):
    """The point count in an APCZ header. (Neither package's
    ``decompress_soa`` reads a quantized blob of no points: it expects the
    lossless layout there; ROADMAP fault 11.)"""
    return int(np.frombuffer(blob[6:10], np.uint32)[0])


@pytest.mark.parametrize("rows,qbits,scale", [(4, 14, 1.0), (3, 14, 1.0), (4, 12, 0.5)])
def test_encode_device_quantized_byte_equal(rows, qbits, scale):
    ref_buf, buf = _buffers(0.6, seed=3)
    packed, meta = compressor.device_quantizer(qbits)(buf, scale)
    packed, meta = packed.numpy()[:rows], meta.numpy()
    blob = compressor.encode_device_quantized(packed, meta, qbits, scale)
    assert blob == ref_comp.encode_device_quantized(packed, meta, qbits, scale)
    for decode in (compressor.decompress_soa, ref_comp.decompress_soa):
        soa = decode(blob)
        assert soa["positions"].shape == (int(meta[0]), 3)
        assert ("intensity" in soa) == (rows == 4)
    # compress_buffer is the quantizer and this encoder in one call
    if rows == 4:
        assert compressor.compress_buffer(buf, qbits, intensity_scale=scale) == blob


def _assert_blobs_close(blob, ref_blob):
    """Survivors within one quantum, jaccard >= 0.99 on the quantization
    grid, intensity equal; each package's decoder reads the other's blob."""
    got, want = compressor.decompress_soa(blob), ref_comp.decompress_soa(ref_blob)
    assert got["positions"].shape == want["positions"].shape
    for a, b in ((got, ref_comp.decompress_soa(blob)), (want, compressor.decompress_soa(ref_blob))):
        np.testing.assert_array_equal(a["positions"], b["positions"])
    n = got["positions"].shape[0]
    if n == 0:
        return
    header = np.frombuffer(ref_blob[11:59], np.float64)
    lo, step = header[:3], header[3:]
    q = np.rint((got["positions"] - lo) / step).astype(np.int64)
    q_ref = np.rint((want["positions"] - lo) / step).astype(np.int64)
    assert np.abs(q - q_ref).max() <= 1
    a, b = set(map(tuple, q.tolist())), set(map(tuple, q_ref.tolist()))
    assert len(a & b) / len(a | b) >= 0.99
    np.testing.assert_array_equal(got["intensity"], want["intensity"])


@pytest.mark.parametrize("capture", ["ring", "random"])
def test_replay_matches_reference(tmp_path, pallas_interpret, capture):
    """``replay_pcap`` against the reference's engine at packet_bucket 32
    and config 5's settings; the ring capture is tests/test_pcap_compressor
    's ``_write_pcap`` (100 packets: a revolution cut to 32, then 25)."""
    path = str(tmp_path / "s.pcap")
    if capture == "ring":
        chip_smoke.write_pcap(path, *chip_smoke.vlp16_ring_capture(100))
    else:
        chip_smoke.write_pcap(path, *chip_smoke.random_capture("VLP16", 110))
    blobs = list(streaming.StreamingEngine(CONFIG5, packet_bucket=32, device="cpu").replay_pcap(path))
    ref_blobs = list(ref_streaming.StreamingEngine(CONFIG5, packet_bucket=32).replay_pcap(path))
    assert len(blobs) == len(ref_blobs) == {"ring": 2, "random": 3}[capture]
    for blob, ref_blob in zip(blobs, ref_blobs):
        _assert_blobs_close(blob, ref_blob)


def test_batched_replay_equals_single(tmp_path):
    path = str(tmp_path / "s.pcap")
    chip_smoke.write_pcap(path, *chip_smoke.vlp16_ring_capture(320))  # 4.3 revolutions
    engine = streaming.StreamingEngine(CONFIG5, packet_bucket=80, device="cpu")
    single = list(engine.replay_pcap(path))
    batched = list(engine.replay_pcap(path, batch=3))
    assert len(single) == len(batched) == 5
    assert single == batched


def test_empty_revolution_matches_reference(tmp_path, pallas_interpret):
    """Every return out of range: a blob with no points, as the
    reference's."""
    payloads, stamps = chip_smoke.vlp16_ring_capture(30, dist_m=0.0)
    path = str(tmp_path / "zero.pcap")
    chip_smoke.write_pcap(path, payloads, stamps)
    blobs = list(streaming.StreamingEngine(CONFIG5, packet_bucket=32, device="cpu").replay_pcap(path))
    ref_blobs = list(ref_streaming.StreamingEngine(CONFIG5, packet_bucket=32).replay_pcap(path))
    assert len(blobs) == 1 and blobs == ref_blobs
    assert _header_count(blobs[0]) == 0


def test_packets_beyond_the_bucket_are_cut():
    payloads, stamps = _random_packets("VLP16", 40)
    engine = streaming.StreamingEngine(CONFIG5, packet_bucket=32, device="cpu")
    assert engine.process_scan_packets(payloads, stamps) == \
        engine.process_scan_packets(payloads[:32], stamps[:32])


def test_production_engine_runs_the_preprocessor_pipeline():
    """The production preset on an HDL-32E revolution at packet_bucket 20
    (7,680 slots) with injected RANSAC draws: the engine's blob equals the
    port's own Preprocessor on the decoded buffer, compressed; a batch of
    two equals the two single runs."""
    payloads, stamps_us = chip_smoke.hdl32_capture(revs=2, per_rev=20)
    stamps = stamps_us * 1e-6
    engine = streaming.StreamingEngine(PRODUCTION_128K_CONFIG, model="HDL32E", packet_bucket=20,
                                       device="cpu")
    s = engine.settings
    draws = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(2, s.num_iterations, s.ransac_n)).astype(np.float32))
    scans = [(payloads[:20], stamps[:20]), (payloads[20:], stamps[20:])]
    blobs = [engine.process_scan_packets(p, t, ground_uniforms=draws[i])
             for i, (p, t) in enumerate(scans)]
    pre = Preprocessor(PRODUCTION_128K_CONFIG, device="cpu")
    for i, (p, t) in enumerate(scans):
        fields, stamp_off = _fields(p, t, 20)
        buf = streaming.decode_fields(torch.from_numpy(fields), torch.from_numpy(stamp_off),
                                      torch.tensor(20), 0.4, 130.0, "HDL32E")
        out, plane = pre.process_buffer(buf, ground_uniforms=draws[i])
        assert abs(float(plane[2])) > 0.9 and 1000 < int(out.mask.sum()) < 7680
        assert blobs[i] == compressor.compress_buffer(out, 14)
    assert engine.process_scan_batch(scans, ground_uniforms=draws) == blobs


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming.StreamingEngine(CONFIG5)


def test_read_payloads_numpy_variant_feeds_the_engine(tmp_path):
    """The engine reads captures through the sidecar; its numpy version
    gives the same payloads."""
    path = str(tmp_path / "s.pcap")
    chip_smoke.write_pcap(path, *chip_smoke.vlp16_ring_capture(90))
    a, b = _read_payloads(path), _read_payloads(path, native=False)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
