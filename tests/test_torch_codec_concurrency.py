"""The port's APCZ writers compress a blob's streams on a process-wide
thread pool. Their blobs must stay byte-equal to the reference's serial
writers for every layout; concurrent callers must get the blobs a serial
caller gets; the pool must not grow; a worker's error must reach the
caller; one usable core and a new process (pid) must give the same bytes.
"""
import os
import sys
import threading

import numpy as np
import pytest

from autodriver_pointcloud_preprocessor_tpu.io import compressor as ref_comp
from autodriver_pointcloud_preprocessor_tpu_torch.io import compressor

N = 3000


def _cloud(seed, n=N, extra=()):
    """An azimuth-ordered ring scan with float32 intensity, uint16 ring
    and float64 time, plus the named ``extra`` attributes."""
    rng = np.random.default_rng(seed)
    az = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(2, 60, n)
    soa = {
        "positions": np.stack([r * np.cos(az), r * np.sin(az), rng.uniform(-2, 1, n)],
                              axis=1).astype(np.float32),
        "intensity": rng.uniform(0, 255, n).astype(np.float32),
        "ring": rng.integers(0, 32, n).astype(np.uint16),
        "time": 1.7e9 + az / (2 * np.pi) * 0.1,
    }
    makers = {
        "normals": lambda: rng.normal(size=(n, 3)).astype(np.float32),
        "return_type": lambda: rng.integers(0, 3, n).astype(np.uint8),
        "label": lambda: rng.integers(-5, 5, n).astype(np.int32),
        "id": lambda: rng.integers(0, 2**32, n).astype(np.uint32),
        "range": lambda: r.astype(np.float64),
    }
    soa.update({name: makers[name]() for name in extra})
    return soa


SOA_CASES = {
    "q14": (lambda: _cloud(1), 14),
    "q8": (lambda: _cloud(2), 8),
    "lossless": (lambda: _cloud(3), 0),
    "empty": (lambda: _cloud(4, n=0), 14),
    "empty_lossless": (lambda: _cloud(4, n=0), 0),
    "no_attributes": (lambda: {"positions": _cloud(5)["positions"]}, 14),
    "normals_2d": (lambda: _cloud(6, extra=("normals",)), 14),
    "every_dtype": (lambda: _cloud(7, extra=("return_type", "label", "id", "range")), 14),
    # 3 position streams and 9 attributes: more tasks than workers
    "more_streams_than_workers": (
        lambda: _cloud(8, extra=("normals", "return_type", "label", "id", "range")), 12),
}


@pytest.mark.parametrize("case", list(SOA_CASES))
def test_compress_soa_byte_equal_reference(case):
    make, qbits = SOA_CASES[case]
    soa = make()
    blob = compressor.compress_soa(soa, quantization_bits=qbits)
    assert blob == ref_comp.compress_soa(soa, quantization_bits=qbits)
    if soa["positions"].shape[0]:  # no decoder reads a quantized empty blob (fault 11)
        back = compressor.decompress_soa(blob)
        assert back.keys() == soa.keys()
        for name in soa:
            if name != "positions":
                np.testing.assert_array_equal(back[name], soa[name])


def _packed(seed, n, capacity, rows):
    """Quantizer output as ``device_quantizer`` gives it: int16 rows with
    the live columns first, meta [count, (lo, step) per axis]."""
    rng = np.random.default_rng(seed)
    packed = np.zeros((rows, capacity), np.int16)
    packed[:3, :n] = np.cumsum(rng.integers(-40, 41, (3, n)), axis=1).clip(-8192, 8191)
    if rows > 3:
        packed[3, :n] = rng.integers(0, 256, n)
    meta = np.array([n, -50.0, 0.006, -50.0, 0.006, -3.0, 0.0004], np.float32)
    return packed, meta


@pytest.mark.parametrize("rows,qbits,scale,n", [
    (4, 14, 1.0, 2500), (3, 14, 1.0, 2500), (4, 12, 0.5, 1800), (4, 14, 1.0, 0), (3, 14, 1.0, 0),
])
def test_encode_device_quantized_byte_equal_reference(rows, qbits, scale, n):
    packed, meta = _packed(9, n, 4096, rows)
    blob = compressor.encode_device_quantized(packed, meta, qbits, scale)
    assert blob == ref_comp.encode_device_quantized(packed, meta, qbits, scale)
    if n:
        soa = compressor.decompress_soa(blob)
        assert soa["positions"].shape == (n, 3)
        assert ("intensity" in soa) == (rows == 4)


def test_concurrent_callers_get_serial_blobs():
    """Four threads, each encoding its own clouds 20 times through the
    shared pool, get the blobs one caller gets serially."""
    clouds = [_cloud(20 + t, n=1500 + 300 * t, extra=("normals",) if t % 2 else ()) for t in range(4)]
    serial = [compressor.compress_soa(soa) for soa in clouds]
    assert serial == [ref_comp.compress_soa(soa) for soa in clouds]
    got = [[] for _ in clouds]
    errors = []

    def caller(t):
        try:
            for _ in range(20):
                got[t].append(compressor.compress_soa(clouds[t]))
        except Exception as exc:  # reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(t,)) for t in range(len(clouds))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    for t, blobs in enumerate(got):
        assert blobs == [serial[t]] * 20


def test_pool_does_not_grow():
    """One pool a process, its workers capped: with every worker started,
    50 more blobs start no thread and keep the same pool and threads."""
    pool = compressor._executor()
    assert pool is not None  # more than one usable core here
    workers = pool._max_workers
    assert workers == min(len(os.sched_getaffinity(0)), compressor._MAX_WORKERS)
    # hold tasks until every worker is started (a pool starts them lazily)
    release, held = threading.Event(), []
    while len(pool._threads) < workers and len(held) < 10 * workers:
        held.append(pool.submit(release.wait, 30))
    release.set()
    for fut in held:
        assert fut.result(timeout=60)
    threads = set(pool._threads)
    assert len(threads) == workers
    before = threading.active_count()
    soa = _cloud(30, extra=("normals", "return_type", "label"))
    blob = compressor.compress_soa(soa)
    for _ in range(50):
        assert compressor.compress_soa(soa) == blob
    assert threading.active_count() <= before
    assert set(pool._threads) == threads
    assert compressor._executor() is pool


def test_worker_error_reaches_caller():
    """An unsupported attribute dtype raises ``KeyError`` from the dtype
    table, as in the reference, now inside a worker; the pool serves the
    next call."""
    soa = _cloud(40)
    soa["flag"] = np.ones(N, bool)
    with pytest.raises(KeyError):
        ref_comp.compress_soa(soa)
    with pytest.raises(KeyError):
        compressor.compress_soa(soa)
    packed, meta = _packed(41, 100, 128, 4)
    with pytest.raises(KeyError):  # the same through the quantized writer
        compressor._write_quantized_container(
            packed[:3, :100].astype(np.int32), meta[[1, 3, 5]], meta[[2, 4, 6]], 100, 14,
            compressor._submit_attrs([("flag", np.ones(100, bool))], 6), 6)
    del soa["flag"]
    assert compressor.compress_soa(soa) == ref_comp.compress_soa(soa)


def test_one_core_compresses_inline(monkeypatch):
    monkeypatch.setattr(compressor, "_pool", None)
    monkeypatch.setattr(compressor, "_pool_pid", None)
    monkeypatch.setattr(compressor.os, "sched_getaffinity", lambda pid: {0})
    assert compressor._executor() is None
    soa = _cloud(50, extra=("normals",))
    assert compressor.compress_soa(soa) == ref_comp.compress_soa(soa)
    packed, meta = _packed(51, 2000, 2048, 4)
    assert (compressor.encode_device_quantized(packed, meta, 14)
            == ref_comp.encode_device_quantized(packed, meta, 14))
    with pytest.raises(KeyError):
        compressor.compress_soa({**soa, "flag": np.ones(N, bool)})


def test_new_process_gets_new_pool(monkeypatch):
    """A pid other than the pool's (a forked child) creates a pool of its
    own rather than submitting to threads it does not have."""
    old = compressor._executor()
    monkeypatch.setattr(compressor, "_pool", old)
    monkeypatch.setattr(compressor, "_pool_pid", os.getpid())
    monkeypatch.setattr(compressor.os, "getpid", lambda: -1)
    new = compressor._executor()
    try:
        assert new is not old and new is not None
        soa = _cloud(60)
        assert compressor.compress_soa(soa) == ref_comp.compress_soa(soa)
        assert compressor._executor() is new
    finally:
        new.shutdown(wait=True)
