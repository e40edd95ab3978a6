"""Where a merged round's APCZ encode goes, stream by stream, on this host.

Builds the merged cloud of ``bench_gpu``'s ``round_3lidar`` cell (three
production nodes over ``bench_gpu.inputs.bench_soa`` scenes of seeds 0-2,
the sync concatenator with the cell's extrinsics), then times the
compressor node's ``PointCloudCodec.encode`` on it, in turns: on the
codec's stream pool, and inline (the writers' one-core path, a serial
writer). Last, each stream of the blob alone. Prints the host's usable
cores, the pool's workers, whether both paths give the same bytes, and
last one JSON line of every number (ms, medians over ``--repeats``).

    python3 tools/codec_streams.py [--device cuda|cpu] [--repeats 20] [--cut]

``--cut`` takes the CPU rehearsal's sizes (8,000 points a scan in 8,192);
the default is the cell's 128,000 in 131,072. Host times only: the card,
when there is one, runs the three nodes and the merge.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_gpu import cells, harness, inputs  # noqa: E402

CUT = harness.Sizes(points=8000, capacity=8192, extent=10.0, production_buckets=(4096, 3584))


def merged_round(device: str, sizes: harness.Sizes):
    """The round cell's merged PointCloud2 for scenes of seeds 0-2."""
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.linalg import se3_matrix
    from autodriver_pointcloud_preprocessor_tpu_torch.parallel import PointcloudConcatenatorNode
    from autodriver_pointcloud_preprocessor_tpu_torch.runtime import (
        PointcloudPreprocessorNode, TopicBus,
    )

    k = cells.ROUND_SENSORS
    ext = {f"/lidar{i}/processed": se3_matrix(
        (cells.ROUND_SPACING * i, 0.0, 0.0), (0.0, 0.0, float(np.sin(np.pi * i / 3)),
                                              float(np.cos(np.pi * i / 3)))
    ).numpy() for i in range(k)}
    bus = TopicBus()
    cfg = cells.production_config(sizes)
    nodes = [PointcloudPreprocessorNode(
        node_name=f"pre_{i}", parameter_namespace=f"lidar{i}", bus=bus, device=device,
        overrides={**cfg, "input_topic": f"/lidar{i}/points", "output_topic": f"/lidar{i}/processed"})
        for i in range(k)]
    concat = PointcloudConcatenatorNode(bus, list(ext), output_topic="/merged", extrinsics=ext,
                                        mode="sync", slop=0.05, device=device)
    merged = []
    bus.create_subscription("/merged", merged.append)
    for i in range(k):
        msg = cells.velodyne_msg(inputs.bench_soa(sizes.points, i, extent=sizes.extent),
                                 10.0 + 0.01 * i, "lidar")
        bus.create_publisher(f"/lidar{i}/points").publish(msg)
    assert len(merged) == 1 and concat.frame_count == 1 and all(n.frame_count == 1 for n in nodes)
    return merged[0]


def _ms(fn, repeats):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--cut", action="store_true")
    args = ap.parse_args(argv)

    from autodriver_pointcloud_preprocessor_tpu_torch.core import pointcloud_to_dict
    from autodriver_pointcloud_preprocessor_tpu_torch.io import compressor

    if args.device.startswith("cuda"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        print(f"[codec_streams] card: {smi}")
    msg = merged_round(args.device, CUT if args.cut else harness.Sizes())
    codec = compressor.PointCloudCodec()
    cores = len(os.sched_getaffinity(0))
    pool = compressor._executor()
    workers = pool._max_workers if pool is not None else 1
    print(f"[codec_streams] usable cores {cores}, pool workers {workers}")

    def inline(fn):
        """``fn()`` with the writers on their one-core path."""
        saved = compressor._pool
        compressor._pool = None
        try:
            return fn()
        finally:
            compressor._pool = saved

    encode = lambda: codec.encode(msg).data  # noqa: E731
    pooled_blob, serial_blob = encode(), inline(encode)
    timed = lambda: _ms(encode, args.repeats)  # noqa: E731
    pooled = [timed()]  # in turns: pooled, inline, inline, pooled
    serial = [inline(timed), inline(timed)]
    pooled.append(timed())

    soa, _ = pointcloud_to_dict(msg, skip_nans=False)
    positions = np.asarray(soa["positions"], np.float32)
    streams = {"pointcloud_to_dict": _ms(lambda: pointcloud_to_dict(msg, skip_nans=False),
                                         args.repeats)}
    lo, hi = positions.min(axis=0).astype(np.float64), positions.max(axis=0).astype(np.float64)
    scale = (2**codec.quantization_bits - 1) / np.maximum(hi - lo, 1e-30)
    quantize = lambda: ((positions - lo) * scale + 0.5).astype(np.int64).astype(np.int32)  # noqa: E731
    streams["quantize"] = _ms(quantize, args.repeats)
    q = quantize().T
    for c, axis in enumerate("xyz"):
        streams[f"position_{axis}"] = _ms(lambda: compressor._position_stream(q[c], codec.level),
                                          args.repeats)
    for name, arr in sorted(soa.items()):
        if name != "positions":
            streams[name] = _ms(lambda: compressor._attr_record(name, np.asarray(arr), codec.level),
                                args.repeats)
    result = {
        "points": int(positions.shape[0]), "blob_bytes": len(pooled_blob),
        "byte_equal": pooled_blob == serial_blob, "usable_cores": cores, "pool_workers": workers,
        "encode_pooled_ms": pooled, "encode_serial_ms": serial, "alone_ms": streams,
        "device": args.device,
    }
    for k, v in result.items():
        print(f"{k} = {v}")
    print(json.dumps(result))
    return 0 if result["byte_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
