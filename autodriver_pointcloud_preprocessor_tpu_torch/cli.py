"""Console entry points (reference packaging parity: setup.py:63-68 registers
``pointcloud_preprocessor`` and ``pointcloud_compressor``; this framework
also ships the loader and concatenator the reference left as stubs).

Port of ``autodriver_pointcloud_preprocessor_tpu/cli.py``, installed as
``pointcloud_{preprocessor,compressor,loader,concatenator,warmup}_torch``.
Each command runs standalone on the in-process bus: file/PCAP sources in,
processed/compressed files out. Under ROS 2, use the adapter in
``ros2_adapter.py`` instead. Every command that builds an engine or a node
takes ``--device`` (default ``cuda:0``; without a card it raises unless
given ``--device cpu``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_DEVICE_HELP = "torch device of the engine (default cuda:0; 'cpu' runs the plain versions)"


def _parse_set_value(val: str):
    """``--set key=value`` value coercion: try JSON for anything that could
    be a number/bool/list/dict, but fall back to the raw string — values
    like ``knn_d2mode=fast3`` or ``downsample_method=farthest`` start with a
    JSON-looking character yet are legitimate strings."""
    if val and val[0] in "[{tf0123456789-":
        try:
            return json.loads(val)
        except json.JSONDecodeError:
            return val
    return val


def preprocessor_main(argv=None) -> int:
    """Preprocess clouds from a directory/file/PCAP through the engine."""
    ap = argparse.ArgumentParser("pointcloud_preprocessor")
    ap.add_argument("source", help=".pcd/.ply/... file, directory, or .pcap")
    ap.add_argument("-o", "--output-dir", default="./processed")
    ap.add_argument("--params", default=None,
                    help="JSON file of reference-named parameters")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="parameter override, e.g. --set voxel_size=0.05")
    ap.add_argument("--extension", default=".pcd")
    ap.add_argument("--profile", action="store_true",
                    help="per-stage timing (reference stage keys)")
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--device", default=None, help=_DEVICE_HELP)
    args = ap.parse_args(argv)

    from .io.loader import PointcloudLoader
    from .io.pcd import write_point_cloud
    from .core.codec import pointcloud_to_dict
    from .models import Preprocessor

    overrides = {}
    if args.params:
        with open(args.params) as f:
            overrides.update(json.load(f))
    for kv in args.set:
        key, _, val = kv.partition("=")
        overrides[key] = _parse_set_value(val)

    engine = Preprocessor(overrides, profile=args.profile, device=args.device)
    loader = PointcloudLoader(args.source, rate_hz=0)
    os.makedirs(args.output_dir, exist_ok=True)

    count = 0
    for msg in loader.scans():
        soa, meta = pointcloud_to_dict(msg)
        out, meta = engine.process_soa(soa, meta)
        path = os.path.join(
            args.output_dir, f"{count:08d}{args.extension}"
        )
        write_point_cloud(path, out)
        count += 1
        if args.profile:
            times = {k: round(v * 1e3, 3) for k, v in engine.processing_times.items()}
            print(f"scan {count}: {times}", file=sys.stderr)
        if args.max_scans and count >= args.max_scans:
            break
    print(f"processed {count} scans -> {args.output_dir}")
    return 0


def compressor_main(argv=None) -> int:
    """Compress (or decompress) cloud files with the APCZ codec.

    The reference registered this entry point without a main
    (reference setup.py:66, pointcloud_compressor.py has no ``main``) —
    this is the working implementation.
    """
    ap = argparse.ArgumentParser("pointcloud_compressor")
    ap.add_argument("source", help="cloud file, directory, or .pcap")
    ap.add_argument("-o", "--output-dir", default="./compressed")
    ap.add_argument("-d", "--decompress", action="store_true")
    ap.add_argument("-q", "--quantization-bits", type=int, default=14)
    ap.add_argument("--level", type=int, default=6)
    ap.add_argument("--max-scans", type=int, default=None)
    args = ap.parse_args(argv)

    from .io.compressor import compress_soa, decompress_soa
    from .io.pcd import read_point_cloud, write_point_cloud
    from .io.loader import PointcloudLoader
    from .core.codec import pointcloud_to_dict

    os.makedirs(args.output_dir, exist_ok=True)
    count, in_bytes, out_bytes = 0, 0, 0
    if args.decompress:
        import glob

        files = (
            sorted(glob.glob(os.path.join(args.source, "*.apcz")))
            if os.path.isdir(args.source)
            else [args.source]
        )
        for path in files:
            with open(path, "rb") as f:
                blob = f.read()
            soa = decompress_soa(blob)
            out_path = os.path.join(
                args.output_dir,
                os.path.splitext(os.path.basename(path))[0] + ".pcd",
            )
            write_point_cloud(out_path, soa)
            count += 1
    else:
        loader = PointcloudLoader(args.source, rate_hz=0)
        for msg in loader.scans():
            soa, _ = pointcloud_to_dict(msg)
            blob = compress_soa(soa, args.quantization_bits, args.level)
            in_bytes += len(msg.data)
            out_bytes += len(blob)
            with open(
                os.path.join(args.output_dir, f"{count:08d}.apcz"), "wb"
            ) as f:
                f.write(blob)
            count += 1
            if args.max_scans and count >= args.max_scans:
                break
        if out_bytes:
            print(
                f"ratio {in_bytes / out_bytes:.2f}x "
                f"({in_bytes} -> {out_bytes} bytes)",
                file=sys.stderr,
            )
    print(f"{'decompressed' if args.decompress else 'compressed'} {count} scans")
    return 0


def loader_main(argv=None) -> int:
    """Replay clouds from files/PCAP (prints scan stats)."""
    ap = argparse.ArgumentParser("pointcloud_loader")
    ap.add_argument("source")
    ap.add_argument("--rate-hz", type=float, default=10.0)
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--max-scans", type=int, default=None)
    args = ap.parse_args(argv)

    from .io.loader import PointcloudLoader
    from .runtime.bus import TopicBus

    bus = TopicBus()
    stats = {"n": 0}

    def on_msg(msg):
        stats["n"] += 1
        print(f"scan {stats['n']}: {msg.width} points, frame {msg.header.frame_id}")

    bus.create_subscription("/loader/points", on_msg)
    loader = PointcloudLoader(
        args.source, bus=bus, rate_hz=args.rate_hz, loop=args.loop
    )
    loader.spin(max_scans=args.max_scans)
    return 0


def concatenator_main(argv=None) -> int:
    """Merge per-sensor cloud files into combined scans."""
    ap = argparse.ArgumentParser("pointcloud_concatenator")
    ap.add_argument("sources", nargs="+", help="one directory per sensor")
    ap.add_argument("-o", "--output-dir", default="./concatenated")
    ap.add_argument("--extrinsics", default=None,
                    help="JSON: {source_dir: 16-float row-major matrix}")
    ap.add_argument("--device", default=None, help=_DEVICE_HELP)
    args = ap.parse_args(argv)

    import numpy as np

    from .io.loader import PointcloudLoader
    from .io.pcd import write_point_cloud
    from .core.codec import pointcloud_to_dict
    from .parallel import PointcloudConcatenatorNode
    from .runtime.bus import TopicBus

    extrinsics = {}
    if args.extrinsics:
        with open(args.extrinsics) as f:
            raw = json.load(f)
        extrinsics = {
            f"/in{idx}": np.asarray(raw[src], np.float32).reshape(4, 4)
            for idx, src in enumerate(args.sources)
            if src in raw
        }

    bus = TopicBus()
    topics = [f"/in{i}" for i in range(len(args.sources))]
    # robust mode auto-publishes when all sensors delivered; the explicit
    # flush below handles the final partial round
    node = PointcloudConcatenatorNode(
        bus, topics, extrinsics=extrinsics, mode="robust", timeout=1e9,
        device=args.device,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    outs = {"n": 0}

    def on_merged(msg):
        soa, _ = pointcloud_to_dict(msg)
        write_point_cloud(
            os.path.join(args.output_dir, f"{outs['n']:08d}.pcd"), soa
        )
        outs["n"] += 1

    bus.create_subscription("/points/concatenated", on_merged)
    loaders = [PointcloudLoader(src, bus=bus, topic=t, rate_hz=0)
               for src, t in zip(args.sources, topics)]
    iters = [ld.scans() for ld in loaders]
    pubs = [bus.create_publisher(t) for t in topics]
    while True:
        done = False
        for it, pub in zip(iters, pubs):
            try:
                pub.publish(next(it))
            except StopIteration:
                done = True
        node.flush()
        if done:
            break
    print(f"wrote {outs['n']} merged scans -> {args.output_dir}")
    return 0


def warmup_main(argv=None) -> int:
    """Build what a configuration's first scans would otherwise build, and
    capture the program of each capacity bucket.

    The reference seeds JAX's persistent compilation cache here, one
    program a bucket. The port's counterparts are the CUDA kernels (nvcc,
    into ``build/torch_kernels/``), the native sidecars (g++, into
    ``build/torch_native/``) and, on a card, each bucket's captured program
    (a CUDA graph of the whole pipeline, ``models/graphs.py``): this
    command builds the first two once per deployment, at image-build or
    deploy time, and captures one scan of each bucket through the engine.
    A CUDA graph lives only as long as its process, so the capture is
    repeated at each bucket's first scan in the node's own process; what
    this command reports is its cost there.

    Prints one line per bucket: the capture's host time (its warm-up run
    included), the bytes of its graph's memory pool and the first scan's
    wall time (on the CPU, where the engine runs eagerly, the wall time
    alone).
    """
    ap = argparse.ArgumentParser("pointcloud_warmup")
    ap.add_argument("--params", default=None,
                    help="JSON file of reference-named parameters")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="parameter override, e.g. --set voxel_size=0.05")
    ap.add_argument("--preset", default=None, choices=["production_128k"],
                    help="start from a named production preset")
    ap.add_argument("--buckets", default="32768,65536,131072,262144",
                    help="comma-separated capacity ladder to run")
    ap.add_argument("--attrs", default="intensity,ring",
                    help="comma-separated attribute schema of the scans; "
                         "'' = positions-only")
    ap.add_argument("--cache-dir", default=None,
                    help="accepted for the reference's command line; the "
                         "port's kernels are built into build/torch_kernels/ "
                         "and its sidecars into build/torch_native/")
    ap.add_argument("--device", default=None, help=_DEVICE_HELP)
    args = ap.parse_args(argv)

    import time

    import numpy as np

    overrides = {}
    if args.preset == "production_128k":
        from .models.presets import PRODUCTION_128K_CONFIG

        overrides.update(PRODUCTION_128K_CONFIG)
    if args.params:
        with open(args.params) as f:
            overrides.update(json.load(f))
    for kv in args.set:
        key, _, val = kv.partition("=")
        overrides[key] = _parse_set_value(val)

    from . import native
    from .core import from_soa, resolve_device, valid_count
    from .io import compressor, pcap
    from .models import graphs
    from .models.preprocessor import Preprocessor
    from .ops import _build

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    built = [str(native.BUILD_DIR)]
    if device.type == "cuda":
        _build.load_library()
        built.insert(0, str(_build.BUILD_DIR))
    pcap._load_native()
    compressor._load_native()
    print(f"built kernels and sidecars in {time.perf_counter() - t0:.1f}s "
          f"-> {', '.join(built)}", flush=True)

    engine = Preprocessor(overrides, device=device)
    attr_names = [a for a in args.attrs.split(",") if a]
    rng = np.random.default_rng(0)
    total = 0.0
    for cap in [int(b) for b in args.buckets.split(",") if b]:
        n = cap - cap // 16
        soa = {"positions": rng.normal(0, 5, (n, 3)).astype(np.float32)}
        if "intensity" in attr_names:
            soa["intensity"] = rng.uniform(0, 255, n).astype(np.float32)
        if "ring" in attr_names:
            soa["ring"] = rng.integers(0, 32, n).astype(np.uint16)
        buf, _ = from_soa(soa, capacity=cap, device=device)
        t0 = time.perf_counter()
        out, _plane = engine.process_buffer(buf)
        survivors = int(valid_count(out))
        dt = time.perf_counter() - t0
        total += dt
        captured = ""
        if graphs.captures(device):
            prog = graphs.programs()[-1]  # the program this scan ran
            captured = (f"captured in {prog.capture_ms:.1f} ms, graph pool "
                        f"{prog.pool_bytes / 2**20:.1f} MB, ")
        print(f"warmup bucket {cap}: {captured}first scan {dt:.1f}s "
              f"(survivors {survivors})", flush=True)
    print(f"warmed {args.buckets} in {total:.1f}s on {device}")
    return 0
