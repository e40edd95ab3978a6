"""Smoke run of the PyTorch port on one CUDA card: kernels, main path, engine.

    python3 chip_smoke.py [--profile DIR]

1. Builds the hand-written CUDA kernels from ``csrc/`` (nvcc, first use)
   and prints each kernel's registers and resident CTAs an SM.
2. Holds each kernel against its plain PyTorch version, run on a CPU copy
   of the same inputs, at the shapes the production pipeline gives it (K1
   and K2 bit for bit; K1 both as ``masked_compact`` on 8 stacked rows and
   as the ``pre_compact`` stage, every row of the buffer and its new mask
   in one launch), and checks with torch.profiler that one ``pre_compact``
   stage call runs exactly one device operation, K1's kernel.
3. Batch axis, at B=8 with the main path's shapes from 8 bench scenes
   (seeds 0-7): each batched kernel equals its unbatched launch on every
   element bit for bit, and its plain version on a CPU copy under the
   checks of phase 2.
4. Drives the production pipeline (``PRODUCTION_128K_CONFIG``, 128,000
   points at capacity 131072, the bench scene of ``bench.py``) through
   ``from_soa`` -> ``build_pipeline`` -> ``to_soa``: 3 warm-up and 20 timed
   scans, each checked for survivors, plane and kernel launches (1/1/2).
5. The engine: ``Preprocessor(PRODUCTION_128K_CONFIG).process_soa`` on the
   bench scene (survivors, plane, the ``processing_times`` keys) and in
   profile mode (one key per stage).
6. ``Preprocessor.process_batch`` on the 8 scenes, vmapped and sequential:
   every scan's survivors and normals equal the same scan run alone with
   the same draws, and K1/K2/K3 launch 1/1/2 times per batch vmapped and
   8/8/16 times sequential.
7. Runs one scan through the port on the CPU (plain versions) with the same
   RANSAC draws and compares survivor sets (jaccard >= 0.99) and the
   normals of common survivors (>= 98% within 2 degrees) with the card's.
8. Times each kernel beside its plain version and the nearest single
   PyTorch call, single-scan and batched, and the ms per scan of the
   serial, sequential and vmapped modes at B=8 (CUDA events).

The outlier slice, ``bench_suite.py`` config 2 (voxel + statistical and
radius outliers, K3 with the second radius in the fused sweep) and
``PRODUCTION_128K_QUALITY_CONFIG`` (pass-merged normals):

9. (a) K3's ``radius2`` and ``bisect`` at config 2's shapes (131,072
   rows, wb=1, k=20, passes 0 and 1) against their plain versions on a
   CPU copy; at B=8 each batched launch with a radius2 per scan equals its
   unbatched launch bit for bit.
10. (b) Config 2 on the bench scene through ``build_pipeline``: 3 warm-up
    and 20 timed scans, survivors and launches (0/1/2 a scan).
11. (c) Config 2 through ``Preprocessor`` (the reference-named config):
    keys and metadata in normal and profile mode (4 K3 launches, the
    radius stage on its own), ``process_batch`` at B=8 vmapped and
    sequential (launches K2/K3 1/2 and 8/16, every scan equal to its lone
    run), and the ms per scan of the serial, sequential and vmapped modes.
12. (d) Config 2 with ``knn_kmode='bisect'``: single scans, survivor
    jaccard against the sweep run (>= 0.95).
13. (e) ``PRODUCTION_128K_QUALITY_CONFIG`` through
    ``Preprocessor.process_soa``: 20 timed scans, launches 1/1/2.
14. (f) Config 2 and the QUALITY preset once on the CPU (plain versions,
    the same draws) against the card: jaccard >= 0.99, QUALITY's normals
    >= 98% within 2 degrees.
15. (g) K3's kernel and plain times at config 2's shapes for sweep with
    ``radius2`` and for bisect, beside their bounds.

The configuration surface (every launch count is set to 0 just before a
path and read just after, and must be the path's count a scan times the
scans; every path runs once more on the CPU with the same draws, survivor
jaccard >= 0.99):

16. (h) ``bench_suite.py`` config 6, the 1M-point merged cloud (1,000,000
    points at capacity 1,048,576, the 'wide' voxel keys): K1 (3 x
    1,048,576 -> 524,288) and K2 (4 x 524,288) bit for bit and K3 (both
    passes at 409,600 rows, sweep k=16 wb=1 with moments) against their
    plain versions on a CPU copy, then their kernel, plain, library and
    bound times at those shapes.
17. (i) Config 6 through ``build_pipeline``: 23 scans (1/1/2 a scan) and
    one full-size CPU run.
18. (j) Config 7 (the reference's stage order) through ``Preprocessor``,
    the bench scene in a spinning sensor's azimuth order (1/1/2), and two
    scans in the scene's own order, whose ground points fill the pre-voxel
    bucket so that both the card and the CPU keep nothing (ROADMAP fault
    10).
19. (k) Config 3 (RANSAC alone, 0/0/0) and (l) config 1 (crop and voxel,
    0/1/0) through ``build_pipeline``.
20. (m) ``Preprocessor({})``, the defaults (0/1/2).
21. (n) Production with the random, uniform and farthest-point
    downsamplers (1/0/2; FPS 6 scans).
22. (o) Production with the height cut (1/1/2).
23. p50 and p90 ms a scan of every path.

The streaming data path (``io.streaming.StreamingEngine``: packets ->
decode on the card -> pipeline -> quantizer on the card -> host varint +
DEFLATE -> APCZ blobs), on captures written by the script itself (the
payload parser is the C++ sidecar, built with g++ at first use):

24. (p) The packet decode on the card against the CPU, on an HDL-32E
    revolution at 192 packets (73,728 slots) and a VLP-16 one at 128
    (49,152): mask, ring, intensity, time and distance bit for bit,
    positions and azimuth within 1e-4; the quantizer on the production
    output of the HDL-32E revolution: one K1 launch, count equal, box
    within 1e-6 relative, rows within one quantum of the CPU's; the decode's
    and the quantizer's launches (torch.profiler) and times, and K1's at
    the quantizer's call against its plain version and bound.
25. (q) ``bench_suite.py`` config 5: a VLP-16 capture of 1,500 packets (20
    revolutions, tests/test_pcap_compressor.py's ``_write_pcap``),
    ``packet_bucket=128``, ``{"voxel_size": 0.05, "estimate_normals":
    False}``: ``replay_pcap`` single and ``batch=20`` (launches 1/2/0 a
    revolution or batch, the batch's blobs equal the single replay's), ms a
    revolution p50 and p90, real-time factor at 10 Hz, compression against
    the packet bytes; the CPU's blobs: counts equal, jaccard >= 0.99 on the
    quantization grid.
26. (r) ``PRODUCTION_128K_CONFIG`` on an HDL-32E capture of 3 revolutions
    (181 packets each, ``packet_bucket=192``, tools/make_hdl32_fixture.py's
    scene, strongest return): ``replay_pcap`` (2/2/2 a revolution) and a
    ``process_scan_batch`` of 8 (2/2/2, each revolution equal to its lone
    run with the same draws), ms a revolution, real-time factor, and one
    revolution on the CPU with the same draws (jaccard >= 0.99).

The node layer (``runtime``, ``parallel``, ``cli``), on the production
preset at full width, every kernel launch counted per callback:

28. (t) ``PointcloudPreprocessorNode`` on the card (no device given) with a
    static TF on its buffer: 23 Velodyne-style PointCloud2 messages (the
    bench scenes of seeds 0-22 as x, y, z, intensity, ring, NaN returns
    included; 3 warm-up, 20 timed). Every message publishes one cloud
    (``frame_count`` = messages, so a scan the callback's log-and-drop
    ``except`` swallowed fails), byte-equal to a lone
    ``Preprocessor(PRODUCTION_128K_CONFIG)`` with the same seed and TF on
    the same inputs in order; launches 1/1/2 a callback; callback ms p50
    and p90 and the ``processing_times`` keys. The same with the TF looked
    up on every scan (clouds byte-equal; ``set_tf_matrix``'s ms), and
    pipelined (the same clouds one callback later, ``flush_pipeline``
    publishes the last). One message on a CPU node (its own RANSAC draws):
    jaccard >= 0.99, >= 98% of normals within 2 degrees.
29. (u) Three namespaced production nodes -> a ``sync`` concatenator on the
    card (extrinsics yaw 120 degrees and 200 m apart) -> the compressor
    node: 3 warm-up and 8 timed rounds of three 128,000-point messages, each
    1 merged frame whose count is the sum of the nodes' outputs, each
    sensor's survivors in its extrinsic's region, launches 3/3/6; the
    card's merge byte-equal to a CPU concatenator's on the same messages;
    a live ``voxel_size`` reconfigure of one node moves its count alone.
30. (v) ``cli.preprocessor_main`` with no ``--device`` on three 128,000-point
    PCD files (3/3/6 launches, files byte-equal to a saving node's), and
    ``cli.warmup_main --preset production_128k --buckets 131072``.

The sharded pipeline (``parallel.sharding``), ranks started with
``torch.multiprocessing`` (spawn) after the kernels are built:

31. (w) ``bench_suite.py`` config 6's merged cloud (1,000,000 points at
    1,048,576) over 4 gloo ranks sharing cuda:0, 262,144 points, a
    102,400-row share of the post-downsample bucket and a 512-row halo a
    rank (no pre-voxel bucket, as in the reference's local run): 3 warm-up
    and 10 timed steps (``shard_buffer`` and the run), each checked on
    every rank (one plane on all ranks with |n_z| > 0.99, 0 < live out <=
    live in, unit normals) with launches 0/1/2 a step on each rank; every
    rank's live count ahead of its shrink; K2 and K3 at rank 0's shapes
    against their plain versions and timed; the gathered survivors against
    the unsharded port on the card (the voxel counts ahead of the per-rank
    caps within 15%, the survivors within 15% of the unsharded survival
    rate applied to the voxels the caps kept, planes within 1 degree) and
    against the same 4 ranks on the CPU with the same draws
    (jaccard >= 0.99, >= 98% of normals within 2 degrees); the
    production-slab keep-mask agreement at 131,072 rows (halo 0 and 512, >=
    0.985 at 512); a world of one rank a card over NCCL bit-equal to the
    same world over gloo. Times are rank 0's CUDA events with a barrier
    before each step, 4 ranks time-sharing one card: not a scaling figure.
    The gloo ranks run eagerly (``sharding.captures_step``). Then the
    step as one captured program: an NCCL world of
    ``torch.cuda.device_count()`` ranks, one a card (with one card, config
    6's whole cloud at 1,048,576 on one rank), and of 4 ranks when there
    are 4 cards or more (else it prints that it did not run): on every
    rank the captured step bit-equal to the eager body
    (``make_local_run``) with the same draws, on the capture's draws and
    on others, launches 0/1/2 a step and the collectives a step equal
    both ways (the replay credits them), p50 and p90 a step captured and
    eager in turns, capture ms and pool MB.

Captured programs (``models/graphs.py``): on the card the engine's
production mode (``Preprocessor`` with ``profile=False``) and the
streaming engine replay one CUDA graph a scan, a batch or a revolution,
so every engine phase above (5, 6, 8, (c), (e), (j), (m)-(o), (q), (r),
(t)-(v)) runs replays, and its exact launch counts are the counts each
replay credits; ``build_pipeline`` calls stay eager.

32. (x) Each path as a captured program against the same path run
    eagerly (``build_pipeline(settings)`` called directly; for streaming
    the engine's body run eagerly) with the same draws: production, config
    2, QUALITY, configs 6 and 7, the defaults, each downsampler (FPS 3
    timed scans) and the height cut bit for bit (mask, positions,
    attributes, normals, plane) with equal launch counts; three replays,
    each traced alone with torch.profiler (the window open 50 ms before
    and after it), each run exactly the K1/K2/K3 kernels its program
    credits; ms/scan p50 and p90 ``from_soa``..``to_soa`` and of
    the pipeline alone, graphed and eager in turns; capture ms and graph
    pool MB. B=8 vmapped and sequential the same way, with ms/scan.
    ``update_config({"voxel_size": 0.08})`` and three TFs after the
    capture: each replay bit-equal to a fresh eager engine's run. Config
    5 replays single and ``batch=20``: blobs byte-equal to the eager
    engine's, ms a revolution. The pipelined node's clouds against the
    static node's are phase (t)'s check, on replays. Profile mode:
    production and config 2 replay one program a stage, each replay
    bit-equal to the stage run eagerly with the same draws (profile mode
    runs duplicates and the radius filter as stages of their own, as the
    reference does, so it is held to its own eager run, not to the
    production mode's output), with equal launches, and the per-stage ms
    replayed and eager. Phase (u)'s round with the concatenator's merge
    replayed and with the merge run eagerly, in turns: merged clouds
    byte-equal, round ms, a traced round's launches and syncs. With two
    cards or more, an engine on cuda:1 while cuda:0 is current, graphed
    and eager, bit-equal to one on cuda:0 (else it prints that it did not
    run). The cache's byte bound: the vmapped production program captured
    at B = 1..16, the pools and the memory reserved within the bound
    after each capture, evicted programs gone.

The reference's XLA window route (``PipelineSettings(pallas_ok=False)``:
the window stages take ``ops/window.py``'s XLA route, whole-block rolled
windows and an exact top-k, with no K3; K1 and K2 stay):

33. (y) Production, config 2 and config 6 (1,000,000 points, one timed
    run each way) on the engine, each replay bit-equal to the same run
    eagerly with the same draws, launches 1/1/0, 0/1/0 and 1/1/0 a scan
    both ways; ms/scan p50 and p90 graphed and eager in turns, capture ms
    and pool MB; the card against the CPU with the same draws (jaccard >=
    0.99, >= 98% of common normals within 2 degrees); the jaccard against
    the kernel route on the same scan, printed with no bound (another
    function). Then config 6's sharded step with ``pallas_ok=False`` in
    the NCCL world of ``device_count()`` ranks, captured against its eager
    body on two draws, bit for bit (0/1/0 a step), p50 and p90 both ways.
34. (z) The committed fixtures on the card:
    ``tests/test_torch_fixture_parity.py``'s checks (the
    ``parity_golden.npz`` stages, the ring-scene pipeline window against
    exact and its window floors, the HDL-32E floor; each window check on
    the kernel route and the XLA route) at that file's tolerances.

With ``--profile DIR`` it also traces, with torch.profiler, 5 single scans
and one vmapped batch of the production preset and of config 2, 5
QUALITY scans, 5 scans of each path of phases 17-22 (3 of config 6, 1 of
FPS and of config 7 in scene order), and (27, phase (s)) 5 revolutions of
config 5's replay and of phase (r), and (r)'s batch of 8, 5 callbacks of
the node and of the pipelined node, 2 graph rounds, one sharded step
on rank 0 (``DIR/sharded/profile.txt``), and 5 scans of each phase-(x)
path graphed and eager (3 for FPS, a batch for B=8) and of production
and config 2 on the XLA route, and writes the
time per operator (device and host) to ``DIR/profile.txt``, each table
headed by its device-busy share, kernel launches, graph launches and
syncs.

Prints the card, the numbers, one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Exits non-zero, before printing any
result, when no CUDA device is present or any check fails. Imports nothing
of JAX.
"""
from __future__ import annotations

import json
import struct
import subprocess
import sys
import tempfile
import time
import weakref

import numpy as np
import torch

N_POINTS, CAPACITY = 128_000, 131_072
WARMUP, TIMED = 3, 20
BATCH = 8
KERNELS = ("masked_compact", "segmented_sums", "window_stats")
REPLACES = {
    "masked_compact": "autodriver_pointcloud_preprocessor_tpu/ops/pallas_segmean.py:84",
    "segmented_sums": "autodriver_pointcloud_preprocessor_tpu/ops/pallas_segmean.py:84",
    "window_stats": "autodriver_pointcloud_preprocessor_tpu/ops/pallas_window.py:109",
}
SOURCES = {
    "masked_compact": "autodriver_pointcloud_preprocessor_tpu_torch/csrc/segmean.cu",
    "segmented_sums": "autodriver_pointcloud_preprocessor_tpu_torch/csrc/segmean.cu",
    "window_stats": "autodriver_pointcloud_preprocessor_tpu_torch/csrc/window_stats.cu",
}
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside
#: the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
#: bench_suite.py config 2 (:141-156): settings and parameters
CONFIG2_SETTINGS = dict(
    remove_duplicates=False, crop_to_roi=False, voxel_downsample=True,
    remove_statistical_outliers=True, nb_neighbors=20, remove_radius_outliers=True,
    estimate_normals=False, knn_method="window", voxel_compact_keys=True,
)
CONFIG2_PARAMS = dict(voxel_size=0.08, std_ratio=2.0, radius_nb_points=8,
                      radius_search_radius=0.4)
#: the same configuration under the reference's parameter names
CONFIG2 = {
    "remove_duplicates": False, "crop_to_roi": False, "voxel_size": 0.08,
    "remove_statistical_outliers": True, "remove_statistical_outliers.nb_neighbors": 20,
    "remove_statistical_outliers.std_ratio": 2.0, "remove_radius_outliers": True,
    "remove_radius_outliers.nb_points": 8, "remove_radius_outliers.search_radius": 0.4,
    "estimate_normals": False, "knn_method": "window",
}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def scene(n: int, seed: int = 0) -> np.ndarray:
    """bench.py's _scene: 60% ground plane over +-40 m, 24 object
    clusters, and a sprinkle of NaN returns."""
    rng = np.random.default_rng(seed)
    n_ground = int(n * 0.6)
    n_obj = n - n_ground
    ground = np.column_stack(
        [rng.uniform(-40, 40, (2, n_ground)).T, rng.normal(0, 0.03, n_ground)]
    )
    centers = rng.uniform(-30, 30, (24, 3)) * [1, 1, 0] + [0, 0, 1.5]
    obj = centers[rng.integers(0, len(centers), n_obj)] + rng.normal(0, 0.8, (n_obj, 3))
    pts = np.vstack([ground, obj]).astype(np.float32)
    pts[:: max(n // 200, 1)] = np.nan
    return pts


def bench_soa(seed: int = 0) -> dict:
    """The bench scene of ``seed`` with intensity and ring attributes."""
    rng = np.random.default_rng(seed + 1)
    return {
        "positions": scene(N_POINTS, seed),
        "intensity": rng.uniform(0, 255, N_POINTS).astype(np.float32),
        "ring": rng.integers(0, 32, N_POINTS).astype(np.uint16),
    }


def event_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(kernel, plain, reps: int = 20):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = event_ms(plain, reps)
    k1 = event_ms(kernel, reps)
    k2 = event_ms(kernel, reps)
    p2 = event_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: float, flops: float):
    """(least ms the card could take, what bounds it) for the given work."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_work(values, mask, cap):
    """Bytes of K1: each input read once, the output written once."""
    c, n = values.shape[-2:]
    batch = values.numel() // (c * n)
    return values.numel() * 4 + mask.numel() + batch * c * cap * 4, 0.0


def k2_work(values, flags):
    """Bytes and FLOPs of K2: one add per input value."""
    return 2 * values.numel() * 4 + flags.numel(), float(values.numel())


def k3_work(rows, k, wb, direction, moments, mom0, kmode="csel", radius2=False,
            csel_compares=True):
    """Bytes and FLOPs of one K3 pass on this run's rows: 8 FLOPs (3 sub,
    3 mul, 2 add) for the distance of every valid (query, candidate) pair
    of a window, a square root and an add for each of the k kept
    distances of a valid query, and 19 FLOPs (9 products, 10 sums) for
    every in-radius pair of the moments (``mom0``: the in-radius counts the
    pass gave). ``radius2``: one compare per valid pair for the second
    radius's count. ``kmode='bisect'``: 14 compares per valid pair (13
    bisections and the final masked sum), ``kmode='csel'``: 3 (2
    refinements and the final masked sum; ``csel_compares=False`` leaves
    them out, as the count before this correction did), on distances
    counted once. Bytes: 13 read and 48 written per row, 4 more with
    ``radius2``."""
    x, y, z, valid = rows
    n = x.shape[-1]
    ok = (valid & torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z)).reshape(-1, n)
    per_block = ok.reshape(ok.shape[0], -1, 128).sum(-1).double()  # [B, blocks]
    lo, hi = (-wb, wb) if wb > 0 else ((0, 1) if direction == 0 else (-1, 0))
    padded = torch.nn.functional.pad(per_block, (-lo, hi))
    window = sum(padded[:, s : s + per_block.shape[1]] for s in range(hi - lo + 1))
    pairs = float((per_block * window).sum())
    compares = {"bisect": 14, "csel": 3 if csel_compares else 0}.get(kmode, 0)
    per_pair = 8 + compares + (1 if radius2 else 0)
    flops = per_pair * pairs + 2 * k * float(ok.sum())
    if moments:
        flops += 19 * float(mom0.reshape(ok.shape)[ok].double().sum())
    return ok.numel() * (13 + 48 + (4 if radius2 else 0)), flops


def survivor_normals(soa: dict) -> dict:
    """Survivor position (rounded to 1e-5) -> its unit normal."""
    keys = (tuple(r) for r in np.round(soa["positions"], 5).tolist())
    return dict(zip(keys, np.asarray(soa["normals"], dtype=np.float64)))


def bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def event_counts(events) -> dict:
    """Kernel launches, graph launches and syncs on the host, and device
    ms, in a torch.profiler trace's ``key_averages()``."""
    def count(key):
        return sum(e.count for e in events if e.key == key)

    return {"cudaLaunchKernel": count("cudaLaunchKernel"), "cudaGraphLaunch": count("cudaGraphLaunch"),
            "cudaStreamSynchronize": count("cudaStreamSynchronize"),
            "device_ms": sum(e.self_device_time_total for e in events
                             if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3}


def profile_runs(runs, dev, out_dir: str):
    """Trace each ``(tag, fn)`` of ``runs`` with torch.profiler, after one
    untraced call (which captures again a program the cache dropped:
    phase (x) clears it); write the time per operator (device and host) of
    each to ``out_dir/profile.txt``."""
    import os

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):  # warm up the tracer
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        for tag, fn in runs:
            fn()
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - w0) * 1e3
            events = prof.key_averages()
            c = event_counts(events)
            line = (f"{tag}: wall {wall_ms:.3f} ms (traced), device busy {c['device_ms']:.3f} ms "
                    f"({100 * c['device_ms'] / wall_ms:.1f}%), {c['cudaLaunchKernel']} "
                    f"cudaLaunchKernel, {c['cudaGraphLaunch']} cudaGraphLaunch, "
                    f"{c['cudaStreamSynchronize']} cudaStreamSynchronize")
            f.write(line + "\n\n")
            f.write(events.table(sort_by="self_device_time_total", row_limit=40))
            f.write("\n\n")
            f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
            f.write("\n\n")
            print(f"[chip_smoke] profile: {line}")
    print(f"[chip_smoke] profile tables: {out_dir}/profile.txt")


def soa_positions(seed: int = 0) -> dict:
    """bench_suite.py's config-2 input: the bench scene, positions only."""
    return {"positions": scene(N_POINTS, seed)}


def position_set(soa: dict) -> set:
    return {tuple(r) for r in np.round(soa["positions"], 5).tolist()}


def jaccard(a, b) -> float:
    return len(a & b) / max(len(a | b), 1)


def check_k3_plain(tag, got, rows, kw, radius, radius2=None):
    """K3 launch ``got`` against its plain version on a CPU copy of its
    inputs: means within 1e-5 relative on >= 99.9% of valid rows, equal
    k-select counts, in-radius counts and second-radius counts, moments
    within 1e-5 relative. Returns the largest mean difference."""
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.window_stats import window_stats

    got = [t.cpu() for t in got]
    rows_cpu = [r.cpu() for r in rows]
    cpu = lambda v: v.cpu() if torch.is_tensor(v) else v  # noqa: E731
    want = window_stats(*rows_cpu, cpu(radius), radius2=None if radius2 is None else cpu(radius2), **kw)
    check(len(got) == len(want) == (3 if radius2 is None else 4), f"K3 {tag}: outputs")
    valid = rows_cpu[3]
    rel = ((got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-12))[valid]
    share = float((rel <= 1e-5).float().mean())
    check(share >= 0.999, f"K3 {tag}: only {share:.5f} of means within 1e-5 relative")
    check(torch.equal(got[1][valid], want[1][valid]), f"K3 {tag}: k-select counts differ")
    check(torch.equal(got[2][..., 0, :][valid], want[2][..., 0, :][valid]),
          f"K3 {tag}: in-radius counts differ")
    mom_err = float(((got[2] - want[2]).abs() / (want[2].abs() + 1.0)).movedim(-2, 0)[:, valid].max())
    check(mom_err <= 1e-5, f"K3 {tag}: moments differ by {mom_err:.3e} relative (> 1e-5)")
    extra = ""
    if radius2 is not None:
        check(torch.equal(got[3][valid], want[3][valid]), f"K3 {tag}: second-radius counts differ")
        extra = f", count2 equal on {int(valid.sum())} valid rows (mean {float(got[3][valid].mean()):.2f})"
    print(f"[chip_smoke] K3 {tag} {tuple(got[0].shape)}: {share:.6f} of means within 1e-5, "
          f"max rel {float(rel.max()):.3e}, moments max rel {mom_err:.3e}{extra}")
    return float((got[0] - want[0]).abs()[valid].max())


def mode_ms(modes: dict, reps: int = 3) -> dict:
    """{mode: ms per scan}: median over ``reps`` runs of each batch mode,
    CUDA events around each, after one warm run of every mode."""
    times = {m: [] for m in modes}
    for fn in modes.values():
        fn()
    for _ in range(reps):
        for m, fn in modes.items():
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[m].append(start.elapsed_time(end) / BATCH)
    print(f"[chip_smoke]   all runs {json.dumps({m: [round(x, 3) for x in v] for m, v in times.items()})}")
    return {m: float(np.median(v)) for m, v in times.items()}


def outlier_slice(dev, quality_cfg):
    """Phases 9-15: config 2 and the QUALITY preset (see the module
    docstring). Returns the K3 numbers at config 2's shapes and each
    path's launch counts."""
    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa, stack_buffers, to_soa
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        STAGE_TIMING_KEYS, PipelineParams, PipelineSettings, build_pipeline, params_from_config,
        settings_from_config, stage_functions,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.window import _sorted_rows
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.window_stats import (
        window_stats, window_stats_plain,
    )

    settings = PipelineSettings(**CONFIG2_SETTINGS)
    params = PipelineParams.make(**CONFIG2_PARAMS, device=dev)
    radius, radius2 = params.search_radius, params.radius_search_radius
    stages = dict(stage_functions(settings))
    launches = {}

    def k3_rows(buf):
        """K3's rows of config 2's two passes, from a (batched) buffer."""
        for name in ("non_finite", "voxel"):
            buf = stages[name](buf, params, None, None)[0]
        p0 = [buf.positions[..., c, :].contiguous() for c in range(3)] + [buf.mask.contiguous()]
        p1 = list(_sorted_rows(buf.positions, buf.mask, 1))
        return {"pass0": p0, "pass1": p1}, buf.mask.sum(-1)

    passes = {"pass0": dict(direction=0), "pass1": dict(direction=1)}
    common = dict(k=settings.nb_neighbors, window_blocks=settings.window_blocks, moments=True)
    modes = {"sweep+radius2": "sweep", "bisect+radius2": "bisect"}

    # ---- (a) K3's new modes against their plain versions -----------------
    t0 = time.perf_counter()
    rows, live = k3_rows(from_soa(soa_positions(), capacity=CAPACITY, device=dev)[0])
    print(f"[chip_smoke] (a) config 2 K3 rows: {CAPACITY} a pass, {int(live)} live voxels")
    max_err = 0.0
    for mode, kmode in modes.items():
        for p, kw in passes.items():
            kw = dict(common, kmode=kmode, **kw)
            got = window_stats(*rows[p], radius, radius2=radius2, **kw)
            max_err = max(max_err, check_k3_plain(f"{mode} {p}", got, rows[p], kw, radius, radius2))
    bufs = [from_soa(soa_positions(seed), capacity=CAPACITY, device=dev)[0] for seed in range(BATCH)]
    brows, blive = k3_rows(stack_buffers(bufs))
    per_scan_r2 = torch.tensor([0.4 + 0.01 * i for i in range(BATCH)], device=dev)
    for mode, kmode in modes.items():
        for p, kw in passes.items():
            kw = dict(common, kmode=kmode, **kw)
            got = window_stats(*brows[p], radius, radius2=per_scan_r2, **kw)
            for i in range(BATCH):
                alone = window_stats(*(r[i] for r in brows[p]), radius, radius2=per_scan_r2[i], **kw)
                check(all(torch.equal(bits(g[i]), bits(a)) for g, a in zip(got, alone)),
                      f"batched K3 {mode} {p}: element {i} differs from its unbatched launch")
    print(f"[chip_smoke] (a) B={BATCH} (live {blive.tolist()}): batched K3 sweep and bisect with "
          f"a radius2 per scan equal their unbatched launches bit for bit; vs plain max abs err "
          f"{max_err:.3e} ({time.perf_counter() - t0:.1f} s)")

    # ---- (b) config 2 through build_pipeline -----------------------------
    def scan_loop(tag, one_scan, want):
        """Warm-up and timed scans of ``one_scan() -> (out soa, plane)``:
        survivors in (0, N), finite positions, launches ``want`` a scan.
        Returns (survivor sets, timed ms, launches of the run)."""
        times, sets = [], []
        _build.reset_launches()
        for i in range(WARMUP + TIMED):
            before = dict(_build.LAUNCHES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            soa, plane = one_scan(i)
            end.record()
            torch.cuda.synchronize()
            n = soa["positions"].shape[0]
            check(0 < n < N_POINTS, f"{tag} scan {i}: {n} survivors outside (0, {N_POINTS})")
            check(bool(np.isfinite(soa["positions"]).all()), f"{tag} scan {i}: non-finite survivors")
            got = tuple(_build.LAUNCHES[k] - before[k] for k in KERNELS)
            check(got == want, f"{tag} scan {i}: launches {got}, expected {want}")
            if i >= WARMUP:
                times.append(start.elapsed_time(end))
                sets.append(position_set(soa))
        run_launches = {k: _build.LAUNCHES[k] for k in KERNELS}
        print(f"[chip_smoke] {tag}: {WARMUP + TIMED} scans ok, launches {json.dumps(run_launches)}; "
              f"p50 {float(np.median(times)):.3f} ms/scan, p90 {float(np.percentile(times, 90)):.3f} "
              f"(CUDA events, from_soa..to_soa), survivors {min(map(len, sets))}..{max(map(len, sets))}")
        return sets, times, run_launches

    soa2 = soa_positions()
    run2 = build_pipeline(settings)

    def config2_scan(run):
        def one(i):
            scan, meta = from_soa(soa2, capacity=CAPACITY, device=dev)
            out, plane = run(scan, params, None)
            return to_soa(out, meta), plane
        return one

    t0 = time.perf_counter()
    sweep_sets, c2_ms, launches["config2_single"] = scan_loop(
        "(b) config 2 single scans", config2_scan(run2), (0, 1, 2))
    check(all(s == sweep_sets[0] for s in sweep_sets), "(b) config 2: scans of one input differ")
    print(f"[chip_smoke] (b) took {time.perf_counter() - t0:.1f} s")

    # ---- (c) config 2 through the engine ---------------------------------
    t0 = time.perf_counter()
    base_keys = {"tensor_transfer", "preprocessing_time", "device_to_host"}
    for profile in (False, True):
        engine = Preprocessor(CONFIG2, profile=profile, seed=0)
        check(engine.settings.voxel_compact_keys is False, "(c) compact keys on without a crop")
        engine.process_soa(soa2, capacity=CAPACITY)  # warm
        _build.reset_launches()
        eout, emeta = engine.process_soa(soa2, capacity=CAPACITY)
        torch.cuda.synchronize()
        got = tuple(_build.LAUNCHES[k] for k in KERNELS)
        want = (0, 1, 4 if profile else 2)
        check(got == want, f"(c) process_soa(profile={profile}): launches {got}, expected {want}")
        launches["config2_profile" if profile else "config2_engine"] = dict(zip(KERNELS, got))
        n = eout["positions"].shape[0]
        check(0 < n < N_POINTS and "normals" not in eout, f"(c) profile={profile}: {n} survivors")
        check("has_normals" not in emeta and emeta["ground_plane_estimate"] is None,
              f"(c) profile={profile}: metadata {sorted(emeta)}")
        keys = set(base_keys)
        if profile:
            keys |= {STAGE_TIMING_KEYS[name]
                     for name, _ in stage_functions(engine.settings, separate_stages=True)}
            check("remove_radius_outliers" in keys, "(c) profile mode has no radius stage")
        check(set(engine.processing_times) == keys,
              f"(c) processing_times keys {sorted(engine.processing_times)} != {sorted(keys)}")
        times = {k: round(v * 1e3, 3) for k, v in engine.processing_times.items()}
        print(f"[chip_smoke] (c) Preprocessor(config 2).process_soa(profile={profile}): {n} "
              f"survivors, launches {json.dumps(launches['config2_profile' if profile else 'config2_engine'])}, "
              f"processing_times ms {json.dumps(times)}")
    engine = Preprocessor(CONFIG2, seed=0)
    alone = [position_set(to_soa(engine.process_buffer(b)[0])) for b in bufs]
    for sequential, want in ((False, (0, 1, 2)), (True, (0, BATCH, 2 * BATCH))):
        mode = "sequential" if sequential else "vmapped"
        _build.reset_launches()
        outs, _ = engine.process_batch(bufs, sequential=sequential)
        torch.cuda.synchronize()
        got = tuple(_build.LAUNCHES[k] for k in KERNELS)
        check(got == want, f"(c) process_batch {mode}: launches {got}, expected {want}")
        launches[f"config2_{mode}"] = dict(zip(KERNELS, got))
        sizes = []
        for i, o in enumerate(outs):
            a = position_set(to_soa(o))
            j = jaccard(a, alone[i])
            check(j == 1.0, f"(c) process_batch {mode}: scan {i} jaccard {j:.6f} against its lone run")
            sizes.append(len(a))
        print(f"[chip_smoke] (c) process_batch {mode} B={BATCH}: launches "
              f"{json.dumps(launches[f'config2_{mode}'])}; every scan equals its lone run; "
              f"survivors {sizes}")

    def serial():
        for b in bufs:
            engine.process_buffer(b)
            torch.cuda.synchronize()

    c2_modes = mode_ms({
        "serial": serial,
        "sequential": lambda: engine.process_batch(bufs, sequential=True),
        "vmapped": lambda: engine.process_batch(bufs),
    })
    print(f"[chip_smoke] (c) config 2 B={BATCH} ms/scan (CUDA events, median of 3 batches): "
          + ", ".join(f"{m} {v:.3f}" for m, v in c2_modes.items())
          + f" ({time.perf_counter() - t0:.1f} s)")

    # ---- (d) config 2 with the bisect k-select ---------------------------
    t0 = time.perf_counter()
    bisect_settings = PipelineSettings(**CONFIG2_SETTINGS, knn_kmode="bisect")
    bisect_sets, c2b_ms, launches["config2_bisect"] = scan_loop(
        "(d) config 2 bisect single scans", config2_scan(build_pipeline(bisect_settings)), (0, 1, 2))
    j = jaccard(bisect_sets[0], sweep_sets[0])
    print(f"[chip_smoke] (d) bisect vs sweep survivors: {len(bisect_sets[0])} vs "
          f"{len(sweep_sets[0])}, jaccard {j:.5f} ({time.perf_counter() - t0:.1f} s)")
    check(j >= 0.95, f"(d) bisect vs sweep survivor jaccard {j:.5f} < 0.95")

    # ---- (e) the QUALITY preset through the engine -----------------------
    t0 = time.perf_counter()
    qengine = Preprocessor(quality_cfg, seed=0)
    soa_q = bench_soa()

    def quality_scan(i):
        out, meta = qengine.process_soa(soa_q, capacity=CAPACITY)
        plane = meta["ground_plane_estimate"]
        check(plane is not None and abs(float(plane[2])) > 0.9, f"(e) scan {i}: plane {plane}")
        check(out["normals"].shape == (out["positions"].shape[0], 3) and meta.get("has_normals") is True,
              f"(e) scan {i}: normals")
        return out, plane

    _, q_ms, launches["quality_single"] = scan_loop("(e) QUALITY process_soa", quality_scan, (1, 1, 2))
    print(f"[chip_smoke] (e) took {time.perf_counter() - t0:.1f} s")

    # ---- (f) both once on the CPU ----------------------------------------
    t0 = time.perf_counter()
    cpu2 = to_soa(run2(from_soa(soa2, capacity=CAPACITY, device="cpu")[0],
                       PipelineParams.make(**CONFIG2_PARAMS, device="cpu"), None)[0])
    j2 = jaccard(position_set(cpu2), sweep_sets[0])
    qsettings = settings_from_config(quality_cfg)
    u = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(qsettings.num_iterations, qsettings.ransac_n)).astype(np.float32))
    qrun = build_pipeline(qsettings)
    sides = [
        survivor_normals(to_soa(qrun(from_soa(soa_q, capacity=CAPACITY, device=d)[0],
                                     params_from_config(quality_cfg, device=d), None, u.to(d))[0]))
        for d in (dev, "cpu")
    ]
    common_q = sides[0].keys() & sides[1].keys()
    jq = jaccard(sides[0].keys(), sides[1].keys())
    cos = np.array([abs(float(np.dot(sides[0][p], sides[1][p]))) for p in common_q])
    nq = float((cos >= np.cos(np.deg2rad(2.0))).mean()) if len(cos) else 0.0
    print(f"[chip_smoke] (f) GPU vs CPU: config 2 survivors {len(sweep_sets[0])} vs "
          f"{len(position_set(cpu2))}, jaccard {j2:.5f}; QUALITY {len(sides[0])} vs "
          f"{len(sides[1])}, jaccard {jq:.5f}, normals within 2 deg {nq:.5f} of {len(common_q)} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(j2 >= 0.99, f"(f) config 2 GPU vs CPU jaccard {j2:.5f} < 0.99")
    check(jq >= 0.99, f"(f) QUALITY GPU vs CPU jaccard {jq:.5f} < 0.99")
    check(nq >= 0.98, f"(f) QUALITY GPU vs CPU: only {nq:.5f} of normals within 2 deg")

    # ---- (g) K3's times at config 2's shapes -----------------------------
    t0 = time.perf_counter()
    k3 = {}
    r2 = (radius * radius).reshape(1)
    r2b = (radius2 * radius2).reshape(1)
    for mode, kmode in modes.items():
        km_t, pm_t, nbytes, flops = 0.0, 0.0, 0.0, 0.0
        for p, kw in passes.items():
            kw = dict(common, kmode=kmode, **kw)
            km, pm = interleaved_ms(
                lambda p=p, kw=kw: window_stats(*rows[p], radius, radius2=radius2, **kw),
                lambda p=p, kw=kw: window_stats_plain(
                    *rows[p], r2, kw["k"], kw["window_blocks"], kw["kmode"], kw["direction"],
                    kw["moments"], r2b),
                reps=10,
            )
            mom0 = window_stats(*rows[p], radius, radius2=radius2, **kw)[2][..., 0, :]
            b, f = k3_work(rows[p], kw["k"], kw["window_blocks"], kw["direction"], True, mom0,
                           kmode=kmode, radius2=True)
            nbytes, flops = nbytes + b, flops + f
            km_t, pm_t = km_t + km, pm_t + pm
            print(f"[chip_smoke] (g) K3 {mode} {p}: kernel {km:.4f} ms, plain {pm:.4f} ms")
        bms, by = bound(nbytes, flops)
        k3[mode] = {"ms": km_t, "plain_ms": pm_t, "bound_ms": bms, "bound_by": by,
                    "library_ms": None, "rows": CAPACITY, "passes": 2}
        print(f"[chip_smoke] (g) K3 {mode}, both passes at {CAPACITY} rows: kernel {km_t:.4f} ms, "
              f"plain torch {pm_t:.4f} ms, bound {bms:.4f} ms ({by})")
    print(f"[chip_smoke] (g) took {time.perf_counter() - t0:.1f} s")
    print(f"[chip_smoke] outlier slice: config 2 p50 {float(np.median(c2_ms)):.3f} ms/scan "
          f"(bisect {float(np.median(c2b_ms)):.3f}), B={BATCH} vmapped {c2_modes['vmapped']:.3f} "
          f"ms/scan; QUALITY p50 {float(np.median(q_ms)):.3f} ms/scan")
    def five(one_scan):
        def run():
            for i in range(5):
                one_scan(i)
        return run

    profile = [
        ("config 2: 5 single scans", five(config2_scan(run2))),
        (f"config 2: 1 vmapped batch of {BATCH}", lambda: engine.process_batch(bufs)),
        ("QUALITY: 5 single scans (process_soa)", five(quality_scan)),
    ]
    return {"k3_config2": k3, "k3_config2_max_abs_err": max_err, "launches": launches,
            "profile": profile}


#: bench_suite.py config 6 (:353-400): the 1M-point merged cloud
CONFIG6_POINTS, CONFIG6_CAPACITY = 1_000_000, 1_048_576
CONFIG6_SETTINGS = dict(
    remove_statistical_outliers=True, nb_neighbors=16, estimate_normals=True,
    max_neighbors=16, remove_ground=True, ransac_n=3, num_iterations=64,
    knn_method="window", ground_before_voxel=True, voxel_compact_keys="wide",
    post_downsample_capacity=409_600, pre_voxel_compact_capacity=524_288,
)
CONFIG6_PARAMS = dict(voxel_size=0.05, distance_threshold=0.12)
CONFIG6_SHAPES = {
    "masked_compact": "3 x 1048576 -> 524288",
    "segmented_sums": "4 x 524288",
    "window_stats": "409600 rows, sweep k=16 wb=1 moments, 2 passes",
}
#: bench_suite.py config 3 (:162-188) and config 1 (:103-126)
CONFIG3_SETTINGS = dict(
    remove_duplicates=False, crop_to_roi=False, voxel_downsample=False,
    estimate_normals=False, remove_ground=True, ransac_n=3, num_iterations=100,
)
CONFIG1_SETTINGS = dict(
    remove_duplicates=False, remove_nans=True, remove_infs=True, crop_to_roi=True,
    voxel_downsample=True, estimate_normals=False,
)


def sensor_order(soa: dict) -> dict:
    """The scan's points in a spinning sensor's firing order (by azimuth,
    non-finite rows last): ground and objects interleave. In the bench
    scene's own order every ground point comes first."""
    pts = soa["positions"]
    order = np.argsort(np.arctan2(pts[:, 1], pts[:, 0]), kind="stable")
    return {k: v[order] for k, v in soa.items()}


def same_set_jaccard(a: set, b: set) -> float:
    """Jaccard of two survivor sets; 1.0 when both are empty."""
    return 1.0 if not (a or b) else jaccard(a, b)


def surface_slice(dev, production_cfg):
    """Phases 16-23: the configuration surface (see the module docstring).
    Returns K1-K3's numbers at config 6's shapes, each path's launch
    counts, the profile runs and the paths' timings."""
    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa, to_soa
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        PipelineParams, PipelineSettings, build_pipeline, stage_functions,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.segmean import (
        compact_rows, compact_rows_plain, run_ids, segmented_sums, segmented_sums_plain,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.voxel import sorted_voxel_channels
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.window import _sorted_rows
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.window_stats import (
        window_stats, window_stats_plain,
    )

    launches, timings, profile = {}, {}, []

    def drive(tag, one_scan, per_scan, scans=WARMUP + TIMED, warm=WARMUP, allow_empty=False):
        """``scans`` runs of ``one_scan(i) -> out soa``, the first ``warm``
        untimed; the counts are set to 0 just before and read just after,
        and must be ``per_scan`` (K1, K2, K3) times the scans. Returns the
        last scan's survivor set."""
        times, sizes = [], []
        _build.reset_launches()
        for i in range(scans):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            soa = one_scan(i)
            end.record()
            torch.cuda.synchronize()
            n = soa["positions"].shape[0]
            check((allow_empty or n > 0) and n < N_POINTS * 8,
                  f"{tag} scan {i}: {n} survivors")
            check(bool(np.isfinite(soa["positions"]).all()), f"{tag} scan {i}: non-finite survivors")
            if i >= warm:
                times.append(start.elapsed_time(end))
            sizes.append(n)
        got = tuple(_build.LAUNCHES[k] for k in KERNELS)
        want = tuple(scans * c for c in per_scan)
        check(got == want, f"{tag}: launches {got} in {scans} scans, expected {want}")
        launches[tag] = dict(zip(KERNELS, got))
        p50, p90 = float(np.median(times)), float(np.percentile(times, 90))
        timings[tag] = {"p50_ms": p50, "p90_ms": p90, "scans": len(times)}
        print(f"[chip_smoke] {tag}: {scans} scans ok, launches {json.dumps(launches[tag])} "
              f"({per_scan} a scan); p50 {p50:.3f} ms/scan, p90 {p90:.3f} (CUDA events, from_soa.."
              f"to_soa, {len(times)} timed), survivors {min(sizes)}..{max(sizes)}")
        return position_set(soa)

    def vs_cpu(tag, gpu_set, cpu_soa, seconds, note=""):
        cpu_set = position_set(cpu_soa)
        j = same_set_jaccard(gpu_set, cpu_set)
        print(f"[chip_smoke] {tag} GPU vs CPU: survivors {len(gpu_set)} vs {len(cpu_set)}, jaccard "
              f"{j:.5f} (CPU run {seconds:.1f} s{note})")
        check(j >= 0.99, f"{tag} GPU vs CPU jaccard {j:.5f} < 0.99")

    # ---- (h) config 6's kernels against their plain versions -------------
    t0 = time.perf_counter()
    settings6 = PipelineSettings(**CONFIG6_SETTINGS)
    run6 = build_pipeline(settings6)
    params6 = PipelineParams.make(**CONFIG6_PARAMS, device=dev)
    stages6 = dict(stage_functions(settings6))
    soa6 = {"positions": scene(CONFIG6_POINTS)}
    H6, n6 = settings6.num_iterations, settings6.ransac_n
    u6 = torch.from_numpy(np.random.default_rng(6).uniform(size=(H6, n6)).astype(np.float32))
    buf6, _ = from_soa(soa6, capacity=CONFIG6_CAPACITY, device=dev)
    b = buf6
    for name in ("non_finite", "crop", "ground"):
        b, _ = stages6[name](b, params6, None, u6.to(dev))
    k1_rows, k1_mask = b.positions.contiguous(), b.mask
    pcap = settings6.pre_voxel_compact_capacity
    check(int(k1_mask.sum()) <= pcap, f"(h) config 6: {int(k1_mask.sum())} live > the {pcap} bucket")
    b = stages6["pre_compact"](b, params6)[0]
    k2_vals, k2_flags, _, _, _ = sorted_voxel_channels(
        b, params6.voxel_size, dedup_exact=True, curve_order=True, compact_keys="wide")
    b = stages6["voxel"](b, params6)[0]
    cap6 = settings6.post_downsample_capacity
    live6 = int(b.mask.sum())
    check(live6 <= cap6, f"(h) config 6: {live6} voxels overflow the {cap6} bucket")
    p0 = [b.positions[c, :cap6].contiguous() for c in range(3)] + [b.mask[:cap6].contiguous()]
    k3_rows6 = {"pass0": p0, "pass1": list(_sorted_rows(torch.stack(p0[:3]), p0[3], 1))}
    k3_kw6 = {p: dict(k=settings6.nb_neighbors, window_blocks=1, kmode="sweep", direction=d,
                      moments=True) for p, d in (("pass0", 0), ("pass1", 1))}
    print(f"[chip_smoke] (h) config 6 shapes: K1 {tuple(k1_rows.shape)} live {int(k1_mask.sum())} "
          f"-> {pcap}; K2 {tuple(k2_vals.shape)} runs {int(k2_flags[1:].sum()) + 1}; K3 {cap6} "
          f"rows, {live6} live voxels, 'wide' keys")
    err6 = {}
    outs, new_mask = compact_rows([k1_rows], k1_mask, pcap)
    want, want_mask = compact_rows_plain([k1_rows.cpu()], k1_mask.cpu(), pcap)
    check(torch.equal(bits(outs[0]), bits(want[0])) and torch.equal(new_mask.cpu(), want_mask),
          "(h) K1 at config 6's shapes is not bit-exact against its plain version")
    err6["masked_compact"] = 0.0
    got = segmented_sums(k2_vals, k2_flags).cpu()
    ref = segmented_sums_plain(k2_vals.cpu(), k2_flags.cpu())
    check(torch.equal(bits(got), bits(ref)), "(h) K2 at config 6's shapes is not bit-equal to plain")
    err6["segmented_sums"] = float((got - ref).abs().max())
    err6["window_stats"] = max(
        check_k3_plain(f"config 6 {p}", window_stats(*k3_rows6[p], params6.search_radius, **kw),
                       k3_rows6[p], kw, params6.search_radius)
        for p, kw in k3_kw6.items())
    print(f"[chip_smoke] (h) config 6 kernels vs plain max abs err {json.dumps(err6)} "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- (h) their times at config 6's shapes ----------------------------
    t0 = time.perf_counter()
    k6 = {}
    km, pm = interleaved_ms(lambda: compact_rows([k1_rows], k1_mask, pcap),
                            lambda: compact_rows_plain([k1_rows], k1_mask, pcap), reps=10)
    lib = event_ms(lambda: k1_rows[:, k1_mask], 10)
    k6["masked_compact"] = (km, pm, lib, *bound(*k1_work(k1_rows, k1_mask, pcap)))
    n2 = k2_vals.shape[-1]
    ids = run_ids(k2_flags)
    km, pm = interleaved_ms(lambda: segmented_sums(k2_vals, k2_flags),
                            lambda: segmented_sums_plain(k2_vals, k2_flags), reps=10)
    lib = event_ms(lambda: torch.zeros_like(k2_vals).index_add_(1, ids, k2_vals), 10)
    k6["segmented_sums"] = (km, pm, lib, *bound(*k2_work(k2_vals, k2_flags)))
    r2 = (params6.search_radius ** 2).reshape(1)
    k3_km = k3_pm = nbytes = flops = 0.0
    for p, kw in k3_kw6.items():
        rows = k3_rows6[p]
        km, pm = interleaved_ms(
            lambda rows=rows, kw=kw: window_stats(*rows, params6.search_radius, **kw),
            lambda rows=rows, kw=kw: window_stats_plain(
                *rows, r2, kw["k"], kw["window_blocks"], kw["kmode"], kw["direction"],
                kw["moments"]),
            reps=3,
        )
        mom0 = window_stats(*rows, params6.search_radius, **kw)[2][0]
        bb, ff = k3_work(rows, kw["k"], 1, kw["direction"], True, mom0, kmode="sweep")
        nbytes, flops = nbytes + bb, flops + ff
        k3_km, k3_pm = k3_km + km, k3_pm + pm
        print(f"[chip_smoke] (h) K3 config 6 {p}: kernel {km:.4f} ms, plain {pm:.4f} ms")
    k6["window_stats"] = (k3_km, k3_pm, None, *bound(nbytes, flops))
    for k, (km, pm, lib, bms, by) in k6.items():
        lib_txt = "none" if lib is None else f"{lib:.4f} ms"
        print(f"[chip_smoke] (h) {k} at config 6's shapes: kernel {km:.4f} ms, plain torch "
              f"{pm:.4f} ms, library {lib_txt}, bound {bms:.4f} ms ({by}), kernel/bound "
              f"{km / bms:.1f}x")
    print(f"[chip_smoke] (h) took {time.perf_counter() - t0:.1f} s")

    # ---- (i) config 6 through build_pipeline, and once on the CPU --------
    t0 = time.perf_counter()

    u6_d = u6.to(dev)

    def config6_scan(i):
        scan, meta = from_soa(soa6, capacity=CONFIG6_CAPACITY, device=dev)
        return to_soa(run6(scan, params6, None, u6_d)[0], meta)

    set6 = drive("config6", config6_scan, (1, 1, 2))
    t1 = time.perf_counter()
    cpu6 = to_soa(run6(from_soa(soa6, capacity=CONFIG6_CAPACITY, device="cpu")[0],
                       PipelineParams.make(**CONFIG6_PARAMS, device="cpu"), None, u6)[0])
    vs_cpu("(i) config 6", set6, cpu6, time.perf_counter() - t1, f", full size: {CONFIG6_POINTS:,} points")
    print(f"[chip_smoke] (i) took {time.perf_counter() - t0:.1f} s")
    profile.append(("config 6: 3 single scans", lambda: [config6_scan(i) for i in range(3)]))

    # ---- (j)-(o) the 128k paths ----------------------------------------
    soa_bench = bench_soa()
    soa_sensor = sensor_order(soa_bench)

    def engine_path(tag, cfg, soa, per_scan, scans=WARMUP + TIMED, warm=WARMUP, **kw):
        """``cfg`` through ``Preprocessor.process_buffer`` on the card with
        fixed draws (RANSAC's, and the random downsampler's at the stage's
        capacity), then once on the CPU with the same draws."""
        t0 = time.perf_counter()
        engine = Preprocessor(cfg, seed=0)
        s = engine.settings
        gu = torch.from_numpy(np.random.default_rng(7).uniform(
            size=(s.num_iterations, s.ransac_n)).astype(np.float32))
        ds_cap = s.pre_voxel_compact_capacity or CAPACITY
        du = torch.from_numpy(np.random.default_rng(8).uniform(size=ds_cap).astype(np.float32))
        gu_d, du_d = gu.to(dev), du.to(dev)

        def one(i):
            scan, meta = from_soa(soa, capacity=CAPACITY, device=dev)
            return to_soa(engine.process_buffer(scan, gu_d, du_d)[0], meta)

        got = drive(tag, one, per_scan, scans, warm, **kw)
        cpu_engine = Preprocessor(cfg, seed=0, device="cpu")
        t1 = time.perf_counter()
        scan, meta = from_soa(soa, capacity=CAPACITY, device="cpu")
        vs_cpu(tag, got, to_soa(cpu_engine.process_buffer(scan, gu, du)[0], meta),
               time.perf_counter() - t1)
        print(f"[chip_smoke] {tag} took {time.perf_counter() - t0:.1f} s")
        n_prof = 1 if scans < WARMUP + TIMED else 5
        profile.append((f"{tag}: {n_prof} single scan(s)", lambda: [one(i) for i in range(n_prof)]))
        return got

    config7 = {**production_cfg, "remove_ground.before_voxel": False, "downsample.max_points": 0}
    engine_path("config7", config7, soa_sensor, (1, 1, 2))
    # the bench scene's own order: the 65536 bucket ahead of ground removal
    # holds ground points only (ROADMAP fault 10), on the card and the CPU
    engine_path("config7_scene_order", config7, soa_bench, (1, 1, 2), scans=2, warm=1,
                allow_empty=True)
    soa_pos = {"positions": soa_bench["positions"]}

    def settings_path(tag, settings_kw, params_kw, per_scan, draws=None):
        t0 = time.perf_counter()
        run = build_pipeline(PipelineSettings(**settings_kw))
        params = PipelineParams.make(**params_kw, device=dev)

        args = () if draws is None else (draws.to(dev),)

        def one(i):
            scan, meta = from_soa(soa_pos, capacity=CAPACITY, device=dev)
            return to_soa(run(scan, params, None, *args)[0], meta)

        got = drive(tag, one, per_scan)
        t1 = time.perf_counter()
        scan, meta = from_soa(soa_pos, capacity=CAPACITY, device="cpu")
        cpu = to_soa(run(scan, PipelineParams.make(**params_kw, device="cpu"), None,
                         *(() if draws is None else (draws,)))[0], meta)
        vs_cpu(tag, got, cpu, time.perf_counter() - t1)
        print(f"[chip_smoke] {tag} took {time.perf_counter() - t0:.1f} s")
        profile.append((f"{tag}: 5 single scans", lambda: [one(i) for i in range(5)]))

    u3 = torch.from_numpy(np.random.default_rng(9).uniform(size=(100, 3)).astype(np.float32))
    settings_path("config3", CONFIG3_SETTINGS, dict(distance_threshold=0.12), (0, 0, 0), u3)
    settings_path("config1", CONFIG1_SETTINGS, dict(voxel_size=0.08), (0, 1, 0))
    engine_path("defaults", {}, soa_bench, (0, 1, 2))
    for method, per_scan, scans in (("random", (1, 0, 2), WARMUP + TIMED),
                                    ("uniform", (1, 0, 2), WARMUP + TIMED),
                                    ("farthest_point", (1, 0, 2), 6)):
        engine_path(f"downsample_{method}", {**production_cfg, "downsample_method": method},
                    soa_bench, per_scan, scans=scans, warm=1 if scans < WARMUP + TIMED else WARMUP)
    engine_path("height_ground", {**production_cfg, "remove_ground.method": "height",
                                  "ground_plane": [0.0, 0.0, 1.0, 0.0]}, soa_bench, (1, 1, 2))
    return {"k_config6": k6, "err_config6": err6, "launches": launches, "timings": timings,
            "profile": profile}


# ---- synthetic Velodyne captures (packets, pcap files) --------------------

#: bench_suite.py config 5 (:230-300): the streaming engine's settings
CONFIG5 = {"voxel_size": 0.05, "estimate_normals": False}
CONFIG5_PACKETS, CONFIG5_BUCKET = 1500, 128
#: the HDL-32E capture of phase (r): single return, 10 Hz, 181 packets
#: (2,172 firings of 32 lasers) a revolution
HDL32_PER_REV, HDL32_REVS, HDL32_BUCKET = 181, 3, 192
#: K1/K2/K3 launches a revolution (or a batch) of the streaming paths: the
#: pipeline's own and the quantizer's K1
STREAM_LAUNCHES = {"config5": (1, 2, 0), "production": (2, 2, 2)}
HDL32_ELEVATIONS = np.array(
    [-30.67, -9.33, -29.33, -8.0, -28.0, -6.67, -26.67, -5.33, -25.33, -4.0, -24.0,
     -2.67, -22.67, -1.33, -21.33, 0.0, -20.0, 1.33, -18.67, 2.67, -17.33, 4.0, -16.0,
     5.33, -14.67, 6.67, -13.33, 8.0, -12.0, 9.33, -10.67, 10.67], dtype=np.float32)


def make_payloads(az_cdeg, ticks, refl, factory: int = 0x2237) -> np.ndarray:
    """(P, 1206) uint8 Velodyne payloads from block azimuths (P, 12) in
    hundredths of a degree, range ticks (P, 12, 32) of 2 mm and
    reflectivities (P, 12, 32)."""
    p = az_cdeg.shape[0]
    out = np.zeros((p, 1206), np.uint8)
    blocks = out[:, :1200].reshape(p, 12, 100)
    blocks[:, :, 0], blocks[:, :, 1] = 0xFF, 0xEE
    az = np.asarray(az_cdeg, np.int64) % 36000
    blocks[:, :, 2], blocks[:, :, 3] = az & 0xFF, az >> 8
    ch = blocks[:, :, 4:100].reshape(p, 12, 32, 3)
    t = np.clip(np.asarray(ticks, np.int64), 0, 65535)
    ch[..., 0], ch[..., 1], ch[..., 2] = t & 0xFF, t >> 8, np.asarray(refl) & 0xFF
    out[:, 1204], out[:, 1205] = factory & 0xFF, factory >> 8
    return out


def write_pcap(path: str, payloads: np.ndarray, stamps_us: np.ndarray) -> None:
    """A pcap file of Ethernet/IPv4/UDP frames to port 2368, one a payload,
    stamped at ``stamps_us`` (integer microseconds)."""
    eth = b"\x00" * 6 + b"\x11" * 6 + struct.pack(">H", 0x0800)
    udp_len = 8 + payloads.shape[1]
    ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 20 + udp_len, 0, 0, 64, 17, 0,
                     b"\xc0\xa8\x01\x01", b"\xc0\xa8\x01\x02")
    head = eth + ip + struct.pack(">HHHH", 51000, 2368, udp_len, 0)
    with open(path, "wb") as f:
        f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1))
        for payload, us in zip(payloads, stamps_us):
            frame = head + payload.tobytes()
            f.write(struct.pack("<IIII", int(us) // 10**6, int(us) % 10**6, len(frame), len(frame)))
            f.write(frame)


def vlp16_ring_capture(num_packets: int, dist_m: float = 10.0):
    """tests/test_pcap_compressor.py's ``_write_pcap`` capture, as
    (payloads, stamps in us): a VLP-16 sweeping 4.8 degrees a packet (75
    packets a revolution), every return at ``dist_m`` with reflectivity 42."""
    i = np.arange(num_packets)
    az = (i[:, None] * 480 + np.arange(12) * 40) % 36000
    ticks = np.full((num_packets, 12, 32), int(dist_m / 0.002))
    stamps = (1000 + i // 10) * 10**6 + (i % 10) * 1000
    return make_payloads(az, ticks, np.full_like(ticks, 42)), stamps


def random_capture(model: str, packets: int, seed: int = 1):
    """(payloads, stamps in us) of ``packets`` packets with ranges of
    0.4-120 m, 5% empty returns, random reflectivities, and azimuths that
    start at 350 degrees and wrap (the parity tests' capture)."""
    rng = np.random.default_rng(seed)
    step = 40 if model == "VLP16" else 16
    az = 35000 + (np.arange(packets)[:, None] * 12 + np.arange(12)) * step
    ticks = rng.integers(200, 60000, (packets, 12, 32))
    ticks[rng.random(ticks.shape) < 0.05] = 0
    payloads = make_payloads(az, ticks, rng.integers(0, 256, ticks.shape))
    return payloads, 1_000_000_000 + np.arange(packets) * 1327


def hdl32_capture(revs: int = HDL32_REVS, per_rev: int = HDL32_PER_REV, seed: int = 11):
    """An HDL-32E capture at 10 Hz, single (strongest) return, as
    (payloads, stamps in us): tools/make_hdl32_fixture.py's scene (ground 2 m
    below the sensor out to 70 m, three walls, two boxes that move between
    revolutions, a porous canopy in front of what lies behind it) at 12
    firings a packet, ``per_rev`` packets a revolution."""
    rng = np.random.default_rng(seed)
    firings = per_rev * 12
    k = np.arange(firings)
    az_cdeg = np.rint(k * 36000.0 / firings).astype(np.int64) % 36000
    az = (az_cdeg / 100.0)[None, :, None]  # (1, F, 1) degrees
    el = np.deg2rad(HDL32_ELEVATIONS.astype(np.float64))[None, None, :]  # (1, 1, 32)
    shape = (revs, firings, 32)
    cos_el, sin_el = np.cos(el), np.sin(el)
    ground = np.where(el < -1e-4, 2.0 / np.maximum(-sin_el, 1e-9), 0.0)
    solid = np.broadcast_to(np.where(ground <= 70.0, ground, 0.0), shape).copy()
    rev = np.arange(revs)[:, None, None]
    segs = [(30.0, 80.0, 10.0, 3.0), (120.0, 150.0, 6.0, 2.0), (200.0, 290.0, 18.0, 4.0)]
    for az_c, dps, d, hw, h in ((100.0, 12.0, 7.0, 4.0, 1.6), (310.0, -8.0, 12.0, 6.0, 2.2)):
        c = (az_c + dps * rev) % 360.0
        segs.append((c - hw, c + hw, d, h))
    for a0, a1, d, h in segs:
        inside = (az - a0) % 360.0 <= (a1 - a0) % 360.0
        r = d / cos_el
        z = r * sin_el
        hit = inside & (z >= -2.0) & (z <= -2.0 + h) & (r <= 70.0)
        r = np.broadcast_to(r, shape)
        solid = np.where(hit & ((solid == 0.0) | (r < solid)), r, solid)
    solid = np.where(solid > 0.0, solid + rng.normal(0.0, 0.01, shape), 0.0)
    r = np.broadcast_to(9.0 / cos_el, shape)
    zc = r * sin_el + 2.0
    canopy_hit = ((az >= 160.0) & (az <= 190.0) & (zc >= 0.5) & (zc <= 3.5) & (r <= 70.0)
                  & (rng.uniform(size=shape) <= 0.55))
    canopy = np.where(canopy_hit, r + rng.normal(0.0, 0.05, shape), 0.0)
    strongest = np.where((canopy > 0.0) & ((solid == 0.0) | (canopy < solid)), canopy, solid)
    ticks = np.rint(strongest / 0.002).astype(np.int64).reshape(revs * per_rev, 12, 32)
    refl = np.broadcast_to((60 + 40 * np.sin(np.deg2rad(az))).astype(np.int64), shape)
    payloads = make_payloads(np.tile(az_cdeg, revs).reshape(-1, 12), ticks,
                             refl.reshape(revs * per_rev, 12, 32), factory=0x2137)
    i = np.arange(revs * per_rev)
    stamps = 2000 * 10**6 + (i // per_rev) * 100_000 + (i % per_rev) * 552
    return payloads, stamps


def revolutions(payloads: np.ndarray, stamps: np.ndarray):
    """[(payloads, stamps)] of each revolution, split where the block-0
    azimuth wraps, as ``StreamingEngine.replay_pcap`` splits them."""
    az0 = payloads[:, 2].astype(np.int32) | (payloads[:, 3].astype(np.int32) << 8)
    bounds = [0, *(np.flatnonzero(np.diff(az0) < -18000) + 1).tolist(), payloads.shape[0]]
    return [(payloads[a:b], stamps[a:b]) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def grid_jaccard(blob, other, decompress) -> tuple:
    """(jaccard of two blobs' survivors on ``blob``'s quantization grid,
    largest grid step between matched survivors, survivor counts, whether
    the intensities are equal)."""
    a, b = decompress(blob), decompress(other)
    lo_step = np.frombuffer(blob[11:59], np.float64)
    qa = np.rint((a["positions"] - lo_step[:3]) / lo_step[3:]).astype(np.int64)
    qb = np.rint((b["positions"] - lo_step[:3]) / lo_step[3:]).astype(np.int64)
    sa, sb = set(map(tuple, qa.tolist())), set(map(tuple, qb.tolist()))
    steps = int(np.abs(qa - qb).max(initial=0)) if qa.shape == qb.shape else -1
    same_i = qa.shape == qb.shape and np.array_equal(a.get("intensity"), b.get("intensity"))
    return same_set_jaccard(sa, sb), steps, (len(qa), len(qb)), same_i


def streaming_slice(dev, production_cfg):
    """Phases 24-27: the streaming data path (see the module docstring).
    Returns each path's launch counts and timings, the profile runs, and
    K1's numbers at the quantizer's call."""
    from autodriver_pointcloud_preprocessor_tpu_torch.io.compressor import (
        decompress_soa, device_quantizer,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.io.pcap import _read_payloads
    from autodriver_pointcloud_preprocessor_tpu_torch.io.streaming import (
        StreamingEngine, _split_packet_fields, decode_fields,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        build_pipeline, params_from_config, settings_from_config,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.segmean import (
        compact_rows, compact_rows_plain,
    )

    launches, timings, profile, ops = {}, {}, [], {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def counts():
        return tuple(_build.LAUNCHES[k] for k in KERNELS)

    def traced_launches(fn) -> int:
        """cudaLaunchKernel calls of one ``fn()`` (torch.profiler)."""
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")

    def fields_of(payloads, stamps, pb):
        p = payloads.shape[0]
        fields = np.zeros((1176, pb), np.uint8)
        fields[:, :p] = _split_packet_fields(payloads)
        stamp_off = np.zeros(pb, np.float32)
        stamp_off[:p] = (stamps - stamps.min()).astype(np.float32)
        return torch.from_numpy(fields), torch.from_numpy(stamp_off), torch.tensor(p, dtype=torch.int32)

    def decode_on(tensors, device, model):
        f, so, n = (t.to(device) for t in tensors)
        return decode_fields(f, so, n, 0.4, 130.0, model)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- (p) decode and quantizer, card vs CPU -------------------------
        t0 = time.perf_counter()
        hdl_path, vlp_path = f"{tmp}/hdl32.pcap", f"{tmp}/vlp16.pcap"
        write_pcap(hdl_path, *hdl32_capture())
        write_pcap(vlp_path, *vlp16_ring_capture(CONFIG5_PACKETS))
        hdl_revs = revolutions(*_read_payloads(hdl_path))  # through the sidecar
        vlp_revs = revolutions(*_read_payloads(vlp_path))
        check([len(p) for p, _ in hdl_revs] == [HDL32_PER_REV] * HDL32_REVS,
              f"(p) HDL-32E capture: revolutions of {[len(p) for p, _ in hdl_revs]} packets")
        check(len(vlp_revs) == 20, f"(p) VLP-16 capture: {len(vlp_revs)} revolutions, not 20")
        for tag, model, rev, pb in (("HDL-32E", "HDL32E", hdl_revs[0], HDL32_BUCKET),
                                    ("VLP-16", "VLP16", vlp_revs[0], CONFIG5_BUCKET)):
            tensors = fields_of(*rev, pb)
            card, cpu = decode_on(tensors, dev, model), decode_on(tensors, "cpu", model)
            check(torch.equal(card.mask.cpu(), cpu.mask), f"(p) {tag} decode: masks differ")
            for k in ("intensity", "ring", "time", "distance"):
                check(torch.equal(bits(card.attributes[k]), bits(cpu.attributes[k])),
                      f"(p) {tag} decode: {k} differs from the CPU's")
            az_err = float((card.attributes["azimuth"].cpu() - cpu.attributes["azimuth"]).abs().max())
            pos_err = float((card.positions.cpu() - cpu.positions)[:, cpu.mask].abs().max())
            check(az_err <= 1e-4 and pos_err <= 1e-4,
                  f"(p) {tag} decode: azimuth {az_err:.3e} deg, positions {pos_err:.3e} m from the CPU's")
            f_d, so_d, n_d = (t.to(dev) for t in tensors)
            decode_ms = event_ms(lambda: decode_fields(f_d, so_d, n_d, 0.4, 130.0, model), 20)
            ops[f"decode_{model}"] = {
                "launches": traced_launches(lambda: decode_fields(f_d, so_d, n_d, 0.4, 130.0, model)),
                "ms": decode_ms, "slots": card.capacity, "live": int(cpu.mask.sum())}
            print(f"[chip_smoke] (p) {tag} decode at {card.capacity} slots ({int(cpu.mask.sum())} live): "
                  f"mask, ring, intensity, time, distance equal to the CPU's bit for bit; azimuth "
                  f"{az_err:.3e} deg, positions {pos_err:.3e} m; {decode_ms:.4f} ms a call (CUDA "
                  f"events), {ops[f'decode_{model}']['launches']} cudaLaunchKernel")
        # the quantizer on the production output of the HDL-32E revolution
        settings = settings_from_config(production_cfg)
        draws = torch.from_numpy(np.random.default_rng(12).uniform(
            size=(BATCH, settings.num_iterations, settings.ransac_n)).astype(np.float32))
        out, _ = build_pipeline(settings)(decode_on(fields_of(*hdl_revs[0], HDL32_BUCKET), dev, "HDL32E"),
                                          params_from_config(production_cfg, device=dev), None,
                                          draws[0].to(dev))
        quantize = device_quantizer(14)
        _build.reset_launches()
        packed, meta = quantize(out, 1.0)
        torch.cuda.synchronize()
        check(counts() == (1, 0, 0), f"(p) quantizer launches {counts()}, expected (1, 0, 0)")
        out_cpu = type(out)(out.positions.cpu(), out.mask.cpu(), {k: v.cpu() for k, v in out.attributes.items()})
        packed_cpu, meta_cpu = quantize(out_cpu, 1.0)
        meta, packed = meta.cpu(), packed.cpu()
        n_live = int(meta_cpu[0])
        steps = (packed[:3, :n_live].int() - packed_cpu[:3, :n_live].int()).abs()
        check(float(meta[0]) == float(meta_cpu[0]) and n_live > 0, f"(p) quantizer count {meta[0]} vs {meta_cpu[0]}")
        rel = float(((meta[1:] - meta_cpu[1:]).abs() / meta_cpu[1:].abs()).max())
        check(rel <= 1e-6, f"(p) quantizer lo/step differ by {rel:.3e} relative")
        check(int(steps.max()) <= 1 and float((steps > 0).float().mean()) <= 1e-3
              and torch.equal(packed[3, :n_live], packed_cpu[3, :n_live]),
              f"(p) quantizer rows: {int((steps > 0).sum())} coordinates differ, by up to {int(steps.max())}")
        q_ms = event_ms(lambda: quantize(out, 1.0), 20)
        ops["quantize"] = {"launches": traced_launches(lambda: quantize(out, 1.0)), "ms": q_ms,
                           "slots": out.capacity, "live": n_live}
        # K1 at the quantizer's call: 4 rows (positions, intensity) of the
        # production output, compacted in place
        inten = out.attributes["intensity"]
        k1_out, k1_mask = compact_rows([out.positions, inten], out.mask, out.capacity)
        want, want_mask = compact_rows_plain([out.positions.cpu(), inten.cpu()], out.mask.cpu(), out.capacity)
        check(all(torch.equal(bits(a), bits(b)) for a, b in zip(k1_out, want))
              and torch.equal(k1_mask.cpu(), want_mask), "(p) K1 at the quantizer's call differs from plain")
        rows4 = torch.cat([out.positions, inten[None]]).contiguous()
        km, pm = interleaved_ms(lambda: compact_rows([out.positions, inten], out.mask, out.capacity),
                                lambda: compact_rows_plain([out.positions, inten], out.mask, out.capacity))
        lib = event_ms(lambda: rows4[:, out.mask], 20)
        k1_quant = (km, pm, lib, *bound(*k1_work(rows4, out.mask, out.capacity)),
                    f"4 x {out.capacity} -> {out.capacity} (positions, intensity)")
        print(f"[chip_smoke] (p) quantizer on the production output ({out.capacity} slots, {n_live} live): "
              f"1 K1 launch; vs the CPU: count equal, lo/step {rel:.3e} relative, {int((steps > 0).sum())} "
              f"coordinates one quantum apart; {q_ms:.4f} ms a call, {ops['quantize']['launches']} "
              f"cudaLaunchKernel. K1 there: kernel {km:.4f} ms, plain {pm:.4f}, library {lib:.4f}, "
              f"bound {k1_quant[3]:.4f} ({k1_quant[4]}) ({time.perf_counter() - t0:.1f} s)")

        # ---- (q) bench_suite.py config 5 through StreamingEngine -----------
        t0 = time.perf_counter()
        engine5 = StreamingEngine(CONFIG5, packet_bucket=CONFIG5_BUCKET)
        check(engine5.device == dev, f"StreamingEngine defaults to {engine5.device}, not {dev}")

        def replay(engine, path, batch=1):
            """(blobs, ms between consecutive blobs, wall s) of one replay."""
            stamps_s, blobs = [time.perf_counter()], []
            for blob in engine.replay_pcap(path, batch=batch):
                blobs.append(blob)
                stamps_s.append(time.perf_counter())
            return blobs, np.diff(stamps_s) * 1e3, stamps_s[-1] - stamps_s[0]

        replay(engine5, vlp_path)  # warm-up
        for batch, tag in ((1, "streaming_config5"), (20, "streaming_config5_batch20")):
            _build.reset_launches()
            blobs, _, _ = replay(engine5, vlp_path, batch)
            torch.cuda.synchronize()
            per = 20 if batch == 1 else 1
            # the pipeline's 0/2/0 (the decoded buffer's 9 voxel channels
            # take two K2 launches of 8 rows at most) and the quantizer's K1
            want = tuple(per * c for c in STREAM_LAUNCHES["config5"])
            check(counts() == want, f"(q) {tag}: launches {counts()}, expected {want}")
            launches[tag] = dict(zip(KERNELS, counts()))
            if batch == 1:
                single_blobs = blobs
            else:
                check(blobs == single_blobs, "(q) batch=20 blobs differ from the single replay's")
            walls, per_rev = [], []
            for _ in range(3 if batch == 1 else 5):
                b, gaps, wall = replay(engine5, vlp_path, batch)
                walls.append(wall)
                per_rev.extend(gaps if batch == 1 else [wall * 1e3 / len(b)])
            p50, p90 = float(np.median(per_rev)), float(np.percentile(per_rev, 90))
            rtf = len(blobs) / 10.0 / float(np.median(walls))
            timings[tag] = {"p50_ms": p50, "p90_ms": p90, "realtime_10hz": rtf, "revolutions": len(blobs)}
            print(f"[chip_smoke] (q) config 5 replay batch={batch}: {len(blobs)} revolutions, launches "
                  f"{json.dumps(launches[tag])}; ms a revolution p50 {p50:.3f}, p90 {p90:.3f} (host clock, "
                  f"{'between blobs' if batch == 1 else 'replay wall / revolutions'}); {rtf:.1f}x real time "
                  f"at 10 Hz")
        raw_bytes = sum(p.nbytes for p, _ in vlp_revs)
        ratio = raw_bytes / sum(len(b) for b in single_blobs)
        t1 = time.perf_counter()
        cpu_blobs = list(StreamingEngine(CONFIG5, packet_bucket=CONFIG5_BUCKET, device="cpu")
                         .replay_pcap(vlp_path))
        check(len(cpu_blobs) == len(single_blobs), f"(q) {len(cpu_blobs)} CPU blobs vs {len(single_blobs)}")
        worst = 1.0
        for i, (g, c) in enumerate(zip(single_blobs, cpu_blobs)):
            j, steps, sizes, same_i = grid_jaccard(g, c, decompress_soa)
            check(sizes[0] == sizes[1] and 0 < sizes[0] and j >= 0.99 and steps <= 1 and same_i,
                  f"(q) revolution {i}: card vs CPU survivors {sizes}, jaccard {j:.5f}, {steps} steps")
            worst = min(worst, j)
        timings["streaming_config5"]["compression_ratio"] = ratio
        print(f"[chip_smoke] (q) compression {ratio:.3f}x against {raw_bytes} packet bytes; card vs CPU "
              f"(CPU replay {time.perf_counter() - t1:.1f} s): counts equal, jaccard >= {worst:.5f} on "
              f"the grid ({time.perf_counter() - t0:.1f} s)")
        vlp_5 = vlp_revs[:5]
        profile.append(("streaming config 5: 5 revolutions",
                        lambda: [engine5.process_scan_packets(*r) for r in vlp_5]))

        # ---- (r) the production preset on the HDL-32E capture --------------
        t0 = time.perf_counter()
        engine_r = StreamingEngine(production_cfg, model="HDL32E", packet_bucket=HDL32_BUCKET)
        replay(engine_r, hdl_path)  # warm-up
        _build.reset_launches()
        blobs_r, _, _ = replay(engine_r, hdl_path)
        torch.cuda.synchronize()
        want = tuple(HDL32_REVS * c for c in STREAM_LAUNCHES["production"])
        check(counts() == want, f"(r) production replay: launches {counts()}, expected {want}")
        launches["streaming_production_hdl32"] = dict(zip(KERNELS, counts()))
        for i, b in enumerate(blobs_r):
            soa = decompress_soa(b)
            n = soa["positions"].shape[0]
            check(1000 < n < 65536 and bool(np.isfinite(soa["positions"]).all()),
                  f"(r) revolution {i}: {n} survivors")
        per_rev, walls = [], []
        for _ in range(5):
            _, gaps, wall = replay(engine_r, hdl_path)
            per_rev.extend(gaps)
            walls.append(wall)
        p50, p90 = float(np.median(per_rev)), float(np.percentile(per_rev, 90))
        timings["streaming_production_hdl32"] = {
            "p50_ms": p50, "p90_ms": p90, "realtime_10hz": HDL32_REVS / 10.0 / float(np.median(walls)),
            "revolutions": HDL32_REVS}
        # a batch of 8 revolutions (the capture's 3, cycled), each with its draws
        scans8 = [hdl_revs[i % HDL32_REVS] for i in range(BATCH)]
        draws_d = draws.to(dev)
        engine_r.process_scan_batch(scans8, ground_uniforms=draws_d)  # warm-up
        _build.reset_launches()
        batch_blobs = engine_r.process_scan_batch(scans8, ground_uniforms=draws_d)
        torch.cuda.synchronize()
        check(counts() == STREAM_LAUNCHES["production"],
              f"(r) process_scan_batch of {BATCH}: launches {counts()}, expected {STREAM_LAUNCHES['production']}")
        launches["streaming_production_hdl32_batch8"] = dict(zip(KERNELS, counts()))
        for i, scan in enumerate(scans8):
            alone = engine_r.process_scan_packets(*scan, ground_uniforms=draws_d[i])
            check(alone == batch_blobs[i], f"(r) batch of {BATCH}: revolution {i} differs from its lone run")
        batch_ms = []
        for _ in range(5):
            w0 = time.perf_counter()
            engine_r.process_scan_batch(scans8, ground_uniforms=draws_d)
            batch_ms.append((time.perf_counter() - w0) * 1e3 / BATCH)
        timings["streaming_production_hdl32_batch8"] = {
            "p50_ms": float(np.median(batch_ms)), "p90_ms": float(np.percentile(batch_ms, 90)),
            "realtime_10hz": 100.0 / float(np.median(batch_ms)), "revolutions": BATCH}
        t1 = time.perf_counter()
        cpu_engine = StreamingEngine(production_cfg, model="HDL32E", packet_bucket=HDL32_BUCKET, device="cpu")
        j, steps, sizes, same_i = grid_jaccard(
            batch_blobs[0], cpu_engine.process_scan_packets(*hdl_revs[0], ground_uniforms=draws[0]),
            decompress_soa)
        check(j >= 0.99, f"(r) card vs CPU: survivors {sizes}, jaccard {j:.5f}")
        print(f"[chip_smoke] (r) production on HDL-32E ({HDL32_PER_REV} packets, {HDL32_BUCKET * 384} slots "
              f"a revolution): launches {json.dumps(launches['streaming_production_hdl32'])} in "
              f"{HDL32_REVS} revolutions ({STREAM_LAUNCHES['production']} each), {json.dumps(launches['streaming_production_hdl32_batch8'])} "
              f"a batch of {BATCH}, every batched revolution equal to its lone run; ms a revolution p50 "
              f"{p50:.3f}, p90 {p90:.3f} (host clock, between blobs), "
              f"{timings['streaming_production_hdl32']['realtime_10hz']:.1f}x real time; batch of {BATCH} "
              f"{timings['streaming_production_hdl32_batch8']['p50_ms']:.3f} ms a revolution; card vs CPU "
              f"survivors {sizes}, jaccard {j:.5f} (CPU {time.perf_counter() - t1:.1f} s) "
              f"({time.perf_counter() - t0:.1f} s)")
        hdl_5 = [hdl_revs[i % HDL32_REVS] for i in range(5)]
        profile.append(("streaming production HDL-32E: 5 revolutions",
                        lambda: [engine_r.process_scan_packets(*r) for r in hdl_5]))
        profile.append((f"streaming production HDL-32E: 1 batch of {BATCH}",
                        lambda: engine_r.process_scan_batch(scans8, ground_uniforms=draws_d)))
    return {"launches": launches, "timings": timings, "profile": profile, "ops": ops,
            "k1_quantizer": k1_quant}


#: phases (t)-(v): the node's static sensor -> robot transform (yaw 30
#: degrees, the sensor 1.9 m up), the processing_times keys they print, and
#: the three sensors' extrinsics (yaw 120 degrees apart, 200 m apart along
#: x, so that every sensor's survivors lie in a region of their own)
NODE_TF = ((1.5, -0.5, 1.9), (0.0, 0.0, float(np.sin(np.pi / 12)), float(np.cos(np.pi / 12))))
NODE_TIME_KEYS = ("ros_to_numpy", "tf_lookup", "tensor_transfer", "preprocessing_time",
                  "device_to_host", "pointcloud_msg_parsing", "pointcloud_pub", "total_callback_time")
GRAPH_SENSORS, GRAPH_SPACING, GRAPH_ROUNDS = 3, 200.0, 8
NODE_LAUNCHES = (1, 1, 2)


def velodyne_msg(seed: int, stamp: float, frame: str = "velodyne"):
    """The bench scene of ``seed`` as a Velodyne-style PointCloud2: x, y, z,
    intensity float32 and ring uint16, the NaN returns included."""
    from autodriver_pointcloud_preprocessor_tpu_torch.core import (
        Header, PointFieldType, Time, build_pointfields, make_pointcloud2,
        structured_dtype_from_fields,
    )

    soa = bench_soa(seed)
    fields, step = build_pointfields(["x", "y", "z", "intensity", "ring"],
                                     [PointFieldType.FLOAT32] * 4 + [PointFieldType.UINT16])
    arr = np.zeros(len(soa["positions"]), dtype=structured_dtype_from_fields(fields, step))
    arr["x"], arr["y"], arr["z"] = soa["positions"].T
    arr["intensity"], arr["ring"] = soa["intensity"], soa["ring"]
    return make_pointcloud2(arr, fields, header=Header(Time.from_float(stamp), frame), is_dense=False)


def node_slice(dev, production_cfg):
    """Phases 28-30: the node, the three-sensor graph and the CLI on the
    card (see the module docstring). Returns each path's launch counts and
    timings and the profile runs."""
    import contextlib
    import functools
    import io
    import os

    from autodriver_pointcloud_preprocessor_tpu_torch import cli
    from autodriver_pointcloud_preprocessor_tpu_torch.core import (
        Time, pointcloud_to_dict, read_points, soa_to_structured,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.io.compressor import (
        PointcloudCompressorNode, decompress_soa,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.io.loader import PointcloudLoader
    from autodriver_pointcloud_preprocessor_tpu_torch.io.pcd import write_point_cloud
    from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.linalg import se3_matrix
    from autodriver_pointcloud_preprocessor_tpu_torch.parallel import PointcloudConcatenatorNode
    from autodriver_pointcloud_preprocessor_tpu_torch.runtime import (
        Parameter, PointcloudPreprocessorNode, TopicBus,
    )

    launches, timings, profile = {}, {}, []
    counts = lambda: tuple(_build.LAUNCHES[k] for k in KERNELS)  # noqa: E731
    tf = se3_matrix(*NODE_TF).numpy()
    scans = WARMUP + TIMED

    def make_node(name, bus, device=None, **overrides):
        """A production node with the static TF on its buffer and a
        subscriber (the 0-subscriber short-circuit would skip every scan)."""
        node = PointcloudPreprocessorNode(
            node_name=name, bus=bus, device=device,
            pipelined=overrides.pop("pipelined", False),
            overrides={**production_cfg, "robot_frame": "base_link", **overrides})
        node.tf_buffer.set_transform("base_link", "velodyne", matrix=tf)
        outs = []
        bus.create_subscription(node.output_topic, outs.append)
        return node, outs

    def drive_node(tag, node, bus, msgs, outs, published):
        """Every message through ``node.callback`` via the bus; the counts
        are set to 0 just before and read just after, and each callback
        must launch K1/K2/K3 1/1/2 times. Returns the callback ms (host
        clock; ``to_soa`` has synchronised) and the processing_times of
        the timed callbacks."""
        pub = bus.create_publisher(node.input_topic)
        cb_ms, times = [], []
        _build.reset_launches()
        for i, msg in enumerate(msgs):
            before = counts()
            w0 = time.perf_counter()
            pub.publish(msg)
            w1 = time.perf_counter()
            got = tuple(a - b for a, b in zip(counts(), before))
            check(got == NODE_LAUNCHES, f"({tag}) callback {i}: launches {got}, expected {NODE_LAUNCHES}")
            check(len(outs) == published(i), f"({tag}) callback {i}: {len(outs)} clouds published")
            if i >= WARMUP:
                cb_ms.append((w1 - w0) * 1e3)
                times.append(dict(node.processing_times))
        launches[tag] = dict(zip(KERNELS, counts()))
        check(counts() == tuple(len(msgs) * c for c in NODE_LAUNCHES),
              f"({tag}) launches {counts()} in {len(msgs)} callbacks")
        return cb_ms, times

    def report(tag, cb_ms, times, note=""):
        p50, p90 = float(np.median(cb_ms)), float(np.percentile(cb_ms, 90))
        # the pipelined node's engine records no tensor_transfer and no
        # device_to_host (process_soa_async), as the reference's
        keys = {k: float(np.median([t[k] for t in times])) * 1e3 for k in NODE_TIME_KEYS
                if k in times[0]}
        timings[tag] = {"p50_ms": p50, "p90_ms": p90, "callbacks": len(cb_ms),
                        "processing_times_p50_ms": keys}
        print(f"[chip_smoke] ({tag}) callback ms p50 {p50:.3f}, p90 {p90:.3f} (host clock around "
              f"publish, {len(cb_ms)} timed){note}; processing_times p50 ms "
              f"{json.dumps({k: round(v, 3) for k, v in keys.items()})}")

    # ---- (t) the node at full width ---------------------------------------
    t0 = time.perf_counter()
    msgs = [velodyne_msg(i, 100.0 + 0.1 * i) for i in range(scans)]
    bus_t = TopicBus()
    node, outs = make_node("node", bus_t)
    check(node.engine.device == dev, f"the node's engine runs on {node.engine.device}, not {dev}")
    check(node.use_gpu is False, "use_gpu defaults to True")
    cb_ms, times = drive_node("node", node, bus_t, msgs, outs, lambda i: i + 1)
    check(node.frame_count == len(msgs) == len(outs),
          f"(t) {node.frame_count} frames for {len(msgs)} messages ({len(outs)} published)")
    check(set(NODE_TIME_KEYS) <= set(node.processing_times),
          f"(t) processing_times keys {sorted(node.processing_times)}")
    check(all(o.header.frame_id == "base_link" for o in outs), "(t) header frame not overridden")
    # a lone engine with the same seed and TF, on the same inputs in order
    lone = Preprocessor(production_cfg)
    lone.set_tf_matrix(node.camera_to_robot_tf)
    sizes = []
    for i, (msg, out) in enumerate(zip(msgs, outs)):
        soa, meta = pointcloud_to_dict(msg)
        want, meta = lone.process_soa(soa, meta)
        n = want["positions"].shape[0]
        check(0 < n < 50_000 and want["normals"].shape == (n, 3), f"(t) scan {i}: {n} survivors")
        check(soa_to_structured(want, meta, node.new_dtype, include_normals=True).tobytes() == out.data,
              f"(t) callback {i}: the published cloud differs from the lone Preprocessor's")
        sizes.append(n)
    report("node", cb_ms, times, f", survivors {min(sizes)}..{max(sizes)}, every cloud byte-equal to a "
           f"lone Preprocessor's; {node.frame_count} frames for {len(msgs)} messages")
    pub_t = bus_t.create_publisher(node.input_topic)
    profile.append(("node: 5 callbacks (static TF)", lambda: [pub_t.publish(m) for m in msgs[:5]]))

    # the same messages with the TF looked up and installed on every scan
    bus_d = TopicBus()
    node_d, outs_d = make_node("node_dynamic_tf", bus_d, static_camera_to_robot_tf=False)
    cb_ms, times = drive_node("node_dynamic_tf", node_d, bus_d, msgs, outs_d, lambda i: i + 1)
    check([o.data for o in outs_d] == [o.data for o in outs], "(t) dynamic TF changed the clouds")
    report("node_dynamic_tf", cb_ms, times, ", clouds byte-equal to the static TF's")
    w0 = time.perf_counter()
    for _ in range(50):
        node_d.engine.set_tf_matrix(tf)
    torch.cuda.synchronize()
    set_tf_ms = (time.perf_counter() - w0) * 1e3 / 50
    timings["node_dynamic_tf"]["set_tf_matrix_ms"] = set_tf_ms
    print(f"[chip_smoke] (t) Preprocessor.set_tf_matrix: {set_tf_ms:.4f} ms a call (host clock, 50 calls)")

    # pipelined: the same clouds one callback later, flush publishes the last
    bus_p = TopicBus()
    node_p, outs_p = make_node("node_pipelined", bus_p, pipelined=True)
    cb_ms, times = drive_node("node_pipelined", node_p, bus_p, msgs, outs_p, lambda i: i)
    node_p.flush_pipeline()
    torch.cuda.synchronize()
    check(len(outs_p) == len(msgs) and node_p.frame_count == len(msgs),
          f"(t) pipelined: {len(outs_p)} clouds, {node_p.frame_count} frames for {len(msgs)} messages")
    check([o.data for o in outs_p] == [o.data for o in outs], "(t) pipelined clouds differ")
    report("node_pipelined", cb_ms, times, ", clouds byte-equal to the node's, one callback later")
    pub_p = bus_p.create_publisher(node_p.input_topic)
    profile.append(("node pipelined: 5 callbacks", lambda: [pub_p.publish(m) for m in msgs[:5]]))

    # one message on a CPU node and on a fresh card node with the same
    # RANSAC draws: each generator's own draws move up to ~4% of this
    # scene's survivors (the plane refit on another inlier set), which
    # says nothing of the port
    settings = node.engine.settings
    draws = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(settings.num_iterations, settings.ransac_n)).astype(np.float32))
    same_draws = {}
    for name, device in (("node_card", None), ("node_cpu", "cpu")):
        bus_x = TopicBus()
        node_x, outs_x = make_node(name, bus_x, device=device)
        node_x.engine.process_buffer = functools.partial(
            node_x.engine.process_buffer, ground_uniforms=draws.to(node_x.engine.device))
        t1 = time.perf_counter()
        bus_x.create_publisher(node_x.input_topic).publish(msgs[0])
        check(node_x.frame_count == 1, f"(t) {name} dropped the message")
        same_draws[name] = (outs_x[0], time.perf_counter() - t1)

    def survivors(msg):
        pts = read_points(msg)
        return survivor_normals({
            "positions": np.stack([pts["x"], pts["y"], pts["z"]], 1),
            "normals": np.stack([pts["normal_x"], pts["normal_y"], pts["normal_z"]], 1)})

    a, c = survivors(same_draws["node_card"][0]), survivors(same_draws["node_cpu"][0])
    cpu_s = same_draws["node_cpu"][1]
    common = a.keys() & c.keys()
    j = len(common) / max(len(a.keys() | c.keys()), 1)
    cos = np.array([abs(float(np.dot(a[p], c[p]))) for p in common])
    normals_ok = float((cos >= np.cos(np.deg2rad(2.0))).mean()) if len(cos) else 0.0
    check(j >= 0.99 and normals_ok >= 0.98,
          f"(t) card vs CPU node: jaccard {j:.5f}, normals within 2 deg {normals_ok:.5f}")
    print(f"[chip_smoke] (t) card vs CPU node (the same RANSAC draws): survivors {len(a)} vs {len(c)}, "
          f"jaccard {j:.5f}, normals within 2 deg {normals_ok:.5f} (CPU callback {cpu_s:.1f} s) "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- (u) the three-sensor graph at full width --------------------------
    t0 = time.perf_counter()
    ext = {f"/lidar{i}/processed": se3_matrix(
        (GRAPH_SPACING * i, 0.0, 0.0), (0.0, 0.0, float(np.sin(np.pi * i / 3)), float(np.cos(np.pi * i / 3)))
    ).numpy() for i in range(GRAPH_SENSORS)}
    bus_u = TopicBus()
    nodes = [PointcloudPreprocessorNode(
        node_name=f"pre_{i}", parameter_namespace=f"lidar{i}", bus=bus_u,
        overrides={**production_cfg, "input_topic": f"/lidar{i}/points",
                   "output_topic": f"/lidar{i}/processed"}) for i in range(GRAPH_SENSORS)]
    concat = PointcloudConcatenatorNode(bus_u, list(ext), output_topic="/merged", extrinsics=ext,
                                        mode="sync", slop=0.05)
    check(concat.device == dev and all(e.device == dev for e in concat.extrinsics.values()),
          f"the concatenator runs on {concat.device}")
    comp = PointcloudCompressorNode(bus_u, "/merged", "/merged/compressed")
    merged, blobs = [], []
    bus_u.create_subscription("/merged", merged.append)
    bus_u.create_subscription("/merged/compressed", blobs.append)
    pubs = [bus_u.create_publisher(f"/lidar{i}/points") for i in range(GRAPH_SENSORS)]
    graph_msgs = [velodyne_msg(100 + i, 0.0, frame=f"lidar{i}") for i in range(GRAPH_SENSORS)]

    def graph_round(r):
        """One round: each sensor's message (stamps within the slop), the
        engines reseeded so that a round repeats the last one exactly.
        Returns (host ms, the nodes' output counts)."""
        for n in nodes:
            n.engine.generator.manual_seed(0)
        for i, msg in enumerate(graph_msgs):
            msg.header.stamp = Time.from_float(10.0 + r + 0.01 * i)
        frames = concat.frame_count
        w0 = time.perf_counter()
        for pub, msg in zip(pubs, graph_msgs):
            pub.publish(msg)
        ms = (time.perf_counter() - w0) * 1e3
        check(concat.frame_count == frames + 1 and comp.frame_count == len(blobs) == frames + 1,
              f"(u) round {r}: {concat.frame_count - frames} merged frames")
        return ms, [read_points(n.latest_output).shape[0] for n in nodes]

    def check_round(r, sizes):
        pts = read_points(merged[-1])
        check(pts.shape[0] == sum(sizes), f"(u) round {r}: merged {pts.shape[0]} != {sum(sizes)}")
        start = 0
        for i, n in enumerate(sizes):
            seg = pts[start:start + n]
            d = np.hypot(seg["x"] - GRAPH_SPACING * i, seg["y"])
            check(n > 0 and float(d.max()) < 90.0, f"(u) round {r}: sensor {i}'s survivors leave its region")
            start += n
        soa = decompress_soa(blobs[-1].data)
        check(soa["positions"].shape[0] == pts.shape[0], "(u) the blob's count differs from the merge")

    round_ms, sizes0 = [], None
    _build.reset_launches()
    for r in range(WARMUP + GRAPH_ROUNDS):
        before = counts()
        ms, sizes = graph_round(r)
        got = tuple(a - b for a, b in zip(counts(), before))
        want = tuple(GRAPH_SENSORS * c for c in NODE_LAUNCHES)
        check(got == want, f"(u) round {r}: launches {got}, expected {want}")
        check_round(r, sizes)
        check(sizes0 is None or sizes == sizes0, f"(u) round {r}: counts {sizes} != {sizes0}")
        sizes0 = sizes
        if r >= WARMUP:
            round_ms.append(ms)
    launches["graph3"] = dict(zip(KERNELS, counts()))
    # the card concatenator against a CPU one on the same three messages
    cpu_bus = TopicBus()
    cpu_concat = PointcloudConcatenatorNode(cpu_bus, list(ext), output_topic="/merged", extrinsics=ext,
                                            mode="sync", slop=0.05, device="cpu")
    cpu_merged = []
    cpu_bus.create_subscription("/merged", cpu_merged.append)
    for topic, node in zip(ext, nodes):
        cpu_bus.create_publisher(topic).publish(node.latest_output)
    check(cpu_concat.frame_count == 1 and cpu_merged[0].data == merged[-1].data,
          "(u) the card concatenator's merge is not bit-equal to the CPU one's")
    # a live voxel_size reconfigure of one node: its count moves, not the others'
    res = nodes[1].set_parameters([Parameter("lidar1.voxel_size", 0.3)])
    check(res[0].successful, f"(u) reconfigure refused: {res[0].reason}")
    _, sizes = graph_round(WARMUP + GRAPH_ROUNDS)
    check_round("reconfigured", sizes)
    check(sizes[1] < sizes0[1] and sizes[0] == sizes0[0] and sizes[2] == sizes0[2],
          f"(u) after lidar1.voxel_size=0.3: counts {sizes0} -> {sizes}")
    p50, p90 = float(np.median(round_ms)), float(np.percentile(round_ms, 90))
    timings["graph3"] = {"p50_ms": p50, "p90_ms": p90, "rounds": len(round_ms)}
    print(f"[chip_smoke] (u) three production nodes -> sync concatenator on the card -> compressor: "
          f"{GRAPH_ROUNDS} timed rounds of {GRAPH_SENSORS} x {N_POINTS} points, 1 merged frame each, "
          f"launches {json.dumps(launches['graph3'])} "
          f"({tuple(GRAPH_SENSORS * c for c in NODE_LAUNCHES)} a round), counts {sizes0} (sum = merged), each "
          f"sensor in its region; card merge bit-equal to the CPU concatenator's; lidar1.voxel_size=0.3 "
          f"-> counts {sizes}; ms a round p50 {p50:.3f}, p90 {p90:.3f} (host clock, publish to blob) "
          f"({time.perf_counter() - t0:.1f} s)")
    profile.append(("graph3: 2 rounds", lambda: [graph_round(100 + r) for r in range(2)]))

    # ---- (v) the CLI on the card ---------------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        src, out_cli, out_node = (os.path.join(tmp, d) for d in ("in", "cli", "node"))
        os.makedirs(src)
        for i in range(3):
            write_point_cloud(os.path.join(src, f"{i:04d}.pcd"), bench_soa(200 + i))
        params = os.path.join(tmp, "production.json")
        with open(params, "w") as f:
            json.dump(production_cfg, f)
        _build.reset_launches()
        w0 = time.perf_counter()
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cli.preprocessor_main([src, "-o", out_cli, "--params", params])
        cli_s = time.perf_counter() - w0
        check(rc == 0 and counts() == tuple(3 * c for c in NODE_LAUNCHES),
              f"(v) preprocessor_main: rc {rc}, launches {counts()} for 3 scans")
        launches["cli"] = dict(zip(KERNELS, counts()))
        # the node on the same files, saving what it publishes
        bus_v = TopicBus()
        node_v = PointcloudPreprocessorNode(bus=bus_v, overrides={
            **production_cfg, "save_pointcloud": True, "pointcloud_save_directory": out_node})
        bus_v.create_subscription(node_v.output_topic, lambda m: None)
        pub_v = bus_v.create_publisher(node_v.input_topic)
        for msg in PointcloudLoader(src, rate_hz=0).scans():
            pub_v.publish(msg)
        check(node_v.frame_count == 3, f"(v) the node published {node_v.frame_count} of 3 scans")
        files = sorted(os.listdir(out_cli))
        check(files == sorted(os.listdir(out_node)) == [f"{i:08d}.pcd" for i in range(3)],
              f"(v) files {files} vs {sorted(os.listdir(out_node))}")
        for name in files:
            with open(os.path.join(out_cli, name), "rb") as a, open(os.path.join(out_node, name), "rb") as b:
                check(a.read() == b.read(), f"(v) {name}: the CLI's output differs from the node's")
        print(f"[chip_smoke] (v) preprocessor_main (no --device) on 3 PCD files of {N_POINTS} points: "
              f"{stdout.getvalue().strip()!r} in {cli_s:.2f} s, launches {json.dumps(launches['cli'])}, "
              f"files byte-equal to the node's")
    stdout = io.StringIO()
    w0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = cli.warmup_main(["--preset", "production_128k", "--buckets", str(CAPACITY)])
    lines = stdout.getvalue().strip().splitlines()
    check(rc == 0 and any(ln.startswith(f"warmup bucket {CAPACITY}:") for ln in lines)
          and lines[-1].startswith(f"warmed {CAPACITY} in"), f"(v) warmup_main: rc {rc}, {lines}")
    for ln in lines:
        print(f"[chip_smoke] (v) warmup_main: {ln}")
    print(f"[chip_smoke] (v) warmup_main {time.perf_counter() - w0:.2f} s ({time.perf_counter() - t0:.1f} s)")
    return {"launches": launches, "timings": timings, "profile": profile,
            "round": {"run": graph_round, "concat": concat, "merged": merged}}


# ---- the sharded pipeline: config 6 over 4 ranks (phase (w)) --------------

#: ranks sharing cuda:0 through gloo, the halo, steps
SHARD_WORLD, SHARD_HALO = 4, 512
SHARD_WARMUP, SHARD_TIMED = 3, 10
#: the production-slab protocol (tests/test_parallel.py:601-643) and the
#: backend check's step: 131,072 rows
SLAB_CAPACITY = 131_072
#: the outlier-only window stage: its keep-mask is the kNN-mean class
SLAB_SETTINGS = dict(
    remove_duplicates=False, crop_to_roi=False, voxel_downsample=False, estimate_normals=False,
    remove_statistical_outliers=True, nb_neighbors=8, knn_method="window",
)
#: K1, K2, K3 launches a sharded config-6 step on each rank: no pre-voxel
#: bucket (the reference's local run has none), one K2 launch for the 4
#: voxel channels, both neighbourhood passes
SHARD_LAUNCHES = (0, 1, 2)


def slab_scene() -> np.ndarray:
    """tests/test_parallel.py's production-slab scene at 131,072 rows: ~94%
    fill, 80% ground over +-10 m, one object at 2 m."""
    r = np.random.default_rng(0)
    n = SLAB_CAPACITY - SLAB_CAPACITY // 16
    n_ground = int(n * 0.8)
    ground = np.column_stack([r.uniform(-10, 10, (2, n_ground)).T, r.normal(0, 0.02, n_ground)])
    obj = r.normal([0, 0, 2.0], 0.4, (n - n_ground, 3))
    return np.vstack([ground, obj]).astype(np.float32)


def rank_draws(rank: int, world: int) -> np.ndarray:
    """Rank ``rank``'s RANSAC draws, [64 // world, 3]: the same on the card
    and on the CPU."""
    return np.random.default_rng(60 + rank).uniform(size=(64 // world, 3)).astype(np.float32)


class ShardRank:
    """One rank of a phase-(w) world: its device, mesh and outputs."""

    def __init__(self, rank, world, device, out_dir):
        from autodriver_pointcloud_preprocessor_tpu_torch.parallel import sharding as sh

        self.sh, self.rank, self.world, self.out_dir = sh, rank, world, out_dir
        self.dev = torch.device(device)
        self.mesh = sh.make_mesh()
        self.group = self.mesh.get_group("point")
        self.info, self.arrays = {"rank": rank}, {}

    def gathered(self, t: torch.Tensor) -> np.ndarray:
        """Every rank's ``t`` on a leading rank axis (bool travels as int32)."""
        parts = self.sh._all_gather(t.to(torch.int32) if t.dtype == torch.bool else t, self.group)
        return torch.stack(parts).cpu().numpy()

    def save_output(self, tag, local, plane):
        """Rank 0 keeps the gathered buffer and the plane of ``tag``."""
        full = self.sh.unshard_buffer(local, self.mesh)
        if self.rank == 0:
            self.arrays.update({
                f"{tag}_pos": full.positions.cpu().numpy(), f"{tag}_mask": full.mask.cpu().numpy(),
                f"{tag}_plane": plane.cpu().numpy()})
            if "normals" in full.attributes:
                self.arrays[f"{tag}_normals"] = full.attributes["normals"].cpu().numpy()

    def write(self):
        import os

        with open(os.path.join(self.out_dir, f"rank{self.rank}.json"), "w") as f:
            json.dump(self.info, f)
        if self.rank == 0:
            np.savez(os.path.join(self.out_dir, "rank0.npz"), **self.arrays)


def config6_step_inputs(r: ShardRank):
    """The replicated config-6 input on ``r``'s device, settings, params and
    the rank's draws."""
    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        PipelineParams, PipelineSettings,
    )

    buf, _ = from_soa({"positions": scene(CONFIG6_POINTS)}, capacity=CONFIG6_CAPACITY, device=r.dev)
    settings = PipelineSettings(**CONFIG6_SETTINGS)
    params = PipelineParams.make(**CONFIG6_PARAMS, device=r.dev)
    draws = torch.from_numpy(rank_draws(r.rank, r.world)).to(r.dev)
    return buf, settings, params, draws


def shard_job_card(r: ShardRank, profile_dir=None):
    """Config 6 over the world on cuda:0: warm-up and timed steps with every
    check, the live counts ahead of the shrink, K2 and K3 at their sharded
    shapes against their plain versions and timed (rank 0), the
    production-slab agreement, and with ``profile_dir`` one traced step."""
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        PipelineParams, PipelineSettings, build_pipeline,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import voxel as voxel_mod
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import window as window_mod
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.segmean import (
        run_ids, segmented_sums, segmented_sums_plain,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.window_stats import (
        window_stats, window_stats_plain,
    )

    sh = r.sh
    buf, settings, params, draws = config6_step_inputs(r)
    run = sh.build_sharded_pipeline(settings, r.mesh, "point", SHARD_HALO)
    check(not sh.captures_step(r.group, r.dev), "(w) a gloo step would capture")

    def step():
        out, plane = run(sh.shard_buffer(buf, r.mesh), params, None, draws)
        return out, plane

    times, steps = [], SHARD_WARMUP + SHARD_TIMED
    coll = []
    _build.reset_launches()
    for i in range(steps):
        torch.cuda.synchronize()
        torch.distributed.barrier()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        sh.reset_collectives()
        start.record()
        local = sh.shard_buffer(buf, r.mesh)
        out, plane = run(local, params, None, draws)
        end.record()
        torch.cuda.synchronize()
        coll.append(dict(sh.COLLECTIVES))
        if i >= SHARD_WARMUP:
            times.append(start.elapsed_time(end))
        live_in, live_out = int(local.mask.sum()), int(out.mask.sum())
        check(0 < live_out <= live_in, f"(w) rank {r.rank} step {i}: {live_out} live of {live_in}")
        planes = r.gathered(plane)
        check(bool((planes == planes[0]).all()) and abs(float(planes[0][2])) > 0.99,
              f"(w) rank {r.rank} step {i}: planes {planes.tolist()}")
        lens = out.attributes["normals"].norm(dim=0)[out.mask]
        check(bool(((lens - 1.0).abs() < 1e-3).all()), f"(w) rank {r.rank} step {i}: normals not unit")
    launches = tuple(_build.LAUNCHES[k] for k in KERNELS)
    want = tuple(steps * c for c in SHARD_LAUNCHES)
    check(launches == want, f"(w) rank {r.rank}: launches {launches} in {steps} steps, expected {want}")
    r.info.update(times=times, launches=launches, collectives=coll[-1], live_in=live_in,
                  live_out=live_out, capacity_out=out.capacity)
    r.save_output("config6", out, plane)

    # the live count ahead of the shrink, stage by stage, with K2's and
    # K3's inputs recorded on the way
    seen = {"k2": [], "k3": []}
    real_k2, real_k3 = voxel_mod.segmented_sums, window_mod.window_stats

    def spy_k2(values, flags):
        seen["k2"].append((values, flags))
        return real_k2(values, flags)

    def spy_k3(*rows, **kw):
        seen["k3"].append((rows, kw))
        return real_k3(*rows, **kw)

    voxel_mod.segmented_sums, window_mod.window_stats = spy_k2, spy_k3
    try:
        b = sh.shard_buffer(buf, r.mesh)
        for name, fn in sh._local_stages(settings, sh._Axis.of(r.mesh, "point"), SHARD_HALO):
            if name == "shrink":
                r.info["pre_shrink_live"] = int(b.mask.sum())
            b, _ = fn(b, params, None, draws, None)
    finally:
        voxel_mod.segmented_sums, window_mod.window_stats = real_k2, real_k3
    share = -(-settings.post_downsample_capacity // r.world)
    share = -(-share // 512) * 512
    r.info.update(share=share, cap_engaged=r.info["pre_shrink_live"] > share)
    check(len(seen["k2"]) == 1 and len(seen["k3"]) == 2,
          f"(w) rank {r.rank}: {len(seen['k2'])} K2 and {len(seen['k3'])} K3 calls in a step")

    if r.rank == 0:  # K2 and K3 at this rank's shapes: kernel, plain, library, bound
        vals, flags = seen["k2"][0]
        got = segmented_sums(vals, flags).cpu()
        ref = segmented_sums_plain(vals.cpu(), flags.cpu())
        check(torch.equal(bits(got), bits(ref)), "(w) K2 at the sharded shapes is not bit-equal to plain")
        km, pm = interleaved_ms(lambda: segmented_sums(vals, flags),
                                lambda: segmented_sums_plain(vals, flags), reps=10)
        n2 = vals.shape[-1]
        ids = run_ids(flags)
        lib = event_ms(lambda: torch.zeros_like(vals).index_add_(1, ids, vals), 10)
        bms, by = bound(*k2_work(vals, flags))
        r.info["k2"] = dict(ms=km, plain_ms=pm, library_ms=lib, bound_ms=bms, bound_by=by,
                            max_abs_err=float((got - ref).abs().max()),
                            shapes=f"{vals.shape[0]} x {n2}")
        k3_km = k3_pm = nbytes = flops = err = 0.0
        shapes = []
        for p, (rows, kw) in enumerate(seen["k3"]):
            xyzv, radius = rows[:4], rows[4]
            kw = {k: v for k, v in kw.items() if k != "radius2" or v is not None}
            err = max(err, check_k3_plain(f"sharded pass {p}", window_stats(*xyzv, radius, **kw),
                                          xyzv, kw, radius))
            r2 = (radius ** 2).reshape(1)
            km, pm = interleaved_ms(
                lambda: window_stats(*xyzv, radius, **kw),
                lambda: window_stats_plain(*xyzv, r2, kw["k"], kw["window_blocks"], kw["kmode"],
                                           kw["direction"], kw["moments"]),
                reps=3)
            mom0 = window_stats(*xyzv, radius, **kw)[2][0]
            bb, ff = k3_work(xyzv, kw["k"], kw["window_blocks"], kw["direction"], kw["moments"], mom0,
                             kmode=kw["kmode"])
            nbytes, flops, k3_km, k3_pm = nbytes + bb, flops + ff, k3_km + km, k3_pm + pm
            shapes.append(f"{xyzv[0].shape[-1]} rows wb={kw['window_blocks']} {kw['kmode']} "
                          f"direction {kw['direction']}")
        bms, by = bound(nbytes, flops)
        r.info["k3"] = dict(ms=k3_km, plain_ms=k3_pm, library_ms=None, bound_ms=bms, bound_by=by,
                            max_abs_err=err, shapes=", ".join(shapes))
    torch.distributed.barrier()

    if profile_dir:  # one traced step on rank 0 (every rank runs it)
        import os

        if r.rank == 0:
            profile_runs([("sharded config 6: 1 step, rank 0 of 4", step)], r.dev,
                         os.path.join(profile_dir, "sharded"))
        else:
            for _ in range(2):  # profile_runs' untraced call and its traced one
                step()
                torch.cuda.synchronize()

    # the production-slab protocol: keep-masks against the unsharded
    # port's in the same (spatially sorted) frame
    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa

    sbuf, _ = from_soa({"positions": slab_scene()}, capacity=SLAB_CAPACITY, device=r.dev)
    ssettings = PipelineSettings(**SLAB_SETTINGS)
    sparams = PipelineParams.make(std_ratio=1.0, device=r.dev)
    masks = {}
    for halo in (0, SHARD_HALO):
        srun = sh.build_sharded_pipeline(ssettings, r.mesh, "point", halo)
        masks[halo] = sh.unshard_buffer(srun(sh.shard_buffer(sbuf, r.mesh), sparams)[0], r.mesh).mask
    if r.rank == 0:
        sorted_buf = sh.spatial_sort(sbuf)
        single = build_pipeline(ssettings)(sorted_buf, sparams, None)[0].mask
        live = sorted_buf.mask
        r.info["slab_agree"] = {h: float((single == m)[live].float().mean()) for h, m in masks.items()}


def shard_job_cpu(r: ShardRank, profile_dir=None):
    """One config-6 step with the same draws on CPU ranks (plain versions)."""
    buf, settings, params, draws = config6_step_inputs(r)
    run = r.sh.build_sharded_pipeline(settings, r.mesh, "point", SHARD_HALO)
    out, plane = run(r.sh.shard_buffer(buf, r.mesh), params, None, draws)
    r.save_output("config6", out, plane)


def shard_job_backend(r: ShardRank, profile_dir=None):
    """Config 6's settings on the 131,072-row slab scene, one rank a card,
    fixed draws: the step the NCCL and gloo worlds both run."""
    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        PipelineParams, PipelineSettings,
    )

    buf, _ = from_soa({"positions": slab_scene()}, capacity=SLAB_CAPACITY, device=r.dev)
    run = r.sh.build_sharded_pipeline(PipelineSettings(**CONFIG6_SETTINGS), r.mesh, "point",
                                      SHARD_HALO)
    params = PipelineParams.make(**CONFIG6_PARAMS, device=r.dev)
    draws = torch.from_numpy(rank_draws(r.rank, r.world)).to(r.dev)
    out, plane = run(r.sh.shard_buffer(buf, r.mesh), params, None, draws)
    r.info["backend"] = torch.distributed.get_backend()
    r.save_output("slab", out, plane)


def shard_job_captured(r: ShardRank, profile_dir=None, xla=False):
    """Config 6's step in an NCCL world, one rank a card:
    ``build_sharded_pipeline``'s captured step against ``make_local_run``'s
    eager body with the same draws, bit for bit (mask, positions,
    attributes, normals, plane), with the same launches and collectives a
    step (the replay's credited), on the capture's draws and on others;
    then both timed in turns (rank 0's CUDA events, a barrier before each
    step, the run alone on the sharded slab). ``xla``: the step with
    ``pallas_ok=False`` (the XLA window route: no K3)."""
    import dataclasses

    from autodriver_pointcloud_preprocessor_tpu_torch.models import graphs
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build

    sh = r.sh
    buf, settings, params, draws = config6_step_inputs(r)
    want_launches = SHARD_LAUNCHES
    if xla:
        settings = dataclasses.replace(settings, pallas_ok=False)
        want_launches = SHARD_LAUNCHES[:2] + (0,)
    check(sh.captures_step(r.group, r.dev), f"(w) NCCL rank {r.rank}: the step would not capture")
    step = sh.build_sharded_pipeline(settings, r.mesh, "point", SHARD_HALO)
    eager = sh.make_local_run(settings, "point", SHARD_HALO, r.mesh)
    local = sh.shard_buffer(buf, r.mesh)
    step_launches = [0] * len(KERNELS)

    def run_step(u):
        before = [_build.LAUNCHES[k] for k in KERNELS]
        out = step(local, params, None, u)
        for i, k in enumerate(KERNELS):
            step_launches[i] += _build.LAUNCHES[k] - before[i]
        return out

    def counted(fn, u):
        torch.cuda.synchronize()
        _build.reset_launches()
        sh.reset_collectives()
        out = fn(u)
        torch.cuda.synchronize()
        return out, tuple(_build.LAUNCHES[k] for k in KERNELS), dict(sh.COLLECTIVES)

    t0 = time.perf_counter()
    for i, u in enumerate((draws, draws.flip(0))):  # the capture and a replay, a replay on others
        got = counted(run_step, u)
        if i == 0:
            first_s = time.perf_counter() - t0
        want = counted(lambda u: eager(local, params, None, u), u)
        check(same_tree(got[0], want[0]),
              f"(w) NCCL rank {r.rank} of {r.world}: the captured step differs from the eager one")
        check(got[1] == want[1] == want_launches,
              f"(w) NCCL rank {r.rank}: launches captured {got[1]}, eager {want[1]}")
        check(got[2] == want[2], f"(w) NCCL rank {r.rank}: collectives {got[2]} vs {want[2]}")
    prog = graphs.programs()[-1]
    check(prog.replays == 2, f"(w) NCCL rank {r.rank}: {prog.replays} replays of the step's program")

    def timed(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            torch.distributed.barrier()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return out

    half = SHARD_TIMED // 2
    tg = timed(lambda: run_step(draws), half)
    te = timed(lambda: eager(local, params, None, draws), SHARD_TIMED)
    tg += timed(lambda: run_step(draws), SHARD_TIMED - half)
    if profile_dir and not xla:  # one traced step each way on rank 0 (every rank runs them)
        import os

        runs = [(f"sharded config 6 captured: 1 step, rank 0 of {r.world} NCCL",
                 lambda: run_step(draws)),
                (f"sharded config 6 eager: 1 step, rank 0 of {r.world} NCCL",
                 lambda: eager(local, params, None, draws))]
        if r.rank == 0:
            profile_runs(runs, r.dev, os.path.join(profile_dir, f"sharded_nccl{r.world}"))
        else:
            for _, fn in runs:
                for _ in range(2):  # profile_runs' untraced call and its traced one
                    fn()
                    torch.cuda.synchronize()
    if r.rank == 0:  # at once: the world's later collectives and teardown can still fail
        print(f"[chip_smoke] (w) NCCL rank 0 of {r.world}: captured p50/p90 "
              f"{p50_p90(tg)} ms, eager {p50_p90(te)} ms", flush=True)
    r.info["captured"] = dict(
        captured_ms=tg, eager_ms=te, capture_ms=prog.capture_ms, first_call_s=first_s,
        pool_mb=prog.pool_bytes / 2**20, launches_a_step=got[1], collectives_a_step=got[2],
        launches=step_launches, live_out=int(got[0][0].mask.sum()), capacity=local.capacity)
    r.save_output("captured", *got[0])


SHARD_JOBS = {"card": shard_job_card, "cpu": shard_job_cpu, "backend": shard_job_backend,
              "captured": shard_job_captured,
              "captured_xla": lambda r, profile_dir=None: shard_job_captured(r, xla=True)}


def shard_rank(rank, world, backend, device, store, out_dir, job, profile_dir):
    """Entry of one spawned rank: joins the world over ``backend`` (a
    ``file://`` store), runs ``SHARD_JOBS[job]`` on ``device`` ('{rank}'
    is the rank) and writes its outputs to ``out_dir``. A failed check
    exits non-zero, which fails the parent's join."""
    import datetime

    device = device.format(rank=rank)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(2)
    torch.distributed.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                         world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        r = ShardRank(rank, world, device, out_dir)
        SHARD_JOBS[job](r, profile_dir)
        r.write()
    finally:
        # a captured NCCL collective holds its communicator: drop the
        # programs before the group
        from autodriver_pointcloud_preprocessor_tpu_torch.models import graphs

        graphs.clear()
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        torch.distributed.destroy_process_group()


def spawn_world(job, world, backend, device, profile_dir=None):
    """Runs ``job`` on ``world`` spawned ranks; returns (every rank's info,
    rank 0's arrays, seconds). Any rank's failure raises here."""
    import os
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(shard_rank, args=(world, backend, device, os.path.join(tmp, "store"), tmp,
                                             job, profile_dir),
                           nprocs=world, join=True, start_method="spawn")
        infos = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                infos.append(json.load(f))
        with np.load(os.path.join(tmp, "rank0.npz")) as z:
            arrays = {k: z[k] for k in z.files}
    return infos, arrays, time.perf_counter() - t0


def sharded_slice(dev, profile_dir=None):
    """Phase 31 (w): config 6's merged cloud over 4 ranks (see the module
    docstring). Returns the path's launches, K2's and K3's numbers at the
    sharded shapes, and the timings."""
    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        PipelineParams, PipelineSettings, build_pipeline, stage_functions,
    )

    label = f"{SHARD_WORLD} ranks time-sharing one H100 through gloo"
    print(f"[chip_smoke] (w) config 6 sharded: {CONFIG6_POINTS:,} points at {CONFIG6_CAPACITY:,}, "
          f"{SHARD_WORLD} gloo ranks on cuda:0, {CONFIG6_CAPACITY // SHARD_WORLD:,} points a rank, "
          f"halo {SHARD_HALO}; pre_voxel_compact_capacity ignored (the reference's sharded local "
          f"run has no pre-voxel stage)")
    infos, arrays, secs = spawn_world("card", SHARD_WORLD, "gloo", "cuda:0", profile_dir)
    steps = SHARD_WARMUP + SHARD_TIMED
    times = infos[0]["times"]
    p50, p90 = float(np.median(times)), float(np.percentile(times, 90))
    for info in infos:
        print(f"[chip_smoke] (w) rank {info['rank']}: launches {info['launches']} in {steps} steps "
              f"({SHARD_LAUNCHES} a step), live {info['live_in']} in -> {info['pre_shrink_live']} "
              f"ahead of the shrink (share {info['share']}, cap engaged: {info['cap_engaged']}) -> "
              f"{info['live_out']} survivors of {info['capacity_out']} rows")
    coll = infos[0]["collectives"]
    print(f"[chip_smoke] (w) a step: {coll['calls']} collectives, {coll['bytes']} bytes put in by "
          f"each rank (rank 0's count)")
    print(f"[chip_smoke] (w) p50 {p50:.3f} ms a step, p90 {float(p90):.3f} (rank 0's CUDA events, "
          f"barrier before each, shard_buffer + run; {label}: not a scaling figure); "
          f"all {[round(t, 3) for t in times]}; world took {secs:.1f} s")
    agree = infos[0]["slab_agree"]
    print(f"[chip_smoke] (w) production slabs ({SLAB_CAPACITY:,} rows, {SHARD_WORLD} slabs of "
          f"{SLAB_CAPACITY // SHARD_WORLD:,}): keep-mask agreement with the unsharded port "
          f"{json.dumps(agree)} (halo 0 / {SHARD_HALO})")
    check(agree[str(SHARD_HALO)] >= 0.985, f"(w) slab agreement {agree} < 0.985 at halo {SHARD_HALO}")

    # against the unsharded port on the card (its own draws). A rank whose
    # voxels overflow its share keeps an unbiased subset of them (the
    # reference's documented per-shard cap; one device's bucket holds
    # them all): the voxel counts ahead of the shrink, and the survivors
    # against the unsharded survival rate applied to the voxels the caps
    # kept, agree within 15%; the planes within 1 degree
    settings6 = PipelineSettings(**CONFIG6_SETTINGS)
    params6 = PipelineParams.make(**CONFIG6_PARAMS, device=dev)
    u6 = torch.from_numpy(np.random.default_rng(6).uniform(
        size=(settings6.num_iterations, settings6.ransac_n)).astype(np.float32)).to(dev)
    buf6, _ = from_soa({"positions": scene(CONFIG6_POINTS)}, capacity=CONFIG6_CAPACITY, device=dev)
    single, splane = build_pipeline(settings6)(buf6, params6, None, u6)
    b = buf6
    for name, fn in stage_functions(settings6):
        b, _ = fn(b, params6, None, u6, None)
        if name == "voxel":
            break
    voxels_single = int(b.mask.sum())
    voxels = sum(i["pre_shrink_live"] for i in infos)
    kept = sum(min(i["pre_shrink_live"], i["share"]) for i in infos)
    ns, nm = int(single.mask.sum()), int(arrays["config6_mask"].sum())
    expected = ns * kept / voxels
    ps, pm = splane.cpu().numpy(), arrays["config6_plane"]
    angle = float(np.degrees(np.arccos(min(abs(float(np.dot(ps[:3], pm[:3]))), 1.0))))
    print(f"[chip_smoke] (w) sharded vs unsharded port on the card: voxels {voxels} vs "
          f"{voxels_single} ({abs(voxels - voxels_single) / voxels_single:.4f} apart), {kept} kept "
          f"by the per-rank caps; survivors {nm} vs {ns} ({abs(ns - nm) / ns:.4f} apart), "
          f"{expected:.0f} expected from the caps ({abs(nm - expected) / expected:.4f} apart); "
          f"planes {angle:.4f} degrees apart")
    check(abs(voxels - voxels_single) / voxels_single < 0.15,
          f"(w) sharded voxels {voxels} vs unsharded {voxels_single}: > 15% apart")
    check(abs(nm - expected) / expected < 0.15,
          f"(w) sharded survivors {nm} vs {expected:.0f} expected from the caps: > 15% apart")
    check(angle <= 1.0, f"(w) sharded plane {pm} vs unsharded {ps}: {angle:.3f} degrees")

    # the same 4-rank step on CPU ranks with the same draws
    _, cpu, cpu_secs = spawn_world("cpu", SHARD_WORLD, "gloo", "cpu")

    def survivors(a):
        m = a["config6_mask"]
        return survivor_normals({"positions": a["config6_pos"][:, m].T,
                                 "normals": a["config6_normals"][:, m].T})

    a, c = survivors(arrays), survivors(cpu)
    common = a.keys() & c.keys()
    j = len(common) / max(len(a.keys() | c.keys()), 1)
    cos = np.array([abs(float(np.dot(a[p], c[p]))) for p in common])
    normals_ok = float((cos >= np.cos(np.deg2rad(2.0))).mean()) if len(cos) else 0.0
    print(f"[chip_smoke] (w) card vs CPU ranks: survivors {len(a)} vs {len(c)}, jaccard {j:.5f}, "
          f"normals within 2 deg {normals_ok:.5f} (CPU world {cpu_secs:.1f} s)")
    check(j >= 0.99, f"(w) card vs CPU jaccard {j:.5f} < 0.99")
    check(normals_ok >= 0.98, f"(w) card vs CPU: only {normals_ok:.5f} of normals within 2 deg")

    # NCCL against gloo: a world of one rank a card, the same step
    n_cards = torch.cuda.device_count()
    worlds = {b: spawn_world("backend", n_cards, b, "cuda:{rank}") for b in ("nccl", "gloo")}
    (ni, na, nsec), (gi, ga, gsec) = worlds["nccl"], worlds["gloo"]
    check(ni[0]["backend"] == "nccl" and gi[0]["backend"] == "gloo", "(w) backends")
    same = all(np.array_equal(na[k].view(np.int32) if na[k].dtype == np.float32 else na[k],
                              ga[k].view(np.int32) if ga[k].dtype == np.float32 else ga[k])
               for k in na)
    print(f"[chip_smoke] (w) NCCL world of {n_cards} vs gloo world of {n_cards} on the "
          f"{SLAB_CAPACITY:,}-row step: bit-equal {same}, survivors {int(na['slab_mask'].sum())} "
          f"({nsec:.1f} s and {gsec:.1f} s)")
    if n_cards == 1:
        check(same, "(w) the NCCL world's output differs from the gloo world's")

    # the step as one captured program: NCCL worlds of one rank a card
    # (config 6's whole cloud on one card when there is one), and of 4
    # ranks on 4 cards; the gloo ranks above ran eagerly
    captured_runs, captured_launches = {}, [0] * len(KERNELS)
    for world in (sorted({n_cards, 4}) if n_cards >= 4 else [n_cards]):
        ci, _, csec = spawn_world("captured", world, "nccl", "cuda:{rank}", profile_dir)
        c0 = ci[0]["captured"]
        g50, g90 = p50_p90(c0["captured_ms"])
        e50, e90 = p50_p90(c0["eager_ms"])
        captured_runs[f"nccl_{world}"] = {
            "captured_ms": [g50, g90], "eager_ms": [e50, e90], "capture_ms": c0["capture_ms"],
            "first_call_s": c0["first_call_s"], "pool_mb": c0["pool_mb"],
            "points_a_rank": c0["capacity"], "collectives_a_step": c0["collectives_a_step"]}
        for info in ci:
            captured_launches = [a + b for a, b in zip(captured_launches, info["captured"]["launches"])]
        print(f"[chip_smoke] (w) captured step, NCCL world of {world} (one rank a card, "
              f"{c0['capacity']:,} points a rank): every rank bit-equal to its eager step on two "
              f"draws, launches {c0['launches_a_step']} a step both ways, collectives a step "
              f"{json.dumps(c0['collectives_a_step'])} both ways (credited by the replay); rank 0 "
              f"p50/p90 captured {g50:.3f}/{g90:.3f} ms, eager {e50:.3f}/{e90:.3f} ms (in turns, "
              f"{SHARD_TIMED} each); capture {c0['capture_ms']:.1f} ms (first call "
              f"{c0['first_call_s']:.2f} s), pool {c0['pool_mb']:.1f} MB; "
              f"{c0['live_out']} survivors on rank 0 ({csec:.1f} s)")
    if n_cards < 4:
        print(f"[chip_smoke] (w) the 4-rank NCCL world (one rank a card) did not run: "
              f"{n_cards} card(s) here")
    print(f"[chip_smoke] (w) the {SHARD_WORLD} gloo ranks on cuda:0 ran eagerly "
          f"(sharding.captures_step: gloo's collectives are host round trips)")
    return {
        "launches": {"sharded": dict(zip(KERNELS, (sum(i["launches"][k] for i in infos)
                                                   for k in range(len(KERNELS))))),
                     "sharded_captured": dict(zip(KERNELS, captured_launches))},
        "timings": {"sharded": {"p50_ms": p50, "p90_ms": p90, "steps": len(times), "label": label},
                    "sharded_captured": captured_runs},
        "kernels": {"segmented_sums": infos[0]["k2"], "window_stats": infos[0]["k3"]},
        "collectives": coll,
    }


# ---- captured programs: graphed against eager (phase (x)) -------------------

#: bench_suite.py config 6 under the reference's parameter names (the
#: engine's surface); phase (x) checks it gives ``CONFIG6_SETTINGS``
CONFIG6_NAMED = {
    "remove_statistical_outliers": True, "remove_statistical_outliers.nb_neighbors": 16,
    "estimate_normals": True, "estimate_normals.max_neighbors": 16, "remove_ground": True,
    "remove_ground.ransac_number": 3, "remove_ground.num_iterations": 64, "knn_method": "window",
    "remove_ground.before_voxel": True, "downsample.max_points": 409_600,
    "downsample.pre_voxel_capacity": 524_288, "voxel_size": 0.05,
    "remove_ground.distance_threshold": 0.12,
}


def same_tree(a, b) -> bool:
    """Bit-equality of two nested outputs (buffers, planes, lists), on the
    device."""
    from torch.utils._pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)

    def as_bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(as_bits(x), as_bits(y))
        for x, y in zip(la, lb))


def call_ms(fn, n: int) -> list:
    """Device ms of each of ``n`` calls of ``fn`` (CUDA events, a sync after
    each: one scan at a time)."""
    out = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def p50_p90(times) -> tuple:
    return float(np.median(times)), float(np.percentile(times, 90))


def trace_counts(fn) -> dict:
    """``event_counts`` of one call of ``fn`` under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return event_counts(prof.key_averages())


def profile_stage_paths(dev, production_cfg, counts):
    """Phase (x): production and config 2 in profile mode, one replayed
    program a stage, against the same stages run eagerly with the same
    draws, bit for bit with equal launches; the per-stage ms (the engine's
    ``processing_times``, median of ``TIMED`` scans) replayed and eager
    (``graphs.captures`` off), in turns."""
    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa
    from autodriver_pointcloud_preprocessor_tpu_torch.models import graphs
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        draw_uniforms, stage_functions,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build

    paths, launches = {}, {}
    graphs.clear()  # the engine phase's profile run captured these stages already
    for tag, cfg, soa in (("profile_production", production_cfg, bench_soa()),
                          ("profile_config2", CONFIG2, soa_positions())):
        t0 = time.perf_counter()
        engine = Preprocessor(cfg, profile=True, seed=0)
        s = engine.settings
        gu = torch.from_numpy(np.random.default_rng(7).uniform(
            size=(s.num_iterations, s.ransac_n)).astype(np.float32)).to(dev)
        buf, _ = from_soa(soa, capacity=CAPACITY, device=dev)
        stages = stage_functions(s, separate_stages=True)
        draws = draw_uniforms(s, (), CAPACITY, None, dev, gu)
        before = len(graphs.programs())
        for i in range(2):  # the captures, then the replays
            _build.reset_launches()
            got = engine.process_buffer(buf, gu)
            torch.cuda.synchronize()
            graphed = counts()
            _build.reset_launches()
            want, plane = buf, torch.full((4,), float("nan"), device=dev)
            for _, fn in stages:
                want, aux = fn(want, engine.params, None, *draws)
                plane = plane if aux is None else aux
            torch.cuda.synchronize()
            check(graphed == counts(), f"(x) {tag}: launches replayed {graphed}, eager {counts()}")
            check(same_tree(got, (want, plane)), f"(x) {tag}: a replay differs from the eager stages")
        check(len(graphs.programs()) - before == len(stages),
              f"(x) {tag}: {len(graphs.programs()) - before} programs for {len(stages)} stages")
        eager_engine = Preprocessor(cfg, profile=True, seed=0)
        captures = graphs.captures

        def stage_ms(eng, eager, n):
            graphs.captures = (lambda device: False) if eager else captures
            try:
                runs = []
                for _ in range(n):
                    eng.process_buffer(buf, gu)
                    runs.append(dict(eng.processing_times))
            finally:
                graphs.captures = captures
            return runs

        half = TIMED // 2
        rg = stage_ms(engine, False, half)
        re_ = stage_ms(eager_engine, True, TIMED)
        rg += stage_ms(engine, False, TIMED - half)
        keys = list(rg[0])
        per_stage = {k: [float(np.median([r[k] for r in rg])) * 1e3,
                         float(np.median([r[k] for r in re_])) * 1e3] for k in keys}
        paths[tag] = {"stage_ms_replayed_eager": per_stage, "stages": len(stages), "timed": TIMED}
        launches[f"graph_{tag}"] = graphed
        print(f"[chip_smoke] (x) {tag}: {len(stages)} stage programs, each replay bit-equal to the "
              f"stage run eagerly with the same draws, launches {json.dumps(graphed)} a scan both "
              f"ways; stage ms (median of {TIMED}, a sync after each) replayed / eager: "
              + ", ".join(f"{k} {a:.3f}/{b:.3f}" for k, (a, b) in per_stage.items())
              + f" ({time.perf_counter() - t0:.1f} s)")
    return paths, launches


def merge_round(round_handle):
    """Phase (x): the three-sensor round of phase (u) with the
    concatenator's merge replayed (its default on the card) and with the
    merge run eagerly, in turns: the merged clouds byte-equal, round ms
    p50 and p90 both ways, launches, graph launches and syncs of a round
    (torch.profiler)."""
    from autodriver_pointcloud_preprocessor_tpu_torch.models import graphs
    from autodriver_pointcloud_preprocessor_tpu_torch.parallel.concat import concatenate_buffers

    t0 = time.perf_counter()
    run, concat, merged = round_handle["run"], round_handle["concat"], round_handle["merged"]
    rounds = iter(range(1000, 2000))

    def one(eager):
        if eager:  # the instance's merge shadowed by the plain function
            concat._merge = concatenate_buffers
        try:
            ms, _ = run(next(rounds))
        finally:
            concat.__dict__.pop("_merge", None)
        return ms, merged[-1].data

    _, replayed = one(False)
    prog = graphs.programs()[-1]  # the merge runs after the three nodes' replays
    check(prog.credits == dict.fromkeys(KERNELS, 0) and prog.replays > 0,
          f"(x) the round's last program is not the merge's: credits {prog.credits}")
    _, eager = one(True)
    check(replayed == eager, "(x) the round's merged cloud replayed differs from the eager merge's")
    half = GRAPH_ROUNDS // 2
    tg = [one(False)[0] for _ in range(half)]
    te = [one(True)[0] for _ in range(GRAPH_ROUNDS)]
    tg += [one(False)[0] for _ in range(GRAPH_ROUNDS - half)]
    traced = {"replayed": trace_counts(lambda: one(False)), "eager": trace_counts(lambda: one(True))}
    row = {"round_ms_replayed": p50_p90(tg), "round_ms_eager": p50_p90(te),
           "capture_ms": prog.capture_ms, "pool_mb": prog.pool_bytes / 2**20, "traced": traced}
    print(f"[chip_smoke] (x) three-sensor round, the merge replayed vs eager: merged clouds "
          f"byte-equal; ms a round p50/p90 replayed {row['round_ms_replayed'][0]:.3f}/"
          f"{row['round_ms_replayed'][1]:.3f}, eager {row['round_ms_eager'][0]:.3f}/"
          f"{row['round_ms_eager'][1]:.3f} (host clock, publish to blob, {GRAPH_ROUNDS} each in "
          f"turns); a traced round {json.dumps(traced)}; merge capture {prog.capture_ms:.1f} ms, "
          f"pool {prog.pool_bytes / 2**20:.1f} MB ({time.perf_counter() - t0:.1f} s)")
    return row


def cache_bound(dev, production_cfg):
    """Phase (x), fault 15: the vmapped production program captured at B =
    1..16 on an empty cache. After each capture the pools of the cached
    programs stay within ``POOL_FRACTION`` of the card, the memory
    reserved since the start within that bound plus one program's pool,
    and every evicted program is gone (``programs()``, ``lookup``). Also
    whether dropping a program hands its pool back without
    ``torch.cuda.empty_cache``."""
    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa
    from autodriver_pointcloud_preprocessor_tpu_torch.models import graphs
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import draw_uniforms
    from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor

    t0 = time.perf_counter()
    engine = Preprocessor(production_cfg, seed=0)
    s = engine.settings
    scans = [from_soa(bench_soa(seed), capacity=CAPACITY, device=dev)[0] for seed in range(16)]
    u = torch.from_numpy(np.random.default_rng(5).uniform(
        size=(16, s.num_iterations, s.ransac_n)).astype(np.float32)).to(dev)

    def key_args(b):
        return (scans[:b], engine.params, draw_uniforms(s, (b,), CAPACITY, None, dev, u[:b]))

    # does a dropped program give its pool back by itself?
    graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved(dev)
    engine.process_batch(scans[:8], ground_uniforms=u[:8])
    r1 = torch.cuda.memory_reserved(dev)
    graphs.clear()
    r2 = torch.cuda.memory_reserved(dev)
    torch.cuda.empty_cache()
    r3 = torch.cuda.memory_reserved(dev)
    release = {"captured_mb": (r1 - r0) / 2**20, "after_drop_mb": (r2 - r0) / 2**20,
               "after_empty_cache_mb": (r3 - r0) / 2**20}

    print(f"[chip_smoke] (x) fault 15: a dropped B=8 program: reserved +{release['captured_mb']:.1f} "
          f"MB with it, +{release['after_drop_mb']:.1f} MB after dropping it, "
          f"+{release['after_empty_cache_mb']:.1f} MB after empty_cache")
    total = torch.cuda.mem_get_info(dev)[1]
    bound = graphs.POOL_FRACTION * total
    base = torch.cuda.memory_reserved(dev)
    print(f"[chip_smoke] (x) fault 15: B=1..16 vmapped production programs, bound "
          f"{bound / 2**20:.1f} MB ({graphs.POOL_FRACTION} of {total / 2**30:.1f} GiB)")
    progs, rows = {}, []  # weak: a reference here would keep an evicted pool alive
    for b in range(1, 17):
        engine.process_batch(scans[:b], ground_uniforms=u[:b])
        torch.cuda.synchronize()
        prog = graphs.lookup(("engine", "vmapped", s), key_args(b))
        check(prog is not None, f"(x) fault 15: no program at B={b}")
        progs[b] = weakref.ref(prog)
        cached = graphs.programs()
        held = sum(p.pool_bytes for p in cached)
        reserved = torch.cuda.memory_reserved(dev) - base
        gone = [k for k, ref in progs.items() if all(ref() is not q for q in cached)]
        row = {"b": b, "pool_mb": prog.pool_bytes / 2**20, "cached": len(cached),
               "held_mb": held / 2**20, "reserved_mb": reserved / 2**20, "evicted": gone,
               "evicted_alive": [k for k in gone if progs[k]() is not None]}
        rows.append(row)
        print(f"[chip_smoke] (x) fault 15: B={b} {json.dumps(row)}")
        for k in gone:
            check(graphs.lookup(("engine", "vmapped", s), key_args(k)) is None,
                  f"(x) fault 15: the evicted B={k} program is still found")
        check(held <= bound or len(cached) == 1,
              f"(x) fault 15: at B={b} the pools hold {held} bytes over the bound {bound:.0f}")
        check(reserved <= bound + prog.pool_bytes,
              f"(x) fault 15: at B={b} {reserved} bytes reserved, over the bound {bound:.0f} plus "
              f"the new pool {prog.pool_bytes}")
        del prog, cached
    print(f"[chip_smoke] (x) fault 15 took {time.perf_counter() - t0:.1f} s")
    graphs.clear()
    torch.cuda.empty_cache()
    return {"bound_mb": bound / 2**20, "steps": rows, "release": release}


def second_card(dev, production_cfg):
    """Phase (x), fault 14: with two cards or more, production engines on
    cuda:1 and on cuda:0 while cuda:0 is current, each graphed and eager
    on the same scan and draws: all four outputs bit-equal."""
    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        build_pipeline, draw_uniforms,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor
    from torch.utils._pytree import tree_map

    if torch.cuda.device_count() < 2:
        print(f"[chip_smoke] (x) fault 14 (an engine on cuda:1 while cuda:0 is current) did not "
              f"run: {torch.cuda.device_count()} card here")
        return None
    torch.cuda.set_device(dev)
    outs = {}
    for d in (dev, torch.device("cuda:1")):
        engine = Preprocessor(production_cfg, seed=0, device=d)
        s = engine.settings
        gu = torch.from_numpy(np.random.default_rng(7).uniform(
            size=(s.num_iterations, s.ransac_n)).astype(np.float32)).to(d)
        buf, _ = from_soa(bench_soa(), capacity=CAPACITY, device=d)
        graphed = [engine.process_buffer(buf, gu) for _ in range(2)]
        eager = build_pipeline(s)(buf, engine.params, None, *draw_uniforms(s, (), CAPACITY, None, d, gu))
        check(torch.cuda.current_device() == dev.index, "(x) fault 14: the current device moved")
        outs[str(d)] = tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                                (graphed[0], graphed[1], eager))
    a, b = outs.values()
    check(all(same_tree(x, y) for x, y in zip(a, b)) and same_tree(a[0], a[2]),
          "(x) fault 14: the engine on cuda:1 differs from the one on cuda:0")
    print("[chip_smoke] (x) fault 14: an engine on cuda:1 with cuda:0 current, graphed (capture and "
          "replay) and eager: bit-equal to the engine on cuda:0")
    return True


#: seconds the tracer's window stays open before and after a traced
#: replay (phase (x)): more than any skew of the card's clock against the
#: host's, which would cut device records off the window's ends
TRACE_MARGIN_S = 0.05
#: traced replays of each phase-(x) program, each held to its credits
TRACE_REPEATS = 3
#: host calls that enqueue device work (the start of a traced replay)
ENQUEUE_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def graph_slice(dev, production_cfg, round_handle):
    """Phase (x): every engine path as a captured program against the same
    path run eagerly with the same draws (see the module docstring), then
    profile mode's stage programs, the round's merge, the cache's byte
    bound and a second card. Returns each path's numbers and launch
    counts, and the profile runs."""
    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa, stack_buffers, to_soa
    from autodriver_pointcloud_preprocessor_tpu_torch.io.pcap import _read_payloads
    from autodriver_pointcloud_preprocessor_tpu_torch.io.streaming import StreamingEngine
    from autodriver_pointcloud_preprocessor_tpu_torch.models import graphs
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        PipelineSettings, build_pipeline, draw_uniforms, params_from_config,
        settings_from_config,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor
    from autodriver_pointcloud_preprocessor_tpu_torch.models.presets import (
        PRODUCTION_128K_QUALITY_CONFIG,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    paths, launches, profile, leads = {}, {}, [], []
    check(settings_from_config(CONFIG6_NAMED) == PipelineSettings(**CONFIG6_SETTINGS),
          "(x) CONFIG6_NAMED does not give config 6's settings")

    def counts():
        return dict(zip(KERNELS, (_build.LAUNCHES[k] for k in KERNELS)))

    def replay_trace(tag, prog, *args):
        """``TRACE_REPEATS`` replays, each alone under torch.profiler: the
        K1/K2/K3 kernels each trace shows must be the launches the program
        credits. The tracer keeps a device record only where its time,
        taken to the host's clock, lies inside the window that it opened
        and closed on the host, so a replay enqueued the moment the window
        opens loses its first records to any skew of the two clocks. The
        card is idle when the window opens, which it does
        ``TRACE_MARGIN_S`` before the replay is enqueued, and it closes as
        long after the card is idle again. Each trace's lead, its first
        device record's start less the start of the first host call that
        enqueued device work, goes to ``leads``: a negative lead is the
        clocks' skew."""
        for _ in range(TRACE_REPEATS):
            torch.cuda.synchronize()  # no earlier work runs in the window
            with torch.profiler.profile(activities=acts) as prof:
                time.sleep(TRACE_MARGIN_S)
                prog(*args)
                torch.cuda.synchronize()
                time.sleep(TRACE_MARGIN_S)
            events = prof.events()
            device = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
            enqueued = min((e.time_range.start for e in events
                            if e.device_type == torch.autograd.DeviceType.CPU
                            and e.name.startswith(ENQUEUE_CALLS)), default=float("nan"))
            seen = {k: sum(f"{k}_kernel" in e.name for e in device) for k in KERNELS}
            leads.append(device[0].time_range.start - enqueued if device else float("nan"))
            head = "; ".join(f"{e.name[:48]} at {e.time_range.start:.1f}" for e in device[:3])
            check(seen == prog.credits,
                  f"(x) {tag}: one replay ran {seen} in {len(device)} device ops, credited "
                  f"{prog.credits} (us into the window: first enqueue {enqueued:.1f}, first "
                  f"device records {head})")
        return seen, len(device)

    def program_stats(prog):
        return {"capture_ms": prog.capture_ms, "pool_mb": prog.pool_bytes / 2**20}

    def engine_path(tag, cfg, soa, capacity, timed):
        t0 = time.perf_counter()
        engine = Preprocessor(cfg, seed=0)
        s = engine.settings
        run = build_pipeline(s)
        gu = torch.from_numpy(np.random.default_rng(7).uniform(
            size=(s.num_iterations, s.ransac_n)).astype(np.float32)).to(dev)
        ds_cap = s.pre_voxel_compact_capacity or capacity
        du = torch.from_numpy(np.random.default_rng(8).uniform(size=ds_cap).astype(np.float32)).to(dev)
        draws = draw_uniforms(s, (), capacity, None, dev, gu, du)
        buf, meta = from_soa(soa, capacity=capacity, device=dev)
        _build.reset_launches()
        got = engine.process_buffer(buf, gu, du)  # the capture and one replay
        torch.cuda.synchronize()
        graphed = counts()
        _build.reset_launches()
        want = run(buf, engine.params, None, *draws)
        torch.cuda.synchronize()
        eager = counts()
        check(graphed == eager, f"(x) {tag}: graphed launches {graphed}, eager {eager}")
        check(same_tree(got, want), f"(x) {tag}: graphed output differs from the eager run's")
        prog = graphs.lookup(("engine", "scan", s), (buf, engine.params, draws))
        check(prog is not None, f"(x) {tag}: no program ran")
        seen, nodes = replay_trace(tag, prog, buf, engine.params, draws)

        def scan_graphed():
            b, m = from_soa(soa, capacity=capacity, device=dev)
            return to_soa(engine.process_buffer(b, gu, du)[0], m)

        def scan_eager():
            b, m = from_soa(soa, capacity=capacity, device=dev)
            return to_soa(run(b, engine.params, None, *draws)[0], m)

        check(len(scan_graphed()["positions"]) == int(got[0].mask.sum()), f"(x) {tag}: to_soa")
        half = max(timed // 2, 1)  # in turns: graphed, eager, eager, graphed
        tg = call_ms(scan_graphed, half)
        te = call_ms(scan_eager, half) + call_ms(scan_eager, timed - half)
        tg += call_ms(scan_graphed, timed - half)
        pg = call_ms(lambda: engine.process_buffer(buf, gu, du), timed)
        pe = call_ms(lambda: run(buf, engine.params, None, *draws), timed)
        n = int(got[0].mask.sum())
        row = {"scan_graphed_ms": p50_p90(tg), "scan_eager_ms": p50_p90(te),
               "pipeline_graphed_ms": p50_p90(pg), "pipeline_eager_ms": p50_p90(pe),
               **program_stats(prog), "kernels_a_replay": seen, "device_ops_a_replay": nodes,
               "survivors": n, "timed": timed}
        paths[tag] = row
        launches[f"graph_{tag}"] = graphed
        print(f"[chip_smoke] (x) {tag}: graphed == eager bit for bit ({n} survivors, normals and "
              f"plane), launches {json.dumps(graphed)} a scan both ways, each of "
              f"{TRACE_REPEATS} replays traced {json.dumps(seen)} of {nodes} device ops; capture {prog.capture_ms:.1f} ms, pool "
              f"{prog.pool_bytes / 2**20:.1f} MB; ms/scan from_soa..to_soa p50/p90 graphed "
              f"{row['scan_graphed_ms'][0]:.3f}/{row['scan_graphed_ms'][1]:.3f}, eager "
              f"{row['scan_eager_ms'][0]:.3f}/{row['scan_eager_ms'][1]:.3f}; pipeline alone "
              f"graphed {row['pipeline_graphed_ms'][0]:.3f}/{row['pipeline_graphed_ms'][1]:.3f}, "
              f"eager {row['pipeline_eager_ms'][0]:.3f}/{row['pipeline_eager_ms'][1]:.3f} "
              f"({timed} timed; {time.perf_counter() - t0:.1f} s)")
        n_prof = min(timed, 5)
        profile.append((f"(x) {tag} graphed: {n_prof} scans",
                        lambda: [scan_graphed() for _ in range(n_prof)]))
        profile.append((f"(x) {tag} eager: {n_prof} scans",
                        lambda: [scan_eager() for _ in range(n_prof)]))
        return engine

    soa_bench = bench_soa()
    t_all = time.perf_counter()
    production = engine_path("production", production_cfg, soa_bench, CAPACITY, TIMED)
    engine_path("config2", CONFIG2, soa_positions(), CAPACITY, TIMED)
    engine_path("quality", PRODUCTION_128K_QUALITY_CONFIG, soa_bench, CAPACITY, TIMED)
    engine_path("config6", CONFIG6_NAMED, {"positions": scene(CONFIG6_POINTS)}, CONFIG6_CAPACITY, 10)
    engine_path("config7", {**production_cfg, "remove_ground.before_voxel": False,
                            "downsample.max_points": 0}, sensor_order(soa_bench), CAPACITY, TIMED)
    engine_path("defaults", {}, soa_bench, CAPACITY, TIMED)
    for method in ("random", "uniform", "farthest_point"):
        engine_path(f"downsample_{method}", {**production_cfg, "downsample_method": method},
                    soa_bench, CAPACITY, 3 if method == "farthest_point" else TIMED)
    engine_path("height_ground", {**production_cfg, "remove_ground.method": "height",
                                  "ground_plane": [0.0, 0.0, 1.0, 0.0]}, soa_bench, CAPACITY, TIMED)

    # ---- B=8, vmapped and sequential -------------------------------------
    t0 = time.perf_counter()
    engine, run = production, build_pipeline(production.settings)
    bufs = [from_soa(bench_soa(seed), capacity=CAPACITY, device=dev)[0] for seed in range(BATCH)]
    s = engine.settings
    u = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(BATCH, s.num_iterations, s.ransac_n)).astype(np.float32)).to(dev)
    for sequential in (False, True):
        mode = "sequential" if sequential else "vmapped"
        _build.reset_launches()
        got = engine.process_batch(bufs, sequential=sequential, ground_uniforms=u)
        torch.cuda.synchronize()
        graphed = counts()
        _build.reset_launches()
        if sequential:
            runs = [run(b, engine.params, None, u[i]) for i, b in enumerate(bufs)]
            want = ([r[0] for r in runs], torch.stack([r[1] for r in runs]))
            got_cmp = got
        else:
            want = run(stack_buffers(bufs), engine.params, None, u)
            got_cmp = (stack_buffers(got[0]), got[1])
        torch.cuda.synchronize()
        eager = counts()
        check(graphed == eager, f"(x) B={BATCH} {mode}: graphed launches {graphed}, eager {eager}")
        check(same_tree(got_cmp, want), f"(x) B={BATCH} {mode}: graphed differs from eager")
        draws = ([draw_uniforms(s, (), CAPACITY, None, dev, u[i]) for i in range(BATCH)]
                 if sequential else draw_uniforms(s, (BATCH,), CAPACITY, None, dev, u))
        prog = graphs.lookup(("engine", mode, s), (bufs, engine.params, draws))
        check(prog is not None, f"(x) B={BATCH} {mode}: no program ran")
        seen, nodes = replay_trace(f"B={BATCH} {mode}", prog, bufs, engine.params, draws)

        def eager_batch(sequential=sequential):
            if sequential:
                return [run(b, engine.params, None, u[i]) for i, b in enumerate(bufs)]
            return run(stack_buffers(bufs), engine.params, None, u)

        tg = [t / BATCH for t in call_ms(
            lambda sq=sequential: engine.process_batch(bufs, sequential=sq, ground_uniforms=u), 5)]
        te = [t / BATCH for t in call_ms(eager_batch, 5)]
        tag = f"b{BATCH}_{mode}"
        paths[tag] = {"ms_per_scan_graphed": p50_p90(tg), "ms_per_scan_eager": p50_p90(te),
                      **program_stats(prog), "kernels_a_replay": seen, "device_ops_a_replay": nodes}
        launches[f"graph_{tag}"] = graphed
        print(f"[chip_smoke] (x) B={BATCH} {mode}: graphed == eager bit for bit, launches "
              f"{json.dumps(graphed)} a batch both ways, each of {TRACE_REPEATS} replays traced "
              f"{json.dumps(seen)}; "
              f"capture {prog.capture_ms:.1f} ms, pool {prog.pool_bytes / 2**20:.1f} MB; ms/scan "
              f"(device buffers in and out, median of 5 batches) graphed {paths[tag]['ms_per_scan_graphed'][0]:.3f}, "
              f"eager {paths[tag]['ms_per_scan_eager'][0]:.3f}")
        profile.append((f"(x) B={BATCH} {mode} graphed: 1 batch",
                        lambda sq=sequential: engine.process_batch(bufs, sequential=sq, ground_uniforms=u)))
    print(f"[chip_smoke] (x) B={BATCH} took {time.perf_counter() - t0:.1f} s")

    # ---- a reconfigure and a changing TF after capture ---------------------
    t0 = time.perf_counter()
    buf, _ = from_soa(soa_bench, capacity=CAPACITY, device=dev)
    gu = u[0]
    reconf = Preprocessor(production_cfg, seed=0)
    reconf.process_buffer(buf, gu)  # the capture (or a replay of phase 5's program)

    def fresh_eager(cfg, tf=None):
        s = settings_from_config({**cfg, "_has_tf": tf is not None})
        return build_pipeline(s)(buf, params_from_config(cfg, tf, dev), None, gu)

    delta = {"voxel_size": 0.08}
    programs_before = len(graphs.programs())
    reconf.update_config(delta)
    check(same_tree(reconf.process_buffer(buf, gu), fresh_eager({**production_cfg, **delta})),
          "(x) after update_config the replay differs from a fresh eager engine's")
    reused = len(graphs.programs()) == programs_before
    tf = np.eye(4, dtype=np.float32)
    for shift in (0.0, 0.75, -1.25):  # a TF, then two replacing it
        tf[:3, 3] = (1.5, -0.5 + shift, 1.9)
        reconf.set_tf_matrix(tf)
        check(same_tree(reconf.process_buffer(buf, gu), fresh_eager({**production_cfg, **delta}, tf)),
              f"(x) with TF shift {shift} the replay differs from a fresh eager engine's")
    print(f"[chip_smoke] (x) update_config({json.dumps(delta)}) after capture "
          f"({'the same program' if reused else 'a new program'}) and three TFs: each replay "
          f"bit-equal to a fresh eager engine ({time.perf_counter() - t0:.1f} s)")

    # ---- streaming: config 5 single and batch=20 ---------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/config5.pcap"
        write_pcap(path, *vlp16_ring_capture(CONFIG5_PACKETS))
        graphed_engine = StreamingEngine(CONFIG5, packet_bucket=CONFIG5_BUCKET)
        eager_engine = StreamingEngine(CONFIG5, packet_bucket=CONFIG5_BUCKET)
        captures = graphs.captures

        def eager_replay(batch):
            graphs.captures = lambda device: False  # the engine's body, eagerly
            try:
                return list(eager_engine.replay_pcap(path, batch=batch))
            finally:
                graphs.captures = captures

        for batch in (1, 20):
            tag = "streaming_config5" if batch == 1 else "streaming_config5_batch20"
            _build.reset_launches()
            got = list(graphed_engine.replay_pcap(path, batch=batch))
            torch.cuda.synchronize()
            graphed = counts()
            _build.reset_launches()
            want = eager_replay(batch)
            torch.cuda.synchronize()
            check(graphed == counts(), f"(x) {tag}: graphed launches {graphed}, eager {counts()}")
            check(got == want, f"(x) {tag}: graphed blobs differ from the eager engine's")
            walls_g, walls_e = [], []
            for _ in range(3):  # in turns
                w0 = time.perf_counter()
                list(graphed_engine.replay_pcap(path, batch=batch))
                walls_g.append((time.perf_counter() - w0) * 1e3 / len(got))
                w0 = time.perf_counter()
                eager_replay(batch)
                walls_e.append((time.perf_counter() - w0) * 1e3 / len(got))
            prog = graphs.programs()[-1]
            paths[tag] = {"ms_per_revolution_graphed": float(np.median(walls_g)),
                          "ms_per_revolution_eager": float(np.median(walls_e)),
                          **program_stats(prog), "revolutions": len(got)}
            launches[f"graph_{tag}"] = graphed
            print(f"[chip_smoke] (x) {tag}: {len(got)} blobs byte-equal to the eager engine's, "
                  f"launches {json.dumps(graphed)} both ways; capture {prog.capture_ms:.1f} ms, "
                  f"pool {prog.pool_bytes / 2**20:.1f} MB; ms a revolution (replay wall / "
                  f"revolutions, median of 3) graphed {paths[tag]['ms_per_revolution_graphed']:.3f}, "
                  f"eager {paths[tag]['ms_per_revolution_eager']:.3f}")
        revs = revolutions(*_read_payloads(path))[:5]
        profile.append(("(x) streaming config 5 graphed: 5 revolutions",
                        lambda: [graphed_engine.process_scan_packets(*r) for r in revs]))
    print(f"[chip_smoke] (x) streaming took {time.perf_counter() - t0:.1f} s")

    stage_paths, stage_launches = profile_stage_paths(dev, production_cfg, counts)
    paths.update(stage_paths)
    launches.update(stage_launches)
    paths["round_merge"] = merge_round(round_handle)
    paths["second_card"] = second_card(dev, production_cfg)
    paths["cache_bound"] = cache_bound(dev, production_cfg)
    paths["traced_replays"] = {"traces": len(leads), "margin_s": TRACE_MARGIN_S,
                               "lead_us_min": min(leads), "lead_us_max": max(leads)}
    print(f"[chip_smoke] (x) {len(leads)} traced replays, each showing every kernel its program "
          f"credits; lead of the first device record over the first enqueue min "
          f"{min(leads):.1f} us, max {max(leads):.1f} us (window margin {TRACE_MARGIN_S} s)")
    print(f"[chip_smoke] (x) phase (x) took {time.perf_counter() - t_all:.1f} s")
    return {"paths": paths, "launches": launches, "profile": profile}


# ---- the XLA window route: PipelineSettings(pallas_ok=False) (phase (y)) ----

#: K1, K2, K3 launches a scan with pallas_ok=False: compaction and the
#: voxel stage keep K1 and K2; the window stages take the XLA route
XLA_LAUNCHES = {"production": (1, 1, 0), "config2": (0, 1, 0), "config6": (1, 1, 0)}


def xla_slice(dev):
    """Phase (y): production, config 2 and config 6 (1,000,000 points,
    one timed run each way: its windows take 50 chunks a pass) with
    ``pallas_ok=False``, each a captured program of the engine
    (``Preprocessor(cfg, pallas_ok=False)``, the user's entry) against the
    same run eagerly with the same draws, bit for bit with the launches of
    ``XLA_LAUNCHES``; ms/scan graphed and eager in turns, capture ms and
    pool MB; the card against the CPU with the same draws (jaccard >=
    0.99, >= 98% of common normals within 2 degrees); the jaccard against
    the kernel route on the same scan (another function: no bound); then
    one sharded config-6 step with ``pallas_ok=False`` captured against
    its eager body in the NCCL world of ``device_count()`` ranks."""
    import dataclasses

    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa, to_soa
    from autodriver_pointcloud_preprocessor_tpu_torch.models import graphs
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        build_pipeline, draw_uniforms, params_from_config,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor
    from autodriver_pointcloud_preprocessor_tpu_torch.models.presets import PRODUCTION_128K_CONFIG
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build

    cpu = torch.device("cpu")
    paths, launches, profile = {}, {}, []

    def counts():
        return tuple(_build.LAUNCHES[k] for k in KERNELS)

    def survivors(out, normals):
        m = out.mask.cpu().numpy()
        pos = out.positions.cpu().numpy()[:, m].T
        nrm = (out.attributes["normals"].cpu().numpy()[:, m].T if normals
               else np.zeros_like(pos))
        return survivor_normals({"positions": pos, "normals": nrm})

    def xla_path(tag, cfg, soa, capacity, timed):
        t0 = time.perf_counter()
        engine = Preprocessor(cfg, seed=0, pallas_ok=False)
        s = engine.settings
        run = build_pipeline(s)
        gu = torch.from_numpy(np.random.default_rng(7).uniform(
            size=(s.num_iterations, s.ransac_n)).astype(np.float32)).to(dev)
        draws = draw_uniforms(s, (), capacity, None, dev, gu)
        buf, _ = from_soa(soa, capacity=capacity, device=dev)
        _build.reset_launches()
        got = engine.process_buffer(buf, gu)  # the capture and one replay
        torch.cuda.synchronize()
        graphed = counts()
        _build.reset_launches()
        want = run(buf, engine.params, None, *draws)
        torch.cuda.synchronize()
        eager = counts()
        check(graphed == eager == XLA_LAUNCHES[tag],
              f"(y) {tag}: launches graphed {graphed}, eager {eager}, expected {XLA_LAUNCHES[tag]}")
        check(same_tree(got, want), f"(y) {tag}: graphed output differs from the eager run's")
        prog = graphs.lookup(("engine", "scan", s), (buf, engine.params, draws))
        check(prog is not None and prog.credits == dict(zip(KERNELS, XLA_LAUNCHES[tag])),
              f"(y) {tag}: no program, or its credits differ")
        _build.reset_launches()
        check(same_tree(engine.process_buffer(buf, gu), want) and counts() == XLA_LAUNCHES[tag],
              f"(y) {tag}: a second replay differs")

        def scan_graphed():
            b, m = from_soa(soa, capacity=capacity, device=dev)
            return to_soa(engine.process_buffer(b, gu)[0], m)

        def scan_eager():
            b, m = from_soa(soa, capacity=capacity, device=dev)
            return to_soa(run(b, engine.params, None, *draws)[0], m)

        half = max(timed // 2, 1)  # in turns: graphed, eager, eager, graphed
        tg = call_ms(scan_graphed, half)
        te = call_ms(scan_eager, half) + call_ms(scan_eager, timed - half)
        tg += call_ms(scan_graphed, timed - half)
        normals = s.estimate_normals
        card = survivors(want[0], normals)
        t1 = time.perf_counter()
        cpu_out = run(from_soa(soa, capacity=capacity, device=cpu)[0],
                      params_from_config(cfg, device=cpu), None,
                      *(None if d is None else d.cpu() for d in draws))
        cpu_s = time.perf_counter() - t1
        host = survivors(cpu_out[0], normals)
        common = card.keys() & host.keys()
        j = len(common) / max(len(card.keys() | host.keys()), 1)
        cos = np.array([abs(float(np.dot(card[p], host[p]))) for p in common])
        normals_ok = float((cos >= np.cos(np.deg2rad(2.0))).mean()) if normals else 1.0
        check(j >= 0.99, f"(y) {tag}: card vs CPU jaccard {j:.5f} < 0.99")
        check(normals_ok >= 0.98, f"(y) {tag}: only {normals_ok:.5f} of normals within 2 degrees")
        kernel_route = build_pipeline(dataclasses.replace(s, pallas_ok=True))(
            buf, engine.params, None, *draws)
        kr = survivors(kernel_route[0], False)
        j_kernel = len(card.keys() & kr.keys()) / max(len(card.keys() | kr.keys()), 1)
        row = {"scan_graphed_ms": p50_p90(tg), "scan_eager_ms": p50_p90(te),
               "capture_ms": prog.capture_ms, "pool_mb": prog.pool_bytes / 2**20,
               "launches_a_scan": XLA_LAUNCHES[tag], "survivors": len(card),
               "card_vs_cpu_jaccard": j, "card_vs_cpu_normals_2deg": normals_ok,
               "vs_kernel_route_jaccard": j_kernel, "timed": timed}
        paths[tag] = row
        launches[f"xla_{tag}"] = dict(zip(KERNELS, graphed))
        print(f"[chip_smoke] (y) {tag} pallas_ok=False: graphed == eager bit for bit ({len(card)} "
              f"survivors), launches {graphed} a scan both ways; capture {prog.capture_ms:.1f} ms, "
              f"pool {prog.pool_bytes / 2**20:.1f} MB; ms/scan from_soa..to_soa p50/p90 graphed "
              f"{row['scan_graphed_ms'][0]:.3f}/{row['scan_graphed_ms'][1]:.3f}, eager "
              f"{row['scan_eager_ms'][0]:.3f}/{row['scan_eager_ms'][1]:.3f} ({timed} timed each); "
              f"card vs CPU jaccard {j:.5f}, normals within 2 deg {normals_ok:.5f} (CPU run "
              f"{cpu_s:.1f} s); against the kernel route on the same scan jaccard {j_kernel:.5f} "
              f"(another function) ({time.perf_counter() - t0:.1f} s)")
        if tag != "config6":
            profile.append((f"(y) {tag} pallas_ok=False graphed: 5 scans",
                            lambda: [scan_graphed() for _ in range(5)]))
            profile.append((f"(y) {tag} pallas_ok=False eager: 5 scans",
                            lambda: [scan_eager() for _ in range(5)]))

    for args in (("production", PRODUCTION_128K_CONFIG, bench_soa(), CAPACITY, TIMED),
                 ("config2", CONFIG2, soa_positions(), CAPACITY, TIMED),
                 ("config6", CONFIG6_NAMED, {"positions": scene(CONFIG6_POINTS)},
                  CONFIG6_CAPACITY, 1)):
        xla_path(*args)

    world = torch.cuda.device_count()
    ci, _, csec = spawn_world("captured_xla", world, "nccl", "cuda:{rank}")
    c0 = ci[0]["captured"]
    sharded = {"captured_ms": p50_p90(c0["captured_ms"]), "eager_ms": p50_p90(c0["eager_ms"]),
               "capture_ms": c0["capture_ms"], "pool_mb": c0["pool_mb"],
               "launches_a_step": c0["launches_a_step"], "points_a_rank": c0["capacity"]}
    paths[f"sharded_nccl_{world}"] = sharded
    launches["xla_sharded_captured"] = dict(zip(KERNELS, (
        sum(i["captured"]["launches"][k] for i in ci) for k in range(len(KERNELS)))))
    print(f"[chip_smoke] (y) sharded config 6 pallas_ok=False, NCCL world of {world}: every rank's "
          f"captured step bit-equal to its eager step on two draws, launches "
          f"{c0['launches_a_step']} a step, collectives {json.dumps(c0['collectives_a_step'])}; "
          f"rank 0 p50/p90 captured {sharded['captured_ms'][0]:.3f}/{sharded['captured_ms'][1]:.3f}"
          f" ms, eager {sharded['eager_ms'][0]:.3f}/{sharded['eager_ms'][1]:.3f}; capture "
          f"{c0['capture_ms']:.1f} ms, pool {c0['pool_mb']:.1f} MB ({csec:.1f} s)")
    graphs.clear()
    return {"paths": paths, "launches": launches, "profile": profile}


# ---- the committed fixtures on the card (phase (z)) -------------------------

def fixture_slice(dev):
    """Phase (z): ``tests/test_torch_fixture_parity.py``'s checks on the
    card, under its tolerances: the ``parity_golden.npz`` stages, the
    ring-scene pipeline (window against exact) and window floors, and the
    HDL-32E floor, each window check on both routes."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_fixture_parity.py")
    spec = importlib.util.spec_from_file_location("fixture_parity", path)
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    t0 = time.perf_counter()
    results = {}

    def run(name, fn, *args):
        try:
            results[name] = fn(*args)
        except AssertionError as e:
            fail(f"(z) {name}: {e}")

    golden = fx.golden_fixture(dev)
    run("golden_nonfinite_and_dedup", fx.check_nonfinite_and_dedup, golden)
    for invert in (False, True):
        run(f"golden_crop_invert_{invert}", fx.check_crop, golden, invert)
    run("golden_voxel_position_set", fx.check_voxel_position_set, golden)
    run("golden_statistical_outliers", fx.check_statistical_outliers, golden)
    run("golden_normals (rows by clause)", fx.check_normals_angles, golden)
    run("golden_ground_plane (points whose side differs)", fx.check_ground_plane, golden)
    for route in fx.ROUTES:
        run(f"ring_pipeline_window_vs_exact_{route}", fx.check_ring_pipeline, dev, route)
        run(f"ring_floor_{route}", fx.check_ring_floor, dev, route)
        run(f"hdl32_floor_{route}", fx.check_hdl32_floor, dev, route)
    run("ring_presorted_floor", fx.check_presorted_ring_floor, dev)
    print(f"[chip_smoke] (z) the committed fixtures on the card, every check of "
          f"tests/test_torch_fixture_parity.py at its tolerance: {json.dumps(results)} "
          f"({time.perf_counter() - t0:.1f} s)")
    return results


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    from autodriver_pointcloud_preprocessor_tpu_torch.core import (
        from_soa, stack_buffers, to_soa, unstack_buffer,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        STAGE_TIMING_KEYS, build_pipeline, params_from_config, settings_from_config,
        stage_functions,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor
    from autodriver_pointcloud_preprocessor_tpu_torch.models.presets import (
        PRODUCTION_128K_CONFIG, PRODUCTION_128K_QUALITY_CONFIG,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.segmean import (
        masked_compact, masked_compact_plain, run_ids, segmented_sums, segmented_sums_plain,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.voxel import sorted_voxel_channels
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.window import _sorted_rows
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.window_stats import (
        window_stats, window_stats_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(f"[chip_smoke] card: {smi_line}")
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.load_library()
    print(f"[chip_smoke] kernel build+load {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds():.2f} s)")
    info = _build.kernel_info(window_blocks=1)
    print(f"[chip_smoke] registers a thread, resident CTAs an SM and local bytes a thread "
          f"(spills) of each kernel (K3's shared memory at wb=1): {json.dumps(info)}")

    cfg = PRODUCTION_128K_CONFIG
    settings = settings_from_config(cfg)
    params = params_from_config(cfg, device=dev)
    run = build_pipeline(settings)
    H, n_draw = settings.num_iterations, settings.ransac_n
    draws = np.random.default_rng(2).uniform(size=(H, n_draw)).astype(np.float32)
    batch_draws = torch.from_numpy(
        np.random.default_rng(3).uniform(size=(BATCH, H, n_draw)).astype(np.float32)
    ).to(dev)
    stages = dict(stage_functions(settings))
    comp_cap = settings.pre_voxel_compact_capacity
    cap = settings.post_downsample_capacity
    wb0, wb1 = settings.window_blocks
    k3_passes = {
        "pass0": dict(k=settings.nb_neighbors, window_blocks=wb0,
                      kmode=settings.knn_kmode, direction=0, moments=True),
        "pass1": dict(k=settings.nb_neighbors, window_blocks=wb1,
                      kmode=settings.knn_kmode, direction=1, moments=False),
    }
    r2_dev = (params.search_radius ** 2).reshape(1)

    def kernel_inputs(buf, u):
        """Each kernel's main-path inputs, from a (batched) buffer: K1 rows
        (8 rows, NaN on every dead row) and mask, and the buffer the
        ``pre_compact`` stage gets; K2 channels and run starts; K3 rows of
        pass 0 and pass 1; the live voxel counts."""
        b = buf
        for name in ("non_finite", "crop", "ground"):
            b, _ = stages[name](b, params, None, u)
        pre = b
        k1_mask = b.mask
        k1_rows = torch.cat([b.positions, b.attributes["intensity"].unsqueeze(-2),
                             b.attributes["ring"].unsqueeze(-2).float(), b.positions * 2], dim=-2)
        k1_rows = torch.where(k1_mask.unsqueeze(-2), k1_rows, float("nan"))
        b = stages["pre_compact"](b, params, None, None)[0]
        k2_vals, k2_flags, _, _, _ = sorted_voxel_channels(
            b, params.voxel_size, dedup_exact=True, curve_order=True, compact_keys="box"
        )
        b = stages["voxel"](b, params, None, None)[0]
        live = b.mask.sum(-1)
        check(bool((live <= cap).all()), f"{live.tolist()} voxels overflow the {cap} bucket")
        p0 = [b.positions[..., c, :cap].contiguous() for c in range(3)]
        p0.append(b.mask[..., :cap].contiguous())
        p1 = list(_sorted_rows(torch.stack(p0[:3], dim=-2), p0[3], 1))
        return k1_rows, k1_mask, pre, k2_vals, k2_flags, {"pass0": p0, "pass1": p1}, live

    def pre_compact(b):
        return stages["pre_compact"](b, params, None, None)[0]

    def check_stage(tag, pre):
        """The ``pre_compact`` stage on the card against the same stage on a
        CPU copy, bit for bit (values, zeros and the new mask)."""
        got = pre_compact(pre)
        cpu = type(pre)(pre.positions.cpu(), pre.mask.cpu(), {k: v.cpu() for k, v in pre.attributes.items()})
        want = pre_compact(cpu)
        check(torch.equal(got.mask.cpu(), want.mask), f"K1 {tag}: pre_compact mask differs")
        check(torch.equal(bits(got.positions), bits(want.positions)) and all(
            torch.equal(bits(got.attributes[k]), bits(v)) for k, v in want.attributes.items()),
            f"K1 {tag}: pre_compact rows differ from the stage on the CPU")
        return got

    # ---- main-path inputs of each kernel, from the bench scene ----------
    buf, _ = from_soa(bench_soa(), capacity=CAPACITY, device=dev)
    k1_rows, k1_mask, k1_pre, k2_vals, k2_flags, k3_rows, live = kernel_inputs(
        buf, torch.from_numpy(draws).to(dev)
    )
    print(f"[chip_smoke] shapes: K1 {tuple(k1_rows.shape)} live {int(k1_mask.sum())} "
          f"-> {comp_cap}; K2 {tuple(k2_vals.shape)} runs {int(k2_flags[1:].sum()) + 1}; "
          f"K3 {cap} rows, {int(live)} live")

    # ---- each kernel against its plain version on a CPU copy ------------
    max_err = {}
    out = masked_compact(k1_rows, k1_mask, comp_cap)
    check(torch.equal(bits(out), bits(masked_compact_plain(k1_rows.cpu(), k1_mask.cpu(), comp_cap))),
          "K1 masked_compact is not bit-exact against its plain version")
    check_stage("single scan", k1_pre)
    max_err["masked_compact"] = 0.0
    # one pre_compact stage call is one device operation: K1's kernel
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):  # the first trace warms the tracer up
        with torch.profiler.profile(activities=acts) as prof:
            pre_compact(k1_pre)
            torch.cuda.synchronize()
    device_ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(device_ops) == 1 and "masked_compact_kernel" in device_ops[0],
          f"pre_compact ran {len(device_ops)} device operations, not K1 alone: {device_ops}")
    print(f"[chip_smoke] pre_compact stage: one device operation ({device_ops[0]}) a call "
          f"(torch.profiler)")
    out = segmented_sums(k2_vals, k2_flags).cpu()
    ref = segmented_sums_plain(k2_vals.cpu(), k2_flags.cpu())
    check(torch.equal(bits(out), bits(ref)), "K2 segmented_sums is not bit-equal to its plain version")
    max_err["segmented_sums"] = float((out - ref).abs().max())
    max_err["window_stats"] = max(
        check_k3_plain(tag, window_stats(*k3_rows[tag], params.search_radius, **kw),
                       k3_rows[tag], kw, params.search_radius)
        for tag, kw in k3_passes.items()
    )
    print(f"[chip_smoke] kernel vs plain max abs err: {json.dumps(max_err)}")

    # ---- the batch axis at B=8: batched == unbatched, and == plain -------
    bufs = [from_soa(bench_soa(seed), capacity=CAPACITY, device=dev)[0] for seed in range(BATCH)]
    b1_rows, b1_mask, b1_pre, b2_vals, b2_flags, b3_rows, blive = kernel_inputs(
        stack_buffers(bufs), batch_draws
    )
    print(f"[chip_smoke] batch shapes: K1 {tuple(b1_rows.shape)} live "
          f"{b1_mask.sum(-1).tolist()}; K2 {tuple(b2_vals.shape)}; K3 "
          f"{tuple(b3_rows['pass0'][0].shape)} live {blive.tolist()}")
    batch_err = {}
    out = masked_compact(b1_rows, b1_mask, comp_cap)
    for i in range(BATCH):
        check(torch.equal(bits(out[i]), bits(masked_compact(b1_rows[i], b1_mask[i], comp_cap))),
              f"batched K1: element {i} differs from its unbatched launch")
    check(torch.equal(bits(out), bits(masked_compact_plain(b1_rows.cpu(), b1_mask.cpu(), comp_cap))),
          "batched K1 is not bit-exact against its batched plain version")
    got = check_stage(f"B={BATCH}", b1_pre)
    for i, alone in enumerate(unstack_buffer(b1_pre)):
        one = pre_compact(alone)
        check(torch.equal(got.mask[i], one.mask) and torch.equal(bits(got.positions[i]), bits(one.positions))
              and all(torch.equal(bits(got.attributes[k][i]), bits(v)) for k, v in one.attributes.items()),
              f"batched pre_compact: scan {i} differs from its unbatched launch")
    batch_err["masked_compact"] = 0.0
    out = segmented_sums(b2_vals, b2_flags)
    for i in range(BATCH):
        check(torch.equal(bits(out[i]), bits(segmented_sums(b2_vals[i], b2_flags[i]))),
              f"batched K2: element {i} differs from its unbatched launch")
    ref = segmented_sums_plain(b2_vals.cpu(), b2_flags.cpu())
    check(torch.equal(bits(out), bits(ref)), "batched K2 is not bit-equal to its batched plain version")
    batch_err["segmented_sums"] = float((out.cpu() - ref).abs().max())
    k3_err = 0.0
    for tag, kw in k3_passes.items():
        rows = b3_rows[tag]
        got = window_stats(*rows, params.search_radius, **kw)
        for i in range(BATCH):
            alone = window_stats(*(r[i] for r in rows), params.search_radius, **kw)
            check(all(torch.equal(bits(g[i]), bits(a)) for g, a in zip(got, alone)),
                  f"batched K3 {tag}: element {i} differs from its unbatched launch")
        k3_err = max(k3_err, check_k3_plain(tag, got, rows, kw, params.search_radius))
    batch_err["window_stats"] = k3_err
    print(f"[chip_smoke] B={BATCH}: every batched kernel equals its unbatched launches bit for "
          f"bit; vs batched plain max abs err {json.dumps(batch_err)}")

    # ---- the main path: single scans, from_soa -> pipeline -> to_soa -----
    soa_host = bench_soa()
    gen = torch.Generator(device=dev)
    times_ms, pipe_ms, wall_ms, survivors = [], [], [], []
    per_scan = {"masked_compact": 1, "segmented_sums": 1, "window_stats": 2}
    _build.reset_launches()
    for i in range(WARMUP + TIMED):
        gen.manual_seed(i)
        before = dict(_build.LAUNCHES)
        start, mid0, mid1, end = (torch.cuda.Event(enable_timing=True) for _ in range(4))
        w0 = time.perf_counter()
        start.record()
        scan, meta = from_soa(soa_host, capacity=CAPACITY, device=dev)
        mid0.record()
        out_buf, plane = run(scan, params, gen)
        mid1.record()
        soa = to_soa(out_buf, meta)
        end.record()
        torch.cuda.synchronize()
        w1 = time.perf_counter()
        n = soa["positions"].shape[0]
        plane = plane.cpu().numpy()
        check(0 < n < 50_000, f"scan {i}: {n} survivors outside (0, 50000)")
        check(bool(np.isfinite(plane).all()) and abs(plane[2]) > 0.9, f"scan {i}: plane {plane}")
        check(bool(np.isfinite(soa["positions"]).all()), f"scan {i}: non-finite survivors")
        check(soa["normals"].shape == (n, 3), f"scan {i}: normals shape {soa['normals'].shape}")
        for k, want in per_scan.items():
            got = _build.LAUNCHES[k] - before[k]
            check(got == want, f"scan {i}: {k} launched {got} times, expected {want}")
        if i >= WARMUP:
            times_ms.append(start.elapsed_time(end))
            pipe_ms.append(mid0.elapsed_time(mid1))
            wall_ms.append((w1 - w0) * 1e3)
            survivors.append(n)
    single_launches = {k: _build.LAUNCHES[k] for k in KERNELS}
    print(f"[chip_smoke] main path: {WARMUP + TIMED} scans ok; launches "
          f"{json.dumps(single_launches)} (per scan 1/1/2); survivors "
          f"{min(survivors)}..{max(survivors)}")
    p50 = float(np.median(times_ms))
    print(f"[chip_smoke] p50 {p50:.3f} ms/scan (CUDA events, from_soa..to_soa), "
          f"p90 {float(np.percentile(times_ms, 90)):.3f}, host wall p50 "
          f"{float(np.median(wall_ms)):.3f} ms, {1000.0 / p50:.1f} scans/s; pipeline "
          f"alone (build_pipeline call) p50 {float(np.median(pipe_ms)):.3f} ms")

    # ---- the engine: process_soa, normal and profile mode -----------------
    base_keys = {"tensor_transfer", "preprocessing_time", "device_to_host"}
    for profile in (False, True):
        engine = Preprocessor(cfg, profile=profile, seed=0)
        check(engine.device == dev, f"Preprocessor defaults to {engine.device}, not {dev}")
        for _ in range(2):  # the second call is warm
            eout, emeta = engine.process_soa(soa_host, capacity=CAPACITY)
        n = eout["positions"].shape[0]
        plane = emeta["ground_plane_estimate"]
        check(0 < n < 50_000 and bool(np.isfinite(eout["positions"]).all()),
              f"process_soa(profile={profile}): {n} survivors")
        check(eout["normals"].shape == (n, 3) and emeta.get("has_normals") is True,
              f"process_soa(profile={profile}): normals metadata")
        check(plane is not None and abs(float(plane[2])) > 0.9,
              f"process_soa(profile={profile}): plane {plane}")
        want = set(base_keys)
        if profile:
            want |= {STAGE_TIMING_KEYS[name]
                     for name, _ in stage_functions(settings, separate_stages=True)}
        check(set(engine.processing_times) == want,
              f"processing_times keys {sorted(engine.processing_times)} != {sorted(want)}")
        times = {k: round(v * 1e3, 3) for k, v in engine.processing_times.items()}
        print(f"[chip_smoke] Preprocessor.process_soa(profile={profile}): {n} survivors, plane "
              f"{np.round(plane, 5).tolist()}, processing_times ms {json.dumps(times)}")

    # ---- the engine's batches: vmapped and sequential at B=8 --------------
    engine = Preprocessor(cfg, seed=0)
    alone = [survivor_normals(to_soa(engine.process_buffer(b, ground_uniforms=batch_draws[i])[0]))
             for i, b in enumerate(bufs)]
    batch_launches = {}
    for sequential, want in ((False, (1, 1, 2)), (True, (BATCH, BATCH, 2 * BATCH))):
        mode = "sequential" if sequential else "vmapped"
        _build.reset_launches()
        outs, planes = engine.process_batch(bufs, sequential=sequential, ground_uniforms=batch_draws)
        torch.cuda.synchronize()
        got = tuple(_build.LAUNCHES[k] for k in KERNELS)
        check(got == want, f"process_batch {mode}: launches {got}, expected {want}")
        batch_launches[mode] = dict(zip(KERNELS, got))
        planes = planes.cpu().numpy()
        check(planes.shape == (BATCH, 4) and bool((np.abs(planes[:, 2]) > 0.9).all()),
              f"process_batch {mode}: planes {planes}")
        worst, sizes = 0.0, []
        for i, o in enumerate(outs):
            a, c = survivor_normals(to_soa(o)), alone[i]
            jaccard = len(a.keys() & c.keys()) / max(len(a.keys() | c.keys()), 1)
            check(jaccard == 1.0, f"process_batch {mode}: scan {i} survivors differ from its "
                  f"lone run, jaccard {jaccard:.6f}")
            diff = max((float(np.abs(a[p] - c[p]).max()) for p in a), default=0.0)
            check(diff == 0.0, f"process_batch {mode}: scan {i} normals differ by {diff:.3e}")
            worst = max(worst, diff)
            sizes.append(len(a))
        print(f"[chip_smoke] process_batch {mode} B={BATCH}: launches "
              f"{json.dumps(batch_launches[mode])}; every scan equals its lone run (jaccard "
              f"1.0, normals max diff {worst}); survivors {sizes}")

    # ---- one scan on the CPU with the same draws -------------------------
    u = torch.from_numpy(draws)
    gpu_soa = to_soa(run(from_soa(soa_host, capacity=CAPACITY, device=dev)[0], params,
                         None, u.to(dev))[0])
    t0 = time.perf_counter()
    cpu_soa = to_soa(run(from_soa(soa_host, capacity=CAPACITY, device="cpu")[0],
                         params_from_config(cfg, device="cpu"), None, u)[0])
    cpu_s = time.perf_counter() - t0
    a, c = survivor_normals(gpu_soa), survivor_normals(cpu_soa)
    common = a.keys() & c.keys()
    jaccard = len(common) / max(len(a.keys() | c.keys()), 1)
    cos = np.array([abs(float(np.dot(a[p], c[p]))) for p in common])
    normals_ok = float((cos >= np.cos(np.deg2rad(2.0))).mean()) if len(cos) else 0.0
    print(f"[chip_smoke] GPU vs CPU survivors: {len(a)} vs {len(c)}, jaccard {jaccard:.5f}, "
          f"normals within 2 deg {normals_ok:.5f} of {len(common)} common "
          f"(CPU scan {cpu_s:.1f} s)")
    check(jaccard >= 0.99, f"GPU vs CPU survivor jaccard {jaccard:.5f} < 0.99")
    check(normals_ok >= 0.98, f"GPU vs CPU: only {normals_ok:.5f} of normals within 2 deg")

    # ---- kernel, plain and library times on the card --------------------
    def kernel_times(rows1, mask1, pre, vals2, flags2, rows3, tag):
        """{kernel: (kernel ms, plain ms, library ms or None, bound ms,
        bound by)} on these inputs; K3 counts both passes. Also prints the
        ``pre_compact`` stage's ms (CUDA events, 20 calls) and returns it
        under "pre_compact"."""
        rows1 = rows1[..., :5, :].contiguous()  # the path's 5 rows
        n1, n2 = rows1.shape[-1], vals2.shape[-1]
        # the library calls: one indexing call gathers every scan's live
        # columns in order; one index_add_ sums runs given their ids
        cols = rows1.reshape(-1, 5, n1).transpose(0, 1)
        live = mask1.reshape(-1, n1)
        nb = live.shape[0]
        ids = (run_ids(flags2).reshape(nb, n2)
               + torch.arange(nb, device=dev)[:, None] * n2).reshape(-1)
        flat = vals2.reshape(nb, -1, n2).transpose(0, 1).reshape(vals2.shape[-2], nb * n2)
        res = {}
        km, pm = interleaved_ms(lambda: masked_compact(rows1, mask1, comp_cap),
                                lambda: masked_compact_plain(rows1, mask1, comp_cap))
        lib = event_ms(lambda: cols[:, live], 20)
        res["masked_compact"] = (km, pm, lib, *bound(*k1_work(rows1, mask1, comp_cap)))
        stage_ms = event_ms(lambda: pre_compact(pre), 20)
        print(f"[chip_smoke] pre_compact stage {tag}: {stage_ms:.4f} ms a call (CUDA events)")
        km, pm = interleaved_ms(lambda: segmented_sums(vals2, flags2),
                                lambda: segmented_sums_plain(vals2, flags2))
        lib = event_ms(lambda: torch.zeros_like(flat).index_add_(1, ids, flat), 20)
        res["segmented_sums"] = (km, pm, lib, *bound(*k2_work(vals2, flags2)))
        k3_km, k3_pm, nbytes, flops, flops_pr3 = 0.0, 0.0, 0.0, 0.0, 0.0
        for p, kw in k3_passes.items():
            rows = rows3[p]
            km, pm = interleaved_ms(
                lambda rows=rows, kw=kw: window_stats(*rows, params.search_radius, **kw),
                lambda rows=rows, kw=kw: window_stats_plain(
                    *rows, r2_dev, kw["k"], kw["window_blocks"], kw["kmode"], kw["direction"],
                    kw["moments"]),
                reps=10,
            )
            mom0 = window_stats(*rows, params.search_radius, **kw)[2][..., 0, :]
            b, f = k3_work(rows, kw["k"], kw["window_blocks"], kw["direction"], kw["moments"], mom0)
            flops_pr3 += k3_work(rows, kw["k"], kw["window_blocks"], kw["direction"], kw["moments"],
                                 mom0, csel_compares=False)[1]
            nbytes, flops = nbytes + b, flops + f
            k3_km, k3_pm = k3_km + km, k3_pm + pm
            print(f"[chip_smoke] K3 {tag} {p}: kernel {km:.4f} ms, plain {pm:.4f} ms")
        res["window_stats"] = (k3_km, k3_pm, None, *bound(nbytes, flops))
        print(f"[chip_smoke] window_stats {tag}: bound {res['window_stats'][3]:.4f} ms with csel's "
              f"3 compares a pair, {bound(nbytes, flops_pr3)[0]:.4f} ms without them (PR 3's count)")
        for k, (km, pm, lib, bms, by) in res.items():
            lib_txt = "none" if lib is None else f"{lib:.4f} ms"
            print(f"[chip_smoke] {k} {tag}: kernel {km:.4f} ms, plain torch {pm:.4f} ms, "
                  f"library {lib_txt}, bound {bms:.4f} ms ({by})")
        res["pre_compact"] = stage_ms
        return res

    single_t = kernel_times(k1_rows, k1_mask, k1_pre, k2_vals, k2_flags, k3_rows, "single scan")
    batch_t = kernel_times(b1_rows, b1_mask, b1_pre, b2_vals, b2_flags, b3_rows, f"B={BATCH}")

    # ---- ms per scan of the three modes at B=8 ---------------------------
    def serial():
        for i, b in enumerate(bufs):
            engine.process_buffer(b, ground_uniforms=batch_draws[i])
            torch.cuda.synchronize()

    prod_modes = mode_ms({
        "serial": serial,
        "sequential": lambda: engine.process_batch(bufs, sequential=True, ground_uniforms=batch_draws),
        "vmapped": lambda: engine.process_batch(bufs, ground_uniforms=batch_draws),
    })
    print(f"[chip_smoke] B={BATCH} ms/scan (CUDA events, median of 3 batches, device buffers in "
          f"and out): " + ", ".join(f"{m} {v:.3f}" for m, v in prod_modes.items()))

    # ---- the outlier slice: config 2 and the QUALITY preset --------------
    slice3 = outlier_slice(dev, PRODUCTION_128K_QUALITY_CONFIG)

    # ---- the configuration surface: configs 6, 7, 3, 1, the defaults, ----
    # ---- the downsamplers and the height cut ---------------------------
    slice4 = surface_slice(dev, cfg)

    # ---- the streaming data path: packets in, compressed clouds out ------
    slice5 = streaming_slice(dev, cfg)

    # ---- the node layer: the node, the three-sensor graph, the CLI -------
    slice6 = node_slice(dev, cfg)

    # ---- the sharded pipeline: config 6 over 4 ranks ---------------------
    profile_dir = sys.argv[sys.argv.index("--profile") + 1] if "--profile" in sys.argv else None
    slice7 = sharded_slice(dev, profile_dir)

    # ---- captured programs against eager runs ----------------------------
    slice8 = graph_slice(dev, cfg, slice6["round"])

    # ---- the XLA window route (pallas_ok=False) --------------------------
    slice9 = xla_slice(dev)

    # ---- the committed fixtures ------------------------------------------
    fixture_slice(dev)

    if "--profile" in sys.argv:
        def single():
            for _ in range(5):
                scan, meta = from_soa(soa_host, capacity=CAPACITY, device=dev)
                to_soa(run(scan, params, torch.Generator(device=dev).manual_seed(0))[0], meta)

        profile_runs(
            [("production: 5 single scans", single),
             (f"production: 1 vmapped batch of {BATCH}",
              lambda: engine.process_batch(bufs, ground_uniforms=batch_draws)),
             *slice3["profile"], *slice4["profile"], *slice5["profile"], *slice6["profile"],
             *slice8["profile"], *slice9["profile"]],
            dev, sys.argv[sys.argv.index("--profile") + 1],
        )

    # "launches" and the kernels' numbers are those of the production
    # vmapped batch at its B=8 shapes (the path where all three kernels
    # run); every path's launches, the single-scan figures and K3's modes at
    # config 2's shapes ride beside
    paths = {"production_single": single_launches,
             **{f"production_{m}": v for m, v in batch_launches.items()},
             **slice3["launches"], **slice4["launches"], **slice5["launches"], **slice6["launches"],
             **slice7["launches"], **slice8["launches"], **slice9["launches"]}
    for name, counts in paths.items():
        # config 3 (RANSAC alone) runs no kernel; drive() checked its zeros
        check(name == "config3" or any(counts.values()), f"path {name} launched no kernel")
    kernels = []
    for k in KERNELS:
        km, pm, lib, bms, by = batch_t[k]
        skm, spm, slib, sbms, sby = single_t[k]
        entry = {
            "name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
            "launches": batch_launches["vmapped"][k], "max_abs_err": batch_err[k],
            "ms": km, "plain_ms": pm, "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "batch": BATCH,
            "single_scan": {"launches": single_launches[k], "max_abs_err": max_err[k], "ms": skm,
                            "plain_ms": spm, "bound_ms": sbms, "bound_by": sby,
                            "library_ms": slib},
            "launches_by_path": {name: counts[k] for name, counts in paths.items()},
        }
        if k == "masked_compact":
            entry["pre_compact_stage_ms"] = batch_t["pre_compact"]
            entry["single_scan"]["pre_compact_stage_ms"] = single_t["pre_compact"]
            qkm, qpm, qlib, qbms, qby, qshapes = slice5["k1_quantizer"]
            entry["quantizer"] = {"launches": 1, "ms": qkm, "plain_ms": qpm, "bound_ms": qbms,
                                  "bound_by": qby, "library_ms": qlib, "shapes": qshapes}
        ckm, cpm, clib, cbms, cby = slice4["k_config6"][k]
        entry["config6"] = {"launches": slice4["launches"]["config6"][k],
                            "max_abs_err": slice4["err_config6"][k], "ms": ckm, "plain_ms": cpm,
                            "bound_ms": cbms, "bound_by": cby, "library_ms": clib,
                            "shapes": CONFIG6_SHAPES[k]}
        if k in slice7["kernels"]:
            entry["sharded"] = dict(slice7["kernels"][k], launches=slice7["launches"]["sharded"][k])
        if k == "window_stats":
            entry["modes_run"] = ["csel", "sweep", "bisect", "moments", "radius2"]
            entry["config2"] = dict(slice3["k3_config2"],
                                    max_abs_err=slice3["k3_config2_max_abs_err"])
        kernels.append(entry)
    print(f"[chip_smoke] configuration surface ms/scan: {json.dumps(slice4['timings'])}")
    print(f"[chip_smoke] streaming ms/revolution: {json.dumps(slice5['timings'])}")
    print(f"[chip_smoke] streaming decode and quantizer ops: {json.dumps(slice5['ops'])}")
    print(f"[chip_smoke] node layer ms: {json.dumps(slice6['timings'])}")
    print(f"[chip_smoke] sharded ms/step: {json.dumps(slice7['timings'])}, collectives a step "
          f"{json.dumps(slice7['collectives'])}")
    print(f"[chip_smoke] captured programs against eager runs: {json.dumps(slice8['paths'])}")
    print(f"[chip_smoke] the XLA window route (pallas_ok=False): {json.dumps(slice9['paths'])}")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
