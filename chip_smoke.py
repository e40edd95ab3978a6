"""Smoke run of the PyTorch port on one CUDA card: kernels, main path, engine.

    python3 chip_smoke.py [--profile DIR]

1. Builds the hand-written CUDA kernels from ``csrc/`` (nvcc, first use).
2. Holds each kernel against its plain PyTorch version, run on a CPU copy
   of the same inputs, at the shapes the production pipeline gives it.
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

With ``--profile DIR`` it also traces 5 single scans and one vmapped batch
with torch.profiler and writes the time per operator (device and host) to
``DIR/profile.txt``.

Prints the card, the numbers, one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Exits non-zero, before printing any
result, when no CUDA device is present or any check fails. Imports nothing
of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

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


def k3_work(rows, k, wb, direction, moments, mom0):
    """Bytes and FLOPs of one K3 pass on this run's rows: 8 FLOPs (3 sub,
    3 mul, 2 add) for the distance of every valid (query, candidate) pair
    of a window, a square root and an add for each of the k kept
    distances of a valid query, and 19 FLOPs (9 products, 10 sums) for
    every in-radius pair of the moments (``mom0``: the in-radius counts the
    pass gave). Bytes: 13 read and 48 written per row."""
    x, y, z, valid = rows
    n = x.shape[-1]
    ok = (valid & torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z)).reshape(-1, n)
    per_block = ok.reshape(ok.shape[0], -1, 128).sum(-1).double()  # [B, blocks]
    lo, hi = (-wb, wb) if wb > 0 else ((0, 1) if direction == 0 else (-1, 0))
    padded = torch.nn.functional.pad(per_block, (-lo, hi))
    window = sum(padded[:, s : s + per_block.shape[1]] for s in range(hi - lo + 1))
    flops = 8 * float((per_block * window).sum()) + 2 * k * float(ok.sum())
    if moments:
        flops += 19 * float(mom0.reshape(ok.shape)[ok].double().sum())
    return ok.numel() * (13 + 48), flops


def survivor_normals(soa: dict) -> dict:
    """Survivor position (rounded to 1e-5) -> its unit normal."""
    keys = (tuple(r) for r in np.round(soa["positions"], 5).tolist())
    return dict(zip(keys, np.asarray(soa["normals"], dtype=np.float64)))


def bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def profile_runs(run, soa_host, params, dev, engine, batch_bufs, batch_draws, out_dir: str):
    """Trace 5 single scans and one vmapped batch; write per-operator
    device and host times."""
    import os

    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa, to_soa

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):  # warm up the tracer
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()

    def single():
        for _ in range(5):
            scan, meta = from_soa(soa_host, capacity=CAPACITY, device=dev)
            to_soa(run(scan, params, torch.Generator(device=dev).manual_seed(0))[0], meta)

    def batched():
        engine.process_batch(batch_bufs, ground_uniforms=batch_draws)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        for tag, fn in (("5 single scans", single), (f"1 vmapped batch of {BATCH}", batched)):
            w0 = time.perf_counter()
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - w0) * 1e3
            events = prof.key_averages()
            device_ms = sum(
                e.self_device_time_total for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA
            ) / 1e3
            line = (f"{tag}: wall {wall_ms:.3f} ms (traced), device busy {device_ms:.3f} ms "
                    f"({100 * device_ms / wall_ms:.1f}%)")
            f.write(line + "\n\n")
            f.write(events.table(sort_by="self_device_time_total", row_limit=40))
            f.write("\n\n")
            f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
            f.write("\n\n")
            print(f"[chip_smoke] profile: {line}")
    print(f"[chip_smoke] profile tables: {out_dir}/profile.txt")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa, stack_buffers, to_soa
    from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
        STAGE_TIMING_KEYS, build_pipeline, params_from_config, settings_from_config,
        stage_functions,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor
    from autodriver_pointcloud_preprocessor_tpu_torch.models.presets import (
        PRODUCTION_128K_CONFIG,
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
        (8 rows, NaN on every dead row) and mask; K2 channels and run
        starts; K3 rows of pass 0 and pass 1; the live voxel counts."""
        b = buf
        for name in ("non_finite", "crop", "ground"):
            b, _ = stages[name](b, params, None, u)
        k1_mask = b.mask
        k1_rows = torch.cat([b.positions, b.attributes["intensity"].unsqueeze(-2),
                             b.attributes["ring"].unsqueeze(-2).float(), b.positions * 2], dim=-2)
        k1_rows = torch.where(k1_mask.unsqueeze(-2), k1_rows, float("nan"))
        b = stages["pre_compact"](b, params, None, None)[0]
        k2_vals, k2_flags, _, _ = sorted_voxel_channels(
            b, params.voxel_size, dedup_exact=True, curve_order=True, compact_keys="box"
        )
        b = stages["voxel"](b, params, None, None)[0]
        live = b.mask.sum(-1)
        check(bool((live <= cap).all()), f"{live.tolist()} voxels overflow the {cap} bucket")
        p0 = [b.positions[..., c, :cap].contiguous() for c in range(3)]
        p0.append(b.mask[..., :cap].contiguous())
        p1 = list(_sorted_rows(torch.stack(p0[:3], dim=-2), p0[3], 1))
        return k1_rows, k1_mask, k2_vals, k2_flags, {"pass0": p0, "pass1": p1}, live

    def check_k3(tag, got, rows):
        """K3 against its plain version on a CPU copy: means within 1e-5
        relative on >= 99.9% of valid rows, equal counts, moments within
        1e-5."""
        mean, cnt, mom = (t.cpu() for t in got)
        rows_cpu = [r.cpu() for r in rows]
        kw = k3_passes[tag]
        pmean, pcnt, pmom = window_stats_plain(
            *rows_cpu, r2_dev.cpu(), kw["k"], kw["window_blocks"], kw["kmode"],
            kw["direction"], kw["moments"],
        )
        valid = rows_cpu[3]
        rel = ((mean - pmean).abs() / pmean.abs().clamp(min=1e-12))[valid]
        share = float((rel <= 1e-5).float().mean())
        check(share >= 0.999, f"K3 {tag}: only {share:.5f} of means within 1e-5 relative")
        check(torch.equal(cnt[valid], pcnt[valid]), f"K3 {tag}: k-select counts differ")
        check(torch.equal(mom[..., 0, :][valid], pmom[..., 0, :][valid]),
              f"K3 {tag}: in-radius counts differ")
        # all 10 moment rows: n, Sx..Szz and the cross sums the normals come from
        mom_err = float(((mom - pmom).abs() / (pmom.abs() + 1.0)).movedim(-2, 0)[:, valid].max())
        check(mom_err <= 1e-5, f"K3 {tag}: moments differ by {mom_err:.3e} relative (> 1e-5)")
        print(f"[chip_smoke] K3 {tag} {tuple(mean.shape)}: {share:.6f} of means within 1e-5, "
              f"max rel {float(rel.max()):.3e}, moments max rel {mom_err:.3e}")
        return float((mean - pmean).abs()[valid].max())

    # ---- main-path inputs of each kernel, from the bench scene ----------
    buf, _ = from_soa(bench_soa(), capacity=CAPACITY, device=dev)
    k1_rows, k1_mask, k2_vals, k2_flags, k3_rows, live = kernel_inputs(
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
    max_err["masked_compact"] = 0.0
    out = segmented_sums(k2_vals, k2_flags).cpu()
    ref = segmented_sums_plain(k2_vals.cpu(), k2_flags.cpu())
    err = (out - ref).abs()
    check(bool((err <= 1e-6 * ref.abs()).all()), "K2 segmented_sums differs beyond rtol 1e-6")
    max_err["segmented_sums"] = float(err.max())
    max_err["window_stats"] = max(
        check_k3(tag, window_stats(*k3_rows[tag], params.search_radius, **kw), k3_rows[tag])
        for tag, kw in k3_passes.items()
    )
    print(f"[chip_smoke] kernel vs plain max abs err: {json.dumps(max_err)}")

    # ---- the batch axis at B=8: batched == unbatched, and == plain -------
    bufs = [from_soa(bench_soa(seed), capacity=CAPACITY, device=dev)[0] for seed in range(BATCH)]
    b1_rows, b1_mask, b2_vals, b2_flags, b3_rows, blive = kernel_inputs(
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
    batch_err["masked_compact"] = 0.0
    out = segmented_sums(b2_vals, b2_flags)
    for i in range(BATCH):
        check(torch.equal(bits(out[i]), bits(segmented_sums(b2_vals[i], b2_flags[i]))),
              f"batched K2: element {i} differs from its unbatched launch")
    ref = segmented_sums_plain(b2_vals.cpu(), b2_flags.cpu())
    err = (out.cpu() - ref).abs()
    check(bool((err <= 1e-6 * ref.abs()).all()), "batched K2 differs beyond rtol 1e-6")
    batch_err["segmented_sums"] = float(err.max())
    k3_err = 0.0
    for tag, kw in k3_passes.items():
        rows = b3_rows[tag]
        got = window_stats(*rows, params.search_radius, **kw)
        for i in range(BATCH):
            alone = window_stats(*(r[i] for r in rows), params.search_radius, **kw)
            check(all(torch.equal(bits(g[i]), bits(a)) for g, a in zip(got, alone)),
                  f"batched K3 {tag}: element {i} differs from its unbatched launch")
        k3_err = max(k3_err, check_k3(tag, got, rows))
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
    def kernel_times(rows1, mask1, vals2, flags2, rows3, tag):
        """{kernel: (kernel ms, plain ms, library ms or None, bound ms,
        bound by)} on these inputs; K3 counts both passes."""
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
        km, pm = interleaved_ms(lambda: segmented_sums(vals2, flags2),
                                lambda: segmented_sums_plain(vals2, flags2))
        lib = event_ms(lambda: torch.zeros_like(flat).index_add_(1, ids, flat), 20)
        res["segmented_sums"] = (km, pm, lib, *bound(*k2_work(vals2, flags2)))
        k3_km, k3_pm, nbytes, flops = 0.0, 0.0, 0.0, 0.0
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
            nbytes, flops = nbytes + b, flops + f
            k3_km, k3_pm = k3_km + km, k3_pm + pm
            print(f"[chip_smoke] K3 {tag} {p}: kernel {km:.4f} ms, plain {pm:.4f} ms")
        res["window_stats"] = (k3_km, k3_pm, None, *bound(nbytes, flops))
        for k, (km, pm, lib, bms, by) in res.items():
            lib_txt = "none" if lib is None else f"{lib:.4f} ms"
            print(f"[chip_smoke] {k} {tag}: kernel {km:.4f} ms, plain torch {pm:.4f} ms, "
                  f"library {lib_txt}, bound {bms:.4f} ms ({by})")
        return res

    single_t = kernel_times(k1_rows, k1_mask, k2_vals, k2_flags, k3_rows, "single scan")
    batch_t = kernel_times(b1_rows, b1_mask, b2_vals, b2_flags, b3_rows, f"B={BATCH}")

    # ---- ms per scan of the three modes at B=8 ---------------------------
    def serial():
        for i, b in enumerate(bufs):
            engine.process_buffer(b, ground_uniforms=batch_draws[i])
            torch.cuda.synchronize()

    modes = {
        "serial": serial,
        "sequential": lambda: engine.process_batch(bufs, sequential=True, ground_uniforms=batch_draws),
        "vmapped": lambda: engine.process_batch(bufs, ground_uniforms=batch_draws),
    }
    mode_ms = {m: [] for m in modes}
    for fn in modes.values():  # warm
        fn()
    for _ in range(3):
        for m, fn in modes.items():
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            mode_ms[m].append(start.elapsed_time(end) / BATCH)
    print(f"[chip_smoke] B={BATCH} ms/scan (CUDA events, median of 3 batches, device buffers in "
          f"and out): " + ", ".join(f"{m} {float(np.median(v)):.3f}" for m, v in mode_ms.items())
          + f"; all {json.dumps({m: [round(x, 3) for x in v] for m, v in mode_ms.items()})}")

    if "--profile" in sys.argv:
        profile_runs(run, soa_host, params, dev, engine, bufs, batch_draws,
                     sys.argv[sys.argv.index("--profile") + 1])

    # the slice's path is the vmapped batch: its launches, and the kernels'
    # numbers at its B=8 shapes; the single-scan path's figures ride beside
    kernels = []
    for k in KERNELS:
        km, pm, lib, bms, by = batch_t[k]
        skm, spm, slib, sbms, sby = single_t[k]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
            "launches": batch_launches["vmapped"][k], "max_abs_err": batch_err[k],
            "ms": km, "plain_ms": pm, "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "batch": BATCH,
            "single_scan": {"launches": single_launches[k], "max_abs_err": max_err[k], "ms": skm,
                            "plain_ms": spm, "bound_ms": sbms, "bound_by": sby,
                            "library_ms": slib},
        })
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
