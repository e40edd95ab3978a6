"""K1, K2 and K3 of this checkout against the same kernels of other source trees, on one CUDA card.

    python3 kernel_ab.py [--tree NAME=DIR[:FLAG,...]] ... [--kinds k1,k2,k3] [--profile] [--out DIR]

Records every K1 (``stream_compact_to``, the ``pre_compact`` stage), K2
(``segmented_sums``) and K3 (``window_stats``) call that the engine makes
on chip_smoke.py's bench scenes, with its inputs: the production preset on
one scan and on a vmapped batch of 8, bench_suite.py config 2 likewise,
and the QUALITY preset on one scan (K1 and K2 from the production runs
only). Config 2's K3 calls are also replayed with ``kmode='bisect'``. Each
tree then replays those calls through its own wrappers, in a process of
its own: this checkout, named ``this``, and each ``--tree``, the root of
another checkout (for example the parent commit, ``git archive <commit> |
tar -x -C build/ab/parent``), built with the nvcc flags after the colon,
if any (``--tree recompute=.:-DAPC_D2_CACHE_ROWS=0`` is this checkout with
K3's d2 cache off, ``--tree t8192=.:-DAPC_K1_TILE=8192`` with K1's 8192-
column tiles). The trees take turns: in order, then in reverse.
``--kinds`` replays only the kernels named (default all three).

K1 is replayed at two levels, both with the same signature in every tree
since the port began: ``stream_compact_to(buffer, capacity)`` (the
``pre_compact`` stage: every row of the buffer, the new mask included) and
``masked_compact(rows, mask, capacity)`` on the same buffer's 5 rows
stacked as int32 (what the stage launched before K1 took a row table).

For every case it prints each tree's ms for the case's calls (CUDA events:
the mean of 20 calls after one, the median of 3 such rounds, in each turn)
and whether its outputs equal this checkout's bit for bit (K3: on the
valid rows), or else the largest relative difference of the means. For K1
and K2 it also prints the device time alone (a CUDA graph of 20 wrapper
calls, replayed) beside the library call's (K1: ``values[:, mask]``,
whose device time comes from the tracer's kernel records, since it
synchronises to size its output and cannot be captured; K2:
``index_add_``), and for each tree whose library reports them the
registers, resident CTAs an SM and local bytes of K1, K2 and of K3 at
k=20. ``--profile``: one torch.profiler trace of each K3 case on this
checkout; it prints each launch's grid, block, registers, shared memory,
blocks and warps an SM and the tracer's estimate of the achieved
occupancy, and keeps the traces in ``DIR``. Every record goes to
``DIR/kernel_ab.json`` (default ``build/kernel_ab``). Needs a CUDA card and
nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPS, ROUNDS = 20, 3
PROFILE_KEYS = ("grid", "block", "registers per thread", "shared memory", "blocks per SM",
                "warps per SM", "est. achieved occupancy %")


def event_ms(torch, fn) -> float:
    """Mean ms per call of ``fn`` over REPS calls after one (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def graph_ms(torch, fn) -> float:
    """Device ms per call of ``fn``: a CUDA graph of REPS calls, replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def tracer_ms(torch, fn) -> float:
    """Device ms per call of ``fn``: the tracer's device records of REPS
    calls after one (for a call that cannot be captured in a graph)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / REPS


def record_calls(torch, dev) -> dict:
    """{"k1": {case: [{"positions", "mask", "attributes", "capacity"}]},
    "k2" | "k3": {case: [{"args": [...], "kw": {...}}]}}: the kernel calls
    of the engine's runs on the bench scenes (see the docstring)."""
    import chip_smoke as smoke
    from autodriver_pointcloud_preprocessor_tpu_torch.core import from_soa
    from autodriver_pointcloud_preprocessor_tpu_torch.models.preprocessor import Preprocessor
    from autodriver_pointcloud_preprocessor_tpu_torch.models.presets import (
        PRODUCTION_128K_CONFIG, PRODUCTION_128K_QUALITY_CONFIG,
    )
    from autodriver_pointcloud_preprocessor_tpu_torch import ops
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import voxel, window

    calls = {"k1": {}, "k2": {}, "k3": {}}
    keep = lambda v: v.clone() if torch.is_tensor(v) else v  # noqa: E731

    def recorder(store, real):
        def call(*args, **kw):
            store.append({"args": [keep(a) for a in args], "kw": {k: keep(v) for k, v in kw.items()}})
            return real(*args, **kw)
        return call

    def k1_recorder(store, real):
        def call(buf, capacity):
            store.append({"positions": buf.positions.clone(), "mask": buf.mask.clone(),
                          "attributes": {k: v.clone() for k, v in buf.attributes.items()},
                          "capacity": capacity})
            return real(buf, capacity)
        return call

    def run(case, fn, k2=False):
        real = (voxel.segmented_sums, window.window_stats, ops.stream_compact_to)
        k2_store = calls["k2"].setdefault(case, []) if k2 else []
        k1_store = calls["k1"].setdefault(case, []) if k2 else []
        voxel.segmented_sums = recorder(k2_store, real[0])
        window.window_stats = recorder(calls["k3"].setdefault(case, []), real[1])
        ops.stream_compact_to = k1_recorder(k1_store, real[2])
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            voxel.segmented_sums, window.window_stats, ops.stream_compact_to = real

    cap, batch = smoke.CAPACITY, smoke.BATCH
    bench = smoke.bench_soa()
    scans = [from_soa(smoke.bench_soa(s), capacity=cap, device=dev)[0] for s in range(batch)]
    positions = [from_soa(smoke.soa_positions(s), capacity=cap, device=dev)[0] for s in range(batch)]
    production = Preprocessor(PRODUCTION_128K_CONFIG, seed=0)
    config2 = Preprocessor(smoke.CONFIG2, seed=0)
    run("production, one scan", lambda: production.process_soa(bench, capacity=cap), k2=True)
    run(f"production, B={batch}", lambda: production.process_batch(scans), k2=True)
    run("config 2 sweep + radius2, one scan",
        lambda: config2.process_soa(smoke.soa_positions(), capacity=cap))
    run(f"config 2 sweep + radius2, B={batch}", lambda: config2.process_batch(positions))
    for case in list(calls["k3"]):
        if case.startswith("config 2 sweep"):
            calls["k3"][case.replace("sweep", "bisect")] = [
                dict(c, kw=dict(c["kw"], kmode="bisect")) for c in calls["k3"][case]
            ]
    quality = Preprocessor(PRODUCTION_128K_QUALITY_CONFIG, seed=0)
    run("QUALITY, one scan", lambda: quality.process_soa(bench, capacity=cap))
    return calls


def on_valid(t, valid):
    """The entries of valid rows (a [..., 10, N] moments tensor: per row)."""
    return t.movedim(-2, 0)[:, valid] if t.dim() > valid.dim() else t[valid]


def k1_rows(torch, buf):
    """The buffer's rows stacked as int32 [..., 5, N] (positions, then each
    attribute's rows by name)."""
    lead, n = buf.mask.shape[:-1], buf.mask.shape[-1]
    rows = [buf.positions.view(torch.int32)]
    rows += [buf.attributes[k].reshape(lead + (-1, n)).view(torch.int32) for k in sorted(buf.attributes)]
    return torch.cat(rows, dim=-2).contiguous()


def k1_bits(torch, out) -> list:
    """A K1 output as a list of tensors compared with ``torch.equal``:
    32-bit words, and the mask of a buffer."""
    if torch.is_tensor(out):
        return [out.view(torch.int32)]
    return [out.positions.view(torch.int32), out.mask,
            *(out.attributes[k].view(torch.int32) for k in sorted(out.attributes))]


def replay_k1(torch, name, k1_calls, ref, outputs) -> dict:
    """{level, case: record} of the recorded K1 calls through this
    process's tree (see the docstring)."""
    from autodriver_pointcloud_preprocessor_tpu_torch.core.scan import ScanBuffer
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.compact import stream_compact_to
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.segmean import masked_compact

    records = {}
    for case, cs in k1_calls.items():
        c = cs[0]
        buf = ScanBuffer(c["positions"], c["mask"], c["attributes"])
        cap, rows = c["capacity"], k1_rows(torch, buf)
        levels = {"stream_compact_to": lambda: stream_compact_to(buf, cap),
                  "masked_compact": lambda: masked_compact(rows, buf.mask, cap)}
        for level, fn in levels.items():
            key = f"{level}, {case}"
            rounds = [event_ms(torch, fn) for _ in range(ROUNDS)]
            entry = {"calls": len(cs), "ms": statistics.median(rounds), "rounds": rounds}
            try:
                entry["device_ms"] = graph_ms(torch, fn)
            except RuntimeError as err:  # a wrapper that cannot be captured
                entry["device_ms"], entry["graph_error"] = None, str(err)[:200]
            bits = k1_bits(torch, fn())
            outputs["k1 " + key] = bits
            if ref is not None:
                want = ref["k1 " + key]
                entry["bit_equal"] = len(bits) == len(want) and all(
                    torch.equal(g, w) for g, w in zip(bits, want))
            if name == "this" and level == "masked_compact":
                # one indexing call gathers every scan's live columns in order
                cols = rows.transpose(0, 1) if rows.dim() == 3 else rows
                library = lambda: cols[:, buf.mask]  # noqa: E731
                entry["library_ms"] = statistics.median(event_ms(torch, library) for _ in range(ROUNDS))
                entry["library_device_ms"] = tracer_ms(torch, library)
            records[key] = entry
    return records


def compare_k3(torch, got, want, valid) -> dict:
    got = [on_valid(t, valid) for t in got]
    want = [on_valid(t, valid) for t in want]
    rel = ((got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-12)).max()
    mom = ((got[2] - want[2]).abs() / (want[2].abs() + 1.0)).max()
    return {
        "bit_equal": all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                         for g, w in zip(got, want)),
        "mean_max_rel": float(rel),
        "moments_max_rel": float(mom),
        "counts_equal": all(torch.equal(got[i], want[i]) for i in range(1, len(got)) if i != 2),
    }


def worker(argv) -> None:
    """``--worker NAME TREE FLAGS [CALLS REF OUT [--profile DIR]]``: build
    TREE's library (with FLAGS, comma-separated), then, given CALLS, time
    and check the recorded calls through TREE's wrappers into OUT."""
    name, tree, flags = argv[0], argv[1], [f for f in argv[2].split(",") if f]
    sys.path.insert(0, tree)
    import torch

    import autodriver_pointcloud_preprocessor_tpu_torch as pkg
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.segmean import segmented_sums
    from autodriver_pointcloud_preprocessor_tpu_torch.ops.window_stats import window_stats

    if not Path(pkg.__file__).resolve().is_relative_to(Path(tree).resolve()):
        sys.exit(f"kernel_ab: tree {name} imported the package from {pkg.__file__}")
    _build.load_library(extra_flags=flags) if flags else _build.load_library()
    if len(argv) == 3:
        return
    calls_path, ref_path, out_path = (Path(a) for a in argv[3:6])
    profile_dir = argv[argv.index("--profile") + 1] if "--profile" in argv else None
    dev = torch.device("cuda:0")
    calls = torch.load(calls_path, map_location=dev)
    first = name == "this" and not ref_path.exists()
    ref = None if first else torch.load(ref_path, map_location=dev)
    rec = {"tree": name, "k1": {}, "k3": {}, "k2": {}, "info": {}, "profile": {}}

    outputs = {}
    rec["k1"] = replay_k1(torch, name, calls["k1"], ref, outputs)
    for case, cs in calls["k3"].items():
        fns = [lambda c=c: window_stats(*c["args"], **c["kw"]) for c in cs]
        rounds = [sum(event_ms(torch, f) for f in fns) for _ in range(ROUNDS)]
        outs = [f() for f in fns]
        outputs[case] = outs
        entry = {"ms": statistics.median(rounds), "rounds": rounds}
        if ref is not None:
            checks = [compare_k3(torch, o, w, c["args"][3]) for o, w, c in zip(outs, ref[case], cs)]
            entry.update(bit_equal=all(x["bit_equal"] for x in checks),
                         counts_equal=all(x["counts_equal"] for x in checks),
                         mean_max_rel=max(x["mean_max_rel"] for x in checks),
                         moments_max_rel=max(x["moments_max_rel"] for x in checks))
        rec["k3"][case] = entry
    for case, cs in calls["k2"].items():
        vals, flags_row = cs[0]["args"]
        wrapper = lambda: segmented_sums(vals, flags_row)  # noqa: E731
        rounds = [event_ms(torch, wrapper) for _ in range(ROUNDS)]
        entry = {"calls": len(cs), "ms": statistics.median(rounds), "rounds": rounds}
        try:
            entry["device_ms"] = graph_ms(torch, wrapper)
        except RuntimeError as err:  # a wrapper that cannot be captured
            entry["device_ms"], entry["graph_error"] = None, str(err)[:200]
        out = wrapper()
        outputs["k2 " + case] = [out]
        if ref is not None:
            entry["bit_equal"] = torch.equal(out.view(torch.int32), ref["k2 " + case][0].view(torch.int32))
        if name == "this":
            from autodriver_pointcloud_preprocessor_tpu_torch.ops.segmean import run_ids

            c, n = vals.shape[-2:]
            nb = vals.numel() // (c * n)
            ids = (run_ids(flags_row).reshape(nb, n)
                   + torch.arange(nb, device=vals.device)[:, None] * n).reshape(-1)
            flat = vals.reshape(nb, -1, n).transpose(0, 1).reshape(c, nb * n)
            library = lambda: torch.zeros_like(flat).index_add_(1, ids, flat)  # noqa: E731
            entry["library_ms"] = statistics.median(event_ms(torch, library) for _ in range(ROUNDS))
            entry["library_device_ms"] = graph_ms(torch, library)
        rec["k2"][case] = entry
    if first:
        torch.save(outputs, ref_path)
    if hasattr(_build, "kernel_info"):
        rec["info"] = {f"wb={wb}": _build.kernel_info(window_blocks=wb) for wb in (0, 1, 2)}
    if profile_dir:
        rec["profile"] = profile_k3(torch, window_stats, calls["k3"], Path(profile_dir))
    out_path.write_text(json.dumps(rec))


def profile_k3(torch, window_stats, k3_calls, out_dir: Path) -> dict:
    """{case: [the tracer's record of each K3 launch]}, one trace a case."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):  # warm up the tracer
        torch.zeros(1, device="cuda:0").add_(1)
        torch.cuda.synchronize()
    found = {}
    for i, (case, cs) in enumerate(k3_calls.items()):
        with torch.profiler.profile(activities=acts) as prof:
            for c in cs:
                window_stats(*c["args"], **c["kw"])
            torch.cuda.synchronize()
        path = out_dir / f"k3_trace_{i}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
        found[case] = [
            {"trace": path.name, "dur_us": e.get("dur"),
             **{k: e.get("args", {}).get(k) for k in PROFILE_KEYS}}
            for e in events if e.get("cat") == "kernel" and "window_stats" in e.get("name", "")
        ]
    return found


def parse_trees(argv):
    """[(name, root, nvcc flags)]: this checkout, then each --tree."""
    trees = [("this", str(ROOT), [])]
    for i, arg in enumerate(argv):
        if arg == "--tree":
            name, _, rest = argv[i + 1].partition("=")
            path, _, flags = rest.partition(":")
            trees.append((name, str((ROOT / path).resolve()), [f for f in flags.split(",") if f]))
    return trees


def summary(name, turns, kind, case) -> str:
    entries = [t[kind][case] for t in turns]
    ms = [e["ms"] for e in entries]
    text = f"{name} {sum(ms) / len(ms):.4f} ms (turns {', '.join(f'{m:.4f}' for m in ms)})"
    if kind in ("k1", "k2") and entries[0].get("device_ms") is not None:
        text += f", device {min(e['device_ms'] for e in entries):.4f}"
    if "bit_equal" in entries[-1]:
        if all(e["bit_equal"] for e in entries if "bit_equal" in e):
            text += ", equal to this bit for bit"
        elif kind == "k3":
            checked = [e for e in entries if "mean_max_rel" in e]
            text += (f", means within {max(e['mean_max_rel'] for e in checked):.2e} relative, moments "
                     f"within {max(e['moments_max_rel'] for e in checked):.2e}, counts "
                     f"{'equal' if all(e['counts_equal'] for e in checked) else 'DIFFER'}")
        else:
            text += ", DIFFERS from this"
    return text


def main() -> None:
    if "--worker" in sys.argv:
        worker(sys.argv[sys.argv.index("--worker") + 1:])
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a CUDA card")
    argv = sys.argv[1:]
    trees = parse_trees(argv)
    work_dir = ROOT / "build" / "kernel_ab"  # the recorded calls and outputs (large)
    out_dir = (ROOT / argv[argv.index("--out") + 1]).resolve() if "--out" in argv else work_dir
    for d in (work_dir, out_dir):
        d.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[kernel_ab] card: {card}; trees {json.dumps(trees)}", flush=True)

    def worker_cmd(name, path, flags, *rest):
        return [sys.executable, str(Path(__file__).resolve()), "--worker", name, path, ",".join(flags), *rest]

    # every tree's library at once (each build runs one nvcc per source)
    builds = [subprocess.Popen(worker_cmd(*t)) for t in trees]
    for (name, _, _), proc in zip(trees, builds):
        if proc.wait():
            sys.exit(f"kernel_ab: tree {name} failed to build")
    calls_path, ref_path = work_dir / "calls.pt", work_dir / "this_outputs.pt"
    ref_path.unlink(missing_ok=True)
    kinds = argv[argv.index("--kinds") + 1].split(",") if "--kinds" in argv else ["k1", "k2", "k3"]
    calls = record_calls(torch, torch.device("cuda:0"))
    torch.save({kind: (cases if kind in kinds else {}) for kind, cases in calls.items()}, calls_path)

    turns = {name: [] for name, _, _ in trees}
    for turn, (name, path, flags) in enumerate(trees + trees[::-1]):
        rec_path = work_dir / f"turn{turn}_{name}.json"
        extra = ["--profile", str(out_dir)] if "--profile" in argv and turn == 0 else []
        subprocess.run(worker_cmd(name, path, flags, str(calls_path), str(ref_path), str(rec_path), *extra),
                       check=True)
        turns[name].append(json.loads(rec_path.read_text()))

    this = turns["this"][0]
    for kind in ("k1", "k3", "k2"):
        for case in this[kind]:
            print(f"[kernel_ab] {kind.upper()} {case}: "
                  + "; ".join(summary(name, turns[name], kind, case) for name, _, _ in trees), flush=True)
    for case, e in this["k1"].items():
        if "library_ms" in e:
            print(f"[kernel_ab] K1 {case}: values[:, mask] {e['library_ms']:.4f} ms, device "
                  f"(tracer) {e['library_device_ms']:.4f}")
    for case, e in this["k2"].items():
        print(f"[kernel_ab] K2 {case}: index_add_ {e['library_ms']:.4f} ms, device "
              f"{e['library_device_ms']:.4f}")
    for name, _, _ in trees:
        info = turns[name][0]["info"]
        for wb, kernels in info.items():
            picked = {k: v for k, v in kernels.items() if k.startswith(("K1", "K2")) or "MAXK=32" in k}
            print(f"[kernel_ab] {name} kernel info ({wb}): {json.dumps(picked)}")
    for case, launches in this["profile"].items():
        print(f"[kernel_ab] profile {case}: {json.dumps(launches)}")
    (out_dir / "kernel_ab.json").write_text(json.dumps({"card": card, "trees": trees, "turns": turns}, indent=1))
    print(f"[kernel_ab] records: {out_dir / 'kernel_ab.json'}")


if __name__ == "__main__":
    main()
