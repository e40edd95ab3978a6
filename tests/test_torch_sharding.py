"""The port's sharded pipeline (``parallel/sharding.py``) on 4 gloo CPU ranks.

One module-scoped fixture spawns 4 ranks once (``torch.multiprocessing``,
the spawn start method, a ``file://`` store in a temporary directory, one
thread a rank). Every rank runs every port-side case below in order, and
rank 0 writes the gathered outputs to an ``.npz`` that the tests read.
The reference runs in the test process on ``make_mesh(jax.devices()[:4])``
(4 of ``tests/conftest.py``'s 8 virtual CPU devices), its window kernel
in interpret mode where the case needs it. Rank ``i`` gets the
reference's own RANSAC draws, ``uniform(fold_in(key, i), (16, 3))``.

Case (i) is the step as one captured program (a CUDA graph on an NCCL
group, eager on gloo): the dispatch probe, the draws taken ahead and the
replay plumbing with ``tests/test_torch_graphs.py``'s eager stand-in for
the capture. The shrink's device-side select needs no rank and is checked
in this process, against the reference's ``lax.cond``.

The spawned ranks import this module again, so it imports ``jax`` only
inside functions (case (i) brings it in with ``test_torch_graphs``).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from autodriver_pointcloud_preprocessor_tpu_torch.core import ScanBuffer, from_soa, stack_buffers
from autodriver_pointcloud_preprocessor_tpu_torch.models.pipeline import (
    PipelineParams,
    PipelineSettings,
    build_pipeline,
)
from autodriver_pointcloud_preprocessor_tpu_torch.ops import window as port_window
from autodriver_pointcloud_preprocessor_tpu_torch.parallel import sharding as sh

WORLD = 4
#: RANSAC's 64 hypotheses over 4 ranks, 3 draws each
H_LOCAL, RANSAC_N = 16, 3
#: ``__graft_entry__._full_settings()``: the production knobs
FULL = dict(
    remove_statistical_outliers=True, nb_neighbors=16, estimate_normals=True, max_neighbors=16,
    remove_ground=True, ransac_n=3, num_iterations=64, knn_method="window",
    ground_before_voxel=True, voxel_compact_keys=True, knn_d2mode="fast3", knn_kmode="csel",
    window_blocks=(1, 0), normals_merge_passes=False,
)
#: test_parallel.py's exact-kNN pipeline (:122-147)
EXACT = dict(
    remove_statistical_outliers=True, nb_neighbors=8, knn_method="exact",
    estimate_normals=False, remove_ground=True, num_iterations=64, ransac_n=3,
)
#: the window pipelines of test_parallel.py (:355-599)
WINDOW = dict(
    remove_statistical_outliers=True, nb_neighbors=8, estimate_normals=True, max_neighbors=8,
    knn_method="window", remove_ground=True, num_iterations=64, ransac_n=3,
)
#: test_parallel.py:436-441: ground ahead of the neighbourhood, a 2048 bucket
GROUND_FIRST = dict(WINDOW, ground_before_neighborhood=True, post_downsample_capacity=2048)
#: the outlier-only window stage: the keep-mask is the kNN-mean class
OUTLIERS_ONLY = dict(
    remove_duplicates=False, crop_to_roi=False, voxel_downsample=False, estimate_normals=False,
    remove_statistical_outliers=True, nb_neighbors=8, knn_method="window",
)


# ---------------------------------------------------------------- scenes ----

def _scene(rng, n_ground=3000, n_obj=800):
    """test_parallel.py's _scene: a 20 m ground plane and one object."""
    ground = np.column_stack(
        [rng.uniform(-10, 10, (2, n_ground)).T, rng.normal(0, 0.02, n_ground)]
    )
    obj = rng.normal([0, 0, 2.0], 0.4, (n_obj, 3))
    return np.vstack([ground, obj]).astype(np.float32)


def _dense_scene(n, seed=0):
    """The density-matched bench scene (bench._scene at +-10 m), finite,
    with an intensity attribute."""
    rng = np.random.default_rng(seed)
    n_ground = int(n * 0.6)
    ground = np.column_stack(
        [rng.uniform(-10, 10, (2, n_ground)).T, rng.normal(0, 0.03, n_ground)]
    )
    centers = rng.uniform(-7.5, 7.5, (24, 3)) * [1, 1, 0] + [0, 0, 1.5]
    obj = centers[rng.integers(0, 24, n - n_ground)] + rng.normal(0, 0.8, (n - n_ground, 3))
    return {
        "positions": np.vstack([ground, obj]).astype(np.float32),
        "intensity": rng.uniform(0, 255, n).astype(np.float32),
    }


def _bounds_input():
    """Positions [3, 4096] with 500 dead rows, NaN on 100 of them."""
    rng = np.random.default_rng(3)
    pos = _scene(rng, 3000, 1096).T.copy()
    mask = np.ones(4096, bool)
    dead = rng.choice(4096, 500, replace=False)
    mask[dead] = False
    pos[:, dead[:100]] = np.nan
    return pos, mask


def _buf(soa, capacity):
    if not isinstance(soa, dict):
        soa = {"positions": soa}
    return from_soa(soa, capacity=capacity, device="cpu")[0]


def _params(**kw):
    return PipelineParams.make(device="cpu", **kw)


def _survivors(positions, mask, normals=None):
    """Survivor position (rounded to 1e-5) -> its normal (or None)."""
    mask = np.asarray(mask)
    keys = [tuple(p) for p in np.round(np.asarray(positions)[:, mask].T, 5).tolist()]
    if normals is None:
        return dict.fromkeys(keys)
    return dict(zip(keys, np.asarray(normals)[:, mask].T))


def _assert_close(port, ref, normals=True, min_common=300):
    """Survivor jaccard >= 0.99 and, with normals, >= 98% of the common
    survivors' normals within 2 degrees (sign-agnostic)."""
    common = port.keys() & ref.keys()
    jaccard = len(common) / max(len(port.keys() | ref.keys()), 1)
    assert len(common) > min_common, (len(port), len(ref))
    assert jaccard >= 0.99, jaccard
    if normals:
        cos = np.array([abs(float(np.dot(port[p], ref[p]))) for p in common])
        share = float((cos >= np.cos(np.deg2rad(2.0))).mean())
        assert share >= 0.98, share


def _overlap(a, b, tol):
    """test_parallel.py's _survivor_overlap: the smaller of the shares of
    ``a`` rows with a ``b`` row within ``tol`` and vice versa."""
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return min((d2.min(axis=1) < tol * tol).mean(), (d2.min(axis=0) < tol * tol).mean())


# ------------------------------------------------------- the rank side ----

class _Rank:
    """One rank's view: the 1-D mesh, its point axis and the outputs."""

    def __init__(self, rank, draws):
        self.rank = rank
        self.mesh = sh.make_mesh()
        self.axis = sh._Axis.of(self.mesh, "point")
        self.draws = draws
        self.out = {}

    def u(self, h_local=H_LOCAL):
        """This rank's RANSAC draws: the reference's for shard ``rank``,
        ``h_local`` hypotheses."""
        return torch.from_numpy(self.draws[h_local][self.rank])

    def stacked(self, t):
        """Every rank's ``t`` stacked on a leading rank axis."""
        if t.dtype == torch.bool:
            return torch.stack(sh._all_gather(t.to(torch.int32), self.axis.group)).numpy() != 0
        return torch.stack(sh._all_gather(t, self.axis.group)).numpy()

    def save(self, case, **arrays):
        if self.rank == 0:
            for k, v in arrays.items():
                self.out[f"{case}/{k}"] = np.asarray(v)

    def save_buffer(self, case, local, plane=None, **extra):
        """The gathered buffer (positions, mask, normals) and the plane."""
        full = sh.unshard_buffer(local, self.mesh)
        arrays = dict(pos=full.positions.numpy(), mask=full.mask.numpy(), **extra)
        if "normals" in full.attributes:
            arrays["normals"] = full.attributes["normals"].numpy()
        if plane is not None:
            arrays["plane"] = plane.numpy()
        self.save(case, **arrays)

    def sharded(self, settings, buf, params, halo=512, uniforms=True):
        run = sh.build_sharded_pipeline(settings, self.mesh, "point", halo)
        local = sh.shard_buffer(buf, self.mesh)
        return run(local, params, None, self.u() if uniforms else None)

    def single(self, settings, buf, params):
        """The unsharded port pipeline, on rank 0 only (no collectives)."""
        if self.rank != 0:
            return None, None
        return build_pipeline(settings)(buf, params, torch.Generator().manual_seed(0))


def _case_halo(r):
    """(b) the global live box and the halo exchange on sorted slabs."""
    pos, mask = _bounds_input()
    local = sh.shard_buffer(ScanBuffer(torch.from_numpy(pos), torch.from_numpy(mask), {}), r.mesh)
    lo, hi = sh._global_live_bounds(local.positions, local.mask, r.axis)
    ext_pos, ext_mask, h = sh._halo_exchange(local.positions, local.mask, r.axis, 256)
    assert h == 256
    r.save("halo", lo=r.stacked(lo), hi=r.stacked(hi), pos=r.stacked(ext_pos),
           mask=r.stacked(ext_mask))


def _case_ground(r):
    """(d) the distributed RANSAC alone, voting on every slot and on a
    strided subsample."""
    buf = _buf(_scene(np.random.default_rng(0)), 4096)
    local = sh.shard_buffer(buf, r.mesh)
    for sub in (0, 1024):
        out, plane = sh._sharded_ground(local, r.axis, 0.08, RANSAC_N, 64, score_subsample=sub,
                                        uniforms=r.u())
        r.save_buffer(f"ground{sub}", out, plane, planes=r.stacked(plane))


def _case_exact(r):
    """(e) test_parallel.py:122-147's exact-kNN pipeline."""
    buf = _buf(_scene(np.random.default_rng(0)), 4096)
    out, plane = r.sharded(PipelineSettings(**EXACT), buf,
                           _params(voxel_size=0.15, distance_threshold=0.08))
    r.save_buffer("exact", out, plane)


def _case_production(r):
    """(f) the production knobs at capacity 8192."""
    buf = _buf(_dense_scene(8000), 8192)
    out, plane = r.sharded(PipelineSettings(**FULL), buf,
                           _params(voxel_size=0.1, distance_threshold=0.1, search_radius=0.5))
    r.save_buffer("production", out, plane)


def _case_outlier_stats(r):
    """(g) test_sharded_outlier_stats_are_global."""
    rng = np.random.default_rng(0)
    pts = np.vstack([rng.normal(0, 0.1, (2000, 3)), rng.uniform(50, 60, (48, 3))]).astype(np.float32)
    settings = PipelineSettings(
        remove_duplicates=False, crop_to_roi=False, voxel_downsample=False,
        estimate_normals=False, remove_statistical_outliers=True, nb_neighbors=8,
        knn_method="exact",
    )
    out, _ = r.sharded(settings, _buf(pts, 2048), _params(std_ratio=2.0))
    r.save_buffer("outlier_stats", out)


def _case_normals(r):
    """(g) test_sharded_pipeline_estimate_normals_public_api."""
    settings = PipelineSettings(
        estimate_normals=True, max_neighbors=8, knn_method="exact", remove_ground=True,
        num_iterations=64, ransac_n=3,
    )
    buf = _buf(_scene(np.random.default_rng(0), 1500, 300), 2048)
    out, plane = r.sharded(settings, buf, _params(voxel_size=0.12, distance_threshold=0.08))
    r.save_buffer("normals", out, plane, local_capacity=out.capacity)


def _case_parity(r):
    """(g) test_sharded_vs_single_device_survivor_parity (64 duplicates)."""
    pts = _scene(np.random.default_rng(0), 2500, 600)
    buf = _buf(np.vstack([pts, pts[:64]]), 4096)
    params = _params(voxel_size=0.15, distance_threshold=0.08)
    out, plane = r.sharded(PipelineSettings(**EXACT), buf, params)
    single, splane = r.single(PipelineSettings(**EXACT), buf, params)
    r.save_buffer("parity", out, plane)
    if single is not None:
        r.save("parity", single_pos=single.positions, single_mask=single.mask, single_plane=splane)


def _case_shrink(r):
    """(g) test_sharded_post_downsample_shrink: 4096 of 8192 over 4 ranks
    is a 1024-row share each."""
    buf = _buf(_scene(np.random.default_rng(0), 2000, 400), 8192)
    settings = PipelineSettings(estimate_normals=False, post_downsample_capacity=4096)
    params = _params(voxel_size=0.15)
    base, _ = r.sharded(dataclasses.replace(settings, post_downsample_capacity=0), buf, params)
    out, _ = r.sharded(settings, buf, params)
    r.save("shrink", base_counts=r.stacked(base.mask.sum()), counts=r.stacked(out.mask.sum()),
           local_capacity=out.capacity)


def _case_radius(r):
    """(g) test_sharded_radius_outliers."""
    rng = np.random.default_rng(0)
    pts = _scene(rng, 2000, 400)
    specks = rng.uniform(-40, 40, (40, 3)).astype(np.float32)
    specks[:, 2] += 30.0
    settings = PipelineSettings(
        estimate_normals=False, voxel_downsample=False, remove_radius_outliers=True,
        knn_method="exact",
    )
    out, _ = r.sharded(settings, _buf(np.vstack([pts, specks]), 4096),
                       _params(radius_nb_points=4, radius_search_radius=0.8))
    r.save_buffer("radius", out)


def _case_window_full(r):
    """(g) test_sharded_window_path_full_pipeline, against the unsharded
    port."""
    buf = _buf(_scene(np.random.default_rng(0), 9000, 2200), 16384)
    params = _params(voxel_size=0.12, distance_threshold=0.08, std_ratio=1.5, search_radius=0.5)
    out, plane = r.sharded(PipelineSettings(**WINDOW), buf, params)
    single, splane = r.single(PipelineSettings(**WINDOW), buf, params)
    r.save_buffer("window_full", out, plane)
    if single is not None:
        r.save("window_full", single_pos=single.positions, single_mask=single.mask,
               single_plane=splane)


def _case_quality(r):
    """(g) test_sharded_window_quality_vs_single_device: the keep-mask of
    the outlier-only stage against the unsharded port's in the same
    (spatially sorted) frame, at halo 0 and 512."""
    buf = _buf(_scene(np.random.default_rng(0), 12000, 3000), 16384)
    settings = PipelineSettings(**OUTLIERS_ONLY)
    params = _params(std_ratio=1.0)
    single, _ = r.single(settings, sh.spatial_sort(buf), params)
    masks = {}
    for halo in (0, 512):
        out, _ = r.sharded(settings, buf, params, halo=halo, uniforms=False)
        masks[halo] = sh.unshard_buffer(out, r.mesh).mask
    if single is not None:
        r.save("quality", single=single.mask, live=sh.spatial_sort(buf).mask, halo0=masks[0],
               halo512=masks[512])


def _resurrect_input():
    """test_parallel.py:395-425's buffer: a uniform cube with a band of
    live rows killed ahead of the stage."""
    rng = np.random.default_rng(5)
    n = 2048
    buf = _buf(rng.uniform(-10, 10, (n - 300, 3)).astype(np.float32), n)
    mask = buf.mask.clone()
    mask[200:900] = False
    return buf.replace(mask=mask)


#: test_parallel.py:408-413's settings, but for the window route
RESURRECT = dict(
    remove_statistical_outliers=True, nb_neighbors=8, estimate_normals=True, max_neighbors=8,
    remove_ground=True, ground_before_voxel=True, ransac_n=3, num_iterations=32,
    knn_method="window", voxel_downsample=False,
)


def _case_resurrect(r):
    """(g) test_sharded_fused_neighborhood_never_resurrects on the kernel
    route (the reference's case runs the XLA route, ``_case_resurrect_xla``)."""
    buf = _resurrect_input()
    run = sh.build_sharded_pipeline(PipelineSettings(**RESURRECT), r.mesh, "point")
    out, _ = run(sh.shard_buffer(buf, r.mesh, "point"), _params(voxel_size=0.0),
                 torch.Generator().manual_seed(r.rank))
    r.save("resurrect", live_in=int(buf.mask.sum()), live_out=r.stacked(out.mask.sum()))


def _case_resurrect_xla(r):
    """(g) test_parallel.py:395-425 with its own settings (pallas_ok=False:
    the XLA window route) and the reference's draws (8 hypotheses a rank)."""
    buf = _resurrect_input()
    settings = PipelineSettings(**RESURRECT, pallas_ok=False)
    run = sh.build_sharded_pipeline(settings, r.mesh, "point")
    out, plane = run(sh.shard_buffer(buf, r.mesh, "point"), _params(voxel_size=0.0), None,
                     r.u(8))
    r.save_buffer("resurrect_xla", out, plane, live_in=int(buf.mask.sum()))


def _case_ground_first(r):
    """(g) test_sharded_ground_first_defers_shrink_like_single_chip."""
    buf = _buf(_scene(np.random.default_rng(0)), 4096)
    settings = PipelineSettings(**GROUND_FIRST)
    params = _params(voxel_size=0.15, distance_threshold=0.08)
    out, plane = r.sharded(settings, buf, params)
    single, splane = r.single(settings, buf, params)
    r.save_buffer("ground_first", out, plane)
    if single is not None:
        r.save("ground_first", single_mask=single.mask, single_plane=splane)


def _case_ground_first_xla(r):
    """(g) test_parallel.py:428-454 with its own settings (pallas_ok=False)."""
    buf = _buf(_scene(np.random.default_rng(0)), 4096)
    settings = PipelineSettings(**GROUND_FIRST, pallas_ok=False)
    out, plane = r.sharded(settings, buf, _params(voxel_size=0.15, distance_threshold=0.08))
    r.save_buffer("ground_first_xla", out, plane)


def _case_knobs(r):
    """(g) test_sharded_pipeline_accepts_per_pass_window_tuple and
    test_sharded_fused_kernel_under_shard_map_threads_knobs: the per-pass
    tuple, kmode and the fused radius2 reach K3 on every pass."""
    buf = _buf(_scene(np.random.default_rng(0), 6000, 1500), 8192)
    settings = PipelineSettings(**dict(
        WINDOW, nb_neighbors=9, remove_radius_outliers=True, window_blocks=(1, 0),
        knn_d2mode="fast3",
    ))
    params = _params(voxel_size=0.12, distance_threshold=0.08, std_ratio=1.5, search_radius=0.5,
                     radius_search_radius=0.4, radius_nb_points=2)
    calls, real = [], port_window.window_stats

    def spy(*a, **kw):
        calls.append(f"{kw['window_blocks']},{kw['kmode']},{kw['direction']},"
                     f"{kw.get('radius2') is not None},{a[0].shape[-1]}")
        return real(*a, **kw)

    port_window.window_stats = spy
    try:
        out_t, plane_t = r.sharded(settings, buf, params)
    finally:
        port_window.window_stats = real
    out_i, plane_i = r.sharded(dataclasses.replace(settings, window_blocks=1), buf, params)
    single, _ = r.single(settings, sh.spatial_sort(buf), params)
    r.save_buffer("knobs", out_t, plane_t, calls=np.array(calls))
    r.save_buffer("knobs_int", out_i, plane_i)
    if single is not None:
        r.save("knobs", single_pos=single.positions, single_mask=single.mask)


def _case_compact_keys(r):
    """(g) test_sharded_voxel_compact_keys_match_exact_keys."""
    buf = _buf(_scene(np.random.default_rng(0), 5000, 1200), 8192)
    params = _params(voxel_size=0.12, distance_threshold=0.08, std_ratio=1.5, search_radius=0.5)
    out_c, plane_c = r.sharded(PipelineSettings(voxel_compact_keys="box", **WINDOW), buf, params)
    out_e, _ = r.sharded(PipelineSettings(**WINDOW), buf, params)
    r.save_buffer("compact_box", out_c, plane_c)
    r.save_buffer("compact_exact", out_e)


def _case_warning(r):
    """(g) the cap warning: a bucket that does not split into 512-row
    shares over 4 ranks inflates the global cap."""
    texts = []
    for cap in (4608, 409_600):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sh.build_sharded_pipeline(
                PipelineSettings(estimate_normals=False, post_downsample_capacity=cap), r.mesh)
        texts.append(" | ".join(str(w.message) for w in caught))
    r.save("warning", inflated=texts[0], exact=texts[1])


def _case_scan_point(r):
    """(h) a 2 x 2 ('scan', 'point') mesh with a batch of 4 scans: each
    scan rank runs 2 scans on the batch axis over its 2-rank point group;
    each scan must equal the same scan run alone on that group."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("scan", "point"))
    s = mesh.get_local_rank("scan")
    scans = [_buf(_dense_scene(4000, seed), 4096) for seed in range(4)]
    mine = scans[2 * s : 2 * s + 2]
    settings = PipelineSettings(**dict(FULL, post_downsample_capacity=2048))
    params = _params(voxel_size=0.1, distance_threshold=0.1, search_radius=0.5)
    draws = torch.from_numpy(np.random.default_rng(10 + s).uniform(size=(2, 32, 3))
                             .astype(np.float32))
    run = sh.build_sharded_pipeline(settings, mesh, "point")
    out, planes = run(sh.shard_buffer(stack_buffers(mine), mesh), params, None, draws)
    same = []
    for i, scan in enumerate(mine):
        alone, plane = run(sh.shard_buffer(scan, mesh), params, None, draws[i])
        same.append(
            torch.equal(out.mask[i], alone.mask)
            and torch.equal(out.positions[i], alone.positions)
            and torch.equal(out.attributes["normals"][i], alone.attributes["normals"])
            and torch.equal(planes[i], plane)
            and int(alone.mask.sum()) > 0
        )
    r.save("scan_point", same=r.stacked(torch.tensor(same)), batch_shape=list(out.mask.shape))


#: the sharded steps the dispatch probe walks: the production knobs with
#: the shrink engaged, exact kNN, the random downsampler ahead of a
#: ground-first RANSAC, unfused radius outliers and normals, the height cut
PROBED = {
    "production_shrink": dict(FULL, post_downsample_capacity=2048),
    "exact": EXACT,
    "random_ground_first": dict(WINDOW, downsample_method="random", ground_before_voxel=False,
                                ground_before_neighborhood=True, post_downsample_capacity=2048),
    "radius_unfused": dict(WINDOW, remove_radius_outliers=True, fuse_neighborhood=False),
    "height": dict(FULL, ground_method="height"),
    "production_xla": dict(FULL, post_downsample_capacity=2048, pallas_ok=False),
}


def _case_capture(r):
    """(i) the step as one captured program, on these gloo CPU ranks: the
    dispatch probe finds no host read on any ``PROBED`` step; drawing the
    uniforms ahead equals drawing them inside; with the capture replaced by
    ``tests/test_torch_graphs.py``'s eager stand-in and ``captures_step``
    held true, the step's replays equal eager runs, credit the kernel
    launches (counted by wrapping K2's and K3's consumers) and the
    collectives, and two groups of equal shapes get a program each."""
    from test_torch_graphs import _EagerGraph, _HostReadProbe, _same

    from autodriver_pointcloud_preprocessor_tpu_torch.models import graphs
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import _build
    from autodriver_pointcloud_preprocessor_tpu_torch.ops import voxel as port_voxel

    buf = _buf(_dense_scene(8000), 8192)
    params = _params(voxel_size=0.1, distance_threshold=0.1, search_radius=0.5,
                     radius_search_radius=0.5, radius_nb_points=2, sampling_ratio=0.5,
                     ground_plane=[0.0, 0.0, 1.0, 0.0])
    local = sh.shard_buffer(buf, r.mesh)
    cpu = torch.device("cpu")
    for name, kw in PROBED.items():
        settings = PipelineSettings(**kw)
        draws = sh.draw_local_uniforms(settings, WORLD, (), local.capacity,
                                       torch.Generator().manual_seed(r.rank), cpu)
        probe = _HostReadProbe()
        with probe:
            out, _ = sh.make_local_run(settings, mesh=r.mesh)(local, params, None, *draws)
        r.save("capture", **{f"probe_{name}": np.array(sorted(set(probe.found)), dtype=str),
                             f"live_{name}": r.stacked(out.mask.sum())})

    same = []
    for kw in (dict(FULL, downsample_method="random"),  # ground, then the downsampler
               dict(WINDOW, downsample_method="random", ground_before_voxel=False)):
        settings = PipelineSettings(**kw)
        run = sh.make_local_run(settings, mesh=r.mesh)
        inside = torch.Generator().manual_seed(7 + r.rank)
        want = run(local, params, inside)
        ahead = torch.Generator().manual_seed(7 + r.rank)
        draws = sh.draw_local_uniforms(settings, WORLD, (), local.capacity, ahead, cpu)
        same.append(_same(run(local, params, None, *draws), want)
                    and torch.equal(torch.rand(3, generator=inside), torch.rand(3, generator=ahead)))
    r.save("capture", draws_ahead=r.stacked(torch.tensor(same)))

    class _Graph(_EagerGraph):  # a replay counts no collective either
        def replay(self):
            saved = dict(sh.COLLECTIVES)
            super().replay()
            sh.COLLECTIVES.update(saved)

    def capture(fn, device):
        outputs = fn()
        return _Graph(fn, outputs), outputs, 0

    def counting(name, real):
        def spy(*a, **kw):
            _build.LAUNCHES[name] += 1
            return real(*a, **kw)
        return spy

    patched = [(graphs, "_capture", capture), (sh, "captures_step", lambda group, device: True),
               (torch.cuda, "mem_get_info", lambda device=None: (1 << 36, 1 << 36)),
               (port_voxel, "segmented_sums", counting("segmented_sums", port_voxel.segmented_sums)),
               (port_window, "window_stats", counting("window_stats", port_window.window_stats))]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]
    for obj, name, value in patched:
        setattr(obj, name, value)
    graphs.clear()
    try:
        settings = PipelineSettings(**dict(FULL, post_downsample_capacity=2048))
        step = sh.build_sharded_pipeline(settings, r.mesh)
        eager = sh.make_local_run(settings, mesh=r.mesh)

        def counted(fn, generator, u):
            _build.reset_launches()
            sh.reset_collectives()
            out = fn(local, params, generator, u)
            return out, [_build.LAUNCHES[k] for k in _build.LAUNCHES] + [
                sh.COLLECTIVES["calls"], sh.COLLECTIVES["bytes"]]

        replays, counts = [], []
        # the capture, a replay on other draws, a replay drawing from a generator
        for u, seed in ((r.u(), None), (r.u().flip(0), None), (None, 5 + r.rank)):
            got, want = (counted(fn, None if seed is None else torch.Generator().manual_seed(seed),
                                 u) for fn in (step, eager))
            replays.append(_same(got[0], want[0]) and got[1] == want[1])
            counts.append(got[1])
        # another group over the same ranks: equal shapes, its own program
        other = sh.make_mesh(dist.new_group(list(range(WORLD))))
        got = sh.build_sharded_pipeline(settings, other)(local, params, None, r.u())
        replays.append(_same(got, eager(local, params, None, r.u())))
        progs = graphs.programs()
        r.save("capture", replays=r.stacked(torch.tensor(replays)), counts=np.array(counts),
               programs=len(progs), program_replays=[p.replays for p in progs])
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
        graphs.clear()


CASES = (
    _case_halo, _case_ground, _case_exact, _case_production, _case_outlier_stats,
    _case_normals, _case_parity, _case_shrink, _case_radius, _case_window_full,
    _case_quality, _case_resurrect, _case_resurrect_xla, _case_ground_first,
    _case_ground_first_xla, _case_knobs, _case_compact_keys,
    _case_warning, _case_scan_point, _case_capture,
)


def _rank_main(rank, store, out_path, draws):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=180))
    try:
        r = _Rank(rank, draws)
        for case in CASES:
            case(r)
        if rank == 0:
            np.savez(out_path, **r.out)
    finally:
        dist.destroy_process_group()


def _reference_draws(key_seed=0):
    """RANSAC draws of the reference's shard i, uniform(fold_in(key, i)),
    for 64 hypotheses (16 a rank) and for 32 (8 a rank)."""
    import jax

    key = jax.random.PRNGKey(key_seed)
    return {
        h: np.stack([
            np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (h, RANSAC_N)))
            for i in range(WORLD)
        ]).astype(np.float32)
        for h in (H_LOCAL, 8)
    }


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every port-side case's outputs, from one spawn of 4 gloo CPU ranks."""
    d = tmp_path_factory.mktemp("sharded")
    out = d / "out.npz"
    mp.start_processes(_rank_main, args=(str(d / "store"), str(out), _reference_draws()),
                       nprocs=WORLD, join=True, start_method="spawn")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _case(port, name):
    prefix = name + "/"
    return {k[len(prefix):]: v for k, v in port.items() if k.startswith(prefix)}


# ---------------------------------------------------- the reference side ----

def _ref_mesh():
    import jax

    from autodriver_pointcloud_preprocessor_tpu.parallel import sharding as rsh

    return rsh.make_mesh(jax.devices()[:WORLD])


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The reference's window kernel in interpret mode: the one way it
    computes the port's window. Executables traced under another backend
    are dropped before and after."""
    import jax

    from autodriver_pointcloud_preprocessor_tpu.parallel import sharding as rsh

    monkeypatch.setenv("APC_WINDOW_BACKEND", "pallas_interpret")
    jax.clear_caches()
    rsh.build_sharded_pipeline.cache_clear()
    yield
    jax.clear_caches()
    rsh.build_sharded_pipeline.cache_clear()


def _ref_sharded(settings_kw, soa, capacity, params_kw, mask=None):
    """The reference's sharded pipeline on 4 CPU devices, key PRNGKey(0);
    ``mask`` replaces the buffer's live mask."""
    import jax

    from autodriver_pointcloud_preprocessor_tpu.core import from_soa as ref_from_soa
    from autodriver_pointcloud_preprocessor_tpu.models import PipelineParams as RParams
    from autodriver_pointcloud_preprocessor_tpu.models import PipelineSettings as RSettings
    from autodriver_pointcloud_preprocessor_tpu.parallel import sharding as rsh

    mesh = _ref_mesh()
    rbuf, _ = ref_from_soa(soa if isinstance(soa, dict) else {"positions": soa}, capacity=capacity)
    if mask is not None:
        rbuf = rbuf.with_mask(jax.numpy.asarray(mask))
    run = rsh.build_sharded_pipeline(RSettings(**settings_kw), mesh)
    out, plane = run(rsh.shard_buffer(rbuf, mesh), RParams.make(**params_kw),
                     jax.random.PRNGKey(0))
    normals = out.attributes.get("normals")
    return (np.asarray(out.positions), np.asarray(out.mask), np.asarray(plane),
            None if normals is None else np.asarray(normals))


# ------------------------------------------------------------------ (a) ----

@pytest.mark.parametrize("batched", [False, True])
def test_spatial_sort_order_is_bit_equal(batched):
    import jax.numpy as jnp

    from autodriver_pointcloud_preprocessor_tpu.core.scan import ScanBuffer as RBuf
    from autodriver_pointcloud_preprocessor_tpu.parallel import sharding as rsh

    soa = _dense_scene(6000, seed=1)
    soa["positions"][::7] += 1e-3  # near-ties in the curve cells
    buf = _buf(soa, 8192)
    rbuf = RBuf(positions=jnp.asarray(buf.positions.numpy()), mask=jnp.asarray(buf.mask.numpy()),
                attributes={"intensity": jnp.asarray(buf.attributes["intensity"].numpy())})
    want = rsh.spatial_sort(rbuf)
    got = sh.spatial_sort(stack_buffers([buf, buf]) if batched else buf)
    for g, w in ((got.positions, want.positions), (got.mask, want.mask),
                 (got.attributes["intensity"], want.attributes["intensity"])):
        g = g.numpy()
        for one in (g if batched else [g]):
            np.testing.assert_array_equal(one, np.asarray(w))


def test_spatial_sort_puts_non_finite_rows_last():
    # one NaN makes the reference's live box NaN (ROADMAP fault 12): the
    # port sorts non-finite rows with the invalid ones and keeps them live
    soa = _dense_scene(3000, seed=2)
    soa["positions"][::50] = np.nan
    buf = _buf(soa, 4096)
    out = sh.spatial_sort(buf)
    finite = torch.isfinite(out.positions).all(0)
    n_good = int((buf.mask & torch.isfinite(buf.positions).all(0)).sum())
    assert bool(finite[:n_good].all()) and int(out.mask.sum()) == 3000
    clean = sh.spatial_sort(buf.replace(mask=buf.mask & torch.isfinite(buf.positions).all(0)))
    assert torch.equal(out.positions[:, :n_good], clean.positions[:, :n_good])


# ------------------------------------------------------------------ (b) ----

def test_global_bounds_and_halo_exchange_are_bit_equal(port):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from autodriver_pointcloud_preprocessor_tpu.core.scan import ScanBuffer as RBuf
    from autodriver_pointcloud_preprocessor_tpu.parallel import sharding as rsh

    pos, mask = _bounds_input()
    mesh = _ref_mesh()
    sb = rsh.shard_buffer(RBuf(jnp.asarray(pos), jnp.asarray(mask), {}), mesh)

    def body(p, m):
        lo, hi = rsh._global_live_bounds(p, m, "point")
        ep, em, _ = rsh._halo_exchange(p, m, "point", 256)
        return lo[None], hi[None], ep[None], em[None]

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(None, "point"), P("point")),
                           out_specs=(P("point"),) * 4, check_vma=False))
    lo, hi, ext_pos, ext_mask = (np.asarray(a) for a in fn(sb.positions, sb.mask))
    got = _case(port, "halo")
    np.testing.assert_array_equal(got["lo"], lo)
    np.testing.assert_array_equal(got["hi"], hi)
    assert got["pos"].shape == ext_pos.shape == (WORLD, 3, 1024 + 2 * 256)
    np.testing.assert_array_equal(got["pos"].view(np.int32), ext_pos.view(np.int32))
    np.testing.assert_array_equal(got["mask"], ext_mask)
    # end ranks got a False-masked zero halo
    assert not got["mask"][0, :256].any() and not got["mask"][-1, -256:].any()


# ------------------------------------------------------------------ (c) ----

@pytest.mark.parametrize("pass_idx", [0, 1, 2, 3])
@pytest.mark.parametrize("batched", [False, True])
def test_bounds_curve_codes_are_bit_equal(pass_idx, batched):
    import jax.numpy as jnp

    from autodriver_pointcloud_preprocessor_tpu.ops import window as rw

    pos, mask = _bounds_input()
    pos = np.nan_to_num(pos)
    lo = np.array([-12.5, -11.0, -1.5], np.float32)
    hi = np.array([11.0, 10.25, 4.0], np.float32)
    perm = rw._PASS_PERMS[pass_idx % 4]
    want = np.asarray(rw.hilbert_codes(
        jnp.stack([pos[p] for p in perm]), jnp.asarray(mask), rw._pass_shift(pass_idx),
        rw._permute_bounds((jnp.asarray(lo), jnp.asarray(hi)), perm)))
    tp, tm, tb = torch.from_numpy(pos), torch.from_numpy(mask), (torch.from_numpy(lo),
                                                                 torch.from_numpy(hi))
    if batched:  # a second scan with its own box
        tp, tm = torch.stack([tp, tp * 0.5]), torch.stack([tm, tm])
        tb = (torch.stack([tb[0], tb[0] * 0.5]), torch.stack([tb[1], tb[1] * 0.5]))
    codes, order = port_window._curve_order(tp, tm, pass_idx, tb)
    got = torch.empty_like(codes).scatter_(-1, order, codes).numpy()
    np.testing.assert_array_equal(got[0] if batched else got, want)
    if batched:
        alone = port_window._curve_order(tp[1], tm[1], pass_idx, (tb[0][1], tb[1][1]))
        assert torch.equal(codes[1], alone[0]) and torch.equal(order[1], alone[1])
    # without bounds nothing changes: the live box of the rows
    no_bounds = port_window.hilbert_codes(tp, tm)
    live = tm.unsqueeze(-2)
    box = (torch.where(live, tp, 3.4e38).amin(-1), torch.where(live, tp, -3.4e38).amax(-1))
    assert torch.equal(no_bounds, port_window.hilbert_codes(tp, tm, 0.0, box))


# ------------------------------------------------------------------ (d) ----

@pytest.mark.parametrize("subsample", [0, 1024])
def test_sharded_ground_matches_reference(port, subsample):
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from autodriver_pointcloud_preprocessor_tpu.core import from_soa as ref_from_soa
    from autodriver_pointcloud_preprocessor_tpu.parallel import sharding as rsh

    pts = _scene(np.random.default_rng(0))
    mesh = _ref_mesh()
    sb = rsh.shard_buffer(ref_from_soa({"positions": pts}, capacity=4096)[0], mesh)
    specs = rsh.buffer_pspecs(sb)

    def body(b, key):
        return rsh._sharded_ground(b, key, 0.08, RANSAC_N, 64, "point", score_subsample=subsample)

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, P()), out_specs=(specs, P()),
                           check_vma=False))
    rout, rplane = fn(sb, jax.random.PRNGKey(0))
    got = _case(port, f"ground{subsample}")
    plane = np.asarray(rplane)
    np.testing.assert_allclose(got["plane"], plane, atol=1e-5)
    assert abs(plane[2]) > 0.99
    for p in got["planes"]:  # equal on every rank
        np.testing.assert_array_equal(p, got["plane"])
    live = np.asarray(sb.mask)
    differ = (got["mask"] != np.asarray(rout.mask)) & live
    pos = np.asarray(sb.positions)
    dist_to_plane = np.abs(plane[:3] @ pos + plane[3])
    # inliers differ only within 1e-5 of the threshold, on <= 0.1% of points
    assert (np.abs(dist_to_plane[differ] - 0.08) <= 1e-5).all()
    assert differ.sum() <= 1e-3 * live.sum(), differ.sum()


# ------------------------------------------------------------------ (e) ----

def test_sharded_exact_pipeline_matches_reference(port):
    pos, mask, plane, _ = _ref_sharded(EXACT, _scene(np.random.default_rng(0)), 4096,
                                       dict(voxel_size=0.15, distance_threshold=0.08))
    got = _case(port, "exact")
    np.testing.assert_allclose(got["plane"], plane, atol=1e-4)
    _assert_close(_survivors(got["pos"], got["mask"]), _survivors(pos, mask), normals=False)


# ------------------------------------------------------------------ (f) ----

def test_sharded_production_knobs_match_reference(port, pallas_interpret):
    pos, mask, plane, normals = _ref_sharded(
        FULL, _dense_scene(8000), 8192,
        dict(voxel_size=0.1, distance_threshold=0.1, search_radius=0.5))
    got = _case(port, "production")
    assert abs(plane[2]) > 0.99 and abs(got["plane"][2]) > 0.99
    np.testing.assert_allclose(got["plane"], plane, atol=1e-4)
    _assert_close(_survivors(got["pos"], got["mask"], got["normals"]),
                  _survivors(pos, mask, normals))


# ------------------------------------------------------------------ (g) ----

def test_sharded_outlier_stats_are_global(port):
    mask = _case(port, "outlier_stats")["mask"]
    assert mask[:2000].mean() > 0.97
    assert mask[2000:2048].sum() == 0


def test_sharded_pipeline_estimate_normals(port):
    got = _case(port, "normals")
    assert got["normals"].shape == (3, 2048) and int(got["local_capacity"]) == 512
    lens = np.linalg.norm(got["normals"][:, got["mask"]], axis=0)
    assert np.all(np.abs(lens - 1.0) < 1e-3)
    assert abs(got["plane"][2]) > 0.99


def test_sharded_vs_single_device_survivor_parity(port):
    got = _case(port, "parity")
    assert abs(got["plane"][2]) > 0.99 and abs(got["single_plane"][2]) > 0.99
    overlap = _overlap(got["single_pos"].T[got["single_mask"]], got["pos"].T[got["mask"]], 0.075)
    assert overlap >= 0.97, overlap


def test_sharded_post_downsample_shrink(port):
    got = _case(port, "shrink")
    # each rank caps its own voxels at its 1024-row share
    assert int(got["local_capacity"]) == 1024
    expected = int(np.minimum(got["base_counts"], 1024).sum())
    assert int(got["counts"].sum()) == expected > 0


def test_sharded_radius_outliers(port):
    got = _case(port, "radius")
    kept = got["pos"][:, got["mask"]]
    assert kept.shape[1] > 1000
    assert (kept[2] < 25.0).all()


def test_sharded_window_path_full_pipeline(port):
    got = _case(port, "window_full")
    assert abs(got["plane"][2]) > 0.99 and abs(got["single_plane"][2]) > 0.99
    lens = np.linalg.norm(got["normals"][:, got["mask"]], axis=0)
    assert np.all(np.abs(lens - 1.0) < 1e-3)
    overlap = _overlap(got["single_pos"].T[got["single_mask"]], got["pos"].T[got["mask"]], 0.06)
    assert overlap >= 0.95, overlap


def test_sharded_window_quality_vs_single_device(port):
    got = _case(port, "quality")
    live = got["live"]
    agree = {h: (got["single"] == got[f"halo{h}"])[live].mean() for h in (0, 512)}
    assert agree[512] >= agree[0]
    assert agree[512] >= 0.97, agree
    assert agree[0] >= 0.95, agree


def test_sharded_fused_neighborhood_never_resurrects(port):
    got = _case(port, "resurrect")
    live_out = int(got["live_out"].sum())
    assert 0 < live_out <= int(got["live_in"])


def test_sharded_xla_route_never_resurrects_like_the_reference(port):
    # test_parallel.py:395-425 as the reference runs it (pallas_ok=False)
    got = _case(port, "resurrect_xla")
    buf = _resurrect_input()
    pos, mask, plane, normals = _ref_sharded(
        dict(RESURRECT, pallas_ok=False), buf.positions.numpy()[:, :1748].T, 2048,
        dict(voxel_size=0.0), mask=buf.mask.numpy())
    assert 0 < int(got["mask"].sum()) <= int(got["live_in"])
    np.testing.assert_allclose(got["plane"], plane, atol=1e-4)
    _assert_close(_survivors(got["pos"], got["mask"], got["normals"]),
                  _survivors(pos, mask, normals))


def test_sharded_ground_first_defers_shrink_like_single_chip(port):
    got = _case(port, "ground_first")
    assert abs(got["plane"][2]) > 0.99 and abs(got["single_plane"][2]) > 0.99
    ns, nm = int(got["single_mask"].sum()), int(got["mask"].sum())
    assert nm > 0 and abs(ns - nm) / max(ns, 1) < 0.15, (ns, nm)


def test_sharded_xla_route_ground_first_matches_the_reference(port):
    # test_parallel.py:428-454 as the reference runs it (pallas_ok=False)
    got = _case(port, "ground_first_xla")
    pos, mask, plane, normals = _ref_sharded(
        dict(GROUND_FIRST, pallas_ok=False), _scene(np.random.default_rng(0)), 4096,
        dict(voxel_size=0.15, distance_threshold=0.08))
    np.testing.assert_allclose(got["plane"], plane, atol=1e-4)
    port, ref = (_survivors(got["pos"], got["mask"], got["normals"]),
                 _survivors(pos, mask, normals))
    # the reference's shrink slices a prefix of the holed voxel buffer and
    # drops live points (ROADMAP fault 13); the port's keeps them, so the
    # reference's survivors are the port's, less those
    common = port.keys() & ref.keys()
    assert len(port) > len(ref) > 200
    assert len(common) >= 0.99 * len(ref), (len(common), len(ref))
    cos = np.array([abs(float(np.dot(port[p], ref[p]))) for p in common])
    assert float((cos >= np.cos(np.deg2rad(2.0))).mean()) >= 0.98


def test_sharded_per_pass_window_tuple_reaches_the_kernel(port):
    got, ints = _case(port, "knobs"), _case(port, "knobs_int")
    # (wb, kmode, direction, radius2 fused, rows): pass 0 symmetric wb=1,
    # pass 1 one-sided wb=0, over the halo-extended slab (2048 + 2 * 512
    # rows on middle ranks)
    calls = [c.rsplit(",", 1) for c in got["calls"].tolist()]
    assert {c[0] for c in calls} == {"1,sweep,0,True", "0,sweep,1,True"}
    assert {int(c[1]) for c in calls} <= {2048 + 512, 2048 + 1024}
    assert abs(got["plane"][2]) > 0.99 and abs(ints["plane"][2]) > 0.99
    surv = got["pos"].T[got["mask"]]
    assert len(surv) > 0
    assert _overlap(got["single_pos"].T[got["single_mask"]], surv, 0.06) >= 0.9
    assert _overlap(ints["pos"].T[ints["mask"]], surv, 0.06) >= 0.9


def test_sharded_voxel_compact_keys_match_exact_keys(port):
    box, exact = _case(port, "compact_box"), _case(port, "compact_exact")
    assert abs(box["plane"][2]) > 0.99
    sc = box["pos"].T[box["mask"]]
    se = exact["pos"].T[exact["mask"]]
    sc, se = sc[np.lexsort(sc.T)], se[np.lexsort(se.T)]
    assert sc.shape == se.shape, (sc.shape, se.shape)
    np.testing.assert_allclose(sc, se, atol=1e-5)


def test_sharded_cap_warning(port):
    got = _case(port, "warning")
    assert "post_downsample_capacity=4608 is not a multiple of 512 * 4" in str(got["inflated"])
    assert "effective global cap 6144" in str(got["inflated"])
    assert str(got["exact"]) == ""


# ------------------------------------------------------------------ (h) ----

def test_scan_point_mesh_batch_equals_lone_scans(port):
    got = _case(port, "scan_point")
    assert got["same"].all(), got["same"]
    assert list(got["batch_shape"]) == [2, 1024]


# ------------------------------------------------------------------ (i) ----

# ------------------------------------------------------------------ (i) ----

#: a 4096 bucket over the 4 ranks: a 1024-row share of a 2048-row slab
SHRINK_SHARE, SHRINK_SLAB = 1024, 2048


def _shrink_stage():
    """The sharded shrink stage of rank 0 of 4 (it needs no collective)."""
    settings = PipelineSettings(estimate_normals=False, post_downsample_capacity=4 * SHRINK_SHARE)
    return dict(sh._local_stages(settings, sh._Axis(None, WORLD, 0), 512))["shrink"]


def _front_compacted(live, seed=0):
    """A voxel stage's slab output: ``live`` points front-compacted, with
    an attribute."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((3, SHRINK_SLAB), np.float32)
    pos[:, :live] = rng.uniform(-10, 10, (3, live))
    return ScanBuffer(
        positions=torch.from_numpy(pos), mask=torch.arange(SHRINK_SLAB) < live,
        attributes={"intensity": torch.from_numpy(rng.uniform(0, 255, SHRINK_SLAB)
                                                  .astype(np.float32))})


def test_sharded_shrink_select_is_bit_equal_to_both_branches():
    from test_torch_graphs import _same

    from autodriver_pointcloud_preprocessor_tpu_torch import ops

    stage = _shrink_stage()
    params = _params()
    lives = (SHRINK_SHARE - 24, SHRINK_SHARE, SHRINK_SHARE + 76)  # below, at, above the share
    bufs = [_front_compacted(live, seed) for seed, live in enumerate(lives)]
    outs = [stage(b, params)[0] for b in bufs]
    for b, out, live in zip(bufs, outs, lives):
        want = (ops.shrink_front(b, SHRINK_SHARE) if live <= SHRINK_SHARE
                else ops.subsample_to(b, SHRINK_SHARE))
        assert out.capacity == SHRINK_SHARE and _same(out, want)
    # a batch mixing the three: each scan takes its own branch
    both = stage(stack_buffers(bufs), params)[0]
    for i, alone in enumerate(outs):
        assert _same(ScanBuffer(both.positions[i], both.mask[i],
                                {k: v[i] for k, v in both.attributes.items()}), alone)


@pytest.mark.parametrize("live", [SHRINK_SHARE - 24, SHRINK_SHARE, SHRINK_SHARE + 76])
def test_sharded_shrink_matches_the_reference_cond(live):
    """Against the reference's ``lax.cond`` of the sharded shrink
    (reference ``parallel/sharding.py:561``) on the same slab."""
    import jax
    import jax.numpy as jnp

    from autodriver_pointcloud_preprocessor_tpu import ops as rops
    from autodriver_pointcloud_preprocessor_tpu.core.scan import ScanBuffer as RBuf
    from autodriver_pointcloud_preprocessor_tpu.core.scan import valid_count

    buf = _front_compacted(live, seed=live)
    rbuf = RBuf(positions=jnp.asarray(buf.positions.numpy()), mask=jnp.asarray(buf.mask.numpy()),
                attributes={k: jnp.asarray(v.numpy()) for k, v in buf.attributes.items()})
    ref = jax.lax.cond(valid_count(rbuf) > SHRINK_SHARE,
                       lambda bb: rops.subsample_to(bb, SHRINK_SHARE),
                       lambda bb: rops.shrink_front(bb, SHRINK_SHARE), rbuf)
    got = _shrink_stage()(buf, _params())[0]
    # the live rows are bit-equal (the reference's sort is unstable only
    # among the dead tail)
    live_rows = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.mask.numpy(), live_rows)
    assert live_rows.sum() == min(live, SHRINK_SHARE)
    np.testing.assert_array_equal(got.positions.numpy()[:, live_rows],
                                  np.asarray(ref.positions)[:, live_rows])
    np.testing.assert_array_equal(got.attributes["intensity"].numpy()[live_rows],
                                  np.asarray(ref.attributes["intensity"])[live_rows])


@pytest.mark.parametrize("path", list(PROBED))
def test_sharded_step_reads_nothing_on_the_host(port, path):
    case = _case(port, "capture")
    assert list(case[f"probe_{path}"]) == [], f"{path}: host reads {list(case[f'probe_{path}'])}"
    assert (case[f"live_{path}"] > 0).all()


def test_sharded_drawing_ahead_equals_drawing_inside(port):
    assert _case(port, "capture")["draws_ahead"].all()


def test_sharded_replays_equal_eager_runs_and_credit_their_counts(port):
    case = _case(port, "capture")
    # every rank: the capture, two replays and the other group's program
    # equal the eager runs with their launches and collectives
    assert case["replays"].shape == (WORLD, 4) and case["replays"].all()
    counts = case["counts"]  # rank 0's K1, K2, K3, collective calls and bytes a step
    assert (counts[:, :3] == [0, 1, 2]).all() and (counts[:, 3] == 7).all()
    assert (counts == counts[0]).all()
    # two groups of equal shapes: a program each; the first replayed 3 times
    assert int(case["programs"]) == 2 and list(case["program_replays"]) == [3, 1]


def test_sharded_step_captures_only_on_nccl_cards():
    class _Group:
        def __init__(self, backend):
            self.backend = backend

    real = dist.get_backend
    try:
        dist.get_backend = lambda group: group.backend
        cuda, cpu = torch.device("cuda:0"), torch.device("cpu")
        assert sh.captures_step(_Group(dist.Backend.NCCL), cuda)
        assert not sh.captures_step(_Group(dist.Backend.GLOO), cuda)
        assert not sh.captures_step(_Group(dist.Backend.NCCL), cpu)
    finally:
        dist.get_backend = real


def test_halo_must_be_a_multiple_of_128():
    with pytest.raises(ValueError, match="multiple of 128"):
        sh.make_local_run(PipelineSettings(), halo=100)


def test_port_sharding_imports_no_jax_at_module_level():
    # the spawned ranks import this module: it must not pull in jax
    import ast

    tree = ast.parse(open(__file__).read())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top for a in n.names] + [
        n.module or "" for n in top if isinstance(n, ast.ImportFrom)]
    assert not any(m == "jax" or m.startswith("jax.") or m.startswith(
        "autodriver_pointcloud_preprocessor_tpu.") for m in names), names
    assert os.path.basename(__file__) == "test_torch_sharding.py"
