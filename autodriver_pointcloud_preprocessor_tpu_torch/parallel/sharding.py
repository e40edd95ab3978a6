"""SPMD execution: the pipeline sharded along the point axis of a process group.

Port of ``autodriver_pointcloud_preprocessor_tpu/parallel/sharding.py``.
A merged multi-LiDAR cloud is cut along its point axis into one slab a
rank. The reference's mesh axis is a ``torch.distributed`` process group
here (wrapped in a ``DeviceMesh`` named for the axis), and its
``shard_map`` body is a plain function that every rank runs on its local
tensors. Stages run on the local slab; the few global steps use
collectives:

* duplicates, non-finite, transforms, crop, the downsamplers and the
  post-downsample shrink: per slab (``spatial_sort`` before sharding
  makes each slab a compact region of the Hilbert curve, so duplicates
  and voxels split across slab edges are rare);
* statistical outliers: local kNN means, the global mean and standard
  deviation from one ``all_reduce`` (exact global thresholds);
* window neighbourhoods: every rank quantizes its curve sorts in the
  global live box (one ``all_reduce`` of the minimum of ``[lo, -hi]``)
  and borrows ``halo`` curve-edge rows from each neighbouring slab (one
  ``all_gather`` of every rank's head and tail rows);
* RANSAC: each rank proposes hypotheses from its own points, the planes
  are gathered, and the votes and the refit's moments are summed over the
  group (an exact distributed estimator).

Each site packs its values into one tensor, so a site is one collective.
Masks travel as float32 or int32: gloo's reductions do not take bool.
This module initialises no process group and picks no backend; the
caller does (gloo for several ranks on one card or on the CPU, NCCL for
one rank a card). Over NCCL on a card each rank captures its step as one
CUDA graph and replays it (``build_sharded_pipeline``, the reference's
``jit``); over gloo the step runs eagerly (``captures_step``). Every
function takes a leading batch axis: on a 2-D ``('scan', 'point')`` mesh
each rank's scans ride it, and the point collectives carry one packed
value per scan on ``mesh.get_group('point')``.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard

from .. import ops
from ..core.scan import ScanBuffer
from ..models import graphs
from ..models.pipeline import (
    PipelineParams,
    PipelineSettings,
    _select_scans,
    draw_uniforms,
    window_backend,
)
from ..ops.compact import gather_columns
from ..ops.ground import _fit_planes_batched
from ..ops.linalg import normals_from_entries, smallest_eigvec_entries
from ..ops.outliers import _AUTO_EXACT_MAX
from ..ops.window import (
    fused_neighborhood_stats,
    hilbert_codes,
    window_mean_knn_dist,
    window_normal_stats,
)

__all__ = [
    "COLLECTIVES",
    "buffer_pspecs",
    "build_sharded_pipeline",
    "captures_step",
    "draw_local_uniforms",
    "make_local_run",
    "make_mesh",
    "reset_collectives",
    "shard_buffer",
    "spatial_sort",
    "unshard_buffer",
]

#: collectives this process issued and the bytes of its own payload in
#: them (what it put in, not what it got back)
COLLECTIVES = {"calls": 0, "bytes": 0}


def reset_collectives() -> None:
    COLLECTIVES["calls"] = COLLECTIVES["bytes"] = 0


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(t: torch.Tensor, group) -> list:
    """Every rank's ``t``, in group-rank order (the list form:
    ``all_gather_into_tensor`` is not on every backend and version)."""
    t = t.contiguous()
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += t.numel() * t.element_size()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


@dataclasses.dataclass(frozen=True)
class _Axis:
    """The point axis of a mesh: its process group, size and this rank's
    index on it (the reference's ``axis_size`` and ``axis_index``)."""

    group: dist.ProcessGroup
    size: int
    rank: int

    @staticmethod
    def of(mesh: DeviceMesh, axis_name: str) -> "_Axis":
        return _Axis(mesh.get_group(axis_name), _axis_size(mesh, axis_name),
                     mesh.get_local_rank(axis_name))


def _axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def make_mesh(group=None, axis_name: str = "point") -> DeviceMesh:
    """1-D mesh over the default process group (or ``group``), named for
    the point axis.

    A ``DeviceMesh`` passes through once it has the axis: the 2-D
    ``('scan', 'point')`` composition, whose point collectives run on
    ``mesh.get_group(axis_name)``. The mesh's device type labels it only
    ('cuda' over NCCL, else 'cpu'); tensors stay where the caller put them.
    """
    if isinstance(group, DeviceMesh):
        if axis_name not in (group.mesh_dim_names or ()):
            raise ValueError(f"mesh axes {group.mesh_dim_names} have no {axis_name!r} axis")
        return group
    group = dist.group.WORLD if group is None else group
    device_type = "cuda" if dist.get_backend(group) == dist.Backend.NCCL else "cpu"
    return DeviceMesh.from_group(group, device_type, mesh_dim_names=(axis_name,))


def buffer_pspecs(buf: ScanBuffer, axis_name: str = "point") -> ScanBuffer:
    """Each field's placement on the point axis: sharded along its last
    dimension (``Shard(-1)``)."""
    del axis_name  # every field is sharded on the point axis alone
    return ScanBuffer(
        positions=Shard(-1), mask=Shard(-1),
        attributes={k: Shard(-1) for k in buf.attributes},
    )


def _take(buf: ScanBuffer, idx: torch.Tensor) -> ScanBuffer:
    """Columns ``idx`` [..., M] of every field, per scan."""
    return ScanBuffer(
        positions=gather_columns(buf.positions, idx),
        mask=buf.mask.gather(-1, idx),
        attributes={k: gather_columns(v, idx) for k, v in buf.attributes.items()},
    )


def spatial_sort(buf: ScanBuffer) -> ScanBuffer:
    """Reorder points along the Hilbert curve, live points first, invalid
    last (a stable sort of ``hilbert_codes``: the reference's order bit for
    bit on finite input). Applied before sharding, it gives every slab a
    compact region, so slab-local voxels, duplicates and windows are
    near-exact.

    Live rows with a non-finite coordinate sort with the invalid ones and
    stay live (the pipeline's non-finite stage drops them). The reference
    quantizes them too, and one NaN makes its live box, and so every
    code, NaN (ROADMAP fault 12)."""
    key_mask = buf.mask & torch.isfinite(buf.positions).all(-2)
    order = torch.sort(hilbert_codes(buf.positions, key_mask), dim=-1, stable=True).indices
    return _take(buf, order)


def shard_buffer(
    buf: ScanBuffer,
    mesh: DeviceMesh,
    axis_name: str = "point",
    spatially_sort: bool = True,
) -> ScanBuffer:
    """This rank's slab of ``buf``: every rank holds the same full buffer
    (the reference's replicated input), sorts it (``spatially_sort``) and
    keeps columns ``[r * n / S, (r + 1) * n / S)``, contiguous. A
    capacity that the axis size ``S`` does not divide raises."""
    axis = _Axis.of(mesh, axis_name)
    if buf.capacity % axis.size:
        raise ValueError(f"capacity {buf.capacity} does not divide into {axis.size} point shards")
    if spatially_sort:
        buf = spatial_sort(buf)
    n = buf.capacity // axis.size
    lo, hi = axis.rank * n, (axis.rank + 1) * n
    return ScanBuffer(
        positions=buf.positions[..., lo:hi].contiguous(),
        mask=buf.mask[..., lo:hi].contiguous(),
        attributes={k: v[..., lo:hi].contiguous() for k, v in buf.attributes.items()},
    )


def unshard_buffer(local: ScanBuffer, mesh: DeviceMesh, axis_name: str = "point") -> ScanBuffer:
    """The whole buffer on every rank: each field's slabs gathered along
    the point axis in rank order (the reference's global array). The mask
    travels as int32."""
    group = mesh.get_group(axis_name)

    def gather(t):
        return torch.cat(_all_gather(t, group), dim=-1)

    return ScanBuffer(
        positions=gather(local.positions),
        mask=gather(local.mask.to(torch.int32)) != 0,
        attributes={k: gather(v) for k, v in local.attributes.items()},
    )


# ---------------------------------------------------------------------------
# cross-shard stages
# ---------------------------------------------------------------------------

def _resolve_knn_method(settings: PipelineSettings, local_capacity: int, axis: _Axis) -> str:
    """'auto' resolved on the GLOBAL capacity, as the single-device ops do
    on theirs: the same settings pick the same kNN method on any mesh."""
    if settings.knn_method != "auto":
        return settings.knn_method
    return "exact" if local_capacity * axis.size <= _AUTO_EXACT_MAX else "window"


def _window_kwargs(settings: PipelineSettings) -> dict:
    """The window knobs of the standalone sharded stages, as the
    pipeline's unfused stages take them: the reference's backend (``"xla"``
    for ``pallas_ok=False``), ``window_blocks`` (an int or a per-pass
    tuple) and the passes."""
    wb = settings.window_blocks
    return dict(
        window_backend=window_backend(settings),
        window_blocks=wb if isinstance(wb, int) else tuple(wb),
        passes=settings.neighborhood_passes,
    )


def _global_outlier_keep(mask, mean_d, std_ratio, axis: _Axis) -> torch.Tensor:
    """Keep-mask from the exact global mean and (population) standard
    deviation of the live kNN means: one all_reduce of (count, sum, sum of
    squares) per scan. ANDed with the live mask, so that a dead row, whose
    mean is 0, never comes back alive."""
    w = mask.to(torch.float32)
    md = torch.where(mask, mean_d, torch.zeros((), dtype=mean_d.dtype, device=mean_d.device))
    s = _all_reduce(torch.stack([w, md * w, md * md * w], -2).sum(-1), dist.ReduceOp.SUM,
                    axis.group)
    n = torch.clamp(s[..., 0:1], min=1.0)
    mu = s[..., 1:2] / n
    var = torch.clamp(s[..., 2:3] / n - mu * mu, min=0.0)
    thr = mu + std_ratio * torch.sqrt(var)
    return mask & (mean_d <= thr)


def _global_live_bounds(positions, mask, axis: _Axis):
    """The live box over every rank, (lo [..., 3], hi [..., 3]), equal on
    all ranks: one all_reduce of the minimum of ``[lo, -hi]``.

    Passed as the window ops' ``bounds``, so every rank quantizes its
    curve sorts into the grid one device would use: with per-slab boxes
    each slab's Hilbert hierarchy has other superblock boundaries than the
    global curve, which no halo repairs."""
    big = 3.4e38
    live = mask.unsqueeze(-2)
    lo = torch.where(live, positions, big).amin(-1)
    hi = torch.where(live, positions, -big).amax(-1)
    box = _all_reduce(torch.cat([lo, -hi], -1), dist.ReduceOp.MIN, axis.group)
    return box[..., :3], -box[..., 3:]


def _halo_exchange(positions, mask, axis: _Axis, halo: int):
    """Borrow ``halo`` curve-edge rows from each neighbouring slab.

    After ``shard_buffer``'s curve sort a boundary point's missing
    neighbours sit in the ADJACENT slab's edge rows. One all_gather of
    every rank's [x, y, z, mask] head and tail rows (float32 [..., 4,
    2 * halo], 16 KB a scan at halo 512) gives each rank its
    predecessor's tail and its successor's head; the window ops run on
    ``[prev_tail | local | next_head]`` and callers slice the statistics
    back to the local rows. End ranks get zero rows with a False mask (the
    curve's two ends are no neighbours). Returns ``(ext_positions,
    ext_mask, halo_used)``.
    """
    halo = min(halo, positions.shape[-1])
    if axis.size == 1 or halo == 0:
        return positions, mask, 0
    rows = torch.cat([positions, mask.unsqueeze(-2).to(positions.dtype)], -2)
    parts = _all_gather(torch.cat([rows[..., :halo], rows[..., -halo:]], -1), axis.group)
    none = torch.zeros_like(rows[..., :halo])
    prev_tail = parts[axis.rank - 1][..., halo:] if axis.rank > 0 else none
    next_head = parts[axis.rank + 1][..., :halo] if axis.rank + 1 < axis.size else none
    ext_pos = torch.cat([prev_tail[..., :3, :], positions, next_head[..., :3, :]], -1)
    ext_mask = torch.cat([prev_tail[..., 3, :] != 0, mask, next_head[..., 3, :] != 0], -1)
    return ext_pos, ext_mask, halo


def _sharded_outliers(buf, settings, std_ratio, axis: _Axis, halo):
    """Statistical outliers with local kNN means and the global threshold:
    exact kNN on the slab, or the window over the halo-extended slab in
    the global box."""
    if _resolve_knn_method(settings, buf.capacity, axis) == "exact":
        sq, _ = ops.knn_exact(buf.positions, buf.mask, k=settings.nb_neighbors)
        d = torch.sqrt(sq)
        finite = torch.isfinite(d)
        d = torch.where(finite, d, torch.zeros((), dtype=d.dtype, device=d.device))
        mean_d = d.sum(-1) / torch.clamp(finite.sum(-1), min=1)
    else:
        bounds = _global_live_bounds(buf.positions, buf.mask, axis)
        pos, msk, h = _halo_exchange(buf.positions, buf.mask, axis, halo)
        mean_d = window_mean_knn_dist(
            pos, msk, k=settings.nb_neighbors, window_blocks=settings.window_blocks,
            passes=settings.neighborhood_passes, kmode=settings.knn_kmode, bounds=bounds,
            backend=window_backend(settings),
        )[..., h : h + buf.capacity]
    return buf.replace(mask=_global_outlier_keep(buf.mask, mean_d, std_ratio, axis))


def _sharded_fused_neighborhood(buf, settings, params, axis: _Axis, halo, fuse_radius):
    """The pipeline's fused neighbourhood, sharded: one window sweep over
    the halo-extended slab (the unsorting ``fused_neighborhood_stats``: K3,
    or the XLA route with ``pallas_ok=False``) feeds the statistical
    outliers (global threshold), the normals and, with ``fuse_radius``,
    the radius-outlier count, with the pipeline's knobs; neighbourhoods
    are those of the pre-outlier cloud."""
    bounds = _global_live_bounds(buf.positions, buf.mask, axis)
    pos, msk, h = _halo_exchange(buf.positions, buf.mask, axis, halo)
    out = fused_neighborhood_stats(
        pos, msk, k=settings.nb_neighbors, radius=params.search_radius,
        window_blocks=settings.window_blocks, passes=settings.neighborhood_passes,
        kmode=settings.knn_kmode,
        radius2=params.radius_search_radius if fuse_radius else None,
        entries_merge=settings.normals_merge_passes, bounds=bounds,
        backend=window_backend(settings),
    )
    n = buf.capacity
    keep = _global_outlier_keep(buf.mask, out[0][..., h : h + n], params.std_ratio, axis)
    if fuse_radius:
        keep = keep & (out[3][..., h : h + n] >= params.radius_nb_points)
    attrs = dict(buf.attributes)
    if settings.estimate_normals:
        attrs["normals"] = out[1][..., h : h + n]
    return ScanBuffer(positions=buf.positions, mask=keep, attributes=attrs)


def _window_stats_local(buf, settings, radius, axis: _Axis, halo):
    """``window_normal_stats`` over the halo-extended slab in the global
    box, sliced back to the local rows: (entries [..., 6, n], count)."""
    bounds = _global_live_bounds(buf.positions, buf.mask, axis)
    pos, msk, h = _halo_exchange(buf.positions, buf.mask, axis, halo)
    entries, count = window_normal_stats(
        pos, msk, radius, window_blocks=settings.window_blocks,
        passes=settings.neighborhood_passes, bounds=bounds, backend=window_backend(settings),
    )
    n = buf.capacity
    return entries[..., h : h + n], count[..., h : h + n]


def _sharded_radius_outliers(buf, settings, params, axis: _Axis, halo, method):
    """Radius outliers: exact kNN on the slab, or halo-extended window
    counts."""
    if method == "exact":
        return ops.remove_radius_outliers(
            buf, params.radius_nb_points, params.radius_search_radius, method="exact",
            **_window_kwargs(settings),
        )
    _entries, count = _window_stats_local(buf, settings, params.radius_search_radius, axis, halo)
    return buf.with_mask(count >= params.radius_nb_points)


def _sharded_normals(buf, settings, params, axis: _Axis, halo, method):
    """Normals: exact kNN on the slab, or halo-extended window
    covariances."""
    if method == "exact":
        return ops.estimate_normals(
            buf, params.search_radius, settings.max_neighbors, method="exact",
            **_window_kwargs(settings),
        )
    entries, count = _window_stats_local(buf, settings, params.search_radius, axis, halo)
    attrs = dict(buf.attributes)
    attrs["normals"] = normals_from_entries(*entries.unbind(-2), count)
    return buf.replace(attributes=attrs)


def _sharded_ground(buf, axis: _Axis, distance_threshold, ransac_n: int, num_iterations: int,
                    score_subsample: int = 0, generator: Optional[torch.Generator] = None,
                    uniforms: Optional[torch.Tensor] = None):
    """Distributed batched RANSAC: local proposals, global votes and refit.

    Each rank fits ``max(num_iterations // S, 1)`` hypotheses from its own
    live points (draws from ``generator``, or ``uniforms`` float32[...,
    h_local, ransac_n]: the reference draws ``uniform(fold_in(key, rank))``),
    every rank's planes are gathered, voted on (with ``score_subsample``,
    on every ``capacity * S // score_subsample``-th slot of each slab) and
    the votes summed; the winner is refit from summed moments, and the
    refit replaces it when its full-N inlier count is no lower. Dead rows
    are zeroed first, as in ``ops/ground.py``: the reference's refit sums
    them raw (ROADMAP fault 3).

    Returns (buffer with the inliers masked out, plane float32[..., 4]),
    the plane equal on every rank.
    """
    lead, cap = buf.batch_shape, buf.capacity
    h_local = max(num_iterations // axis.size, 1)
    zero = torch.zeros((), dtype=torch.float32, device=buf.device)
    x, y, z = (torch.where(buf.mask, buf.positions[..., c, :], zero) for c in range(3))
    if uniforms is None:
        u = torch.rand(lead + (h_local, ransac_n), generator=generator, dtype=torch.float32,
                       device=buf.device)
    else:
        u = torch.as_tensor(uniforms, dtype=torch.float32, device=buf.device)
        if u.shape[-2:] != (h_local, ransac_n) or u.dim() > len(lead) + 2:
            raise ValueError(f"uniforms shape {tuple(u.shape)} != {lead + (h_local, ransac_n)}")
        u = u.expand(lead + (h_local, ransac_n))
    csum = torch.cumsum(buf.mask.to(torch.int32), -1, dtype=torch.int32)
    safe = torch.clamp(csum[..., -1:], min=1)[..., None]
    draw = torch.minimum((u * safe).to(torch.int32), safe - 1).reshape(lead + (-1,))
    # the (draw+1)-th live point
    idx = torch.clamp(torch.searchsorted(csum, draw + 1, side="left"), max=cap - 1)
    normals, ds = _fit_planes_batched(*(c.gather(-1, idx).reshape(u.shape) for c in (x, y, z)))

    planes = torch.cat(_all_gather(torch.cat([normals, ds.unsqueeze(-2)], -2), axis.group), -1)
    nx, ny, nz, d = planes.unbind(-2)  # [..., H], every rank's in rank order
    vx, vy, vz, vm = x, y, z, buf.mask
    if 0 < score_subsample < cap * axis.size:
        stride = cap * axis.size // score_subsample
        vx, vy, vz, vm = (v[..., ::stride] for v in (x, y, z, buf.mask))
    dist_h = torch.abs(
        vx[..., :, None] * nx[..., None, :]
        + vy[..., :, None] * ny[..., None, :]
        + vz[..., :, None] * nz[..., None, :]
        + d[..., None, :]
    )
    thresh = torch.as_tensor(distance_threshold, dtype=torch.float32, device=buf.device)
    votes = ((dist_h <= thresh) & vm[..., :, None]).sum(-2, dtype=torch.int32)
    votes = _all_reduce(votes, dist.ReduceOp.SUM, axis.group)
    best = torch.argmax(votes, dim=-1, keepdim=True)  # the first maximum

    bnx, bny, bnz, bd = (r.gather(-1, best) for r in (nx, ny, nz, d))
    best_in = (torch.abs(x * bnx + y * bny + z * bnz + bd) <= thresh) & buf.mask
    w = best_in.to(torch.float32)
    mom = _all_reduce(
        torch.stack([w, w * x, w * y, w * z, w * x * x, w * y * y, w * z * z,
                     w * x * y, w * x * z, w * y * z], -2).sum(-1),
        dist.ReduceOp.SUM, axis.group,
    )
    s = [mom[..., i : i + 1] for i in range(10)]  # [..., 1] each
    n0 = torch.clamp(s[0], min=1.0)
    mx, my, mz = s[1] / n0, s[2] / n0, s[3] / n0
    rnx, rny, rnz = smallest_eigvec_entries(
        s[4] - n0 * mx * mx, s[5] - n0 * my * my, s[6] - n0 * mz * mz,
        s[7] - n0 * mx * my, s[8] - n0 * mx * mz, s[9] - n0 * my * mz,
    )
    rd = -(rnx * mx + rny * my + rnz * mz)
    inliers = (torch.abs(x * rnx + y * rny + z * rnz + rd) <= thresh) & buf.mask
    # the refit against the winner, both counted on every point
    counts = _all_reduce(
        torch.stack([inliers.sum(-1, dtype=torch.int32), best_in.sum(-1, dtype=torch.int32)], -1),
        dist.ReduceOp.SUM, axis.group,
    )
    use_refined = counts[..., 0:1] >= counts[..., 1:2]
    plane = torch.where(use_refined, torch.cat([rnx, rny, rnz, rd], -1),
                        torch.cat([bnx, bny, bnz, bd], -1))
    inliers = torch.where(use_refined, inliers, best_in)
    return buf.with_mask(~inliers), plane


# ---------------------------------------------------------------------------
# sharded pipeline
# ---------------------------------------------------------------------------

def _local_stages(settings: PipelineSettings, axis: _Axis, halo: int):
    """Ordered ``(stage_name, fn(buf, params, generator, ground_uniforms,
    downsample_uniforms) -> (buf, plane or None))`` of one rank's slab:
    the single-device stage order (``models/pipeline.py``) with the
    cross-shard stages swapped in. No pre-voxel compaction, as in the
    reference (``pre_voxel_compact_capacity`` is ignored)."""
    stages = []
    method = settings.downsample_method
    voxel_grid = settings.voxel_downsample and method == "voxel"
    fuse_dedup = settings.remove_duplicates and voxel_grid
    if settings.remove_duplicates and not fuse_dedup:
        # per slab: duplicates split across slabs survive
        stages.append(("remove_duplicates", lambda b, p, *_: (ops.remove_duplicates(b), None)))
    if settings.remove_nans or settings.remove_infs:
        rn, ri = settings.remove_nans, settings.remove_infs
        stages.append(("non_finite", lambda b, p, *_: (ops.mask_non_finite(b, rn, ri), None)))
    if settings.apply_offset_lidar or settings.apply_tf:
        def xform(b, p, *_):
            if settings.apply_offset_lidar:
                b = ops.se3_transform(b, p.offset_matrix)
            if settings.apply_tf:
                b = ops.se3_transform(b, p.tf_matrix)
                if settings.apply_offset_robot:
                    b = ops.se3_transform(b, p.offset_matrix)
            return b, None

        stages.append(("transform", xform))
    if settings.crop_to_roi:
        stages.append((
            "crop", lambda b, p, *_: (ops.crop_box(b, p.roi_min, p.roi_max, p.crop_invert), None),
        ))

    # ground on the raw cloud (the distributed votes are order-free), right
    # after the downsampler, or last, as in the single-device pipeline
    ground_raw = settings.ground_before_voxel and settings.remove_ground
    ground_first = (
        not ground_raw and settings.ground_before_neighborhood and settings.remove_ground
    )

    def ground(b, p, g, u=None, du=None):
        if settings.ground_method == "height":
            b = ops.remove_ground_by_height(b, p.ground_plane, p.distance_threshold)
            return b, p.ground_plane.expand(b.batch_shape + (4,))
        return _sharded_ground(
            b, axis, p.distance_threshold, settings.ransac_n, settings.num_iterations,
            score_subsample=settings.ground_score_subsample, generator=g, uniforms=u,
        )

    if ground_raw:
        stages.append(("ground", ground))
    if settings.voxel_downsample:
        if method == "voxel":
            # per-slab voxels; compact keys hold on every slab when the
            # caller's ROI bounds the scene, and curve order comes with them
            ck = settings.voxel_compact_keys

            def downsample(b, p, *_):
                return ops.voxel_downsample(
                    b, p.voxel_size, dedup_exact=fuse_dedup, curve_order=bool(ck),
                    compact_keys=ck,
                ), None
        elif method == "random":
            def downsample(b, p, g, u=None, du=None):
                return ops.random_downsample(b, p.sampling_ratio, g, uniforms=du), None
        elif method == "uniform":
            def downsample(b, p, *_):
                return ops.uniform_downsample(b, p.every_k_points), None
        elif method == "farthest_point":
            def downsample(b, p, *_):
                return ops.farthest_point_downsample(b, settings.fps_num_samples), None
        else:
            raise ValueError(f"unknown downsample_method {method!r}")
        stages.append(("voxel", downsample))

    shrink_stage = None
    if settings.voxel_downsample and settings.post_downsample_capacity > 0:
        # this rank's share of the global bucket, rounded up to 512. Ranks
        # cap on their own, so on overflow dense slabs are thinned harder
        # than sparse ones (a spatially biased subset, where one device's
        # hash subsample is unbiased): size the bucket with headroom
        local_cap = -(-settings.post_downsample_capacity // axis.size)
        local_cap = -(-local_cap // 512) * 512

        def shrink(b, p, *_):
            if local_cap >= b.capacity:
                return b, None
            if not voxel_grid or ground_first:
                # no live prefix: a mask-only downsampler, or ground has
                # punched holes in the voxels (the reference slices a
                # prefix here and drops live points, ROADMAP fault 13)
                return ops.subsample_to(b, local_cap), None
            # the voxel output is front-compacted: a prefix slice within
            # the share, the unbiased hash subsample on overflow, scan by
            # scan. Both run and a select on the device picks (the
            # reference's ``lax.cond``), so no host read decides
            return _select_scans(b.mask.sum(-1) > local_cap, ops.subsample_to(b, local_cap),
                                 ops.shrink_front(b, local_cap)), None

        shrink_stage = ("shrink", shrink)
        # under ground_first the shrink waits until after ground, so that
        # RANSAC samples the whole voxel cloud (the single-device order)
        if not ground_first:
            stages.append(shrink_stage)
    if ground_first:
        stages.append(("ground", ground))
        if shrink_stage:
            stages.append(shrink_stage)

    # the single-device fusion: one shared window sweep serves the
    # statistical outliers and at least one more consumer
    fuse = (
        settings.fuse_neighborhood
        and settings.remove_statistical_outliers
        and (settings.estimate_normals or settings.remove_radius_outliers)
        and settings.knn_method != "exact"
    )
    fuse_radius = fuse and settings.remove_radius_outliers
    if fuse:
        stages.append((
            "neighborhood",
            lambda b, p, *_: (_sharded_fused_neighborhood(b, settings, p, axis, halo, fuse_radius),
                              None),
        ))
    elif settings.remove_statistical_outliers:
        stages.append((
            "outliers",
            lambda b, p, *_: (_sharded_outliers(b, settings, p.std_ratio, axis, halo), None),
        ))
    if settings.remove_radius_outliers and not fuse_radius:
        stages.append((
            "radius_outliers",
            lambda b, p, *_: (_sharded_radius_outliers(
                b, settings, p, axis, halo, _resolve_knn_method(settings, b.capacity, axis)), None),
        ))
    if settings.estimate_normals and not fuse:
        stages.append((
            "normals",
            lambda b, p, *_: (_sharded_normals(
                b, settings, p, axis, halo, _resolve_knn_method(settings, b.capacity, axis)), None),
        ))
    if settings.remove_ground and not ground_raw and not ground_first:
        stages.append(("ground", ground))
    return stages


def make_local_run(
    settings: PipelineSettings,
    axis_name: str = "point",
    halo: int = 512,
    mesh: Optional[DeviceMesh] = None,
):
    """One rank's pipeline body: ``run(local_buf, params, generator=None,
    ground_uniforms=None, downsample_uniforms=None) -> (local_buf, plane)``
    on this rank's slab (``shard_buffer``), with collectives on the
    ``axis_name`` axis of ``mesh`` (default: the default process group).
    ``plane`` float32[..., 4] is equal on every rank, NaN when ground
    removal is off. The draws are this rank's own: ``ground_uniforms``
    float32[..., max(num_iterations // S, 1), ransac_n] and
    ``downsample_uniforms`` float32[..., local capacity].

    ``halo``: curve-edge rows borrowed from each neighbouring slab for the
    window stages (``_halo_exchange``; 0 disables); a multiple of 128, so
    that the extended slab keeps K3's 128-row blocks.
    """
    if halo % 128 != 0:
        raise ValueError(f"halo must be a multiple of 128, got {halo}")
    axis = _Axis.of(make_mesh(mesh, axis_name), axis_name)
    stages = _local_stages(settings, axis, halo)

    def run(local_buf: ScanBuffer, params: PipelineParams,
            generator: Optional[torch.Generator] = None,
            ground_uniforms: Optional[torch.Tensor] = None,
            downsample_uniforms: Optional[torch.Tensor] = None):
        buf = local_buf
        plane = torch.full(buf.batch_shape + (4,), float("nan"), dtype=torch.float32,
                           device=buf.device)
        for _, fn in stages:
            buf, aux = fn(buf, params, generator, ground_uniforms, downsample_uniforms)
            if aux is not None:
                plane = aux
        return buf, plane

    return run


def draw_local_uniforms(
    settings: PipelineSettings,
    axis_size: int,
    batch_shape: tuple,
    capacity: int,
    generator: Optional[torch.Generator],
    device: torch.device,
    ground_uniforms: Optional[torch.Tensor] = None,
    downsample_uniforms: Optional[torch.Tensor] = None,
):
    """One rank's random inputs, drawn ahead of its step:
    ``pipeline.draw_uniforms`` for ``make_local_run``'s ``run``, whose
    RANSAC fits ``max(num_iterations // axis_size, 1)`` hypotheses a rank
    and whose random downsampler draws at the slab's ``capacity`` (the
    local run has no pre-voxel bucket)."""
    local = dataclasses.replace(
        settings, num_iterations=max(settings.num_iterations // axis_size, 1),
        pre_voxel_compact_capacity=0)
    return draw_uniforms(local, batch_shape, capacity, generator, device, ground_uniforms,
                         downsample_uniforms)


def captures_step(group: dist.ProcessGroup, device: torch.device) -> bool:
    """Whether the sharded step on ``device`` runs as one captured program:
    only with an NCCL group on a CUDA card (``graphs.captures``), whose
    collectives are device work that a CUDA graph holds. Gloo's
    collectives on card tensors are host round trips, which no graph can
    hold, so a gloo group runs its steps eagerly; so does the CPU."""
    return graphs.captures(device) and dist.get_backend(group) == dist.Backend.NCCL


def _group_tag(group: dist.ProcessGroup) -> tuple:
    """A process group's identity: its name (unique in the process), its
    ranks and its backend. ``DeviceMesh`` equality compares ranks and
    shapes only, so two meshes over different groups of the same ranks
    are equal; their steps must not share a cached run or a program."""
    return (group.group_name, tuple(dist.get_process_group_ranks(group)),
            str(dist.get_backend(group)))


def build_sharded_pipeline(
    settings: PipelineSettings, mesh: DeviceMesh, axis_name: str = "point", halo: int = 512,
):
    """The sharded pipeline over ``mesh``'s ``axis_name`` axis (cached per
    arguments), the reference's ``jax.jit(shard_map(local_run))``: a
    callable with ``make_local_run``'s ``run`` signature, same stage order
    and semantics as ``models/pipeline.build_pipeline`` with the
    cross-shard stages swapped in. Its input is this rank's
    ``shard_buffer`` slab.

    Where ``captures_step`` holds (an NCCL group, a CUDA card: one rank a
    card), a call draws the step's uniforms ahead (``draw_local_uniforms``)
    and replays one captured program (``models/graphs.py``) a (settings,
    axis name, halo, group, input shapes), which this rank captures on its
    own card at the first call; a replay credits the kernel launches and
    ``COLLECTIVES`` that its capture counted. A failed capture raises. On
    a gloo group, and on the CPU, the call runs ``run`` eagerly. A
    captured collective holds the group's communicator: drop the programs
    (``graphs.clear()``) before ``destroy_process_group``.

    Warns when ``post_downsample_capacity`` does not split into 512-row
    shares, which inflates the effective global cap."""
    return _sharded_step(settings, mesh, axis_name, halo, _group_tag(mesh.get_group(axis_name)))


@functools.lru_cache(maxsize=32)
def _sharded_step(settings, mesh, axis_name, halo, group_tag):
    """``build_sharded_pipeline``, cached per arguments and group."""
    cap = settings.post_downsample_capacity
    n_shards = _axis_size(mesh, axis_name)
    if cap > 0 and cap % (512 * n_shards) != 0:
        # ranks cap on their own at 512-rounded shares of ceil(cap / n),
        # so the global cap grows by up to n * 512
        local = -(-cap // n_shards)
        eff = n_shards * (-(-local // 512) * 512)
        warnings.warn(
            f"post_downsample_capacity={cap} is not a multiple of "
            f"512 * {n_shards} point-shards; the sharded pipeline caps "
            f"per shard, making the effective global cap {eff}",
            stacklevel=3,
        )
    run = make_local_run(settings, axis_name, halo, mesh)
    group = mesh.get_group(axis_name)
    tag = ("sharded", settings, axis_name, halo, group_tag)

    def step(local_buf: ScanBuffer, params: PipelineParams,
             generator: Optional[torch.Generator] = None,
             ground_uniforms: Optional[torch.Tensor] = None,
             downsample_uniforms: Optional[torch.Tensor] = None):
        if not captures_step(group, local_buf.device):
            return run(local_buf, params, generator, ground_uniforms, downsample_uniforms)
        draws = draw_local_uniforms(settings, n_shards, local_buf.batch_shape,
                                    local_buf.capacity, generator, local_buf.device,
                                    ground_uniforms, downsample_uniforms)
        args = (local_buf, params, draws)
        prog = graphs.program(tag, lambda: lambda b, p, d: run(b, p, None, *d), *args,
                              counters=(COLLECTIVES,))
        return prog(*args)

    return step
