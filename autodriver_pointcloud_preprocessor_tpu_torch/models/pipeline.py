"""The preprocessing pipeline, run eagerly stage by stage.

Port of ``autodriver_pointcloud_preprocessor_tpu/models/pipeline.py``.
The configuration surface is the reference's, unchanged:
``PipelineSettings`` (static switches, validated the same way),
``settings_from_config`` and the named presets (``models/presets.py``).
``PipelineParams`` holds tensors on one device (``cuda:0`` unless given).

The port runs every stage and stage order of the reference: duplicates
fused into the voxel sort (or as their own stage), non-finite, the SE(3)
transforms, crop, ground removal (RANSAC or the fixed-plane height cut) on
the raw cloud, right after the downsampler or last, pre-voxel stream
compaction (K1), the voxel stage (K2, curve-ordered when the fused
neighbourhood consumes it, 'box' or 'wide' compact keys) or the random,
uniform and farthest-point downsamplers, the post-downsample shrink, the
fused multi-pass Hilbert-window neighbourhood (K3) with the mean+std
outlier threshold of each scan and the radius-outlier count riding the
same sweep, and the standalone statistical outlier, radius outlier and
normal stages (exact kNN or the window). ``pallas_ok=False`` threads the
reference's ``"xla"`` backend to the stages it reaches, as the reference
does: the window stages then take the XLA route of ``ops/window.py``
(another function than K3's windows), while compaction and the voxel
stage keep K1 and K2, which compute the XLA route's function.

Every stage takes one scan or a batch of scans (a leading axis on every
tensor of the buffer, ``core.stack_buffers``), so the same runner serves
``Preprocessor.process_buffer`` and the batched ``process_batch``: at
B scans each kernel launches as often as for one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from ..core.scan import ScanBuffer, resolve_device
from .. import ops
from ..ops.outliers import outlier_keep
from ..ops.window import fused_neighborhood_stats_reordered


@dataclasses.dataclass(frozen=True)
class PipelineSettings:
    """Static, graph-shaping configuration (hashable; keys the jit cache)."""

    remove_duplicates: bool = True
    remove_nans: bool = True
    remove_infs: bool = True
    apply_offset_lidar: bool = False
    apply_tf: bool = False
    apply_offset_robot: bool = False
    crop_to_roi: bool = True
    voxel_downsample: bool = True  # reference gates on voxel_size > 0 (:509)
    #: alternative downsamplers (reference TODO :37): 'voxel' | 'random' |
    #: 'uniform' | 'farthest_point'
    downsample_method: str = "voxel"
    fps_num_samples: int = 4096  # static (farthest_point loop bound)
    #: shrink the buffer to this capacity right after downsampling (0 =
    #: off). Downsampling typically drops >60% of points but mask-only
    #: stages still pay full capacity; the dominant neighborhood stage
    #: scales ~linearly with capacity, so a post-downsample bucket of
    #: capacity//2 nearly halves it. Capped-output semantics: when more
    #: points survive than the bucket holds, a deterministic UNBIASED
    #: subsample of the survivors is kept (ops.subsample_to) — pick a
    #: bucket with headroom over the expected voxel count to make the cap
    #: a no-op. Must be a multiple of 512 for the Pallas kernels
    #: downstream.
    post_downsample_capacity: int = 0
    #: PRE-voxel compaction bucket (0 = off): after the mask-only front
    #: stages (non-finite/crop/raw ground), stream-compact the buffer into
    #: this smaller capacity before the voxel sort
    #: (ops.compact.stream_compact_to — the segmean-kernel compaction,
    #: round 5). The voxel sort's cost is CAPACITY-bound, not live-bound;
    #: with raw ground removal ahead of it the live count is typically
    #: ~40% of capacity, so sorting at half capacity saves ~0.17 ms at
    #: 131k for the compactor's ~0.14 ms — and every downstream stage
    #: (segmean, quantize, hilbert) shrinks with it. Capped-output
    #: semantics: live points beyond the bucket are DROPPED — size it
    #: above the worst-case post-ground live count (the bench asserts
    #: survivors fit). Must be a 512-multiple; ignored when >= the
    #: buffer capacity or when voxel downsampling is off.
    pre_voxel_compact_capacity: int = 0
    remove_statistical_outliers: bool = False
    nb_neighbors: int = 20
    remove_radius_outliers: bool = False
    estimate_normals: bool = True
    max_neighbors: int = 30
    remove_ground: bool = False
    #: 'ransac' (reference behavior) or 'height' — fixed-plane cut using
    #: the ground_plane parameter (the reference declares ground_plane/
    #: use_height but never uses them, :184-185; this makes them real)
    ground_method: str = "ransac"
    #: PERFORMANCE ordering mode: run ground removal right after the voxel
    #: stage, BEFORE the neighborhood stages (outliers/normals), instead of
    #: the reference's outliers -> normals -> ground order (:514-543).
    #: Ground points are typically the majority of a scan, and they are
    #: removed at the end anyway — removing them first lets the
    #: post_downsample_capacity shrink engage so the dominant neighborhood
    #: stage runs at the non-ground point count (~2-3x faster full
    #: pipeline). Documented semantic difference: outlier statistics and
    #: normals are computed on the non-ground cloud only (the final
    #: survivor SET is close but not identical to reference order — points
    #: near the outlier threshold can flip; RANSAC samples the pre-outlier
    #: cloud). Default False preserves reference order.
    ground_before_neighborhood: bool = False
    #: PERFORMANCE ordering mode, one step further than
    #: ground_before_neighborhood: run ground RANSAC on the raw
    #: (post-crop, PRE-voxel) cloud. Ground scoring is elementwise and
    #: order-independent, so moving it before the voxel sort lets the
    #: voxel stage emit its output simultaneously compacted, ground-free
    #: and (with voxel_curve_order) curve-ordered — the neighborhood's
    #: pass-0 curve sort and the capacity-shrink sort both collapse into
    #: a static prefix slice (~0.35 ms at 131k). Semantic difference vs
    #: ground_before_neighborhood: the plane is fit to the raw cloud
    #: (MORE ground samples — equal-or-better fit; inlier masking happens
    #: pre-voxel so ground points never consume voxel segments). Implies
    #: the ground_before_neighborhood semantics for the downstream
    #: stages. Applies to both ground methods (the height cut is
    #: elementwise against a FIXED plane, so its mask is position-
    #: independent too). Ignored unless remove_ground.
    ground_before_voxel: bool = False
    #: emit the voxel stage's output in Hilbert-curve order (primary
    #: hilbert key over the voxel cells; grouping unchanged — see
    #: ops/voxel.py). Enables the presorted fast path of the fused
    #: neighborhood when nothing between voxel and neighborhood reorders
    #: or punches holes in the compacted prefix.
    voxel_curve_order: bool = True
    #: compact voxel sort keys (requires voxel_curve_order): the hilbert
    #: key alone identifies the voxel. Tier 'box' (True is an alias):
    #: one 30-bit key, live span at most 1008 voxel cells per axis
    #: (~0.15 ms cheaper at 131k). Tier 'wide': two int32 keys (60-bit
    #: hilbert), span up to 2^20-64 cells (drops 2 of 7 sort keys under
    #: fused dedup — the big win on wide scenes, e.g. the 1M merged-
    #: cloud config). Out-of-box voxels would be silently mis-merged, so
    #: the span promise is on the caller; settings_from_config auto-
    #: derives the tier from the ROI/voxel-size parameters
    #: (_compact_keys_tier); default off for safety.
    voxel_compact_keys: bool | str = False
    #: False (round 5): drop the voxel sort's stability under fused exact
    #: dedup — saves the implicit-iota tiebreak key (~0.05 ms at 131k,
    #: PERF_NOTES "stable-sort tax"). Semantics: among EXACT coordinate
    #: duplicates, an arbitrary copy donates the representative
    #: attributes (ring/intensity) instead of the first occurrence
    #: (reference np.unique keeps the first, utils.py:532-534); positions
    #: / survivor sets are unaffected. Ignored unless dedup fuses into
    #: the voxel sort.
    voxel_first_attrs: bool = True
    ransac_n: int = 5
    num_iterations: int = 100
    #: RANSAC hypothesis voting subsample (0 = vote on every point): when
    #: > 0, the [N, H] vote pass scores hypotheses on a systematic strided
    #: subsample of ~this many slots; the winner's terminal refit and the
    #: returned inlier mask still use every live point (ops/ground.py
    #: ``score_subsample`` — binomial selection noise ~0.5pp at 16384).
    #: Leave 0 on TPU: the strided slice relayout makes it a measured
    #: pessimization there (PERF_NOTES round 5).
    ground_score_subsample: int = 0
    knn_method: str = "auto"  # 'auto' | 'exact' | 'window'
    #: False selects the reference's XLA variants: the window stages take
    #: the XLA route of ops/window.py (whole-block rolled windows, exact
    #: top-k; no K3); compaction and the voxel stage keep K1 and K2, whose
    #: functions the XLA variants compute too.
    pallas_ok: bool = True
    #: Hilbert-window passes for approximate neighborhoods: more passes =
    #: better recall (axis-permuted curves min-merged), linear cost
    neighborhood_passes: int = 2
    #: candidate halo per side in 128-point blocks for the window kernel;
    #: 1 = 384-candidate windows (fast), 2 = 640 (higher recall);
    #: 0 = one-sided 256 windows alternating direction across passes.
    #: A per-pass TUPLE (len == neighborhood_passes) runs a mixed
    #: profile, e.g. (1, 0) = full symmetric window on the free
    #: presorted pass + a cheap one-sided window on the re-sorted pass
    #: (quality/cost frontier measured in PERF_NOTES.md round 3).
    window_blocks: int | tuple = 1
    #: k-distance extraction in the Pallas window kernel: 'sweep' (exact
    #: k min-extractions — after loop unrolling it costs the same as
    #: bisect at k=20, so exact is the default), 'bisect' (threshold
    #: bisection, k-INDEPENDENT cost: cheaper when nb_neighbors is large)
    #: or 'csel' (own-block threshold select: exact for queries whose k
    #: nearest sit in their own curve block, ~2-3x cheaper than sweep;
    #: quality measured in tools/quality_presorted_knobs.py)
    knn_kmode: str = "sweep"
    #: distance-matmul precision in the Pallas window kernel: 'highest'
    #: (6-pass bf16 emulation, ~2^-24) or 'fast3' (dual hi/lo split, 3
    #: passes, ~2^-16 of window span^2 — below the k-select packing
    #: noise; see PERF_NOTES.md r3 for the measured quality comparison)
    knn_d2mode: str = "highest"
    #: when outliers AND normals are both enabled on the window path, run
    #: them as ONE shared neighborhood sweep (ops/window.py
    #: fused_neighborhood_stats). ~2x faster; documented semantic: normals
    #: are computed on the pre-outlier-filter cloud.
    fuse_neighborhood: bool = True
    #: merge covariance entries across neighborhood passes, picking the
    #: higher-count pass per point (default). False = normals from pass 0
    #: only: 3 normal rows ride the re-sorts instead of 6 entry rows and
    #: later passes skip the moment matmul — measured ~0.1 ms at 51k;
    #: ~9% of normals take the (usually narrower) pass-0 window where
    #: pass 1 would have won the count merge. kNN means and radius counts
    #: still merge across passes either way.
    normals_merge_passes: bool = True

    def __post_init__(self):
        for fname in ("post_downsample_capacity", "pre_voxel_compact_capacity"):
            cap = getattr(self, fname)
            if cap < 0 or (cap > 0 and cap % 512 != 0):
                raise ValueError(
                    f"{fname} must be a non-negative multiple of 512, "
                    f"got {cap}"
                )
        if self.knn_kmode not in ("sweep", "bisect", "csel"):
            raise ValueError(
                "knn_kmode must be 'sweep', 'bisect' or 'csel', "
                f"got {self.knn_kmode!r}"
            )
        if self.knn_d2mode not in ("highest", "fast3"):
            raise ValueError(
                "knn_d2mode must be 'highest' or 'fast3', "
                f"got {self.knn_d2mode!r}"
            )
        wb = self.window_blocks
        if not isinstance(wb, int):
            if len(wb) != self.neighborhood_passes:
                raise ValueError(
                    "per-pass window_blocks tuple length "
                    f"{len(wb)} != neighborhood_passes "
                    f"{self.neighborhood_passes}"
                )
        for w in (wb,) if isinstance(wb, int) else wb:
            if w > 7:
                # kernel packs candidate row indices into 11 mantissa
                # bits: (2*wb+1)*128 must be <= 2048 (pallas_window.py)
                raise ValueError(
                    f"window_blocks={w} exceeds 7 (the Pallas kernel's "
                    "11-bit row-packing budget: (2*wb+1)*128 <= 2048)"
                )

@dataclasses.dataclass(frozen=True)
class PipelineParams:
    """Numeric parameters, as tensors on one device."""

    roi_min: torch.Tensor
    roi_max: torch.Tensor
    crop_invert: torch.Tensor
    voxel_size: torch.Tensor
    std_ratio: torch.Tensor
    search_radius: torch.Tensor
    distance_threshold: torch.Tensor
    offset_matrix: torch.Tensor
    tf_matrix: torch.Tensor
    radius_nb_points: torch.Tensor
    radius_search_radius: torch.Tensor
    sampling_ratio: torch.Tensor
    every_k_points: torch.Tensor
    ground_plane: torch.Tensor

    @staticmethod
    def make(
        roi_min=(-60.0, -60.0, -20.0),
        roi_max=(60.0, 60.0, 20.0),
        crop_invert=False,
        voxel_size=0.01,
        std_ratio=2.0,
        search_radius=0.1,
        distance_threshold=0.2,
        offset_matrix=None,
        tf_matrix=None,
        radius_nb_points=16,
        radius_search_radius=0.05,
        sampling_ratio=0.5,
        every_k_points=5,
        ground_plane=(0.0, 1.0, 0.0, 0.0),
        device: torch.device | str | None = None,
    ) -> "PipelineParams":
        """Parameters on ``device`` (default ``cuda:0``; raises without a
        card unless a device is given)."""
        device = resolve_device(device)

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)

        eye = np.eye(4, dtype=np.float32)
        return PipelineParams(
            roi_min=f32(roi_min),
            roi_max=f32(roi_max),
            crop_invert=torch.as_tensor(bool(crop_invert), device=device),
            voxel_size=f32(voxel_size),
            std_ratio=f32(std_ratio),
            search_radius=f32(search_radius),
            distance_threshold=f32(distance_threshold),
            offset_matrix=f32(eye if offset_matrix is None else offset_matrix),
            tf_matrix=f32(eye if tf_matrix is None else tf_matrix),
            radius_nb_points=f32(radius_nb_points),
            radius_search_radius=f32(radius_search_radius),
            sampling_ratio=f32(sampling_ratio),
            every_k_points=torch.as_tensor(
                np.asarray(every_k_points, np.int32), device=device
            ),
            ground_plane=f32(ground_plane),
        )


#: Stage names with the reference's timing keys (pointcloud_preprocessor.py
#: stage timers; see core/timing.py), as the reference's pipeline has them.
STAGE_TIMING_KEYS = {
    "remove_duplicates": "remove_duplicate_points",
    # fused outlier+normal sweep reports under the outlier key
    "neighborhood": "remove_statistical_outliers",
    "non_finite": "remove_nan_points",
    "transform": "transform",
    "crop": "crop",
    "pre_compact": "pre_voxel_compaction",
    "voxel": "voxel_downsampling",
    "shrink": "post_downsample_shrink",
    "outliers": "remove_statistical_outliers",
    "radius_outliers": "remove_radius_outliers",
    "normals": "normal_estimation",
    "ground": "ground_segmentation",
}


def window_backend(settings: PipelineSettings) -> str:
    """The backend of the window stages: ``"xla"`` (the window ops' XLA
    route) for ``pallas_ok=False``, else ``"auto"`` (K3). The other stages
    take no backend: compaction and the voxel stage compute the same
    function on either of the reference's routes."""
    return "auto" if settings.pallas_ok else "xla"


def stage_functions(settings: PipelineSettings, separate_stages: bool = False):
    """Ordered list of ``(stage_name, fn(buf, params, generator,
    ground_uniforms=None, downsample_uniforms=None) -> (buf, aux))``;
    ``aux`` is the ground plane (float32[..., 4]) or None. The uniforms
    replace the generator's draws of RANSAC and of the random downsampler.

    ``separate_stages=True`` (profile mode) keeps duplicate removal out of
    the voxel sort and the radius outliers out of the fused neighbourhood,
    so that they run, and are timed, as stages of their own.
    """
    stages = []
    method = settings.downsample_method
    backend = window_backend(settings)
    if settings.voxel_downsample and method not in (
        "voxel", "random", "uniform", "farthest_point"
    ):
        raise ValueError(f"unknown downsample_method {method!r}")
    voxel_grid = settings.voxel_downsample and method == "voxel"

    # duplicate removal fuses into the voxel sort when both are enabled
    fuse_dedup = not separate_stages and settings.remove_duplicates and voxel_grid
    if settings.remove_duplicates and not fuse_dedup:
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
            "crop",
            lambda b, p, *_: (ops.crop_box(b, p.roi_min, p.roi_max, p.crop_invert), None),
        ))

    # ground order: on the raw cloud before the voxel stage (ground_raw),
    # right after the downsampler (ground_first), or last (the reference)
    ground_raw = settings.ground_before_voxel and settings.remove_ground
    ground_first = (
        not ground_raw and settings.ground_before_neighborhood and settings.remove_ground
    )

    def make_ground_stage():
        if settings.ground_method == "height":
            def ground(b, p, *_):
                b = ops.remove_ground_by_height(b, p.ground_plane, p.distance_threshold)
                return b, p.ground_plane.expand(b.batch_shape + (4,))

            return ground
        # right after the voxel grid the live points fill a prefix, so the
        # RANSAC draws index slots directly
        live_prefix = ground_first and voxel_grid

        def ground(b, p, g, u=None, du=None):
            return ops.remove_ground(
                b, g, p.distance_threshold, settings.ransac_n, settings.num_iterations,
                uniforms=u, live_prefix=live_prefix,
                score_subsample=settings.ground_score_subsample,
            )

        return ground

    if ground_raw:
        stages.append(("ground", make_ground_stage()))

    # the fused sweep serves statistical outliers with at least one more
    # window consumer: normals or radius outliers (K3 gives the moments and
    # the in-radius2 count in the same pass)
    fuse = (
        settings.fuse_neighborhood
        and settings.remove_statistical_outliers
        and (settings.estimate_normals or settings.remove_radius_outliers)
        and settings.knn_method != "exact"
    )
    # the curve-ordered voxel output is front-compacted and in pass-0
    # curve order, and nothing before the neighbourhood reorders it or
    # punches holes in it (ground_first would): the neighbourhood's pass-0
    # sort and the shrink become a prefix slice
    presorted = fuse and settings.voxel_curve_order and voxel_grid and not ground_first
    cap = settings.post_downsample_capacity

    if settings.pre_voxel_compact_capacity > 0 and settings.voxel_downsample:
        pcap = settings.pre_voxel_compact_capacity

        def pre_compact(b, p, *_):
            if pcap >= b.capacity:  # nothing to shrink
                return b, None
            return ops.stream_compact_to(b, pcap), None

        stages.append(("pre_compact", pre_compact))

    if settings.voxel_downsample:
        # every downsampler runs under the voxel stage's name and timing key
        if method == "voxel":
            def downsample(b, p, *_):
                return ops.voxel_downsample(
                    b, p.voxel_size, dedup_exact=fuse_dedup, curve_order=presorted,
                    compact_keys=settings.voxel_compact_keys if presorted else False,
                ), None
        elif method == "random":
            def downsample(b, p, g, u=None, du=None):
                return ops.random_downsample(b, p.sampling_ratio, g, uniforms=du), None
        elif method == "uniform":
            def downsample(b, p, *_):
                return ops.uniform_downsample(b, p.every_k_points), None
        else:
            def downsample(b, p, *_):
                return ops.farthest_point_downsample(b, settings.fps_num_samples), None

        stages.append(("voxel", downsample))
        if cap > 0 and not ground_first and not presorted:  # else deferred
            def shrink(b, p, *_):
                if cap >= b.capacity:  # nothing to shrink
                    return b, None
                if not voxel_grid:
                    # a mask-only downsampler: one unbiased capped compaction
                    return ops.subsample_to(b, cap), None
                # the voxel output is front-compacted: a prefix slice keeps
                # every voxel unless they overflow the bucket, and then the
                # unbiased hash subsample runs (a prefix in voxel-key order
                # would keep one slab); both run and each scan selects on
                # the device, with no host read (the reference's lax.cond)
                return _select_scans(
                    b.mask.sum(-1) > cap, ops.subsample_to(b, cap), ops.shrink_front(b, cap)
                ), None

            stages.append(("shrink", shrink))

    if ground_first:
        stages.append(("ground", make_ground_stage()))

    # the shrink deferred past the early ground stage (or, presorted, into
    # the prefix slice): the fused neighbourhood folds it into its first
    # curve sort or slice; the unfused path runs one subsample_to
    deferred_cap = cap if (ground_first or presorted) and cap > 0 else 0
    if deferred_cap and not fuse:
        stages.append((
            "shrink",
            lambda b, p, *_: (
                ops.subsample_to(b, deferred_cap) if deferred_cap < b.capacity else b, None
            ),
        ))

    # radius outliers ride the fused sweep (K3's in-radius2 count); profile
    # mode keeps their standalone stage so that its timing key is emitted
    fuse_radius = fuse and settings.remove_radius_outliers and not separate_stages

    if fuse:
        def neighborhood(b, p, *_):
            out = fused_neighborhood_stats_reordered(
                b.positions, b.mask, dict(b.attributes),
                k=settings.nb_neighbors, radius=p.search_radius,
                window_blocks=settings.window_blocks,
                passes=settings.neighborhood_passes,
                kmode=settings.knn_kmode,
                shrink_to=deferred_cap if deferred_cap < b.capacity else 0,
                radius2=p.radius_search_radius if fuse_radius else None,
                presorted=presorted,
                entries_merge=settings.normals_merge_passes,
                # the stage thresholds on the kNN mean alone
                carry_count=False,
                backend=backend,
            )
            pos, valid, attrs, mean_d, normals = out[:5]
            keep = valid & outlier_keep(mean_d, valid, p.std_ratio)
            if fuse_radius:
                keep = keep & (out[6] >= p.radius_nb_points)
            if settings.estimate_normals:
                attrs["normals"] = normals
            return ScanBuffer(positions=pos, mask=keep, attributes=attrs), None

        stages.append(("neighborhood", neighborhood))

    standalone = dict(
        method=settings.knn_method, window_blocks=settings.window_blocks,
        passes=settings.neighborhood_passes, window_backend=backend,
    )
    if settings.remove_statistical_outliers and not fuse:
        stages.append((
            "outliers",
            lambda b, p, *_: (
                ops.remove_statistical_outliers(
                    b, settings.nb_neighbors, p.std_ratio, kmode=settings.knn_kmode,
                    **standalone,
                ),
                None,
            ),
        ))
    if settings.remove_radius_outliers and not fuse_radius:
        stages.append((
            "radius_outliers",
            lambda b, p, *_: (
                ops.remove_radius_outliers(
                    b, p.radius_nb_points, p.radius_search_radius, **standalone
                ),
                None,
            ),
        ))
    if settings.estimate_normals and not fuse:
        stages.append((
            "normals",
            lambda b, p, *_: (
                ops.estimate_normals(b, p.search_radius, settings.max_neighbors, **standalone),
                None,
            ),
        ))

    if settings.remove_ground and not ground_first and not ground_raw:
        stages.append(("ground", make_ground_stage()))
    return stages


def _select_scans(pick: torch.Tensor, a: ScanBuffer, b: ScanBuffer) -> ScanBuffer:
    """Scan by scan, ``a`` where ``pick`` (bool of the batch shape) else
    ``b``: the reference's ``lax.cond`` under ``vmap``."""

    def sel(x, y):
        return torch.where(pick.reshape(pick.shape + (1,) * (x.dim() - pick.dim())), x, y)

    return ScanBuffer(
        positions=sel(a.positions, b.positions),
        mask=sel(a.mask, b.mask),
        attributes={k: sel(v, b.attributes[k]) for k, v in a.attributes.items()},
    )


def pipeline_runner(settings: PipelineSettings):
    """The pipeline body: ``fn(buf, params, generator, ground_uniforms=None,
    downsample_uniforms=None) -> (buf, plane)``.

    ``buf`` is one scan or a batch (``core.stack_buffers``); ``plane`` is
    float32[..., 4] of the batch shape, NaN when ground removal is off.
    ``ground_uniforms`` float32[..., num_iterations, ransac_n] and
    ``downsample_uniforms`` float32[..., capacity] of the random
    downsampler (one set per scan, or one for all) replace the draws from
    ``generator``."""
    stages = stage_functions(settings)

    def run(buf: ScanBuffer, params: PipelineParams,
            generator: Optional[torch.Generator],
            ground_uniforms: Optional[torch.Tensor] = None,
            downsample_uniforms: Optional[torch.Tensor] = None):
        plane = torch.full(
            buf.batch_shape + (4,), float("nan"), dtype=torch.float32, device=buf.device
        )
        for _, fn in stages:
            buf, aux = fn(buf, params, generator, ground_uniforms, downsample_uniforms)
            if aux is not None:
                plane = aux
        return buf, plane

    return run


def draw_uniforms(
    settings: PipelineSettings,
    batch_shape: tuple,
    capacity: int,
    generator: Optional[torch.Generator],
    device: torch.device,
    ground_uniforms: Optional[torch.Tensor] = None,
    downsample_uniforms: Optional[torch.Tensor] = None,
):
    """A run's random inputs, drawn ahead of it: ``(ground_uniforms,
    downsample_uniforms)`` for ``pipeline_runner``'s ``run``.

    The draws a stage would take from ``generator`` are taken here, with
    the shapes and in the order of the stages (RANSAC's float32[...,
    num_iterations, ransac_n], the random downsampler's float32[...,
    capacity at its stage]), so a run handed them consumes the numbers it
    would have drawn itself. Draws the caller gives are kept (as float32
    on ``device``); a draw no stage of ``settings`` takes is None.
    """
    ransac = settings.remove_ground and settings.ground_method != "height"
    random_ds = settings.voxel_downsample and settings.downsample_method == "random"
    pcap = settings.pre_voxel_compact_capacity
    ds_cap = pcap if 0 < pcap < capacity else capacity
    lead = tuple(batch_shape)

    def draw(given, shape):
        if given is not None:
            return torch.as_tensor(given, dtype=torch.float32, device=device)
        return torch.rand(shape, generator=generator, dtype=torch.float32, device=device)

    gu = du = None
    ground_shape = lead + (settings.num_iterations, settings.ransac_n)
    if ransac and settings.ground_before_voxel:  # the ground stage runs first
        gu = draw(ground_uniforms, ground_shape)
    if random_ds:
        du = draw(downsample_uniforms, lead + (ds_cap,))
    if ransac and not settings.ground_before_voxel:
        gu = draw(ground_uniforms, ground_shape)
    return gu, du


@functools.lru_cache(maxsize=64)
def build_pipeline(settings: PipelineSettings):
    """The pipeline for a settings tuple (cached per settings)."""
    return pipeline_runner(settings)


def _compact_keys_tier(cfg: Dict[str, object]):
    """Derive the voxel compact-key tier from the ROI/voxel-size bound.

    Returns ``'box'`` when the crop ROI fits the 1024^3 hilbert box at
    this voxel size (span <= 1008 cells), ``'wide'`` when it fits the
    2^20-cell box (two-key 60-bit hilbert, ops/voxel.py), else False.
    Compact keys silently mis-merge out-of-box voxels, so the ROI must
    genuinely bound the live points: crop enabled, not inverted.
    """
    if not bool(cfg.get("voxel_compact_keys", True)):
        return False
    if not bool(cfg.get("crop_to_roi", True)):
        return False
    if bool(cfg.get("crop_to_roi.invert", False)):
        return False
    voxel = float(cfg.get("voxel_size", 0.01))
    if voxel <= 0.0:
        return False
    span = max(
        hi - lo
        for lo, hi in zip(
            cfg.get("roi_min", (-60.0, -60.0, -20.0)),
            cfg.get("roi_max", (60.0, 60.0, 20.0)),
        )
    )
    cells = span / voxel
    if cells <= 1008.0:
        return "box"
    if cells <= float((1 << 20) - 64):
        return "wide"
    return False


def _parse_window_blocks(value) -> int | tuple:
    """Node/config ``window_blocks`` value -> settings field.

    Accepts an int, or a sequence of per-pass ints (the ROS parameter
    surface carries it as an integer array); a length-1 sequence collapses
    to the uniform int form so ``[1]`` works for any pass count. Tuple
    length vs ``neighborhood_passes`` is validated by
    ``PipelineSettings.__post_init__``.
    """
    if isinstance(value, (int, np.integer)):
        return int(value)
    wb = tuple(int(v) for v in value)
    return wb[0] if len(wb) == 1 else wb


def settings_from_config(cfg: Dict[str, object]) -> PipelineSettings:
    """Map reference-named parameters -> static settings.

    ``cfg`` uses the reference's flat dotted names (SURVEY.md §2a param
    table); missing keys take the reference defaults
    (pointcloud_preprocessor.py:129-199). The TPU performance knobs
    (``knn_method``, ``neighborhood_passes``, ``window_blocks``,
    ``knn_kmode``, ``knn_d2mode``, ``fuse_neighborhood``, the ground
    ordering modes) are first-class config keys too — the shipped bench
    profile (models/presets.py) is reachable through this exact surface,
    and through the node's declared parameters (runtime/node.py).
    """
    offset = np.asarray(
        cfg.get("offset_pointcloud_matrix", np.eye(4).ravel().tolist()),
        dtype=np.float32,
    ).reshape(4, 4)
    has_offset = not np.allclose(offset, np.eye(4))  # reference :284-287
    frame = str(cfg.get("offset_pointcloud_frame", "")).lower()
    has_tf = bool(cfg.get("_has_tf", False))
    return PipelineSettings(
        remove_duplicates=bool(cfg.get("remove_duplicates", True)),
        remove_nans=bool(cfg.get("remove_nans", True)),
        remove_infs=bool(cfg.get("remove_infs", True)),
        apply_offset_lidar=has_offset and frame in ("", "lidar"),
        apply_tf=has_tf,
        apply_offset_robot=has_offset and frame == "robot",
        crop_to_roi=bool(cfg.get("crop_to_roi", True)),
        voxel_downsample=float(cfg.get("voxel_size", 0.01)) > 0.0,
        downsample_method=str(cfg.get("downsample_method", "voxel")),
        fps_num_samples=int(cfg.get("downsample.num_samples", 4096)),
        # reference-shaped param accepts ANY value; the 512-multiple
        # capacity is a kernel constraint, rounded up here (the node logs
        # the effective capacity on reconfigure)
        post_downsample_capacity=(
            -(-int(cfg.get("downsample.max_points", 0)) // 512) * 512
        ),
        pre_voxel_compact_capacity=(
            -(-int(cfg.get("downsample.pre_voxel_capacity", 0)) // 512) * 512
        ),
        remove_statistical_outliers=bool(
            cfg.get("remove_statistical_outliers", False)
        ),
        nb_neighbors=int(cfg.get("remove_statistical_outliers.nb_neighbors", 20)),
        remove_radius_outliers=bool(cfg.get("remove_radius_outliers", False)),
        estimate_normals=bool(cfg.get("estimate_normals", True)),
        max_neighbors=int(cfg.get("estimate_normals.max_neighbors", 30)),
        remove_ground=bool(cfg.get("remove_ground", False)),
        ground_method=str(cfg.get("remove_ground.method", "ransac")),
        ground_before_neighborhood=bool(
            cfg.get("remove_ground.before_neighborhood", False)
        ),
        ground_before_voxel=bool(
            cfg.get("remove_ground.before_voxel", False)
        ),
        # compact voxel sort keys are safe iff the crop ROI bounds the
        # live span at this voxel size: tier 'box' (one 30-bit key) for
        # spans <= 1008 cells, tier 'wide' (two int32 keys, 60-bit
        # hilbert) up to 2^20-64 cells — effectively any croppable scene
        # (both host-side floats here; numeric reconfigure of either
        # re-derives this and recompiles only when the answer flips). A
        # 'voxel_compact_keys' key can force it off.
        voxel_compact_keys=_compact_keys_tier(cfg),
        voxel_first_attrs=bool(cfg.get("voxel_first_attrs", True)),
        ransac_n=int(cfg.get("remove_ground.ransac_number", 5)),
        num_iterations=int(cfg.get("remove_ground.num_iterations", 100)),
        ground_score_subsample=int(
            cfg.get("remove_ground.score_subsample", 0)
        ),
        knn_method=str(cfg.get("knn_method", "auto")),
        neighborhood_passes=int(cfg.get("neighborhood_passes", 2)),
        window_blocks=_parse_window_blocks(cfg.get("window_blocks", 1)),
        knn_kmode=str(cfg.get("knn_kmode", "sweep")),
        knn_d2mode=str(cfg.get("knn_d2mode", "highest")),
        fuse_neighborhood=bool(cfg.get("fuse_neighborhood", True)),
        normals_merge_passes=bool(cfg.get("normals_merge_passes", True)),
    )

def params_from_config(
    cfg: Dict[str, object],
    tf_matrix: Optional[np.ndarray] = None,
    device: torch.device | str | None = None,
) -> PipelineParams:
    """Map reference-named parameters -> PipelineParams on ``device``
    (default ``cuda:0``; raises without a card unless a device is given)."""
    offset = np.asarray(
        cfg.get("offset_pointcloud_matrix", np.eye(4).ravel().tolist()),
        dtype=np.float32,
    ).reshape(4, 4)
    return PipelineParams.make(
        roi_min=cfg.get("roi_min", (-60.0, -60.0, -20.0)),
        roi_max=cfg.get("roi_max", (60.0, 60.0, 20.0)),
        crop_invert=bool(cfg.get("crop_to_roi.invert", False)),
        voxel_size=float(cfg.get("voxel_size", 0.01)),
        std_ratio=float(cfg.get("remove_statistical_outliers.std_ratio", 2.0)),
        search_radius=float(cfg.get("estimate_normals.search_radius", 0.1)),
        distance_threshold=float(cfg.get("remove_ground.distance_threshold", 0.2)),
        offset_matrix=offset,
        tf_matrix=tf_matrix,
        radius_nb_points=float(cfg.get("remove_radius_outliers.nb_points", 16)),
        radius_search_radius=float(
            cfg.get("remove_radius_outliers.search_radius", 0.05)
        ),
        sampling_ratio=float(cfg.get("downsample.sampling_ratio", 0.5)),
        every_k_points=int(cfg.get("downsample.every_k_points", 5)),
        ground_plane=cfg.get("ground_plane", (0.0, 1.0, 0.0, 0.0)),
        device=device,
    )
