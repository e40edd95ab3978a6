"""RANSAC plane segmentation (ground removal).

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/ground.py``: all
hypotheses are sampled at once, every hypothesis scores every live point
in one [N, H] pass, argmax picks the winner, and a least-squares refit on
the winning inliers polishes the plane. A batch of scans runs the same
steps over a leading scan axis (draws [B, H, n], votes [B, N, H]).

Randomness: the reference draws ``jax.random.uniform(key, (H, n))``. torch
cannot reproduce those bits, so the draws come from a ``torch.Generator``
here, or from the caller's ``uniforms`` float32[H, n] when given (the
parity tests pass the reference's own draws, which makes the sample
indices identical). With the generator the agreement is statistical only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.scan import ScanBuffer
from .linalg import smallest_eigvec_entries

__all__ = ["segment_plane", "remove_ground"]


def _fit_planes_batched(sx, sy, sz) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares plane per hypothesis from samples float32[..., H, n].

    Returns (normals float32[..., 3, H] unit, d float32[..., H]) with
    n.p + d = 0.
    """
    cx, cy, cz = sx.mean(dim=-1), sy.mean(dim=-1), sz.mean(dim=-1)
    dx, dy, dz = sx - cx[..., None], sy - cy[..., None], sz - cz[..., None]
    nx, ny, nz = smallest_eigvec_entries(
        (dx * dx).sum(-1), (dy * dy).sum(-1), (dz * dz).sum(-1),
        (dx * dy).sum(-1), (dx * dz).sum(-1), (dy * dz).sum(-1),
    )
    d = -(nx * cx + ny * cy + nz * cz)
    return torch.stack([nx, ny, nz], dim=-2), d


def segment_plane(
    buf: ScanBuffer,
    generator: Optional[torch.Generator],
    distance_threshold: torch.Tensor | float = 0.2,
    ransac_n: int = 5,
    num_iterations: int = 100,
    uniforms: Optional[torch.Tensor] = None,
    live_prefix: bool = False,
    score_subsample: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find the dominant plane among live points, per scan.

    Samples with replacement among the live points: draw j of hypothesis h
    picks the ``floor(u[h, j] * count)``-th live point in buffer order.
    A batched buffer [B, ...] fits each scan with its own draws
    ``u[b]`` (float32[B, H, n]; [H, n] draws serve every scan).

    ``live_prefix`` promises that the live points fill slots [0, count)
    (the voxel stage's output): the draw is then the slot itself, the same
    slot the rank lookup finds on such input. ``score_subsample`` > 0
    (and below the capacity) runs the hypothesis vote on every
    ``capacity // score_subsample``-th slot, a strided view; the refit and
    the inlier mask still use every live point.

    Dead rows may hold NaN coordinates; they are zeroed first, so that the
    refit's weighted sums (NaN * 0 = NaN) stay finite. The reference does
    not zero them and, on such scans, returns the best hypothesis unrefined
    (ROADMAP, faults found).

    Returns (plane float32[..., 4] = [nx, ny, nz, d] with unit normal,
    inlier_mask bool[..., capacity] over live points).
    """
    lead, cap = buf.batch_shape, buf.capacity
    zero = torch.zeros((), dtype=buf.positions.dtype, device=buf.device)
    x, yy, zz = (torch.where(buf.mask, buf.positions[..., c, :], zero) for c in range(3))
    dev = x.device
    if uniforms is None:
        u = torch.rand(
            lead + (num_iterations, ransac_n), generator=generator,
            dtype=torch.float32, device=dev,
        )
    else:
        u = torch.as_tensor(uniforms, dtype=torch.float32, device=dev)
        if u.shape[-2:] != (num_iterations, ransac_n) or u.dim() > len(lead) + 2:
            raise ValueError(
                f"uniforms shape {tuple(u.shape)} != "
                f"{lead + (num_iterations, ransac_n)}"
            )
        u = u.expand(lead + (num_iterations, ransac_n))
    if live_prefix:
        count = buf.mask.sum(-1, dtype=torch.int32, keepdim=True)
    else:
        csum = torch.cumsum(buf.mask.to(torch.int32), -1, dtype=torch.int32)
        count = csum[..., -1:]
    safe_count = torch.clamp(count, min=1)[..., None]  # [..., 1, 1]
    draw = torch.minimum((u * safe_count).to(torch.int32), safe_count - 1).reshape(lead + (-1,))
    if live_prefix:  # the (draw+1)-th live point sits at slot draw
        sample_idx = draw.to(torch.int64)
    else:
        # the (draw+1)-th live point: cumsum(mask) is monotone, so a left
        # searchsorted finds the same slot a stable live-first order would
        sample_idx = torch.clamp(torch.searchsorted(csum, draw + 1, side="left"), max=cap - 1)
    normals, ds = _fit_planes_batched(*(
        torch.gather(c, -1, sample_idx).reshape(u.shape) for c in (x, yy, zz)
    ))

    thresh = torch.as_tensor(distance_threshold, dtype=x.dtype, device=dev)
    vx, vy, vz, vm = x, yy, zz, buf.mask
    if 0 < score_subsample < cap:
        stride = cap // score_subsample
        vx, vy, vz, vm = (v[..., ::stride] for v in (x, yy, zz, buf.mask))
    dist = torch.abs(
        vx[..., :, None] * normals[..., 0, None, :]
        + vy[..., :, None] * normals[..., 1, None, :]
        + vz[..., :, None] * normals[..., 2, None, :]
        + ds[..., None, :]
    )  # [..., N (or N / stride), H]
    votes = ((dist <= thresh) & vm[..., :, None]).sum(dim=-2)
    best = torch.argmax(votes, dim=-1, keepdim=True)  # first maximum, as jnp.argmax

    # terminal refinement: least-squares refit on the winning inliers;
    # per-scan scalars keep a trailing axis of 1 ([..., 1])
    bnx, bny, bnz, bd = (
        torch.gather(r, -1, best)
        for r in (normals[..., 0, :], normals[..., 1, :], normals[..., 2, :], ds)
    )
    best_inliers = (torch.abs(x * bnx + yy * bny + zz * bnz + bd) <= thresh) & buf.mask
    w = best_inliers.to(x.dtype)

    def total(v):
        return v.sum(-1, keepdim=True)

    wsum = torch.clamp(total(w), min=1.0)
    cx, cy, cz = total(x * w) / wsum, total(yy * w) / wsum, total(zz * w) / wsum
    dx, dy, dz = (x - cx) * w, (yy - cy) * w, (zz - cz) * w
    # one factor of w per centered term is enough for 0/1 weights
    nx, ny, nz = smallest_eigvec_entries(
        total(dx * (x - cx)), total(dy * (yy - cy)), total(dz * (zz - cz)),
        total(dx * (yy - cy)), total(dx * (zz - cz)), total(dy * (zz - cz)),
    )
    d_ref = -(nx * cx + ny * cy + nz * cz)
    inlier_mask = (torch.abs(x * nx + yy * ny + zz * nz + d_ref) <= thresh) & buf.mask

    use_refined = total(inlier_mask) >= total(best_inliers)
    plane = torch.where(
        use_refined,
        torch.cat([nx, ny, nz, d_ref], -1),
        torch.cat([bnx, bny, bnz, bd], -1),
    )
    inlier_mask = torch.where(use_refined, inlier_mask, best_inliers)
    return plane, inlier_mask


def remove_ground(
    buf: ScanBuffer,
    generator: Optional[torch.Generator],
    distance_threshold: torch.Tensor | float = 0.2,
    ransac_n: int = 5,
    num_iterations: int = 100,
    uniforms: Optional[torch.Tensor] = None,
    live_prefix: bool = False,
    score_subsample: int = 0,
) -> Tuple[ScanBuffer, torch.Tensor]:
    """Mask out the dominant plane's inliers. Returns (buffer, plane
    float32[..., 4]); ``live_prefix`` and ``score_subsample`` as in
    ``segment_plane``."""
    plane, inliers = segment_plane(
        buf, generator, distance_threshold, ransac_n, num_iterations,
        uniforms=uniforms, live_prefix=live_prefix, score_subsample=score_subsample,
    )
    return buf.with_mask(~inliers), plane
