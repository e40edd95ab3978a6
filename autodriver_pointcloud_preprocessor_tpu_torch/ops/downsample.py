"""Random, uniform and farthest-point downsampling (mask-only).

Port of ``autodriver_pointcloud_preprocessor_tpu/ops/downsample.py``.
Buffers may carry a batch axis; each scan is sampled on its own.

Randomness: the reference draws ``jax.random.uniform(key, (capacity,))``.
Here the draws come from a ``torch.Generator``, or from the caller's
``uniforms`` float32[..., capacity] (the tests pass the reference's own
draws, which makes the survivors identical).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.scan import ScanBuffer

__all__ = ["farthest_point_downsample", "random_downsample", "uniform_downsample"]


def random_downsample(
    buf: ScanBuffer,
    sampling_ratio: torch.Tensor | float,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> ScanBuffer:
    """Keep each live point independently with probability
    ``sampling_ratio`` (Open3D ``random_down_sample``: about ratio * N
    survivors). ``uniforms`` [capacity] serves every scan of a batch,
    [..., capacity] gives each its own."""
    shape = buf.mask.shape
    if uniforms is None:
        u = torch.rand(shape, generator=generator, dtype=torch.float32, device=buf.device)
    else:
        u = torch.as_tensor(uniforms, dtype=torch.float32, device=buf.device)
        if u.shape[-1] != shape[-1] or u.dim() > len(shape):
            raise ValueError(f"uniforms shape {tuple(u.shape)} != {tuple(shape)}")
    ratio = torch.as_tensor(sampling_ratio, dtype=torch.float32, device=buf.device)
    return buf.with_mask(u < ratio)


def uniform_downsample(buf: ScanBuffer, every_k_points: torch.Tensor | int) -> ScanBuffer:
    """Keep every k-th live point, counted by live ordinal (Open3D
    ``uniform_down_sample``)."""
    ordinal = torch.cumsum(buf.mask, -1, dtype=torch.int32) - 1
    k = torch.clamp(torch.as_tensor(every_k_points, dtype=torch.int32, device=buf.device), min=1)
    return buf.with_mask(ordinal % k == 0)


def farthest_point_downsample(buf: ScanBuffer, num_samples: int) -> ScanBuffer:
    """Greedy farthest-point sampling of ``num_samples`` live points per
    scan; all live points when a scan has no more than that.

    Starts from the first live slot; each step takes the live point
    farthest from those taken (squared distances, ties to the first
    index, as ``jnp.argmax``). The chosen index stays on the device: a
    step is a handful of launches and no host read.
    """
    live = buf.mask
    # dead rows get finite zeros, so their -inf running distance stays
    # -inf under the minimum and no step needs the mask again
    pos = torch.where(live.unsqueeze(-2), buf.positions, torch.zeros((), device=buf.device))
    mind = torch.where(live, float("inf"), float("-inf"))
    last = torch.argmax(live.to(torch.uint8), dim=-1, keepdim=True)  # first live slot
    keep = torch.zeros_like(live)
    for step in range(num_samples):
        keep.scatter_(-1, last, True)
        if step + 1 == num_samples:
            break
        # eight launches a step: one gather of the chosen point's x, y, z
        d = pos - pos.gather(-1, last.unsqueeze(-2).expand(pos.shape[:-1] + (1,)))
        sq = d * d
        mind = torch.minimum(mind, sq[..., 0, :] + sq[..., 1, :] + sq[..., 2, :])
        last = torch.argmax(mind, dim=-1, keepdim=True)
    few = live.sum(-1, keepdim=True) <= num_samples
    return buf.replace(mask=torch.where(few, live, keep & live))
