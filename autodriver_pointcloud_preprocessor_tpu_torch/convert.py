"""Reference state -> port state.

The system has no model weights: its state is the scan buffer and the
numeric pipeline parameters. These functions build the port's versions of
both from plain numpy arrays (e.g. ``np.asarray`` of the JAX package's
``ScanBuffer`` and ``PipelineParams`` fields), so the port never imports
jax and one stage's reference output can feed both packages' next stage.
A batched reference buffer (a leading axis, as ``jax.vmap`` gives it)
becomes a batched port buffer. Like every entry point they put their
tensors on ``cuda:0`` unless a device is given.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from .core.scan import ScanBuffer, resolve_device
from .models.pipeline import PipelineParams

__all__ = ["params_from_reference", "scan_from_reference"]


def scan_from_reference(
    positions: np.ndarray,
    mask: np.ndarray,
    attributes: Mapping[str, np.ndarray],
    device: torch.device | str | None = None,
) -> ScanBuffer:
    """ScanBuffer from channel-major reference arrays.

    Args:
        positions: float32[3, capacity], or [B, 3, capacity] for a batch.
        mask: bool[capacity] or [B, capacity].
        attributes: name -> [..., capacity] or [..., C, capacity] array
            (device dtypes, float32 or int32), as the reference buffer
            holds them.
    """
    device = resolve_device(device)
    positions = np.asarray(positions, np.float32)
    mask = np.asarray(mask, bool)
    if (positions.ndim not in (2, 3) or positions.shape[-2] != 3
            or mask.shape != positions.shape[:-2] + positions.shape[-1:]):
        raise ValueError("positions must be [..., 3, N] and mask [..., N]")

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    attrs: Dict[str, torch.Tensor] = {}
    for name, arr in attributes.items():
        arr = np.asarray(arr)
        if arr.shape[-1] != mask.shape[-1] or arr.shape[: mask.ndim - 1] != mask.shape[:-1]:
            raise ValueError(f"attribute {name} has shape {arr.shape}")
        if arr.dtype not in (np.float32, np.int32):
            raise ValueError(f"attribute {name} has dtype {arr.dtype}")
        attrs[name] = tensor(arr)
    return ScanBuffer(positions=tensor(positions), mask=tensor(mask), attributes=attrs)


def params_from_reference(
    arrays: Mapping[str, np.ndarray], device: torch.device | str | None = None
) -> PipelineParams:
    """PipelineParams from a dict of the reference's parameter fields."""
    device = resolve_device(device)
    fields = [f.name for f in dataclasses.fields(PipelineParams)]
    missing = sorted(set(fields) - set(arrays))
    if missing:
        raise ValueError(f"missing parameter fields: {missing}")
    return PipelineParams(**{
        name: torch.from_numpy(np.array(arrays[name])).to(device) for name in fields
    })
