"""ScanBuffer: the fixed-capacity, mask-validated point buffer every op works on.

Port of ``autodriver_pointcloud_preprocessor_tpu/core/scan.py``. The
contract is the reference's: positions are channel-major float32[3,
capacity] (rows x/y/z), the mask is bool[capacity], multi-channel
attributes are [C, capacity] and scalar ones [capacity]. Filters only
update the mask; compaction happens at egress or in explicit compaction
stages. Capacities are bucketed to powers of two.

Device dtypes: positions/intensity/rgb/time-offset float32, ring and
return_type int32; narrow host dtypes are restored at egress. ``time`` is
carried as float32 offsets from a float64 host-side ``time_base``.

A buffer may carry a leading batch axis (positions [B, 3, N], mask [B, N],
attributes [B, ..., N]): ``stack_buffers`` and ``unstack_buffer`` are the
counterparts of the reference's ``tree_map(jnp.stack)`` and
``tree_map(x[i])``. The ops take either form.

Entry points put their tensors on ``resolve_device(device)``: the device
asked for, else ``cuda:0``. Without a card they raise unless the caller
asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "ATTR_DEVICE_DTYPES",
    "ATTR_HOST_DTYPES",
    "ScanBuffer",
    "bucket_capacity",
    "from_soa",
    "to_soa",
    "valid_count",
    "pad_to_capacity",
    "resolve_device",
    "stack_buffers",
    "unstack_buffer",
]

#: Smallest capacity bucket; below this every scan shares one bucket.
MIN_CAPACITY = 1024

#: Device dtype for each canonical attribute.
ATTR_DEVICE_DTYPES = {
    "intensity": torch.float32,
    "rgb": torch.float32,
    "ring": torch.int32,
    "time": torch.float32,  # offsets from metadata['time_base']
    "return_type": torch.int32,
    "normals": torch.float32,
    "azimuth": torch.float32,
    "distance": torch.float32,
}

#: Host dtype each attribute is restored to at egress.
ATTR_HOST_DTYPES = {
    "intensity": np.float32,
    "rgb": np.float32,
    "ring": np.uint16,
    "time": np.float64,
    "return_type": np.uint8,
    "normals": np.float32,
    "azimuth": np.float32,
    "distance": np.float32,
}

_NUMPY_OF_TORCH = {torch.float32: np.float32, torch.int32: np.int32}


@dataclasses.dataclass(frozen=True)
class ScanBuffer:
    """Padded channel-major struct-of-arrays point buffer.

    Attributes:
        positions: float32[..., 3, capacity] — rows are x, y, z.
        mask: bool[..., capacity]; True for live points.
        attributes: dict of per-point tensors, each [..., capacity] or
            [..., C, capacity]; the leading ``...`` is the mask's.
    """

    positions: torch.Tensor
    mask: torch.Tensor
    attributes: Dict[str, torch.Tensor]

    @property
    def capacity(self) -> int:
        return self.positions.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.positions.device

    @property
    def batch_shape(self) -> torch.Size:
        """``()`` for one scan, ``(B,)`` for a batch."""
        return self.mask.shape[:-1]

    @property
    def x(self) -> torch.Tensor:
        return self.positions[..., 0, :]

    @property
    def y(self) -> torch.Tensor:
        return self.positions[..., 1, :]

    @property
    def z(self) -> torch.Tensor:
        return self.positions[..., 2, :]

    def replace(self, **kwargs) -> "ScanBuffer":
        return dataclasses.replace(self, **kwargs)

    def with_mask(self, mask: torch.Tensor) -> "ScanBuffer":
        """New buffer keeping only points where ``mask`` (ANDed with current)."""
        return self.replace(mask=self.mask & mask)


def bucket_capacity(n: int, minimum: int = MIN_CAPACITY) -> int:
    """Round a point count up to its capacity bucket (next power of two)."""
    n = max(int(n), 1)
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def valid_count(buf: ScanBuffer) -> torch.Tensor:
    """Number of live points per scan, int64 of the batch shape."""
    return buf.mask.sum(-1)


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point puts its tensors on: ``device`` when given,
    else ``cuda:0``. Raises when none is given and there is no CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on cuda:0 by default; pass "
            "device='cpu' to run its plain PyTorch versions on the CPU"
        )
    return torch.device("cuda:0")


def stack_buffers(bufs: Sequence[ScanBuffer]) -> ScanBuffer:
    """Same-capacity single-scan buffers -> one buffer with a batch axis."""
    return ScanBuffer(
        positions=torch.stack([b.positions for b in bufs]),
        mask=torch.stack([b.mask for b in bufs]),
        attributes={
            k: torch.stack([b.attributes[k] for b in bufs])
            for k in bufs[0].attributes
        },
    )


def unstack_buffer(buf: ScanBuffer) -> List[ScanBuffer]:
    """A batched buffer -> its scans (views, no copies)."""
    return [
        ScanBuffer(
            positions=buf.positions[i],
            mask=buf.mask[i],
            attributes={k: v[i] for k, v in buf.attributes.items()},
        )
        for i in range(buf.mask.shape[0])
    ]


def from_soa(
    soa: Dict[str, np.ndarray],
    capacity: Optional[int] = None,
    metadata: Optional[dict] = None,
    device: torch.device | str | None = None,
) -> Tuple[ScanBuffer, dict]:
    """Host SoA dict -> padded ScanBuffer on ``resolve_device(device)``.

    Host arrays use the point-major (N,)/(N, C) convention; they are
    transposed to channel-major here. RGB uint8 (N, 3) is normalized to
    [0, 1] float. Returns ``(buffer, metadata)``; metadata gains
    ``time_base`` when a time attribute is present.
    """
    device = resolve_device(device)
    metadata = dict(metadata or {})
    positions = np.asarray(soa["positions"], dtype=np.float32)
    n = positions.shape[0]
    cap = capacity if capacity is not None else bucket_capacity(n)
    if n > cap:
        raise ValueError(f"{n} points exceed capacity {cap}")

    pos_pad = np.zeros((3, cap), dtype=np.float32)
    pos_pad[:, :n] = positions.T
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = True

    attrs: Dict[str, torch.Tensor] = {}
    for name, arr in soa.items():
        if name == "positions" or arr is None:
            continue
        arr = np.asarray(arr)
        if name == "rgb" and arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        if name == "time":
            base = float(arr.min()) if n else 0.0
            metadata["time_base"] = base
            arr = (arr - base).astype(np.float32)
        arr = arr.T if arr.ndim == 2 else arr
        dev_dtype = ATTR_DEVICE_DTYPES.get(name, torch.float32)
        pad = np.zeros(arr.shape[:-1] + (cap,), dtype=_NUMPY_OF_TORCH[dev_dtype])
        pad[..., :n] = arr
        attrs[name] = torch.from_numpy(pad).to(device)

    buf = ScanBuffer(
        positions=torch.from_numpy(pos_pad).to(device),
        mask=torch.from_numpy(mask).to(device),
        attributes=attrs,
    )
    return buf, metadata


def to_soa(buf: ScanBuffer, metadata: Optional[dict] = None) -> Dict[str, np.ndarray]:
    """ScanBuffer -> compacted host SoA dict.

    Invalid rows are dropped; host arrays are point-major (N,)/(N, C) with
    dtypes restored to their host conventions (ring uint16, return_type
    uint8, time float64 rebuilt from ``metadata['time_base']``).
    """
    metadata = metadata or {}
    mask = buf.mask.cpu().numpy()
    out: Dict[str, np.ndarray] = {
        "positions": np.ascontiguousarray(buf.positions.cpu().numpy()[:, mask].T)
    }
    for name in sorted(buf.attributes):
        host = buf.attributes[name].cpu().numpy()[..., mask]
        host = host.T if host.ndim == 2 else host
        if name == "time":
            host = host.astype(np.float64) + float(metadata.get("time_base", 0.0))
        else:
            host = host.astype(ATTR_HOST_DTYPES.get(name, np.float32))
        out[name] = np.ascontiguousarray(host)
    return out


def pad_to_capacity(buf: ScanBuffer, capacity: int) -> ScanBuffer:
    """Grow a buffer to a larger capacity (zero padding, mask False)."""
    cap = buf.capacity
    if capacity == cap:
        return buf
    if capacity < cap:
        raise ValueError(f"cannot shrink {cap} -> {capacity}; use ops.compact_to")
    extra = capacity - cap

    def _pad(x: torch.Tensor) -> torch.Tensor:
        zeros = torch.zeros(x.shape[:-1] + (extra,), dtype=x.dtype, device=x.device)
        return torch.cat([x, zeros], dim=-1)

    return ScanBuffer(
        positions=_pad(buf.positions),
        mask=_pad(buf.mask),
        attributes={k: _pad(v) for k, v in buf.attributes.items()},
    )
