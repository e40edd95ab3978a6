"""StreamingEngine: raw Velodyne packets in, compressed clouds out.

Port of the reference's ``io/streaming.py``. Per revolution:

  packet bytes (u8, ~1.2 KB/packet) --one H2D copy--> packet decode on the
  device --> the full preprocessing pipeline --> quantization on the
  device --int16, ~8 B/pt, one D2H copy--> host varint+DEFLATE --> APCZ blob

The host only restructures packet bytes with numpy strided views, runs
the final entropy stage (native sidecar), and splits revolutions by
peeking block azimuths (24 of 1206 bytes per packet). The packet fields,
the packet times, the packet count of a revolution (or of a batch of
them) and the intensity scale travel in one pinned host buffer; the
quantized rows come back into pinned buffers behind an event, so
``replay_pcap`` dispatches revolution N+1 before it pulls and
entropy-codes revolution N.

On a CUDA card decode, pipeline and quantizer run as one captured program
for each (packet bucket, batch) (``models/graphs.py``; the reference's one
``jit`` of the three), with the generator's draws taken ahead
(``pipeline.draw_uniforms``). The copy of its outputs to the host follows
the replay on the same stream, before the next replay can overwrite them.

The decode and the quantizer's arithmetic are plain PyTorch operations
(the reference computes them as XLA elementwise operations outside any
Pallas kernel); the pipeline runs K1, K2 and K3, and the quantizer's
compaction is one more K1 launch.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.scan import ScanBuffer, resolve_device
from ..models import graphs
from ..models.pipeline import (
    PipelineParams,
    PipelineSettings,
    build_pipeline,
    draw_uniforms,
    params_from_config,
    settings_from_config,
)
from .compressor import device_quantizer, encode_device_quantized
from .pcap import _ELEVATIONS, VLP16, _read_payloads

__all__ = ["StreamingEngine", "decode_fields"]

_FIELD_ROWS = 1176
_SLOTS = 384  # 12 blocks x 32 channels of a packet
_AZ_TO_RAD = float(np.float32(np.pi / 18000.0))


def _split_packet_fields(payloads: np.ndarray) -> np.ndarray:
    """(P, 1206) u8 -> ONE (1176, P) u8 field matrix (host strided copies).

    Row layout: az_lo(12), az_hi(12), d_lo(384), d_hi(384), refl(384) —
    packet index in the lane axis so the device never transposes, and the
    whole scan ships in a single H2D transfer.
    """
    p = payloads.shape[0]
    blocks = payloads[:, :1200].reshape(p, 12, 100)
    ch = blocks[:, :, 4:100].reshape(p, 12, 32, 3)
    return np.concatenate(
        [
            blocks[:, :, 2].T,  # az_lo (12, P)
            blocks[:, :, 3].T,  # az_hi (12, P)
            ch[:, :, :, 0].reshape(p, 384).T,  # d_lo (384, P)
            ch[:, :, :, 1].reshape(p, 384).T,  # d_hi (384, P)
            ch[:, :, :, 2].reshape(p, 384).T,  # refl (384, P)
        ]
    )


def _laser_tables(model: str, device: torch.device):
    """(ring int32[384], firing sequence float32[384, 1], cos and sin of
    the elevation float32[384, 1]) of the 384 channel slots of a packet."""
    laser = torch.arange(_SLOTS, device=device) % 32
    ring = laser % 16 if model == VLP16 else laser
    elev = torch.from_numpy(np.deg2rad(_ELEVATIONS[model]).astype(np.float32)).to(device)
    el = elev[ring]
    seq = (laser // 16).to(torch.float32)
    return ring.to(torch.int32), seq[:, None], torch.cos(el)[:, None], torch.sin(el)[:, None]


def decode_fields(
    fields: torch.Tensor,
    stamp_off: torch.Tensor,
    n_packets: torch.Tensor,
    min_range,
    max_range,
    model: str = VLP16,
    tables=None,
) -> ScanBuffer:
    """Packet field matrix -> ScanBuffer of capacity 384 x P, on the
    tensors' device.

    Args:
        fields: uint8 [1176, P] or [B, 1176, P] (``_split_packet_fields``,
            zero-padded to P packets).
        stamp_off: float32 [P] / [B, P] packet times from the revolution's
            first packet.
        n_packets: int [] / [B] real packets; later columns are padding.
        min_range, max_range: range limits in metres, Python floats or
            float32 tensors on the device (never made per call).
        tables: ``_laser_tables(model, device)``, made once by the caller
            (made here when None).

    Point order is laser-major, as the reference's: flat index j * P + pkt
    where j = block * 32 + laser. Attributes: intensity, ring (int32),
    time (float32 offsets), azimuth (degrees) and distance (metres).
    """
    pb = fields.shape[-1]
    lead = fields.shape[:-2]
    ring, seq, cos_el, sin_el = tables or _laser_tables(model, fields.device)
    f = fields.to(torch.float32)
    az_raw = f[..., 0:12, :] + f[..., 12:24, :] * 256.0  # (.., 12, P) cdeg
    dist = (f[..., 24:408, :] + f[..., 408:792, :] * 256.0) * 0.002  # (.., 384, P)
    inten = f[..., 792:1176, :]
    az_b = az_raw.repeat_interleave(32, dim=-2)  # each block's azimuth, per slot
    if model == VLP16:
        # next block's azimuth (within packet; the last extrapolates)
        last = az_raw[..., -1:, :]
        az_next = torch.cat([az_raw[..., 1:, :], last + (last - az_raw[..., -2:-1, :])], dim=-2)
        daz = torch.remainder(az_next - az_raw, 36000.0)
        az = torch.remainder(az_b + 0.5 * daz.repeat_interleave(32, dim=-2) * seq, 36000.0)
    else:
        az = torch.remainder(az_b, 36000.0)
    az_rad = az * _AZ_TO_RAD
    x = dist * cos_el * torch.sin(az_rad)
    y = dist * cos_el * torch.cos(az_rad)
    z = dist * sin_el
    in_scan = torch.arange(pb, device=fields.device) < n_packets.unsqueeze(-1)  # (.., P)
    valid = (dist >= min_range) & (dist <= max_range) & in_scan.unsqueeze(-2)
    n = _SLOTS * pb
    # contiguous: a batch's intensity rows are a strided slice of the fields
    flat = lambda t: t.reshape(lead + (n,)).contiguous()  # noqa: E731
    return ScanBuffer(
        positions=torch.stack([x, y, z], dim=-3).reshape(lead + (3, n)),
        mask=flat(valid),
        attributes={
            "intensity": flat(inten),
            "ring": flat(ring[:, None].expand(lead + (_SLOTS, pb))),
            "time": flat(stamp_off.unsqueeze(-2).expand(lead + (_SLOTS, pb))),
            "azimuth": flat(az / 100.0),
            "distance": flat(dist),
        },
    )


def _revolution_body(run, quantize, model: str, tables, ranges: torch.Tensor):
    """``body(fields, stamp_off, n_packets, intensity_scale, params, draws)
    -> (packed, meta)``: decode, pipeline and quantizer, one revolution or
    a batch (the function a streaming program captures)."""

    def body(fields, stamp_off, n_packets, intensity_scale, params, draws):
        buf = decode_fields(fields, stamp_off, n_packets, ranges[0], ranges[1], model, tables)
        buf, _plane = run(buf, params, None, *draws)
        return quantize(buf, intensity_scale)

    return body


class StreamingEngine:
    """PCAP/UDP packets -> preprocessed, compressed clouds, on the device.

    Args:
        config: reference-named pipeline parameters (like Preprocessor).
        model: 'VLP16' or 'HDL32E'.
        packet_bucket: packets-per-scan capacity (80 covers a 10 Hz VLP-16
            revolution with margin); later packets of a revolution are cut.
        quantization_bits: codec quantization for the compressed egress.
        min_range, max_range: returns outside [min_range, max_range] m are
            dropped by the decode.
        seed: seed of the engine's generator (RANSAC's and the random
            downsampler's draws, drawn anew for every revolution).
        device: where the engine runs (default ``cuda:0``; raises without a
            card unless a device is given).
    """

    def __init__(
        self,
        config: Optional[Dict[str, object]] = None,
        model: str = VLP16,
        packet_bucket: int = 80,
        quantization_bits: int = 14,
        min_range: float = 0.4,
        max_range: float = 130.0,
        seed: int = 0,
        device: torch.device | str | None = None,
    ):
        self.config = dict(config or {})
        self.model = model
        self.packet_bucket = packet_bucket
        self.qbits = quantization_bits
        self.min_range = min_range
        self.max_range = max_range
        self.device = resolve_device(device)
        self.settings: PipelineSettings = settings_from_config(self.config)
        self.params: PipelineParams = params_from_config(self.config, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._body = _revolution_body(
            build_pipeline(self.settings), device_quantizer(quantization_bits), model,
            _laser_tables(model, self.device),
            torch.tensor([min_range, max_range], dtype=torch.float32, device=self.device),
        )
        self._pinned = self.device.type == "cuda"

    # -- host <-> device ----------------------------------------------------

    def _pack(self, scans: Sequence[Tuple[np.ndarray, np.ndarray]], intensity_scale: float):
        """Revolutions -> one host byte buffer: field matrices (B, 1176, P),
        packet times float32 (B, P), packet counts int32 (B,) and the
        intensity scale float32, each revolution cut to ``packet_bucket``
        packets and zero-padded."""
        b, pb = len(scans), self.packet_bucket
        sizes = (b * _FIELD_ROWS * pb, b * pb * 4, b * 4, 4)
        host = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=self._pinned)
        raw = host.numpy()
        raw[:] = 0
        fields = raw[: sizes[0]].reshape(b, _FIELD_ROWS, pb)
        stamp_off = raw[sizes[0] : sizes[0] + sizes[1]].view(np.float32).reshape(b, pb)
        n_packets = raw[sizes[0] + sizes[1] : sum(sizes[:3])].view(np.int32)
        raw[sum(sizes[:3]) :].view(np.float32)[0] = intensity_scale
        for i, (payloads, stamps) in enumerate(scans):
            p = min(payloads.shape[0], pb)
            fields[i, :, :p] = _split_packet_fields(payloads[:p])
            base = float(stamps[:p].min()) if p else 0.0
            stamp_off[i, :p] = (stamps[:p] - base).astype(np.float32)
            n_packets[i] = p
        return host, sizes

    def _upload(self, host: torch.Tensor, sizes, batch: bool):
        """One copy of the packed buffer to the device, then views of it:
        (fields, stamp_off, n_packets, intensity scale float32[])."""
        dev = host.to(self.device, non_blocking=True)
        b, pb = sizes[2] // 4, self.packet_bucket
        fields = dev[: sizes[0]].view(b, _FIELD_ROWS, pb)
        stamp_off = dev[sizes[0] : sizes[0] + sizes[1]].view(torch.float32).view(b, pb)
        n_packets = dev[sizes[0] + sizes[1] : sum(sizes[:3])].view(torch.int32)
        scale = dev[sum(sizes[:3]) :].view(torch.float32)[0]
        if not batch:
            return fields[0], stamp_off[0], n_packets[0], scale
        return fields, stamp_off, n_packets, scale

    def _pull(self, packed: torch.Tensor, meta: torch.Tensor):
        """Start the copy of the quantized rows to the host; the returned
        handle's event says when they have arrived."""
        if not self._pinned:
            return packed, meta, None
        host_packed = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host_meta = torch.empty(meta.shape, dtype=meta.dtype, pin_memory=True)
        host_packed.copy_(packed, non_blocking=True)
        host_meta.copy_(meta, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host_packed, host_meta, done

    # -- per-scan -----------------------------------------------------------

    def _device_run(self, fields, stamp_off, n_packets, scale, ground_uniforms):
        """Decode, pipeline and quantizer on the uploaded views: one replay
        on a card (its own output tensors, pulled before the next replay),
        eager on the CPU."""
        draws = draw_uniforms(self.settings, n_packets.shape, _SLOTS * fields.shape[-1],
                              self.generator, self.device, ground_uniforms)
        args = (fields, stamp_off, n_packets, scale, self.params, draws)
        if not graphs.captures(self.device):
            return self._body(*args)
        tag = ("stream", self.settings, self.model, self.qbits, self.min_range, self.max_range)
        return graphs.program(tag, lambda: self._body, *args)(*args, clone=False)

    def _dispatch_scan(
        self, payloads: np.ndarray, stamps: np.ndarray,
        intensity_scale: float = 1.0, ground_uniforms: Optional[torch.Tensor] = None,
    ):
        """Dispatch one revolution (H2D, decode, pipeline, quantize, the
        start of the D2H copy); returns a handle for ``_encode_result``.
        Splitting dispatch from encode lets ``replay_pcap`` overlap
        revolution N+1's device work with revolution N's entropy coding."""
        host, sizes = self._pack([(payloads, stamps)], intensity_scale)
        packed, meta = self._device_run(*self._upload(host, sizes, batch=False),
                                        ground_uniforms)
        return (*self._pull(packed, meta), intensity_scale)

    def _encode_result(self, handle) -> bytes:
        """Wait for a dispatched revolution's quantized rows and
        entropy-code them."""
        packed, meta, done, intensity_scale = handle
        if done is not None:
            done.synchronize()
        return encode_device_quantized(
            packed.numpy(), meta.numpy(), self.qbits, intensity_scale
        )

    def process_scan_packets(
        self, payloads: np.ndarray, stamps: np.ndarray,
        intensity_scale: float = 1.0, ground_uniforms: Optional[torch.Tensor] = None,
    ) -> bytes:
        """One revolution's packets -> APCZ compressed blob.
        ``ground_uniforms`` float32[num_iterations, ransac_n] on the engine's
        device replaces the generator's RANSAC draws."""
        return self._encode_result(
            self._dispatch_scan(payloads, stamps, intensity_scale, ground_uniforms)
        )

    def process_scan_batch(
        self,
        scans: Sequence[Tuple[np.ndarray, np.ndarray]],
        intensity_scale: float = 1.0,
        ground_uniforms: Optional[torch.Tensor] = None,
    ) -> List[bytes]:
        """B revolutions (a list of (payloads, stamps)) in one batched run:
        one H2D copy, one decode, pipeline and quantizer over a leading scan
        axis (each kernel launched as often as for one revolution), one D2H
        copy. ``ground_uniforms`` float32[B, num_iterations, ransac_n] gives
        each revolution its RANSAC draws. The replay-throughput mode: it
        adds B-1 revolutions of latency (live streaming uses
        ``process_scan_packets``)."""
        if not scans:
            return []
        host, sizes = self._pack(scans, intensity_scale)
        packed, meta = self._device_run(*self._upload(host, sizes, batch=True),
                                        ground_uniforms)
        packed, meta, done = self._pull(packed, meta)
        if done is not None:
            done.synchronize()
        packed, meta = packed.numpy(), meta.numpy()
        return [
            encode_device_quantized(packed[i], meta[i], self.qbits, intensity_scale)
            for i in range(len(scans))
        ]

    # -- replay -------------------------------------------------------------

    def replay_pcap(self, path: str, batch: int = 1) -> Iterator[bytes]:
        """Yield one compressed blob per revolution of a capture.

        ``batch`` > 1 processes that many revolutions per device dispatch
        (throughput mode; see process_scan_batch).
        """
        payloads, stamps = _read_payloads(path)
        if payloads.shape[0] == 0:
            return
        # revolution split from block-0 azimuths (2 peeked bytes/packet)
        az0 = (
            payloads[:, 2].astype(np.int32)
            | (payloads[:, 3].astype(np.int32) << 8)
        )
        wraps = np.flatnonzero(np.diff(az0) < -18000) + 1
        bounds = [0, *wraps.tolist(), payloads.shape[0]]
        spans = [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        if batch <= 1:
            # one-revolution pipelining: dispatch N+1 BEFORE pulling +
            # entropy-coding N, so the device computes the next revolution
            # while the host encodes the previous one
            pending = None
            for a, b in spans:
                handle = self._dispatch_scan(payloads[a:b], stamps[a:b])
                if pending is not None:
                    yield self._encode_result(pending)
                pending = handle
            if pending is not None:
                yield self._encode_result(pending)
            return
        for i in range(0, len(spans), batch):
            group = spans[i : i + batch]
            yield from self.process_scan_batch(
                [(payloads[a:b], stamps[a:b]) for a, b in group]
            )
