"""Multi-LiDAR concatenation: sync, transform, merge.

Port of ``autodriver_pointcloud_preprocessor_tpu/parallel/concat.py``.
Realizes the reference's declared-but-stub concatenator
(reference: pointcloud_concatenator.py:1-5 — "synchronize + concatenate N
clouds, transform to a target frame; sync via message_filters
ApproximateTimeSynchronizer, or a robust publish-on-partial-failure mode";
the synchronizer import sits unused at pointcloud_preprocessor.py:102).

The merge runs on the node's device: each sensor's padded buffer is
SE(3)-transformed by its extrinsic and the buffers are concatenated along
the point axis (``torch.cat``), with no per-sensor host round trip. The
extrinsics become device tensors once, when the node is made. On a CUDA
card the merge is one captured program (``models/graphs.py``) a set of
buffer capacities and attribute schemas, as the reference jits it; on the
CPU it runs eagerly. The time rebase adds a host float and stays outside
the program, as the reference keeps it outside its ``jit``. Host-side
sync (time matching) stays at the edges where the wall clock lives.
"""
from __future__ import annotations

import collections
import time as _time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.codec import pointcloud_to_dict
from ..core.msg import PointCloud2, Time
from ..core.scan import ScanBuffer, from_soa, resolve_device, to_soa
from ..io.loader import soa_to_pointcloud2
from ..models import graphs
from ..ops.transform import se3_transform

__all__ = [
    "concatenate_buffers",
    "ApproximateTimeSynchronizer",
    "PointcloudConcatenatorNode",
]


def concatenate_buffers(
    buffers: Sequence[ScanBuffer],
    extrinsics: Optional[Sequence[torch.Tensor]] = None,
) -> ScanBuffer:
    """Transform each buffer by its extrinsic and merge into one buffer.

    Output capacity = sum of input capacities; live points keep per-sensor
    contiguity. Attributes present in only some sensors are zero-filled for
    the others (union schema). Extrinsics are float32 4x4 tensors on the
    buffers' device.
    """
    if extrinsics is not None:
        buffers = [se3_transform(buf, ex) for buf, ex in zip(buffers, extrinsics)]

    all_attr_names = sorted({k for b in buffers for k in b.attributes})

    def attr_or_zero(buf: ScanBuffer, name: str) -> torch.Tensor:
        if name in buf.attributes:
            return buf.attributes[name]
        proto = next(b.attributes[name] for b in buffers if name in b.attributes)
        shape = proto.shape[:-1] + (buf.capacity,)
        return torch.zeros(shape, dtype=proto.dtype, device=buf.device)

    return ScanBuffer(
        positions=torch.cat([b.positions for b in buffers], dim=-1),
        mask=torch.cat([b.mask for b in buffers], dim=-1),
        attributes={
            name: torch.cat([attr_or_zero(b, name) for b in buffers], dim=-1)
            for name in all_attr_names
        },
    )


class ApproximateTimeSynchronizer:
    """N-way message matcher by nearest timestamps (message_filters analog).

    Messages must expose ``.header.stamp`` (Time). When one message per
    slot falls within ``slop`` seconds of a common instant, ``callback``
    fires with the matched tuple and the consumed messages are dropped.
    """

    def __init__(
        self,
        num_inputs: int,
        callback: Callable[..., None],
        queue_size: int = 10,
        slop: float = 0.05,
    ):
        self.num_inputs = num_inputs
        self.callback = callback
        self.slop = slop
        self.queues: List[collections.deque] = [
            collections.deque(maxlen=queue_size) for _ in range(num_inputs)
        ]

    def add(self, index: int, msg) -> None:
        self.queues[index].append(msg)
        self._try_match()

    def _try_match(self) -> None:
        if any(not q for q in self.queues):
            return
        # candidate: for each pivot message in queue 0, find the closest
        # message in every other queue; fire on the first pivot whose
        # span fits in slop (greedy, oldest-first)
        for pivot in list(self.queues[0]):
            t0 = pivot.header.stamp.to_float()
            chosen = [pivot]
            ok = True
            for q in self.queues[1:]:
                best = min(q, key=lambda m: abs(m.header.stamp.to_float() - t0))
                if abs(best.header.stamp.to_float() - t0) > self.slop:
                    ok = False
                    break
                chosen.append(best)
            if ok:
                stamps = [m.header.stamp.to_float() for m in chosen]
                if max(stamps) - min(stamps) <= self.slop:
                    for q, m in zip(self.queues, chosen):
                        q.remove(m)
                    self.callback(*chosen)
                    return


class PointcloudConcatenatorNode:
    """Subscribe N PointCloud2 topics -> one merged cloud in a target frame.

    Modes (reference concatenator docstring intent):
    * ``mode='sync'``: ApproximateTimeSynchronizer with ``slop``; publishes
      only complete matched sets.
    * ``mode='robust'``: publishes whatever sensors delivered within
      ``timeout`` seconds of the first arrival in each round — degraded
      sensors don't stall the output.

    Extrinsics: dict topic -> target_from_sensor 4x4; identity when
    omitted. ``self.extrinsics`` holds them as float32 tensors on
    ``device`` (default ``cuda:0``; raises without a card unless a device
    is given), where the merge runs.
    """

    def __init__(
        self,
        bus,
        input_topics: Sequence[str],
        output_topic: str = "/points/concatenated",
        target_frame: str = "base_link",
        extrinsics: Optional[Dict[str, np.ndarray]] = None,
        mode: str = "sync",
        slop: float = 0.05,
        timeout: float = 0.1,
        queue_size: int = 10,
        device: torch.device | str | None = None,
    ):
        from ..runtime.bus import qos_from_name

        if mode not in ("sync", "robust"):
            raise ValueError(f"unknown mode {mode!r}")
        self.bus = bus
        self.device = resolve_device(device)
        self.input_topics = list(input_topics)
        self.target_frame = target_frame
        self.mode = mode
        self.timeout = timeout
        self.extrinsics = {
            t: torch.as_tensor(
                np.asarray((extrinsics or {}).get(t, np.eye(4)), np.float32),
                device=self.device,
            )
            for t in self.input_topics
        }
        self.pub = bus.create_publisher(output_topic, qos_from_name("sensor_data"))
        self.frame_count = 0

        if mode == "sync":
            self._sync = ApproximateTimeSynchronizer(
                len(self.input_topics), self._publish_set, queue_size, slop
            )
        else:
            self._pending: Dict[str, PointCloud2] = {}
            self._round_start: Optional[float] = None

        self.subs = [
            bus.create_subscription(
                topic,
                (lambda t: lambda msg: self._on_msg(t, msg))(topic),
                qos_from_name("sensor_data"),
            )
            for topic in self.input_topics
        ]

    # -- ingestion ------------------------------------------------------------

    def _on_msg(self, topic: str, msg: PointCloud2) -> None:
        if self.mode == "sync":
            self._sync.add(self.input_topics.index(topic), msg)
            return
        # robust mode
        now = _time.monotonic()
        if self._round_start is None:
            self._round_start = now
        self._pending[topic] = msg
        complete = len(self._pending) == len(self.input_topics)
        expired = now - self._round_start >= self.timeout
        if complete or expired:
            self.flush()

    def flush(self) -> None:
        """Robust mode: publish the partial set collected so far."""
        if self.mode != "robust" or not self._pending:
            return
        topics = [t for t in self.input_topics if t in self._pending]
        msgs = [self._pending[t] for t in topics]
        self._publish_set(*msgs, topics=topics)
        self._pending.clear()
        self._round_start = None

    # -- merge ----------------------------------------------------------------

    def _publish_set(self, *msgs: PointCloud2, topics: Optional[List[str]] = None):
        topics = topics or self.input_topics
        buffers, metas = [], []
        for msg in msgs:
            soa, meta = pointcloud_to_dict(msg, skip_nans=False)
            buf, meta = from_soa(soa, metadata=meta, device=self.device)
            buffers.append(buf)
            metas.append(meta)

        # re-base per-sensor time offsets onto the common (min) time_base so
        # absolute times stay correct after the merge: one float32 add of
        # the float32-rounded base difference, as the reference does
        bases = [m.get("time_base") for m in metas]
        known = [b for b in bases if b is not None]
        base_min = min(known) if known else None
        if base_min is not None:
            rebased = []
            for buf, base in zip(buffers, bases):
                if base is not None and base != base_min and "time" in buf.attributes:
                    attrs = dict(buf.attributes)
                    attrs["time"] = attrs["time"] + float(np.float32(base - base_min))
                    buf = buf.replace(attributes=attrs)
                rebased.append(buf)
            buffers = rebased

        merged = self._merge(buffers, [self.extrinsics[t] for t in topics])
        out_soa = to_soa(merged, self._merged_meta(metas))
        stamp = max(m.header.stamp.to_float() for m in msgs)
        out = soa_to_pointcloud2(
            out_soa, frame_id=self.target_frame, stamp=Time.from_float(stamp)
        )
        self.pub.publish(out)
        self.frame_count += 1

    def _merge(self, buffers: List[ScanBuffer], extrinsics: List[torch.Tensor]) -> ScanBuffer:
        """``concatenate_buffers`` on the node's device: on a card, the
        replay of the program for these buffers' capacities and attribute
        schemas (its key; reference ``concat.py:240-250``)."""
        if not graphs.captures(self.device):
            return concatenate_buffers(buffers, extrinsics)
        args = (buffers, extrinsics)
        return graphs.program(("concat",), lambda: concatenate_buffers, *args)(*args)

    @staticmethod
    def _merged_meta(metas):
        # conservative: use the min time_base; per-sensor offsets remain
        # correct to f32 within a sync window (<0.1 s)
        bases = [m.get("time_base") for m in metas if m.get("time_base") is not None]
        return {"time_base": min(bases)} if bases else {}
