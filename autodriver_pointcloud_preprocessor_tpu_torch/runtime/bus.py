"""In-process topic bus: the DDS stand-in at the host edges.

The reference's inter-process transport is ROS 2 pub/sub with QoS
(reference: pointcloud_preprocessor.py:324-335, :376-380). The engine keeps
messaging strictly at the host edges (SURVEY.md §2c); this bus provides the
same topic/QoS-shaped API in-process so nodes compose and test without a
ROS installation, and a thin rclpy adapter can swap in real DDS transport
unchanged.

A copy of the reference package's ``runtime/bus.py`` (the port does not
import the reference).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class QoSProfile:
    """Reliability/history/depth triple (rclpy.qos analog, :325-335)."""

    reliability: str = "reliable"  # 'reliable' | 'best_effort'
    history: str = "keep_last"
    depth: int = 1


def qos_from_name(name: str, depth: int = 1) -> QoSProfile:
    """Map the reference's ``qos`` string parameter to a profile (:330-335)."""
    if name.lower() == "sensor_data":
        return QoSProfile(reliability="best_effort", history="keep_last", depth=depth)
    return QoSProfile(reliability="reliable", history="keep_last", depth=depth)


class Subscription:
    def __init__(self, bus: "TopicBus", topic: str, callback, qos: QoSProfile):
        self.bus = bus
        self.topic = topic
        self.callback = callback
        self.qos = qos
        self._queue: collections.deque = collections.deque(maxlen=max(qos.depth, 1))
        self.destroyed = False

    def destroy(self) -> None:
        self.bus._remove_subscription(self)
        self.destroyed = True


class Publisher:
    def __init__(self, bus: "TopicBus", topic: str, qos: QoSProfile):
        self.bus = bus
        self.topic = topic
        self.qos = qos
        self.destroyed = False

    def publish(self, msg: Any) -> None:
        if self.destroyed:
            raise RuntimeError(f"publisher on {self.topic!r} destroyed")
        self.bus._dispatch(self.topic, msg)

    def get_subscription_count(self) -> int:
        """Subscriber count — backs the reference's 0-subscriber
        short-circuit (pointcloud_preprocessor.py:645)."""
        return self.bus.subscription_count(self.topic)

    def destroy(self) -> None:
        self.bus._remove_publisher(self)
        self.destroyed = True


class TopicBus:
    """Synchronous in-process topic fabric.

    ``deliver='direct'`` (default) invokes callbacks inline on publish —
    deterministic for tests, mirroring a single-threaded rclpy executor
    (reference :1056). ``deliver='queued'`` buffers per-subscription up to
    the QoS depth; callers drain with ``spin_once`` — mirroring KEEP_LAST
    semantics under backpressure.
    """

    def __init__(self, deliver: str = "direct"):
        self._subs: Dict[str, List[Subscription]] = collections.defaultdict(list)
        self._pubs: Dict[str, List[Publisher]] = collections.defaultdict(list)
        self._lock = threading.RLock()
        self.deliver = deliver

    def create_subscription(
        self, topic: str, callback: Callable[[Any], None], qos: Optional[QoSProfile] = None
    ) -> Subscription:
        sub = Subscription(self, topic, callback, qos or QoSProfile())
        with self._lock:
            self._subs[topic].append(sub)
        return sub

    def create_publisher(self, topic: str, qos: Optional[QoSProfile] = None) -> Publisher:
        pub = Publisher(self, topic, qos or QoSProfile())
        with self._lock:
            self._pubs[topic].append(pub)
        return pub

    def subscription_count(self, topic: str) -> int:
        with self._lock:
            return len(self._subs.get(topic, []))

    def spin_once(self) -> int:
        """Drain one queued message per subscription; returns deliveries."""
        delivered = 0
        with self._lock:
            subs = [s for lst in self._subs.values() for s in lst]
        for s in subs:
            if s._queue:
                msg = s._queue.popleft()
                s.callback(msg)
                delivered += 1
        return delivered

    # -- internals ------------------------------------------------------------

    def _dispatch(self, topic: str, msg: Any) -> None:
        with self._lock:
            subs = list(self._subs.get(topic, []))
        for s in subs:
            if self.deliver == "direct":
                s.callback(msg)
            else:
                s._queue.append(msg)  # deque(maxlen) drops oldest = KEEP_LAST

    def _remove_subscription(self, sub: Subscription) -> None:
        with self._lock:
            if sub in self._subs.get(sub.topic, []):
                self._subs[sub.topic].remove(sub)

    def _remove_publisher(self, pub: Publisher) -> None:
        with self._lock:
            if pub in self._pubs.get(pub.topic, []):
                self._pubs[pub.topic].remove(pub)
