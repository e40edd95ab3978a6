"""Transform graph: tf2-shaped lookup without ROS.

Capability parity with the reference's TF2 plumbing (reference:
pointcloud_preprocessor.py:302-307 buffer/listener setup, :704-760 lookup +
quaternion->matrix conversion, with three typed exceptions at :720-728).
Transforms arrive from the host side (a ROS adapter, a dataset loader, or
tests); lookups compose along the frame tree and return planar-friendly
4x4 float32 matrices built by ops/linalg.se3_matrix.

A copy of the reference package's ``runtime/tf.py`` (the port does not
import the reference); ``transform_to_matrix`` calls the port's
``se3_matrix``. The graph lives on the host: the engine copies the matrix
it is given to its device.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.msg import TransformStamped
from ..ops.linalg import se3_matrix

__all__ = [
    "LookupException",
    "ConnectivityException",
    "ExtrapolationException",
    "TransformBuffer",
    "transform_to_matrix",
]


class LookupException(Exception):
    """Frame not known (tf2_ros.LookupException analog)."""


class ConnectivityException(Exception):
    """Frames exist but are not connected (tf2_ros analog)."""


class ExtrapolationException(Exception):
    """Requested time outside the buffered range (tf2_ros analog)."""


def transform_to_matrix(transform: TransformStamped) -> np.ndarray:
    """TransformStamped -> homogeneous 4x4 float32.

    Parity with reference ``transform_to_matrix``
    (pointcloud_preprocessor.py:734-760), built on the scalar-last
    quaternion convention.
    """
    return se3_matrix(
        tuple(transform.translation), tuple(transform.rotation_xyzw)
    ).numpy()


@dataclasses.dataclass
class _Edge:
    matrix: np.ndarray  # parent_from_child
    stamp: float


class TransformBuffer:
    """Minimal tf2 buffer: a tree of parent->child edges with timestamps.

    ``cache_time`` bounds how stale an edge may be relative to a stamped
    lookup before ExtrapolationException is raised (0 disables the check —
    matching static-transform usage).
    """

    def __init__(self, cache_time: float = 0.0):
        self._edges: Dict[Tuple[str, str], _Edge] = {}
        self._parent: Dict[str, str] = {}
        self.cache_time = cache_time

    def set_transform(
        self,
        parent_frame: str,
        child_frame: str,
        matrix: Optional[np.ndarray] = None,
        transform: Optional[TransformStamped] = None,
        stamp: Optional[float] = None,
    ) -> None:
        """Insert/update the parent<-child edge (TransformBroadcaster analog)."""
        if matrix is None:
            if transform is None:
                raise ValueError("need matrix or transform")
            matrix = transform_to_matrix(transform)
        if stamp is None:
            stamp = _time.time()
        self._edges[(parent_frame, child_frame)] = _Edge(
            np.asarray(matrix, np.float32), float(stamp)
        )
        self._parent[child_frame] = parent_frame

    def _chain_to_root(self, frame: str):
        chain = [frame]
        while chain[-1] in self._parent:
            chain.append(self._parent[chain[-1]])
        return chain

    def lookup_transform(
        self,
        target_frame: str,
        source_frame: str,
        stamp: Optional[float] = None,
        timeout: float = 0.0,
    ) -> np.ndarray:
        """target_from_source homogeneous 4x4 (tf_buffer.lookup_transform
        analog, reference :714-719). ``timeout`` is accepted for API parity;
        with a host-fed buffer there is nothing to wait on."""
        del timeout
        known = set(self._parent) | set(p for p, _ in self._edges)
        if target_frame not in known or source_frame not in known:
            missing = source_frame if source_frame not in known else target_frame
            raise LookupException(f"frame {missing!r} does not exist")
        if target_frame == source_frame:
            return np.eye(4, dtype=np.float32)

        up = self._chain_to_root(source_frame)
        down = self._chain_to_root(target_frame)
        common = None
        down_set = set(down)
        for f in up:
            if f in down_set:
                common = f
                break
        if common is None:
            raise ConnectivityException(
                f"no connection between {target_frame!r} and {source_frame!r}"
            )

        def accumulate(frame, ancestor):
            m = np.eye(4, dtype=np.float32)
            while frame != ancestor:
                parent = self._parent[frame]
                edge = self._edges[(parent, frame)]
                self._check_stamp(edge, stamp)
                m = edge.matrix @ m
                frame = parent
            return m

        ancestor_from_source = accumulate(source_frame, common)
        ancestor_from_target = accumulate(target_frame, common)
        return np.linalg.inv(ancestor_from_target) @ ancestor_from_source

    def _check_stamp(self, edge: _Edge, stamp: Optional[float]) -> None:
        if stamp is None or self.cache_time <= 0:
            return
        if abs(stamp - edge.stamp) > self.cache_time:
            raise ExtrapolationException(
                f"transform at {edge.stamp:.3f} too far from requested {stamp:.3f}"
            )
