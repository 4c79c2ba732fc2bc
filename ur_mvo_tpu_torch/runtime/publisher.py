"""Asynchronous message publishing: the observability channel.

Own copy of ``ur_mvo_tpu.runtime.publisher``. Replaces the reference's
ROS2 publisher stack (``ros2_publisher.cc`` + the header-only
``ThreadPublisher<T>`` worker queues, ``thread_publisher.h:13-85``) with a
transport-free equivalent: five typed channels (feature image, debug
image, frame pose, keyframe set, map cloud), each drained by one worker
thread invoking registered callbacks off the critical path. Callbacks can
write debug PNGs (``utils/viz.py``), append to logs, or feed any external
visualizer.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np


@dataclass
class FeatureMessage:
    time: float = 0.0
    image: Optional[np.ndarray] = None
    kpts: Optional[np.ndarray] = None
    valid: Optional[np.ndarray] = None
    track_ids: Optional[np.ndarray] = None


@dataclass
class DebugMessage:
    time: float = 0.0
    image: Optional[np.ndarray] = None


@dataclass
class FramePoseMessage:
    time: float = 0.0
    pose: Optional[np.ndarray] = None  # 4x4 T_wc


@dataclass
class KeyframeMessage:
    ids: List[int] = field(default_factory=list)
    poses: List[np.ndarray] = field(default_factory=list)


@dataclass
class MapMessage:
    ids: Optional[np.ndarray] = None
    points: Optional[np.ndarray] = None


class ChannelPublisher:
    """One mutex+condvar queue with a dedicated drain thread
    (``ThreadPublisher<T>`` parity)."""

    def __init__(self, name: str, maxsize: int = 16):
        self.name = name
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._callbacks: List[Callable[[Any], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, cb: Callable[[Any], None]) -> None:
        self._callbacks.append(cb)
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True, name=f"pub-{self.name}")
            self._thread.start()

    def publish(self, msg: Any) -> None:
        if not self._callbacks:
            return  # channel disabled: zero overhead
        try:
            self._q.put_nowait(msg)
        except queue.Full:
            # drop-oldest backpressure: visualization must never stall VO
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            try:
                self._q.put_nowait(msg)
            except queue.Full:
                pass

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                msg = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            for cb in self._callbacks:
                try:
                    cb(msg)
                except Exception:
                    pass

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)


class Publisher:
    """The five reference channels (``ros2_publisher.h:73-77``)."""

    CHANNELS = ("feature", "debug", "frame_pose", "keyframe", "map")

    def __init__(self):
        self.channels: Dict[str, ChannelPublisher] = {c: ChannelPublisher(c) for c in self.CHANNELS}

    def register(self, channel: str, cb: Callable[[Any], None]) -> None:
        self.channels[channel].register(cb)

    def has_listeners(self, channel: str) -> bool:
        """Callers use this to skip MESSAGE CONSTRUCTION (not just the
        drop inside publish): the keyframe/map payloads copy the whole
        keyframe list + point cloud, ~ms per keyframe at scale — pure
        waste when nothing is subscribed."""
        return bool(self.channels[channel]._callbacks)

    def publish_feature(self, msg: FeatureMessage) -> None:
        self.channels["feature"].publish(msg)

    def publish_debug(self, msg: DebugMessage) -> None:
        self.channels["debug"].publish(msg)

    def publish_frame_pose(self, msg: FramePoseMessage) -> None:
        self.channels["frame_pose"].publish(msg)

    def publish_keyframe(self, msg: KeyframeMessage) -> None:
        self.channels["keyframe"].publish(msg)

    def publish_map(self, msg: MapMessage) -> None:
        self.channels["map"].publish(msg)

    def shutdown(self) -> None:
        for c in self.channels.values():
            c.shutdown()
