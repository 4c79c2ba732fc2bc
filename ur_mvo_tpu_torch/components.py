"""Public data classes (own copy of ``ur_mvo_tpu.components``), API parity
with the reference's Python surface: ``Setup``, ``Image``, ``Mask``,
``DepthMap``, ``Frame`` (auto ids), ``Pose`` (rotation/translation/
covariance with quaternion and 4x4 accessors). Implemented on numpy —
the API layer holds no tensors (arrays convert on demand).
"""

from __future__ import annotations

import itertools
import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from ur_mvo_tpu_torch.config import SensorSetup

# Alias matching the reference's public name.
Setup = SensorSetup

_frame_ids = itertools.count()


class Image:
    """Grayscale image + timestamp (``components.py:16-60``)."""

    def __init__(self, image: np.ndarray, timestamp: Optional[float] = None):
        self._image = image
        self._timestamp = _time.time() if timestamp is None else timestamp

    def get_image(self) -> np.ndarray:
        return self._image

    def set_image(self, image: np.ndarray) -> None:
        self._image = image

    def get_timestamp(self) -> float:
        return self._timestamp

    def set_timestamp(self, timestamp: float) -> None:
        self._timestamp = timestamp


class Mask:
    """Semantic mask; nonzero pixels keep features."""

    def __init__(self, mask: np.ndarray):
        self._mask = mask

    def get_mask(self) -> np.ndarray:
        return self._mask


class DepthMap:
    """Depth image for the RGB-D path."""

    def __init__(self, depth_map: np.ndarray):
        self._depth_map = depth_map

    def get_depth_map(self) -> np.ndarray:
        return self._depth_map


@dataclass
class Frame:
    """One input frame (``components.py:202-279``); ids auto-assigned."""

    image: Image
    right_image: Optional[Image] = None
    depth_map: Optional[DepthMap] = None
    mask: Optional[Mask] = None
    id: int = field(default_factory=lambda: next(_frame_ids))
    # Extra per-frame metadata (used e.g. by the oracle extractor in tests).
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def timestamp(self) -> float:
        return self.image.get_timestamp()


class Pose:
    """Rigid pose: rotation (3,3) + translation (3,) + covariance (6,6)
    (``components.py:285-351``)."""

    def __init__(
        self,
        rotation: np.ndarray,
        translation: np.ndarray,
        covariance: Optional[np.ndarray] = None,
    ):
        self.rotation = np.asarray(rotation, dtype=np.float64).reshape(3, 3)
        self.translation = np.asarray(translation, dtype=np.float64).reshape(3)
        self.covariance = (
            np.eye(6) if covariance is None else np.asarray(covariance, dtype=np.float64)
        )

    @property
    def quaternion(self) -> np.ndarray:
        """Unit quaternion (w, x, y, z). Host numpy on purpose: a 3x3
        conversion on the device would cost a launch and a readback per
        emitted pose."""
        R = self.rotation
        K = np.array([
            1.0 + R[0, 0] + R[1, 1] + R[2, 2],
            1.0 + R[0, 0] - R[1, 1] - R[2, 2],
            1.0 - R[0, 0] + R[1, 1] - R[2, 2],
            1.0 - R[0, 0] - R[1, 1] + R[2, 2],
        ])
        i = int(np.argmax(K))
        s = np.sqrt(max(K[i], 1e-12)) * 0.5
        d = 4.0 * s
        if i == 0:
            q = [s, (R[2, 1] - R[1, 2]) / d, (R[0, 2] - R[2, 0]) / d, (R[1, 0] - R[0, 1]) / d]
        elif i == 1:
            q = [(R[2, 1] - R[1, 2]) / d, s, (R[0, 1] + R[1, 0]) / d, (R[0, 2] + R[2, 0]) / d]
        elif i == 2:
            q = [(R[0, 2] - R[2, 0]) / d, (R[0, 1] + R[1, 0]) / d, s, (R[1, 2] + R[2, 1]) / d]
        else:
            q = [(R[1, 0] - R[0, 1]) / d, (R[0, 2] + R[2, 0]) / d, (R[1, 2] + R[2, 1]) / d, s]
        q = np.asarray(q, dtype=np.float64)
        return q / np.linalg.norm(q)

    @property
    def orientation(self) -> "Pose._Quat":
        q = self.quaternion
        return Pose._Quat(*q)

    class _Quat:
        """Tiny (w, x, y, z) accessor mirroring pyquaternion's attributes."""

        def __init__(self, w, x, y, z):
            self.w, self.x, self.y, self.z = float(w), float(x), float(y), float(z)

    def matrix(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.rotation
        T[:3, 3] = self.translation
        return T

    @classmethod
    def from_matrix(cls, T: np.ndarray) -> "Pose":
        T = np.asarray(T)
        return cls(T[:3, :3], T[:3, 3])

    def __repr__(self) -> str:
        return f"Pose(t={self.translation.round(4).tolist()})"


def _quat_to_rotmat_np(q: np.ndarray) -> np.ndarray:
    """Host-numpy (w, x, y, z) -> 3x3 (see Pose.quaternion for why)."""
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def slerp(q0: np.ndarray, q1: np.ndarray, alpha: float) -> np.ndarray:
    """Spherical interpolation of (w, x, y, z) quaternions."""
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -q1
        d = -d
    if d > 0.9995:
        q = q0 + alpha * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    return (np.sin((1 - alpha) * theta) * q0 + np.sin(alpha * theta) * q1) / np.sin(theta)


def interpolate(p1: Pose, p2: Pose, samples: int = 1) -> list:
    """SLERP/linear pose interpolation filling dropped frames
    (``engine.py:22-40``): samples+1 poses, one per frame since the last
    emission, ENDING AT ``p2``.

    Deliberate divergence: the reference uses alphas i/(samples+1) —
    its first returned pose duplicates the PREVIOUS keyframe pose and
    the last never reaches the current one, lagging every pose by one
    inter-frame step (tolerable under its async 30 ms sleep+poll loop,
    ``main_py.cpp:52``; a measured ~0.1-0.2 m ATE floor for our
    synchronous engine). Here alphas are (i+1)/(samples+1) so the pose
    of frame k is the interpolant AT frame k."""
    q1 = p1.quaternion
    q2 = p2.quaternion
    out = []
    for i in range(samples + 1):
        a = (1.0 / (samples + 1.0)) * (i + 1)
        q = slerp(q1, q2, a)
        t = p1.translation + (p2.translation - p1.translation) * a
        out.append(Pose(_quat_to_rotmat_np(q), t))
    return out
