"""The oracle as a stand-in for the neural extractor on the chunk path.

``ChunkOracle`` extracts from an image (the frame's index in its first
pixel, ``BLANK`` a frame with no features), matches by slot identity on the
device without a host read (so the tracker takes the fused frame step and
the chunk path) and draws from its own generator on every match, as
F-RANSAC does, so that the chunk's sampler bookkeeping shows. Noise-free:
its banks do not depend on the order of the extractions.
"""

from __future__ import annotations

import numpy as np
import torch

from ur_mvo_tpu_torch import components as tcomp
from ur_mvo_tpu_torch import config as tconfig
from ur_mvo_tpu_torch.camera import make_pinhole
from ur_mvo_tpu_torch.engine import UR_MVO
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank
from ur_mvo_tpu_torch.runtime.extractor import OracleExtractor
from ur_mvo_tpu_torch.utils.synthscene import so3_exp

BLANK = 255
W = H = 256
FX = 100.0


class ChunkOracle(OracleExtractor):
    fused_track = True
    _buckets = None

    def __init__(self, points, camera, T_wc, capacity):
        super().__init__(points, camera, capacity=capacity, device="cpu")
        self.T_wc = T_wc
        self._gen = torch.Generator()
        self.reset_state()

    def reset_state(self) -> None:
        super().reset_state()
        self._gen.manual_seed(5)

    def extract(self, image, mask=None, right=False) -> FeatureBank:
        i = int(np.asarray(image).flat[0])
        if i == BLANK:
            K = self.capacity
            return FeatureBank(scores=torch.zeros(K), kpts=torch.zeros(K, 2), desc=torch.zeros(K, self.desc.shape[1]),
                               valid=torch.zeros(K, dtype=torch.bool))
        return self.extract_with_pose(self.T_wc[i], right=right)

    def match(self, bank0, bank1, outlier_rejection=True, floor=None):
        torch.randint(0, 1 << 20, (16,), generator=self._gen)
        return super().match(bank0, bank1, outlier_rejection, floor)


def trajectory(n: int, advance: float = 0.05) -> np.ndarray:
    T = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        T[i, :3, :3] = so3_exp(np.array([0.0, 0.02 * np.sin(0.3 * i), 0.0]))
        T[i, :3, 3] = [advance * i, 0.02 * np.sin(0.2 * i), 0.0]
    return T


def landmarks(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1.5, 2.5, n), rng.uniform(-1.0, 1.0, n), rng.uniform(5.0, 8.0, n)], 1).astype(np.float32)


def frame(i: int, stereo: bool = False) -> tcomp.Frame:
    img = tcomp.Image(np.full((2, 2), i, np.uint8), i / 30.0)
    return tcomp.Frame(image=img, right_image=tcomp.Image(img.get_image(), i / 30.0) if stereo else None)


def engine(n_frames: int, capacity: int, n_points: int, chunk: int = 0, setup=tconfig.SensorSetup.MONO, bf: float = 0.0,
           fx: float = FX):
    """A CPU engine on the oracle over the corridor scene; RGB-D frames take
    the depth of each slot's point (``depth_lookup``)."""
    cfg = tconfig.Configs()
    cfg.superpoint.capacity = capacity
    cfg.initializer.min_matches = 40
    cfg.initializer.min_features_first = 40
    cfg.keyframe.max_num_passed_frame = 3
    cfg.runtime.chunk_frames = chunk
    cam = make_pinhole(W, H, fx, fx, W / 2, H / 2, bf=bf)
    T_wc = trajectory(n_frames)
    X = landmarks(n_points)
    vo = UR_MVO(cfg, setup, camera=cam, extractor=ChunkOracle(X, cam, T_wc, capacity), device="cpu")
    if setup == tconfig.SensorSetup.RGBD:
        def depth_lookup(fr):
            T = T_wc[int(fr.image.get_image().flat[0])]
            z = np.zeros(capacity, np.float32)
            z[: len(X)] = ((X - T[:3, 3]) @ T[:3, :3])[:, 2]
            return lambda kpts, _z=z: _z

        vo._make_depth_lookup = depth_lookup
    return vo, T_wc
