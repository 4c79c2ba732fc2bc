"""Public engine API (port of ``ur_mvo_tpu.engine``, monocular slice).

``UR_MVO(config, setup, device=...)`` with ``process(Frame) ->
List[Pose] | None``, SLERP interpolation of the frames between keyframes,
``process_directory``, ``reset``, ``shutdown``. Poses come back
synchronously from the tracker. ``device`` defaults to ``cuda`` and raises
without it; the tests pass ``device="cpu"``.

Not ported yet (raising): stereo and RGB-D setups, map snapshots, the
chunked sequence program (``process_sequence`` feeds ``process`` frame by
frame).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from ur_mvo_tpu_torch.camera import Camera, make_pinhole
from ur_mvo_tpu_torch.components import Frame, Image, Pose, Setup, interpolate
from ur_mvo_tpu_torch.config import Configs
from ur_mvo_tpu_torch.device import DeviceLike, resolve_device
from ur_mvo_tpu_torch.ops.lie import rotmat_to_quat
from ur_mvo_tpu_torch.runtime.extractor import NeuralExtractor
from ur_mvo_tpu_torch.runtime.frontend import Tracker
from ur_mvo_tpu_torch.utils.tum_io import write_tum


def _load_image(path: str) -> np.ndarray:
    """Grayscale image load without OpenCV (PGM/PNG via PIL if present,
    else raw npy)."""
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image as PILImage

        return np.asarray(PILImage.open(path).convert("L"))
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(f"cannot load {path}: PIL unavailable") from e


class UR_MVO:
    """Drop-in equivalent of the reference's ``UR_MVO`` engine class.

    ``kernels=False`` runs every kernel's plain version on ``device`` (the
    on-card comparison asks for it; the main path never does)."""

    def __init__(
        self,
        config: Union[dict, Configs, str, None] = None,
        setup: Setup = Setup.MONO,
        camera: Optional[Camera] = None,
        extractor=None,
        device: DeviceLike = None,
        kernels: bool = True,
    ):
        self.device = resolve_device(device)
        self._kernels = kernels
        self._build(config, setup, camera, extractor)

    def _build(self, config, setup, camera=None, extractor=None):
        if setup != Setup.MONO:
            raise NotImplementedError(f"UR_MVO(setup={setup}): only the monocular setup is ported yet")
        if isinstance(config, Configs):
            cfg = config
        elif isinstance(config, str):
            cfg = Configs.from_yaml(config, setup)
        elif isinstance(config, dict):
            cfg = Configs.from_dict(config, setup)
        else:
            cfg = Configs(sensor_setup=setup)
        cfg.sensor_setup = setup
        self.config = cfg
        self.setup = setup

        if camera is not None:
            self.camera = camera
        elif cfg.camera_config_path:
            self.camera = Camera.from_yaml(cfg.camera_config_path)
        else:
            self.camera = make_pinhole(
                cfg.superglue.image_width, cfg.superglue.image_height,
                400.0, 400.0, cfg.superglue.image_width / 2, cfg.superglue.image_height / 2,
            )
        # keep the matcher's keypoint-normalization dimensions in sync
        # with the actual camera
        cfg.superglue.image_width = self.camera.width
        cfg.superglue.image_height = self.camera.height
        self._injected_camera = camera
        self._injected_extractor = extractor
        self.extractor = extractor or NeuralExtractor(cfg, self.camera, device=self.device, kernels=self._kernels)
        self.tracker = Tracker(cfg, self.camera, self.extractor, device=self.device, kernels=self._kernels)

        self.last_pose: Optional[Pose] = None
        self.accumulated_samples = 0
        self._trajectory: List[tuple] = []  # (timestamp, Pose)
        # (frame, bank) of a frame whose extraction was queued ahead of
        # time — see process(next_data=...)
        self._prefetched: Optional[tuple] = None

    # ------------------------------------------------------------------

    def _extract_banks(self, data: Frame):
        """Queue the extraction of one frame on the device WITHOUT
        synchronizing: CUDA work is asynchronous, so the host returns while
        the device computes, which is what lets frame-ahead prefetching
        (process(next_data=...)) overlap device inference with host
        bookkeeping."""
        if hasattr(self.extractor, "extract_with_pose") and "T_wc" in data.meta:
            return self.extractor.extract_with_pose(data.meta["T_wc"])
        mask = data.mask.get_mask() if data.mask is not None else None
        return self.extractor.extract(data.image.get_image(), mask)

    def process(self, data: Frame, next_data: Optional[Frame] = None) -> Optional[List[Pose]]:
        """Feed one frame; returns interpolated poses when the backend
        produced a keyframe pose, else None (reference semantics).

        ``next_data``: optional lookahead frame — its extraction is queued
        on the device *before* this frame's tracking/host bookkeeping
        runs, so frame i+1's inference overlaps frame i's host work. The
        next ``process`` call picks the prefetched bank up by the Frame
        object's identity."""
        if data.right_image is not None or data.depth_map is not None:
            raise NotImplementedError("UR_MVO.process: stereo and RGB-D frames are not ported yet")
        ts = data.image.get_timestamp()
        if self._prefetched is not None and self._prefetched[0] is data:
            bank = self._prefetched[1]
        else:
            bank = self._extract_banks(data)
        self._prefetched = None
        if next_data is not None:
            self._prefetched = (next_data, self._extract_banks(next_data))

        pose_mat = self.tracker.process(bank, ts)
        return self._emit(ts, pose_mat)

    def _emit(self, ts, pose_mat) -> Optional[List[Pose]]:
        """Keyframe-pose emission + SLERP fill of the frames in between."""
        if pose_mat is None:
            self.accumulated_samples += 1
            return None
        current = Pose(pose_mat[:3, :3], pose_mat[:3, 3], np.eye(6))
        self._trajectory.append((ts, current))
        if self.last_pose is None:
            self.last_pose = current
            self.accumulated_samples = 0
            return [current]
        res = interpolate(self.last_pose, current, self.accumulated_samples)
        self.accumulated_samples = 0
        self.last_pose = current
        return res

    def process_sequence(self, frames: List[Frame]) -> List[Optional[List[Pose]]]:
        """Whole sequence: per-frame ``process`` with the next frame
        prefetched (the multi-frame chunk program is not ported yet, so
        ``runtime.chunk_frames`` has no effect)."""
        return [
            self.process(f, next_data=frames[i + 1] if i + 1 < len(frames) else None)
            for i, f in enumerate(frames)
        ]

    def process_directory(self, directory: str) -> List[Pose]:
        """EuRoC-style layout: ``cam0/data/*.png``, 19-digit ns timestamps
        in filenames."""
        directory = Path(directory)
        data_dir = directory / "cam0" / "data"
        if not data_dir.is_dir():
            raise FileNotFoundError(f"{data_dir} missing")
        poses: List[Pose] = []

        def load(name):
            stem = name.split(".")[0]
            try:
                ts = int(stem) * 1e-9 if len(stem) >= 16 else float(stem)
            except ValueError:
                ts = None
            img = _load_image(str(data_dir / name))
            return Frame(image=Image(img, ts))

        names = sorted(os.listdir(data_dir))
        nxt = load(names[0]) if names else None
        for i in range(len(names)):
            cur, nxt = nxt, (load(names[i + 1]) if i + 1 < len(names) else None)
            out = self.process(cur, next_data=nxt)
            if out is not None:
                poses.extend(out)
        return poses

    # ------------------------------------------------------------------

    def keyframe_trajectory(self):
        """(timestamps, positions (N,3), quaternions (N,4) wxyz) of all
        keyframes after optimization."""
        self.tracker.backend.flush_pending_ba()
        ts, R, t = self.tracker.backend.store.trajectory()
        quats = rotmat_to_quat(torch.from_numpy(np.asarray(R, np.float32))).numpy()
        return ts, t.astype(np.float64), quats

    def save_trajectory(self, path: str) -> None:
        ts, t, q = self.keyframe_trajectory()
        write_tum(path, list(ts), t, q)

    def reset(self, config=None, setup: Optional[Setup] = None) -> None:
        """Fresh map/trajectory. Injected camera/extractor survive the
        reset. With unchanged config/setup this is a STATE reset (the
        loaded networks and built kernels are kept)."""
        if config is None and (setup is None or setup == self.setup):
            self.tracker.reset_state()
            self.last_pose = None
            self.accumulated_samples = 0
            self._trajectory = []
            self._prefetched = None
            return
        self._build(
            config if config is not None else self.config,
            setup if setup is not None else self.setup,
            camera=self._injected_camera,
            extractor=self._injected_extractor,
        )

    def shutdown(self) -> None:
        self.tracker.backend.flush_pending_ba()
        self.tracker.publisher.shutdown()
