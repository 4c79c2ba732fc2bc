"""Public engine API (port of ``ur_mvo_tpu.engine``).

``UR_MVO(config, setup, device=...)`` for the monocular, stereo and RGB-D
setups, with ``process(Frame) ->
List[Pose] | None``, SLERP interpolation of the frames between keyframes,
``process_directory``, ``reset``, ``shutdown``, and the map API:
``save_map_snapshot``, ``load_map_snapshot`` (localization mode against a
saved map) and ``save_map_ply``. Poses come back synchronously from the
tracker. ``device`` defaults to ``cuda`` and raises without it; the tests
pass ``device="cpu"``. ``process_sequence`` drives a whole sequence, in
blocks of ``runtime.chunk_frames`` frames through ``Tracker.process_chunk``
where that is set (one readback a block), else frame by frame.
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
from ur_mvo_tpu_torch.runtime.map_store import MapStore
from ur_mvo_tpu_torch.utils.tum_io import write_tum
from ur_mvo_tpu_torch.utils.viz import save_map_ply


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
        # (frame, bank, bank_right) of a frame whose extraction was queued
        # ahead of time — see process(next_data=...)
        self._prefetched: Optional[tuple] = None

    # ------------------------------------------------------------------

    def _extract_banks(self, data: Frame):
        """Queue the extraction of one frame on the device WITHOUT
        synchronizing: CUDA work is asynchronous, so the host returns while
        the device computes, which is what lets frame-ahead prefetching
        (process(next_data=...)) overlap device inference with host
        bookkeeping. Returns (bank, bank_right); the right bank exists for
        stereo frames only, rectified with the right camera's map."""
        stereo = self.setup == Setup.STEREO
        if hasattr(self.extractor, "extract_with_pose") and "T_wc" in data.meta:
            bank = self.extractor.extract_with_pose(data.meta["T_wc"])
            bank_right = self.extractor.extract_with_pose(data.meta["T_wc"], right=True) if stereo else None
            return bank, bank_right
        mask = data.mask.get_mask() if data.mask is not None else None
        bank = self.extractor.extract(data.image.get_image(), mask)
        bank_right = None
        if stereo and data.right_image is not None:
            bank_right = self.extractor.extract(data.right_image.get_image(), mask, right=True)
        return bank, bank_right

    def process(self, data: Frame, next_data: Optional[Frame] = None) -> Optional[List[Pose]]:
        """Feed one frame; returns interpolated poses when the backend
        produced a keyframe pose, else None (reference semantics).

        ``next_data``: optional lookahead frame — its extraction is queued
        on the device *before* this frame's tracking/host bookkeeping
        runs, so frame i+1's inference overlaps frame i's host work. The
        next ``process`` call picks the prefetched banks up by the Frame
        object's identity."""
        ts = data.image.get_timestamp()
        depth_lookup = self._make_depth_lookup(data)
        if self._prefetched is not None and self._prefetched[0] is data:
            bank, bank_right = self._prefetched[1:]
        else:
            bank, bank_right = self._extract_banks(data)
        self._prefetched = None
        if next_data is not None:
            self._prefetched = (next_data, *self._extract_banks(next_data))

        pose_mat = self.tracker.process(bank, ts, depth_lookup, bank_right=bank_right)
        return self._emit(ts, pose_mat)

    def _make_depth_lookup(self, data: Frame):
        """RGB-D: keypoints (K, 2) -> depth (K,) read at their pixels. A
        uint8 depth image maps a pixel p in [50, 200] to 100 / p (0 outside
        it); a metric depth image passes through."""
        if self.setup != Setup.RGBD or data.depth_map is None:
            return None
        depth_img = data.depth_map.get_depth_map()

        def depth_lookup(kpts, _d=depth_img):
            c = np.clip(kpts[:, 0].astype(int), 0, _d.shape[1] - 1)
            r = np.clip(kpts[:, 1].astype(int), 0, _d.shape[0] - 1)
            raw = _d[r, c].astype(np.float32)
            if _d.dtype == np.uint8:
                ok = (raw >= 50) & (raw <= 200)
                return np.where(ok, 100.0 / (raw + 1e-5), 0.0)
            return raw

        return depth_lookup

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
        """Whole sequence. With ``runtime.chunk_frames = C > 1`` and an
        initialized neural tracker, blocks of C frames (the last padded
        with its last frame) go through :meth:`Tracker.process_chunk`: their
        device work queued at once, ONE readback a block, the host replaying
        up to the first keyframe or weak row; the stereo chunk extracts the
        right images and gates the disparities in each row, the RGB-D rows
        take their own depth lookups. Initialization, masks, a missing right
        image and weak-tracking recoveries take the per-frame path, with the
        next frame prefetched where it takes it too; after a weak row the
        next two frames go per-frame (the weak frame itself, retried on the
        bank the chunk handed back, and one more). Per-frame return values
        match :meth:`process`."""
        C = int(self.config.runtime.chunk_frames or 0)
        outs: List[Optional[List[Pose]]] = [None] * len(frames)
        stereo = self.setup == Setup.STEREO
        i = 0
        pending_bank = None  # the weak row's bank handed back by the chunk
        pf_count = 0  # frames forced per-frame after a weak row
        while i < len(frames):
            f = frames[i]
            n = min(C, len(frames) - i) if C > 1 else 0
            batch = frames[i : i + n]
            chunkable = (
                n > 1
                and pending_bank is None
                and pf_count == 0
                and self.tracker.chunk_available(stereo)
                and all(fr.mask is None for fr in batch)
                and (not stereo or all(fr.right_image is not None for fr in batch))
            )
            if pf_count > 0:
                pf_count -= 1
            if not chunkable:
                ts = f.image.get_timestamp()
                if pending_bank is not None:
                    # the chunk already extracted this frame's features
                    outs[i] = self._emit(ts, self.tracker.process(pending_bank, ts, self._make_depth_lookup(f)))
                    pending_bank = None
                else:
                    # prefetch the next frame where it takes this path too
                    nxt = None
                    if i + 1 < len(frames):
                        nf = frames[i + 1]
                        if C <= 1 or nf.mask is not None or not self.tracker.chunk_available(stereo):
                            nxt = nf
                    outs[i] = self.process(f, next_data=nxt)
                i += 1
                continue
            imgs = np.stack([fr.image.get_image() for fr in batch])
            imgs_r = np.stack([fr.right_image.get_image() for fr in batch]) if stereo else None
            if n < C:  # pad to C frames, as every block is
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], C - n, axis=0)])
                if imgs_r is not None:
                    imgs_r = np.concatenate([imgs_r, np.repeat(imgs_r[-1:], C - n, axis=0)])
            ts_list = [fr.image.get_timestamp() for fr in batch]
            dls = [self._make_depth_lookup(fr) for fr in batch] if self.setup == Setup.RGBD else None
            results, consumed, weak_bank = self.tracker.process_chunk(
                imgs, ts_list, depth_lookups=dls, n_valid=n, images_right=imgs_r)
            for j, pose_mat in enumerate(results):
                outs[i + j] = self._emit(ts_list[j], pose_mat)
            i += consumed
            if weak_bank is not None:
                # the frame after a weak row is likely weak too: it goes
                # per-frame as well (2 = the weak frame itself + one more)
                pf_count = 2
                if stereo:
                    # the retry needs the right bank too (a promoted keyframe
                    # keeps its stereo seeds): it re-extracts both
                    weak_bank = None
            pending_bank = weak_bank
        return outs

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

    def save_map_snapshot(self, path: str) -> None:
        """Persist the whole map (keyframes, map points, observer matrix,
        covisibility, descriptor banks, loop edges) as npz, for resume or
        localization against it; the JAX package reads it too."""
        self.tracker.backend.flush_pending_ba()
        self.tracker.backend.store.save_snapshot(path)

    def load_map_snapshot(self, path: str) -> None:
        """Load a saved map and enter localization mode: the tracker starts
        initialized against it (newest keyframe as reference, relocalization
        force-enabled and pre-armed), so the next frames either resume
        tracking or re-anchor anywhere in the map (``Tracker.adopt_map``)."""
        backend = self.tracker.backend
        backend.flush_pending_ba()
        backend.store = MapStore.load_snapshot(path, backend.store.cfg)
        self.config.backend.relocalization = True
        self.tracker.adopt_map()
        self.last_pose = None
        self.accumulated_samples = 0
        self._trajectory = []

    def save_map_ply(self, path: str) -> None:
        """Write the triangulated map cloud (good, not culled points) as PLY."""
        self.tracker.backend.flush_pending_ba()
        st = self.tracker.backend.store
        save_map_ply(path, st.mp_pos[st.mp_good & ~st.mp_bad])

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
