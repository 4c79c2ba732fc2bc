"""Feature extraction + matching front end (port of
``ur_mvo_tpu.runtime.extractor.NeuralExtractor``).

``extract``: rectify remap -> SuperPoint (fused stage kernels, stage 4,
heads, NMS) -> top-K keypoint selection -> descriptor sampling.
``extract(right=True)`` rectifies with the right camera's map when the
calibration ships one (else the left map). ``match``: SuperGlue (attention
kernel in every GNN layer, Sinkhorn kernel) -> mutual decode, with the
mutual-NN min-match floor; or ``hybrid``, mutual-NN with SuperGlue's
matches taken when NN starves -> 8-point fundamental RANSAC outlier
rejection. Both stay on the device: no host sync inside either call.

Options of ``superpoint``: ``subpixel`` refines each keypoint by a
quadratic fit over the pre-NMS scores; ``descriptor_source="patch"``
replaces the network's descriptors by normalized 16x16 intensity patches
of the rectified image; ``resolution_buckets`` edge-pads each input to the
smallest bucket that fits and masks the pad out of keypoint selection.

``OracleExtractor`` is the test double: given a synthetic scene (world
points + ground-truth camera poses) it produces exact projections with
configurable noise and identity descriptors, so the whole VO runtime can
be driven without trained weights.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ur_mvo_tpu_torch.camera import Camera, remap_bilinear
from ur_mvo_tpu_torch.config import Configs
from ur_mvo_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from ur_mvo_tpu_torch.models import superglue, superpoint
from ur_mvo_tpu_torch.models.superglue import SuperGlue
from ur_mvo_tpu_torch.models.superpoint import SuperPoint
from ur_mvo_tpu_torch.ops.gridsample import patch_descriptors
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank, select_keypoints
from ur_mvo_tpu_torch.ops.matching import (
    Matches,
    decode_assignment,
    filter_matches,
    gather_match_points,
    select_matches,
)
from ur_mvo_tpu_torch.ops.nn_matcher import match_nn
from ur_mvo_tpu_torch.ops.ransac import ransac_fundamental


class NeuralExtractor:
    """SuperPoint + SuperGlue front end on one device.

    ``device`` defaults to ``cuda`` (raises without CUDA); the tests pass
    ``device="cpu"``, which runs every kernel's plain version. Weights
    start from ``cfg.runtime.seed`` when no checkpoint is configured; the
    RANSAC sampler's generator is seeded from ``cfg.runtime.seed + 1``.
    ``kernels=False`` runs the kernels' plain versions on any device: the
    on-card comparison asks for it explicitly; the main path never does."""

    # ``match`` queues device work without a host sync, so the tracker can
    # fuse it with the track step into one readback a frame
    fused_track = True

    def __init__(self, cfg: Configs, camera: Camera, device: DeviceLike = None, kernels: bool = True):
        self.cfg = cfg
        self.camera = camera
        self.device = dev = resolve_device(device)
        sp_cfg, sg_cfg = cfg.superpoint, cfg.superglue
        # resolution buckets, smallest first; each (bucket, side) gets its
        # rectify map at first use (_bucket_rect)
        self._buckets = None
        if sp_cfg.resolution_buckets:
            self._buckets = sorted((int(h), int(w)) for h, w in sp_cfg.resolution_buckets)
            ragged = [b for b in self._buckets if b[0] % 8 or b[1] % 8]
            if ragged:
                # the encoder's three 2x2 pools and the stage kernel need
                # every bucket side a multiple of 8
                raise ValueError(f"resolution_buckets: {ragged} not multiples of 8 in both sides")
        self._bucket_progs: dict = {}
        dt = compute_dtype(cfg.runtime.compute_dtype)
        init_gen = torch.Generator().manual_seed(cfg.runtime.seed)

        sp = SuperPoint(kernels=kernels)
        if sp_cfg.weights_path:
            sp.load_state_dict(superpoint.load_torch_weights(sp_cfg.weights_path))
        else:
            sp.init_random(init_gen)
        self.superpoint = sp.to(device=dev, dtype=dt).eval().requires_grad_(False)

        self.num_heads = sg_cfg.num_heads
        if sg_cfg.weights_path:
            sg = SuperGlue.from_state_dict(
                superglue.load_weights(sg_cfg.weights_path, sg_cfg.num_layers, sg_cfg.num_heads), kernels=kernels
            )
            # a native checkpoint's embedded architecture wins over the config
            meta = superglue.checkpoint_meta(sg_cfg.weights_path)
            if meta is not None:
                self.num_heads = meta[1]
        else:
            sg = SuperGlue(sg_cfg.num_layers, kernels=kernels).init_random(init_gen)
        self.superglue = sg.to(device=dev, dtype=dt).eval().requires_grad_(False)

        # "auto": a randomly initialized SuperGlue cannot match, so
        # without trained matcher weights use mutual-NN
        self._matcher = sg_cfg.matcher
        if self._matcher == "auto":
            self._matcher = "superglue" if sg_cfg.weights_path else "nn"
        if self._matcher == "hybrid" and not sg_cfg.weights_path:
            self._matcher = "nn"
        if self._matcher not in ("superglue", "nn", "hybrid"):
            raise NotImplementedError(f"matcher {self._matcher!r} is not ported yet")

        self._rect = (
            torch.as_tensor(camera.undistort_map, device=dev) if camera.undistort_map is not None else None
        )
        # the right camera's own rectify map where the calibration has one
        self._rect_right = (
            torch.as_tensor(camera.undistort_map_right, device=dev)
            if camera.undistort_map_right is not None
            else self._rect
        )
        # keypoints normalise by the image the camera delivers (the engine
        # sets SuperGlueConfig.image_width/height to the camera's)
        self.width, self.height = camera.width, camera.height
        self.match_threshold = superglue.resolve_matching_threshold(sg_cfg)
        self._gen = torch.Generator(device=dev)
        self.reset_state()

    def reset_state(self) -> None:
        """Re-seed the match-RANSAC generator so an engine reset reproduces
        a fresh run."""
        self._gen.manual_seed(self.cfg.runtime.seed + 1)

    @torch.no_grad()
    def extract(self, image: np.ndarray, mask: Optional[np.ndarray] = None, right: bool = False) -> FeatureBank:
        """(H, W) uint8 image (numpy or tensor) -> :class:`FeatureBank` on
        the device. ``mask`` nonzero keeps a pixel (replaces border removal).
        ``right`` rectifies with the right camera's map. With resolution
        buckets the image goes through :meth:`_extract_bucketed`."""
        if self._buckets is not None:
            return self._extract_bucketed(image, mask, right)
        return self._extract_impl(
            torch.as_tensor(image, device=self.device),
            None if mask is None else torch.as_tensor(mask, device=self.device),
            self._rect_right if right else self._rect,
        )

    def _extract_impl(self, image: torch.Tensor, mask: Optional[torch.Tensor], rect: Optional[torch.Tensor]):
        """Rectify, SuperPoint, keypoint selection (sub-pixel when asked) and
        the descriptors (the network's, or patches of the rectified image)."""
        sp_cfg = self.cfg.superpoint
        img = image.to(torch.float32) / 255.0
        if rect is not None:
            img = remap_bilinear(img, rect)
        out = self.superpoint(img[None, :, :, None], nms_radius=sp_cfg.nms_radius,
                              return_raw_scores=sp_cfg.subpixel)
        bank = select_keypoints(
            out[0][0],
            out[1][0],
            capacity=sp_cfg.capacity,
            threshold=sp_cfg.keypoint_threshold,
            border=sp_cfg.remove_borders,
            max_keypoints=sp_cfg.max_keypoints,
            mask=mask,
            raw_scores=out[2][0] if sp_cfg.subpixel else None,
        )
        if sp_cfg.descriptor_source == "patch":
            bank = bank._replace(desc=patch_descriptors(img, bank.kpts))
        return bank

    def _bucket_rect(self, bh: int, bw: int, right: bool) -> Optional[torch.Tensor]:
        """The rectify map of one (bucket, side), built once: the calibrated
        map over its top-left crop (bucketed inputs are top-left crops of
        the calibrated sensor, so absolute source coordinates stay valid)
        and identity (x, y) source coordinates over the pad."""
        key = (bh, bw, right)
        if key not in self._bucket_progs:
            cam = self.camera
            base = cam.undistort_map_right if right and cam.undistort_map_right is not None else cam.undistort_map
            rect = None
            if base is not None:
                m = np.asarray(base)
                H0, W0 = m.shape[:2]
                mp = np.stack(np.meshgrid(np.arange(bw, dtype=np.float32), np.arange(bh, dtype=np.float32)), -1)
                mp[: min(H0, bh), : min(W0, bw)] = m[:bh, :bw]
                rect = torch.as_tensor(mp, device=self.device)
            self._bucket_progs[key] = rect
        return self._bucket_progs[key]

    def _extract_bucketed(self, image, mask, right: bool) -> FeatureBank:
        """Pad-to-bucket path: edge-pad bottom/right to the smallest-area
        bucket that fits, mask the pad (plus the true bottom/right border
        margin, which reproduces border removal at the TRUE edges) out of
        keypoint selection. The mask replaces border removal; keypoint
        coordinates are unchanged by the padding."""
        image = image.cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image)
        h, w = image.shape[:2]
        fits = [(bh * bw, bh, bw) for bh, bw in self._buckets if bh >= h and bw >= w]
        if not fits:
            raise ValueError(f"input {h}x{w} exceeds every resolution bucket {self._buckets}")
        _, bh, bw = min(fits)
        img = np.pad(image, ((0, bh - h), (0, bw - w)), mode="edge") if (h, w) != (bh, bw) else image
        b = self.cfg.superpoint.remove_borders
        m = np.ones((bh, bw), np.uint8)
        if mask is not None:
            mask = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
            m[:h, :w] = (mask != 0)[:h, :w]
        if h < bh:
            m[max(h - b, 0):, :] = 0
        if w < bw:
            m[:, max(w - b, 0):] = 0
        dev = self.device
        return self._extract_impl(torch.as_tensor(img, device=dev), torch.as_tensor(m, device=dev),
                                  self._bucket_rect(bh, bw, right))

    @torch.no_grad()
    def match(self, bank0: FeatureBank, bank1: FeatureBank, outlier_rejection: bool = True,
              floor: Optional[int] = None) -> Matches:
        """Match two banks. ``floor`` (default
        ``superglue.nn_fallback_min_matches``; the init attempts pass
        ``nn_fallback_min_matches_init``) substitutes mutual-NN matches when
        SuperGlue yields fewer. Under ``hybrid`` mutual-NN is primary and
        SuperGlue's matches replace it when NN has fewer than ``floor or
        40``, so a floor of 0 cannot turn the rescue off; both matchers run
        on every call and the count picks one on the device."""
        sg_cfg = self.cfg.superglue
        if floor is None:
            floor = sg_cfg.nn_fallback_min_matches

        def _nn() -> Matches:
            return match_nn(bank0, bank1, sg_cfg.nn_min_similarity, sg_cfg.nn_ratio, center=sg_cfg.nn_center)

        def _sg() -> Matches:
            Z = self.superglue.match_scores(
                bank0, bank1, self.width, self.height,
                sinkhorn_iterations=sg_cfg.sinkhorn_iterations, num_heads=self.num_heads,
            )
            return decode_assignment(Z, bank0.valid, bank1.valid, self.match_threshold, margin=sg_cfg.match_margin)

        if self._matcher == "nn":
            m = _nn()
        elif self._matcher == "hybrid":
            m_nn = _nn()
            m = select_matches(m_nn.num_valid() < (floor or 40), _sg(), m_nn)
        else:
            m = _sg()
            if floor > 0:
                m = select_matches(m.num_valid() < floor, _nn(), m)
        if outlier_rejection:
            p0, p1, valid = gather_match_points(m, bank0.kpts, bank1.kpts)
            res = ransac_fundamental(self._gen, p0, p1, valid, iterations=200, sigma=1.0)
            # filter only with enough support for the 8-point model
            keep = torch.where(m.num_valid() >= 8, res.inliers, valid)
            m = filter_matches(m, keep)
        return m


class OracleExtractor:
    """Ground-truth feature oracle over a synthetic scene.

    ``points``: (N, 3) world points with N <= capacity. Each point owns a
    fixed slot identity; ``extract_with_pose`` projects the visible ones
    through the frame's ground-truth camera pose (passed via
    ``Frame.meta['T_wc']``) and ``match`` associates by slot identity:
    perfect data association, configurable pixel noise and dropout. The
    numpy draws are those of the JAX package's oracle, so both see the
    same features from the same seed.
    """

    def __init__(
        self,
        points: np.ndarray,
        camera: Camera,
        capacity: int = 1024,
        noise_px: float = 0.0,
        dropout: float = 0.0,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.points = np.asarray(points, dtype=np.float32)
        self.camera = camera
        self.capacity = int(capacity)
        assert self.points.shape[0] <= self.capacity
        self.noise_px = noise_px
        self.dropout = dropout
        self.rng = np.random.default_rng(seed)
        # Distinct descriptors per landmark (unit norm).
        D = 256
        desc = self.rng.normal(size=(self.points.shape[0], D)).astype(np.float32)
        self.desc = desc / np.linalg.norm(desc, axis=1, keepdims=True)
        # post-descriptor-draw generator state, restored by reset_state
        # so reset runs reproduce a fresh oracle's noise/dropout stream
        self._rng_state0 = self.rng.bit_generator.state

    def extract_with_pose(self, T_wc: np.ndarray, right: bool = False) -> FeatureBank:
        """``right``: the right camera, shifted along the left camera's
        x-axis by the baseline b = bf / fx."""
        n = self.points.shape[0]
        R_wc = np.asarray(T_wc[:3, :3])
        t_wc = np.asarray(T_wc[:3, 3])
        if right:
            t_wc = t_wc + R_wc @ np.array([self.camera.bf / self.camera.fx, 0.0, 0.0])
        pc = (self.points - t_wc) @ R_wc  # R_cw = R_wc^T
        z = pc[:, 2]
        cam = self.camera
        u = cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy
        if self.noise_px > 0:
            u = u + self.rng.normal(scale=self.noise_px, size=n)
            v = v + self.rng.normal(scale=self.noise_px, size=n)
        visible = (z > 0.05) & (u >= 0) & (u <= cam.width - 1) & (v >= 0) & (v <= cam.height - 1)
        if self.dropout > 0:
            visible &= self.rng.random(n) > self.dropout

        K = self.capacity
        kpts = np.zeros((K, 2), np.float32)
        desc = np.zeros((K, self.desc.shape[1]), np.float32)
        scores = np.zeros((K,), np.float32)
        valid = np.zeros((K,), bool)
        kpts[:n] = np.stack([u, v], axis=1)
        desc[:n] = self.desc
        scores[:n] = 1.0
        valid[:n] = visible
        dev = self.device
        return FeatureBank(
            scores=torch.from_numpy(scores * valid).to(dev),
            kpts=torch.from_numpy(kpts * valid[:, None]).to(dev),
            desc=torch.from_numpy(desc * valid[:, None]).to(dev),
            valid=torch.from_numpy(valid).to(dev),
        )

    def reset_state(self) -> None:
        """Restore the noise/dropout stream to its fresh-oracle state."""
        self.rng.bit_generator.state = self._rng_state0

    def extract(self, image, mask=None) -> FeatureBank:
        raise NotImplementedError("OracleExtractor requires extract_with_pose(T_wc)")

    def match(self, bank0: FeatureBank, bank1: FeatureBank, outlier_rejection: bool = True,
              floor: Optional[int] = None) -> Matches:
        # Slot-identity association: slot i matches slot i when both valid.
        both = bank0.valid & bank1.valid
        ids = torch.arange(both.shape[0], dtype=torch.int32, device=both.device)
        return Matches(
            idx1=torch.where(both, ids, torch.full_like(ids, -1)),
            score=both.to(torch.float32),
            valid=both,
        )
