"""Feature extraction + matching front end (port of
``ur_mvo_tpu.runtime.extractor.NeuralExtractor``).

``extract``: rectify remap -> SuperPoint (fused stage kernels, stage 4,
heads, NMS) -> top-K keypoint selection -> descriptor sampling.
``match``: SuperGlue (attention kernel in every GNN layer, Sinkhorn
kernel) -> mutual decode, with the mutual-NN min-match floor -> 8-point
fundamental RANSAC outlier rejection. Both stay on the device: no host
sync inside either call.

Not ported yet: the ``hybrid`` matcher, resolution buckets, sub-pixel
peaks, patch descriptors and the right-camera map; a configuration that
asks for one raises.
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

    def __init__(self, cfg: Configs, camera: Camera, device: DeviceLike = None, kernels: bool = True):
        self.cfg = cfg
        self.camera = camera
        self.device = dev = resolve_device(device)
        sp_cfg, sg_cfg = cfg.superpoint, cfg.superglue
        if sp_cfg.resolution_buckets or sp_cfg.subpixel or sp_cfg.descriptor_source != "network":
            raise NotImplementedError(
                "ur_mvo_tpu_torch.NeuralExtractor: resolution buckets, subpixel peaks and patch "
                "descriptors are not ported yet"
            )
        dt = compute_dtype(cfg.runtime.compute_dtype)
        init_gen = torch.Generator().manual_seed(cfg.runtime.seed)

        sp = SuperPoint(kernels=kernels)
        if sp_cfg.weights_path:
            sp.load_state_dict(superpoint.load_torch_weights(sp_cfg.weights_path))
        else:
            sp.init_random(init_gen)
        self.superpoint = sp.to(device=dev, dtype=dt).eval()

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
        self.superglue = sg.to(device=dev, dtype=dt).eval()

        # "auto": a randomly initialized SuperGlue cannot match, so
        # without trained matcher weights use mutual-NN
        self._matcher = sg_cfg.matcher
        if self._matcher == "auto":
            self._matcher = "superglue" if sg_cfg.weights_path else "nn"
        if self._matcher == "hybrid" and not sg_cfg.weights_path:
            self._matcher = "nn"
        if self._matcher not in ("superglue", "nn"):
            raise NotImplementedError(f"matcher {self._matcher!r} is not ported yet")

        self._rect = (
            torch.as_tensor(camera.undistort_map, device=dev) if camera.undistort_map is not None else None
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
    def extract(self, image: np.ndarray, mask: Optional[np.ndarray] = None) -> FeatureBank:
        """(H, W) uint8 image (numpy or tensor) -> :class:`FeatureBank` on
        the device. ``mask`` nonzero keeps a pixel (replaces border removal)."""
        sp_cfg = self.cfg.superpoint
        img = torch.as_tensor(image, device=self.device).to(torch.float32) / 255.0
        if self._rect is not None:
            img = remap_bilinear(img, self._rect)
        scores, desc = self.superpoint(img[None, :, :, None], nms_radius=sp_cfg.nms_radius)
        return select_keypoints(
            scores[0],
            desc[0],
            capacity=sp_cfg.capacity,
            threshold=sp_cfg.keypoint_threshold,
            border=sp_cfg.remove_borders,
            max_keypoints=sp_cfg.max_keypoints,
            mask=None if mask is None else torch.as_tensor(mask, device=self.device),
        )

    @torch.no_grad()
    def match(self, bank0: FeatureBank, bank1: FeatureBank, outlier_rejection: bool = True,
              floor: Optional[int] = None) -> Matches:
        """Match two banks. ``floor`` (default
        ``superglue.nn_fallback_min_matches``; the init attempts pass
        ``nn_fallback_min_matches_init``) substitutes mutual-NN matches when
        SuperGlue yields fewer."""
        sg_cfg = self.cfg.superglue
        if floor is None:
            floor = sg_cfg.nn_fallback_min_matches

        def _nn() -> Matches:
            return match_nn(bank0, bank1, sg_cfg.nn_min_similarity, sg_cfg.nn_ratio, center=sg_cfg.nn_center)

        if self._matcher == "nn":
            m = _nn()
        else:
            Z = self.superglue.match_scores(
                bank0, bank1, self.width, self.height,
                sinkhorn_iterations=sg_cfg.sinkhorn_iterations, num_heads=self.num_heads,
            )
            m = decode_assignment(Z, bank0.valid, bank1.valid, self.match_threshold, margin=sg_cfg.match_margin)
            if floor > 0:
                m = select_matches(m.num_valid() < floor, _nn(), m)
        if outlier_rejection:
            p0, p1, valid = gather_match_points(m, bank0.kpts, bank1.kpts)
            res = ransac_fundamental(self._gen, p0, p1, valid, iterations=200, sigma=1.0)
            # filter only with enough support for the 8-point model
            keep = torch.where(m.num_valid() >= 8, res.inliers, valid)
            m = filter_matches(m, keep)
        return m
