"""Typed configuration tree (the port's own copy of ``ur_mvo_tpu.config``).

Mirrors the key surface of the reference's hand-written YAML structs
(``include/read_configs.h:9-216`` — ``SuperPointConfig``,
``SuperGlueConfig``, ``KeyframeConfig``, ``OptimizationConfig``,
``SensorSetup``, master ``Configs``) but as dataclasses with YAML load and
**in-memory** dotted-key overrides. The dataclasses are copied whole so
later slices of the port need not copy them again; PyYAML is imported
only by :meth:`Configs.from_yaml`, so the device path needs nothing
beyond torch and numpy.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Any, Optional


class SensorSetup(enum.Enum):
    MONO = "mono"
    STEREO = "stereo"
    RGBD = "rgbd"


@dataclasses.dataclass
class SuperPointConfig:
    """Keypoint extraction knobs (``read_configs.h:9-24``)."""

    max_keypoints: int = 1000
    keypoint_threshold: float = 0.0005
    remove_borders: int = 4
    nms_radius: int = 4
    weights_path: Optional[str] = None  # .npz / .pth; None = random init
    # "network" = SuperPoint descriptor head; "patch" = weights-free
    # normalized 16x16 intensity patches (256-d, ops/gridsample.py) —
    # lets the full pipeline run with an untrained/detector-only model.
    descriptor_source: str = "network"
    # Sub-pixel keypoint refinement (quadratic peak fit on the pre-NMS
    # score map; ops/keypoints.py). The reference emits integer pixels.
    # Default OFF — measured NEGATIVE with the shipped v3 checkpoint:
    # plane-scene mono ATE 0.19 -> 0.26 (the refined peak of its
    # softmax-cell score map is a biased position estimate, and shifted
    # descriptor sampling perturbs NN matching), stereo ATE unchanged
    # (the timestamp fix, not quantization, was the 0.2 m floor). Kept
    # for detectors with smooth calibrated score peaks.
    subpixel: bool = False
    # Padded keypoint capacity of the fixed-shape feature bank. Must be a
    # multiple of 128 for MXU-aligned downstream matmuls and >= max_keypoints.
    capacity: int = 1024
    # Resolution bucket ladder, e.g. [(240, 320), (480, 640)]. The
    # reference's TRT engine accepts any H x W in 100^2-1500^2 in ONE
    # engine (super_point.cpp:55-61); XLA compiles per exact shape, so
    # the TPU-native equivalent is pad-to-bucket: an input is
    # edge-padded (bottom/right) to the smallest bucket that fits and
    # runs through that bucket's ONE compiled program, with the pad
    # region masked out of keypoint selection. Inputs are treated as
    # top-left crops of the calibrated sensor (intrinsics stay exact;
    # rectify maps stay valid over the cropped region). None = off
    # (single-shape compile, the default).
    resolution_buckets: Optional[list] = None


@dataclasses.dataclass
class SuperGlueConfig:
    """Matcher knobs (``read_configs.h:26-41``)."""

    image_width: int = 640
    image_height: int = 512
    # Decode threshold on the Sinkhorn assignment. None = use the
    # calibrated threshold embedded in a native checkpoint
    # (``__meta_matching_threshold__``, written by train_superglue_v3)
    # when one is configured, else the reference default 0.5
    # (``read_configs.h:26-41``). An explicit float always wins.
    matching_threshold: Optional[float] = None
    # "superglue" (learned GNN+Sinkhorn), "nn" (mutual nearest-neighbor
    # with ratio test — no trained weights required), "hybrid"
    # (NN primary, SuperGlue substituted in-program when NN starves
    # below nn_fallback_min_matches — the metric-setup production
    # policy: NN's ratio test wins on clean repetitive-texture scenes
    # where Sinkhorn confidently aliases, SG wins under photometric
    # decay where raw descriptors collapse), or "auto" (superglue when
    # weights_path is set, nn otherwise — a random-init SuperGlue
    # cannot match)
    matcher: str = "auto"
    nn_min_similarity: float = 0.2
    nn_ratio: float = 0.95
    # per-pair descriptor re-centering in the NN matcher (see
    # ops/nn_matcher.match_nn: recovers contrast in collapsed descriptor
    # spaces; +0.10 recall with the shipped v3 detector). Thresholds
    # above apply to the CENTERED cosines when enabled.
    nn_center: bool = False
    # Ambiguity gate on the Sinkhorn decode (ops/matching.py
    # decode_assignment): keep a match only when its log-score beats the
    # row AND column runner-up by this many nats. 0 = off (reference
    # decode). MEASURED NEGATIVE for the texture-aliasing failure mode:
    # at decode threshold 0.8 the post-Sinkhorn gap is >= log(4) by
    # arithmetic (the gate never fires), and the pre-Sinkhorn logit
    # gaps of correct vs aliased confident matches overlap almost
    # completely (p50 8.35 vs 7.38 nats on the r4 diagnosis scene) — a
    # margin in either space trades recall ~1:1. Kept for
    # low-threshold/experimental configs; the production fix for
    # aliasing is the NN floor / hybrid matcher below.
    match_margin: float = 0.0
    # Min-match floor with mutual-NN fallback: when the SuperGlue decode
    # yields fewer than this many matches for a pair, the SAME device
    # program substitutes mutual-NN matches (one extra (K,K) einsum —
    # trivial next to the GNN). Rescues mid-sequence dropouts where the
    # learned matcher leaves too little above its confidence threshold
    # (the checkpoint operating-point cliff). 0 = off. Measured: floor
    # 40 during TRACKING taxes the cells SG wins (mono/plane 0.028 ->
    # 0.065, mono/decay 0.10 -> 0.15) — production mono keeps this 0 and
    # uses the init-only floor below, where the hard failures lived.
    nn_fallback_min_matches: int = 0
    # Same floor applied ONLY to two-view init attempts (the fused init
    # program): the seed-dependent hard failures of the production mono
    # stack were INIT failures (mono/3d failed 2/3 seeds -> 0/3 at
    # floor 40, other cells untouched). 0 = off.
    nn_fallback_min_matches_init: int = 0
    sinkhorn_iterations: int = 20
    num_layers: int = 9
    num_heads: int = 4
    descriptor_dim: int = 256
    keypoint_encoder_dims: tuple = (32, 64, 128, 256)
    weights_path: Optional[str] = None


@dataclasses.dataclass
class KeyframeConfig:
    """Keyframe policy thresholds (``read_configs.h:44-56``; values from
    ``configs/configs_aqua.yaml``)."""

    min_num_match: int = 1
    max_num_match: int = 2
    max_distance: float = 0.5
    max_angle: float = 0.52
    max_num_passed_frame: int = 10


@dataclasses.dataclass
class OptimizationConfig:
    """chi^2 gates for robust optimization (``read_configs.h:58-66``)."""

    mono_point: float = 10.0
    stereo_point: float = 75.0
    rate: float = 0.5


@dataclasses.dataclass
class InitializerConfig:
    """Two-view monocular initialization (``epipolar_geometry.h:20-21``,
    ``tracking.cc:379-648``)."""

    ransac_iterations: int = 200
    sigma: float = 1.0
    min_matches: int = 150
    min_features_first: int = 200
    reseed_time: float = 3.0
    median_depth_scale: float = 4.0
    # Minimum two-view parallax (deg, ORB-SLAM 50th-best-point metric)
    # to accept a monocular initialization. The reference uses 1.0
    # (epipolar_geometry.cc acceptance), which admits marginal-baseline
    # inits whose shallow triangulations drift downstream (measured 5x
    # worse 200-frame ATE); 2.0 rejects those while still initializing
    # within a few frames at normal motion.
    min_parallax_deg: float = 2.0


@dataclasses.dataclass
class BackendConfig:
    """Sliding-window local BA shape (``mapping.cc:260-322, 386-403``)."""

    window_opt_frames: int = 15
    window_fixed_frames: int = 20
    fix_older_than: int = 10
    ba_iterations_phase1: int = 10
    ba_iterations_phase2: int = 5
    # LM convergence early exit (relative cost improvement); 0.0 runs the
    # exact fixed g2o schedule (see ops.ba.BAConfig.tol)
    ba_tol: float = 1e-4
    max_keyframes: int = 512
    # 512 keyframes x ~1000 features create well under 64k live points
    # once outlier removal runs; the observer matrix is (MP, KF) int16.
    max_mappoints: int = 65536
    # Padded BA problem capacities (static shapes for the jitted solver).
    # Realistic windows carry ~1-2k points / ~8k observations; halved
    # from the initial 4096/16384 after profiling (BA cost scales with
    # the padded sizes).
    ba_max_points: int = 2048
    ba_max_observations: int = 8192
    # Keyframe/mappoint culling (the reference ships this disabled,
    # tracking.cc:317; caps from mapping.cc:26-39).
    enable_culling: bool = False
    cull_max_keyframes: int = 30
    cull_max_mappoints: int = 10000
    # Asynchronous keyframe BA: dispatch the windowed BA without blocking
    # and apply its result at the next keyframe (one-keyframe-stale
    # write-back, like a mapping thread). With >1 device the solve runs
    # on the last device, fully off the frontend chip's critical path —
    # the TPU-native analog of the reference's extraction/tracking
    # thread split (tracking.cc:57-59).
    ba_async: bool = False
    # Loop-closure detection (beyond the reference, which has none):
    # keyframe retrieval by centered global-descriptor cosine, geometric
    # verification by descriptor NN match + PnP against the candidate's
    # mappoints; accepted edges feed Backend.global_optimize's pose graph.
    loop_closure: bool = False
    loop_min_gap_frames: int = 30  # frame-id distance before a revisit counts
    loop_top_k: int = 3  # candidates geometrically verified per keyframe
    loop_min_similarity: float = 0.3  # centered global-descriptor cosine gate
    loop_min_inliers: int = 25  # PnP inliers to accept an edge
    loop_edge_weight: float = 3.0  # pose-graph weight vs 1.0 odometry edges
    loop_cooldown_keyframes: int = 5  # skip detection right after an accept
    # Relocalization after tracking loss (beyond the reference, whose
    # only recovery is a fresh-map reseed, tracking.cc:500-513): after
    # `reloc_after_failures` consecutive lost frames, retrieve candidate
    # keyframes by centered global-descriptor cosine and PnP-verify
    # against LIVE mappoints; on success the frame re-enters the
    # EXISTING map as a keyframe (shares the loop_* retrieval gates).
    relocalization: bool = False
    reloc_after_failures: int = 3


@dataclasses.dataclass
class LocalMapTrackingConfig:
    """Optional projection-guided local-map refinement (the reference's
    disabled ``TrackLocalMap`` path, ``tracking.cc:1031-1109``)."""

    enabled: bool = False
    radius_px: float = 15.0
    min_similarity: float = 0.5
    ratio: float = 0.9


@dataclasses.dataclass
class RuntimeConfig:
    """Host pipeline + numerics."""

    # Network compute dtype. bf16 is the TPU-native choice and mirrors the
    # reference's fp16 TensorRT engines; geometry always runs f32-HIGHEST.
    compute_dtype: str = "bfloat16"
    seed: int = 0
    pnp_ransac_iterations: int = 100
    pnp_reprojection_threshold: float = 20.0
    # Multi-frame chunks: >1 queues this many frames' extract + match +
    # track at once with one packed readback (Tracker.process_chunk), cut
    # at the first keyframe or weak row. 0/1 = per-frame fused step. Mono,
    # stereo and RGB-D neural path; engine.process_sequence falls back
    # per-frame elsewhere.
    chunk_frames: int = 0
    results_dir: str = "results"
    save_trajectory: bool = True
    save_debug_images: bool = False


@dataclasses.dataclass
class Configs:
    """Master config (``read_configs.h:81-216``)."""

    camera_config_path: Optional[str] = None
    use_mask: bool = False
    sensor_setup: SensorSetup = SensorSetup.MONO
    superpoint: SuperPointConfig = dataclasses.field(default_factory=SuperPointConfig)
    superglue: SuperGlueConfig = dataclasses.field(default_factory=SuperGlueConfig)
    keyframe: KeyframeConfig = dataclasses.field(default_factory=KeyframeConfig)
    tracking_optimization: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    backend_optimization: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    initializer: InitializerConfig = dataclasses.field(default_factory=InitializerConfig)
    backend: BackendConfig = dataclasses.field(default_factory=BackendConfig)
    local_map_tracking: LocalMapTrackingConfig = dataclasses.field(default_factory=LocalMapTrackingConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_yaml(cls, path: str, setup: SensorSetup = SensorSetup.MONO, overrides: Optional[dict] = None) -> "Configs":
        """Load a reference-format YAML (``configs/configs_aqua.yaml`` keys
        are accepted) and apply dotted-key overrides in memory."""
        import yaml

        with open(path, "r") as f:
            raw = yaml.safe_load(f) or {}
        cfg = cls.from_dict(raw, setup=setup, base_dir=os.path.dirname(os.path.abspath(path)))
        if overrides:
            cfg.apply_overrides(overrides)
        return cfg

    @classmethod
    def from_dict(cls, raw: dict, setup: SensorSetup = SensorSetup.MONO, base_dir: str = ".") -> "Configs":
        cfg = cls(sensor_setup=setup)
        inp = raw.get("input", {})
        cam_rel = inp.get("camera_config_path")
        if cam_rel:
            cfg.camera_config_path = cam_rel if os.path.isabs(cam_rel) else os.path.join(base_dir, cam_rel)
        cfg.use_mask = bool(inp.get("use_mask", 0))
        def _rel(p):
            # weight/calibration paths in YAML resolve relative to the
            # config file (the reference hardcodes container-absolute
            # paths instead — read_configs.h:68-70)
            return p if (p is None or os.path.isabs(p)) else os.path.join(base_dir, p)

        sp = raw.get("superpoint", {})
        for k in ("max_keypoints", "keypoint_threshold", "remove_borders", "nms_radius", "weights_path", "capacity", "descriptor_source", "resolution_buckets"):
            if k in sp:
                setattr(cfg.superpoint, k, _rel(sp[k]) if k == "weights_path" else sp[k])
        sg = raw.get("superglue", {})
        for k in ("image_width", "image_height", "matching_threshold", "sinkhorn_iterations", "num_layers", "num_heads", "weights_path"):
            if k in sg:
                setattr(cfg.superglue, k, _rel(sg[k]) if k == "weights_path" else sg[k])
        kf = raw.get("keyframe", {})
        for k in ("min_num_match", "max_num_match", "max_distance", "max_angle", "max_num_passed_frame"):
            if k in kf:
                setattr(cfg.keyframe, k, kf[k])
        opt = raw.get("optimization", {})
        for name, target in (("tracking", cfg.tracking_optimization), ("backend", cfg.backend_optimization)):
            sub = opt.get(name, {})
            for k in ("mono_point", "stereo_point", "rate"):
                if k in sub:
                    setattr(target, k, float(sub[k]))
        # extended (non-reference) sections: any dataclass field by name
        for section, target in (
            ("superglue", cfg.superglue),
            ("initializer", cfg.initializer),
            ("backend", cfg.backend),
            ("runtime", cfg.runtime),
            ("local_map_tracking", cfg.local_map_tracking),
        ):
            for k, v in (raw.get(section) or {}).items():
                if hasattr(target, k):
                    setattr(target, k, v)
        return cfg

    def apply_overrides(self, overrides: dict) -> None:
        """Dotted-key in-memory overrides, e.g. ``{"superpoint.max_keypoints": 500}``."""
        for dotted, value in overrides.items():
            node: Any = self
            parts = dotted.split(".")
            for p in parts[:-1]:
                node = getattr(node, p)
            leaf = parts[-1]
            if not hasattr(node, leaf):
                raise KeyError(f"Unknown config key: {dotted}")
            setattr(node, leaf, value)

    def validate(self) -> None:
        sp = self.superpoint
        if sp.capacity % 128 != 0:
            raise ValueError("superpoint.capacity must be a multiple of 128 (MXU tile alignment)")
        if sp.capacity < sp.max_keypoints:
            raise ValueError("superpoint.capacity must be >= max_keypoints")
