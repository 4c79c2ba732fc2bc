"""Multi-sequence concurrent VO: one device, many trajectories (port of
``ur_mvo_tpu.parallel.multi_seq``).

One VO stream leaves the card idle most of a frame, so this class runs S
independent monocular sequences lock-step and batches the device work of
each frame across them: SuperPoint extraction as one batch of S images
(one stage-kernel launch a stage), SuperGlue matching as one batch of S
pairs (each GNN layer one attention launch at B = 2S; the transport a
lane at a time), and the fused post-match track core as one batch of S
lanes (ONE pose-GN launch at B = 2S and ONE packed readback a frame).
Each sequence keeps its own :class:`Tracker`, map and trajectory; the
rare control paths (initialization retries, tracking-loss fallback) call
the batched programs at S = 1 through a per-sequence extractor view.

Every lane draws its RANSAC and PnP sets from its own
``torch.Generator``, seeded from ``cfg.runtime.seed`` and the lane index,
so a lane's draws depend neither on S nor on its neighbours. The
extraction is that of the JAX package's MultiSequenceVO: /255 where the image's
maximum exceeds 1.5, no rectification and no mask.

With ``mesh=`` (a 1-D ``DeviceMesh``, ``parallel/mesh.make_mesh``) the
sequences are sharded over the ranks: rank r holds lanes [r S/n, (r+1) S/n)
(their trackers, their batched extract, match and track, their generators,
still seeded by the global lane index), every rank passes all S images and
gets all S lanes' poses back. A lane's bits do not depend on S, on its slot
or on the mesh.

This implements BASELINE.json configs #3/#5 ("all Harbor seqs batched",
"multi-sequence concurrent VO").
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence

import numpy as np
import torch

from ur_mvo_tpu_torch.camera import Camera
from ur_mvo_tpu_torch.config import Configs
from ur_mvo_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from ur_mvo_tpu_torch.models import superglue, superpoint
from ur_mvo_tpu_torch.models.superglue import SuperGlue
from ur_mvo_tpu_torch.models.superpoint import SuperPoint
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank, select_keypoints
from ur_mvo_tpu_torch.ops.matching import Matches, decode_assignment, filter_matches, gather_match_points
from ur_mvo_tpu_torch.ops.nn_matcher import match_nn
from ur_mvo_tpu_torch.ops.ransac import ransac_fundamental
from ur_mvo_tpu_torch.parallel.mesh import gather_objects, mesh_rank_device, shard_batch
from ur_mvo_tpu_torch.runtime.frontend import Tracker, fused_track_core_batched
from ur_mvo_tpu_torch.utils.timing import StageTimer


def stack_lanes(items):
    """S FeatureBanks (or Matches) -> one with a leading lane axis."""
    return type(items[0])(*(torch.stack(f) for f in zip(*items)))


def lane(batched, i: int):
    """Lane ``i`` of a FeatureBank (or Matches) with a leading lane axis."""
    return type(batched)(*(f[i] for f in batched))


class _SeqExtractorView:
    """Per-sequence extractor facade over the shared batched programs: its
    ``extract`` and ``match`` are the batched programs at S = 1 (the
    uncommon control paths); the hot path goes through
    :meth:`MultiSequenceVO.process_batch`. Its draws are its lane's."""

    def __init__(self, owner: "MultiSequenceVO", idx: int):
        self._owner = owner
        self._idx = idx

    def extract(self, image, mask=None) -> FeatureBank:
        self._owner.view_calls["extract"] += 1
        return lane(self._owner._extract_batched(torch.as_tensor(np.asarray(image))[None]), 0)

    def match(self, bank0: FeatureBank, bank1: FeatureBank, outlier_rejection: bool = True,
              floor: Optional[int] = None) -> Matches:
        self._owner.view_calls["match"] += 1
        owner = self._owner
        return lane(owner._match_batched(stack_lanes([bank0]), stack_lanes([bank1]), [owner.generators[self._idx]]), 0)


class MultiSequenceVO:
    """S monocular sequences stepped lock-step on one device, or sharded
    over the ranks of ``mesh``.

    ``extractors``: one per sequence (the oracle, for tests) in place of
    the batched programs' views. ``device`` defaults to ``cuda`` (raises
    without CUDA; on a mesh, the rank's device); ``kernels=False`` runs
    every kernel's plain version on any device (the on-card comparison).
    ``lanes``: the global indices of this rank's sequences; ``trackers``
    and ``generators`` hold theirs."""

    def __init__(self, cfg: Configs, camera: Camera, num_sequences: int, extractors: Optional[Sequence] = None,
                 mesh=None, device: DeviceLike = None, kernels: bool = True):
        if mesh is None:
            self.device = dev = resolve_device(device)
            self.lanes = list(range(num_sequences))
        else:
            n = mesh.size()
            if num_sequences % n:
                raise ValueError(f"MultiSequenceVO: {num_sequences} sequences do not split over a mesh of {n}")
            per = num_sequences // n
            self.device = dev = mesh_rank_device(mesh, device)
            self.lanes = list(range(mesh.get_local_rank() * per, (mesh.get_local_rank() + 1) * per))
        self.mesh = mesh
        self.cfg = cfg
        self.camera = camera
        self.S = num_sequences
        self._plain = not kernels
        sp_cfg, sg_cfg = cfg.superpoint, cfg.superglue
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
            # a native checkpoint's embedded architecture wins over the config
            sg = SuperGlue.from_state_dict(
                superglue.load_weights(sg_cfg.weights_path, sg_cfg.num_layers, sg_cfg.num_heads), kernels=kernels)
            meta = superglue.checkpoint_meta(sg_cfg.weights_path)
            if meta is not None:
                self.num_heads = meta[1]
        else:
            sg = SuperGlue(sg_cfg.num_layers, kernels=kernels).init_random(init_gen)
        self.superglue = sg.to(device=dev, dtype=dt).eval().requires_grad_(False)

        # "auto": without trained matcher weights SuperGlue cannot match, so
        # mutual-NN; any other name than "nn" runs SuperGlue
        matcher = sg_cfg.matcher
        if matcher == "auto":
            matcher = "superglue" if sg_cfg.weights_path else "nn"
        self.matcher = matcher
        # explicit config value > checkpoint-embedded calibration > 0.5
        self.match_threshold = superglue.resolve_matching_threshold(sg_cfg)

        # one generator a lane, seeded by its global index: F-RANSAC, then
        # the PnP prior, then the lane's fallback matches
        self.generators = [torch.Generator(device=dev).manual_seed(cfg.runtime.seed + 1000 * (i + 1))
                           for i in self.lanes]
        self.timer = StageTimer()
        self.view_calls: "collections.Counter[str]" = collections.Counter()  # the views' batched calls at S = 1
        self.last_frame: dict = {}
        self.trackers: List[Tracker] = []
        for j, i in enumerate(self.lanes):
            ext = extractors[i] if extractors is not None else _SeqExtractorView(self, j)
            self.trackers.append(Tracker(cfg, camera, ext, device=dev, kernels=kernels))
        self.K_mat = self.trackers[0].K_mat if self.trackers else None

    # ------------------------------------------------------------------
    # The batched programs
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _extract_batched(self, images) -> FeatureBank:
        """(S, H, W) images -> a FeatureBank with a leading lane axis:
        SuperPoint on the S images as one batch, keypoints a lane at a time."""
        sp_cfg = self.cfg.superpoint
        img = torch.as_tensor(np.asarray(images) if not isinstance(images, torch.Tensor) else images,
                              device=self.device).to(torch.float32)
        img = torch.where(torch.amax(img, dim=(-2, -1), keepdim=True) > 1.5, img / 255.0, img)
        out = self.superpoint(img[..., None], nms_radius=sp_cfg.nms_radius, return_raw_scores=sp_cfg.subpixel)
        return stack_lanes([
            select_keypoints(out[0][i], out[1][i], capacity=sp_cfg.capacity, threshold=sp_cfg.keypoint_threshold,
                             border=sp_cfg.remove_borders, max_keypoints=sp_cfg.max_keypoints,
                             raw_scores=out[2][i] if sp_cfg.subpixel else None)
            for i in range(img.shape[0])
        ])

    @torch.no_grad()
    def _match_batched(self, banks0: FeatureBank, banks1: FeatureBank, generators=None, sets=None) -> Matches:
        """S pairs (banks with a leading lane axis) -> Matches with a leading
        lane axis: SuperGlue on the S pairs at once (or mutual-NN a lane at a
        time), then per lane the decode, 8-point F-RANSAC (200 hypotheses,
        from ``generators[i]``, or the injected ``sets[i]``) and the
        verdicts where the lane has >= 8 matches."""
        sg_cfg = self.cfg.superglue
        S = banks0.scores.shape[0]
        if self.matcher == "nn":
            ms = [match_nn(lane(banks0, i), lane(banks1, i), sg_cfg.nn_min_similarity, sg_cfg.nn_ratio,
                           center=sg_cfg.nn_center) for i in range(S)]
        else:
            Z = self.superglue.match_scores(banks0, banks1, sg_cfg.image_width, sg_cfg.image_height,
                                            sinkhorn_iterations=sg_cfg.sinkhorn_iterations, num_heads=self.num_heads)
            ms = [decode_assignment(Z[i], banks0.valid[i], banks1.valid[i], self.match_threshold) for i in range(S)]
        out = []
        for i, m in enumerate(ms):
            p0, p1, valid = gather_match_points(m, banks0.kpts[i], banks1.kpts[i])
            res = ransac_fundamental(None if generators is None else generators[i], p0, p1, valid, iterations=200,
                                     sets=None if sets is None else sets[i])
            keep = torch.where(m.num_valid() >= 8, res.inliers, valid)
            out.append(filter_matches(m, keep))
        return stack_lanes(out)

    @torch.no_grad()
    def _track_batched(self, matches: Matches, banks: FeatureBank, snapshots: torch.Tensor, generators=None,
                       pnp_sets=None) -> torch.Tensor:
        """The fused post-match core over S lanes
        (:func:`fused_track_core_batched`): (S, 14 + 4K) packed rows on the
        device, one pose-GN call for all lanes."""
        cam, topt, rt, kf = self.camera, self.cfg.tracking_optimization, self.cfg.runtime, self.cfg.keyframe
        S, K = banks.kpts.shape[:2]
        uvr = torch.cat([banks.kpts, -torch.ones((S, K, 1), dtype=torch.float32, device=banks.kpts.device)], dim=-1)
        return fused_track_core_batched(
            generators, [lane(matches, i) for i in range(S)], uvr, snapshots, self.K_mat,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, topt.mono_point, topt.stereo_point,
            rt.pnp_ransac_iterations, rt.pnp_reprojection_threshold, kf.min_num_match, 4.0 * kf.max_distance,
            pnp_sets=pnp_sets, plain=self._plain,
        )[0]

    # ------------------------------------------------------------------

    def _own(self, items):
        """This rank's part of a per-sequence list (all of it without a mesh)."""
        return items[self.lanes[0] : self.lanes[-1] + 1] if self.lanes else items[:0]

    def _gather(self, local: list) -> list:
        """Every rank's per-lane results in global lane order."""
        if self.mesh is None:
            return local
        return [x for part in gather_objects(local, self.mesh) for x in part]

    def process_batch(self, images, timestamps: Sequence[float]) -> List[Optional[np.ndarray]]:
        """One lock-step frame for all sequences. ``images``: (S, H, W).
        Returns per-sequence keyframe poses (or None); on a mesh each rank
        extracts and steps its own lanes and every rank gets all S."""
        if len(images) != self.S:
            raise ValueError(f"process_batch: {len(images)} images for {self.S} sequences")
        with self.timer.span("extract"):
            banks_b = self._extract_batched(self._own(images))
        return self._gather(self._process_lanes(banks_b, self._own(list(timestamps))))

    def process_banks(self, banks_b: FeatureBank, timestamps: Sequence[float]) -> List[Optional[np.ndarray]]:
        """:meth:`process_batch` after the extraction: ``banks_b``, one
        FeatureBank a sequence with a leading lane axis (all S; on a mesh
        each rank takes its block), through the batched match, the batched
        track and each sequence's tracker. ``last_frame`` then counts, over
        this rank's lanes, those that tracked in the batch, those whose
        tracker adopted its row (the others fell back to their tracker's
        own flow) and the ``optimize_pose`` calls the lanes' own flows made
        (:attr:`Tracker.pose_calls`)."""
        if banks_b.scores.shape[0] != self.S:
            raise ValueError(f"process_banks: {banks_b.scores.shape[0]} banks for {self.S} sequences")
        if self.mesh is not None:
            banks_b = shard_batch(banks_b, self.mesh)
        return self._gather(self._process_lanes(banks_b, self._own(list(timestamps))))

    def _process_lanes(self, banks_b: FeatureBank, timestamps: Sequence[float]) -> List[Optional[np.ndarray]]:
        """This rank's lanes' frame: ``banks_b`` and ``timestamps`` theirs."""
        S = len(self.trackers)
        banks = [lane(banks_b, i) for i in range(S)]

        # primary match partners: the ref keyframe bank (tracking) or the
        # init bank (initialization); the lane's own bank otherwise
        partners, have_partner = [], []
        for i, t in enumerate(self.trackers):
            partner = t._ref_bank if t.initialized else t._init_bank
            partners.append(banks[i] if partner is None else partner)
            have_partner.append(partner is not None)
        with self.timer.span("match"):
            matches_b = self._match_batched(stack_lanes(partners), banks_b, self.generators)

        # the batched track for the sequences in tracking state: one
        # upload, one launch of pose GN, one readback
        track_lane = [t.initialized and t._ref_bank is not None for t in self.trackers]
        packed = None
        if any(track_lane):
            K = self.cfg.superpoint.capacity
            snaps = np.zeros((S, K, 6), np.float32)
            for i, t in enumerate(self.trackers):
                if track_lane[i]:
                    snaps[i] = t.fused_snapshot()
            with self.timer.span("track"):
                snaps_d = torch.from_numpy(snaps).to(self.device)
                packed = self._track_batched(matches_b, banks_b, snaps_d, self.generators).cpu().numpy()

        out = []
        pose_calls = sum(t.pose_calls for t in self.trackers)
        with self.timer.span("lanes"):
            for i, t in enumerate(self.trackers):
                m = lane(matches_b, i) if have_partner[i] else None
                pt = t.parse_fused_packed(packed[i]) if track_lane[i] else None
                out.append(t.process(banks[i], timestamps[i], precomputed_match=m, precomputed_track=pt))
        self.last_frame = {"track_lanes": sum(track_lane),
                           "adopted": sum(t.adopted_track for t in self.trackers),
                           "lane_pose_calls": sum(t.pose_calls for t in self.trackers) - pose_calls}
        return out

    def process_batch_with_oracle(self, T_wcs: Sequence[np.ndarray],
                                  timestamps: Sequence[float]) -> List[Optional[np.ndarray]]:
        """Oracle-extractor variant for tests: each sequence extracts from
        its ground-truth pose and matches by slot identity on its own."""
        T_wcs, timestamps = self._own(list(T_wcs)), self._own(list(timestamps))
        return self._gather([t.process(t.extractor.extract_with_pose(T_wcs[i]), timestamps[i])
                             for i, t in enumerate(self.trackers)])

    # ------------------------------------------------------------------

    def trajectories(self):
        """Per sequence, its keyframes' (timestamps, R_wc, t_wc) in insertion
        order (on a mesh, every rank gets all S)."""
        out = []
        for t in self.trackers:
            t.backend.flush_pending_ba()
            out.append(t.backend.store.trajectory())
        return self._gather(out)
