"""VO tracking front end: the host state machine (port of
``ur_mvo_tpu.runtime.frontend``).

Orchestration parity with the reference's ``Tracking``: monocular
two-view initialization, single-frame stereo and RGB-D initialization,
frame-to-keyframe tracking with a PnP prior and
pose-only refinement, the tracking-loss fallback that promotes the last
frame to keyframe, relocalization into the existing map after repeated
losses (with backoff), the keyframe policy, and keyframe insertion into the
mapping backend (with loop detection after it), which is the only event
that emits a pose to the caller (non-keyframe frames are interpolated by
the engine).

A single-owner host loop queues device work (matching, PnP, pose
refinement all stay on ``device``) and reads back ONE packed vector a
frame; decisions (init success, fallback, keyframe) are taken on the host
from it. Stereo frames (``bank_right``) match left to right and gate each
pair by disparity and row inside the same step; RGB-D frames
(``depth_lookup``) seed map points from depth at keyframe insertion.
Local-map tracking (``local_map_tracking.enabled``) takes the two-program
flow and, after a good track, associates the window's map points by
projection and refines the pose once more on them (:meth:`_track_local_map`).
:meth:`Tracker.adopt_map` starts the tracker on a loaded map. The
multi-sequence VO (``parallel/multi_seq.py``) hands :meth:`Tracker.process` the
frame's match and fused-step row, computed for all its sequences at once
(:func:`fused_track_core_batched`). :meth:`Tracker.process_chunk` tracks up
to C frames with one readback (``runtime.chunk_frames``, driven by
``UR_MVO.process_sequence``): the frames' device work is queued at once and
the host replays the rows up to the first keyframe or weak row.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ur_mvo_tpu_torch.camera import Camera
from ur_mvo_tpu_torch.config import Configs, SensorSetup
from ur_mvo_tpu_torch.device import DeviceLike, resolve_device
from ur_mvo_tpu_torch.ops.epipolar import two_view_init
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank
from ur_mvo_tpu_torch.ops.lie import mv
from ur_mvo_tpu_torch.ops.local_map import search_by_projection
from ur_mvo_tpu_torch.ops.matching import Matches
from ur_mvo_tpu_torch.ops.pnp import ransac_pnp
from ur_mvo_tpu_torch.ops.pose_opt import PoseObs, optimize_pose
from ur_mvo_tpu_torch.runtime.backend import Backend
from ur_mvo_tpu_torch.runtime.publisher import (
    FramePoseMessage,
    KeyframeMessage,
    MapMessage,
    Publisher,
)
from ur_mvo_tpu_torch.utils.timing import StageTimer


def _t_wc(R_cw: torch.Tensor, t_cw: torch.Tensor) -> torch.Tensor:
    return -mv(R_cw.transpose(-1, -2), t_cw)


def _track_problem(generator, m: Matches, snapshot, uvr, K_mat, pnp_iterations, pnp_threshold_px, min_match,
                   pnp_sets=None):
    """Candidate scatter + PnP prior of the fused frame step: the two
    pose-GN problems (seeded at the PnP prior, or at the last pose where it
    is weak, and the rescue seeded at the last pose) and what the verdict
    needs, all on the device."""
    K = m.idx1.shape[0]
    dev = snapshot.device
    cand_pos = snapshot[:, 0:3]
    cand_ok = snapshot[:, 3] > 1.5
    cand_live = snapshot[:, 3] > 0.5
    ref_track = snapshot[:, 4]
    R_last_cw = snapshot[0:9, 5].reshape(3, 3)
    t_last_cw = snapshot[9:12, 5]
    idx1 = m.idx1.to(torch.int64)

    # Scatter ref-slot candidates to current-frame slots. Row K is a dump
    # row: many sources may land there, none lands twice on a real row
    # (matches are mutual), so index_copy_ is deterministic on rows < K.
    src_ok = m.valid & cand_ok
    dst = torch.where(src_ok, idx1, torch.full_like(idx1, K))
    X = torch.zeros((K + 1, 3), dtype=torch.float32, device=dev).index_copy_(0, dst, cand_pos)[:K]
    valid_cur = torch.zeros(K + 1, dtype=torch.bool, device=dev).index_copy_(0, dst, src_ok)[:K]
    live_ok = m.valid & cand_live
    dst_live = torch.where(live_ok, idx1, torch.full_like(idx1, K))
    mp_slot = torch.full((K + 1,), -1.0, dtype=torch.float32, device=dev).index_copy_(
        0, dst_live, torch.where(live_ok, ref_track, torch.full_like(ref_track, -1.0))
    )[:K]

    pnp = ransac_pnp(
        generator, X, uvr[:, :2], valid_cur, K_mat,
        iterations=pnp_iterations, threshold_px=pnp_threshold_px, sets=pnp_sets,
    )
    weak = (
        (pnp.n_inliers < min_match)
        | (torch.sum(valid_cur.to(torch.int32)) < 6)
        | ~torch.all(torch.isfinite(pnp.t_cw))
    )
    R0 = torch.where(weak, R_last_cw, pnp.R_cw)
    t0 = torch.where(weak, t_last_cw, pnp.t_cw)
    return X, valid_cur, mp_slot, R0, t0, R_last_cw, t_last_cw, weak


def _track_verdict(num_match, uvr, valid_cur, mp_slot, R_last_cw, t_last_cw, R_cw, t_cw, inliers, n_inliers,
                   min_match, max_jump, weak):
    """Jump guard + rescue over the two problems' results (``R_cw`` (2, 3,
    3) ...): the row packed as :func:`fused_track_core` returns it, and
    what the row read of the last pose, [prior weak (``weak``, the PnP
    prior's verdict), rescue taken, first problem's jump]."""
    # jump guard + rescue (see Tracker._track_frame for the rationale)
    t_wc_last = _t_wc(R_last_cw, t_last_cw)
    jumps = torch.sqrt(torch.sum((_t_wc(R_cw, t_cw) - t_wc_last) ** 2, dim=-1))  # (2,)
    jump_ok = torch.isfinite(jumps) & (jumps <= max_jump)
    enough = n_inliers >= min_match
    take_rescue = enough[0] & ~jump_ok[0]
    ok2 = jump_ok[1] & enough[1]
    R_f = torch.where(take_rescue, R_cw[1], R_cw[0])
    t_f = torch.where(take_rescue, t_cw[1], t_cw[0])
    inl_f = torch.where(take_rescue, inliers[1] & ok2, inliers[0])
    n_f = torch.where(take_rescue, torch.where(ok2, n_inliers[1], torch.zeros_like(n_inliers[1])), n_inliers[0])
    # chi2 inlier classification applies only to slots that carried a 3D
    # constraint; matched-but-untriangulated ids are kept as they are
    keep_id = torch.where(valid_cur, inl_f, mp_slot >= 0)
    frame_track = torch.where(keep_id, mp_slot, torch.full_like(mp_slot, -1.0))
    packed = torch.cat([
        torch.stack([num_match.to(torch.float32), n_f.to(torch.float32)]),
        R_f.reshape(-1), t_f, frame_track, uvr.reshape(-1),
    ])
    return packed, torch.stack([weak.to(torch.float32), take_rescue.to(torch.float32), jumps[0]])


def fused_track_core(generator, m: Matches, uvr, snapshot, K_mat, fx, fy, cx, cy, bf,
                     chi2_mono, chi2_stereo, pnp_iterations, pnp_threshold_px,
                     min_match, max_jump, pnp_sets=None, plain=False):
    """Post-match half of the fused frame step, all on the device:
    candidate scatter + PnP prior + pose refinement + jump-guard rescue.

    ``snapshot`` (K, 6) f32: [:, 0:3] candidate mappoint positions per REF
    slot, [:, 3] a 2-level flag (2 = triangulated candidate with a usable
    3D position, 1 = live but untriangulated mappoint whose TRACK ID must
    still propagate so the point can gather observers and triangulate at a
    later keyframe, 0 = none), [:, 4] the ref track table (mappoint ids,
    exact in f32), [0:9, 5] last R_cw, [9:12, 5] last t_cw.

    The refinement seeded at the PnP pose and its rescue seeded at the last
    pose are ONE batch of two problems (one kernel launch on the card); the
    rescue's result is selected on the device when the first one jumped.
    Nothing is read back here. Returns the packed f32 vector [num_match,
    n_inliers, R_cw(9), t_cw(3), frame_track(K), uvr(3K)] (see
    ``Tracker.parse_fused_packed``) and, beside it, the 3-vector of what
    the row read of the last pose (see :func:`_track_verdict`; the chunk
    path reads it). ``pnp_sets`` injects the PnP minimal sets; ``plain``
    asks for the plain pose optimizer on any device."""
    rows, reads = fused_track_core_batched(
        [generator], [m], uvr[None], snapshot[None], K_mat, fx, fy, cx, cy, bf, chi2_mono, chi2_stereo,
        pnp_iterations, pnp_threshold_px, min_match, max_jump, None if pnp_sets is None else [pnp_sets], plain,
    )
    return rows[0], reads[0]


def fused_track_core_batched(generators, matches, uvr, snapshots, K_mat, fx, fy, cx, cy, bf,
                             chi2_mono, chi2_stereo, pnp_iterations, pnp_threshold_px,
                             min_match, max_jump, pnp_sets=None, plain=False):
    """:func:`fused_track_core` over S lanes: ``generators`` and
    ``matches`` are per-lane sequences (or ``pnp_sets`` a sequence of S
    injected PnP set tensors), ``uvr`` (S, K, 3), ``snapshots`` (S, K, 6).
    The scatter and PnP prior run a lane at a time; the lanes' 2S pose
    problems (lane i's at rows 2i, 2i + 1) are ONE ``optimize_pose`` call,
    one kernel launch on the card. Returns the (S, 14 + 4K) packed rows,
    lane i's row that of :func:`fused_track_core` on lane i's inputs and
    draws, for one readback a lock-step frame, and the (S, 3) rows of what
    each lane read of its last pose."""
    S, K = uvr.shape[0], uvr.shape[1]
    sets = pnp_sets if pnp_sets is not None else [None] * S
    gens = generators if generators is not None else [None] * S
    probs = [_track_problem(gens[i], matches[i], snapshots[i], uvr[i], K_mat, pnp_iterations, pnp_threshold_px,
                            min_match, sets[i]) for i in range(S)]
    X = torch.stack([p[0] for p in probs for _ in range(2)])
    valid = torch.stack([p[1] for p in probs for _ in range(2)])
    uv = uvr.repeat_interleave(2, dim=0)
    R0 = torch.stack([r for p in probs for r in (p[3], p[5])])
    t0 = torch.stack([t for p in probs for t in (p[4], p[6])])
    # lane i's problem 2i is seeded at its PnP prior, 2i + 1 (the rescue) at
    # its last frame's pose
    res = optimize_pose(R0, t0, PoseObs(X=X, uv=uv, valid=valid), fx, fy, cx, cy, bf,
                        chi2_mono=chi2_mono, chi2_stereo=chi2_stereo, plain=plain)
    rows, reads = [], []
    for i, (_, valid_cur, mp_slot, _, _, R_last_cw, t_last_cw, weak) in enumerate(probs):
        two = slice(2 * i, 2 * i + 2)
        row, read = _track_verdict(matches[i].num_valid(), uvr[i], valid_cur, mp_slot, R_last_cw, t_last_cw,
                                   res.R_cw[two], res.t_cw[two], res.inliers[two], res.n_inliers[two],
                                   min_match, max_jump, weak)
        rows.append(row)
        reads.append(read)
    return torch.stack(rows), torch.stack(reads)


class Tracker:
    """``device`` defaults to the extractor's device, else ``cuda`` (raises
    without CUDA). ``kernels=False`` runs the pose optimizer's plain version
    on any device (the on-card comparison asks for it; the main path never
    does)."""

    def __init__(self, cfg: Configs, camera: Camera, extractor, backend: Optional[Backend] = None,
                 publisher: Optional[Publisher] = None, device: DeviceLike = None, kernels: bool = True):
        if device is None:
            device = getattr(extractor, "device", None)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.camera = camera
        self.extractor = extractor
        self.publisher = publisher or Publisher()
        self.timer = StageTimer()
        self.backend = backend or Backend(
            camera, cfg.backend, cfg.backend_optimization,
            keypoints_per_frame=cfg.superpoint.capacity, device=self.device, kernels=kernels,
            bf16_point_side=cfg.sensor_setup in (SensorSetup.STEREO, SensorSetup.RGBD),
        )
        self.K_mat = torch.as_tensor(np.asarray(camera.intrinsic_matrix(), np.float32), device=self.device)
        self._plain = not kernels
        # the fused frame step (one packed readback a frame) serves
        # extractors whose match stays on the device without a host sync;
        # the oracle keeps the two-program flow
        self._fused = bool(getattr(extractor, "fused_track", False))
        # one generator for this consumer (PnP and two-view samplers),
        # re-seeded by reset_state
        self._gen = torch.Generator(device=self.device)
        self._reset_fields()

    def _reset_fields(self) -> None:
        self._initialized = False
        self._init_bank = None
        self._init_time = None
        self._init_frame_id = None
        self._frame_counter = 0

        # last-frame state
        self._last_pose = np.eye(4, dtype=np.float32)  # T_wc
        self._last_bank = None
        self._last_track = None  # (K,) mappoint ids of last frame
        self._last_uvr = None  # lazily materialized (see _after_track)
        self._last_time = 0.0
        self._last_frame_id = -1
        self._last_track_well = False
        self._num_since_last_keyframe = 0
        self._frames_lost = 0  # all frames that could not be tracked
        self._relocalizations = 0
        self._pose_calls = 0  # optimize_pose calls of this tracker's own flow
        # process_chunk's calls, rows queued, rows consumed, weak rows and
        # rows cut where the carried pose was read and differed from the host's
        self.chunk_stats = dict.fromkeys(("chunks", "rows", "consumed", "weak", "pose_cuts"), 0)
        self.adopted_track = False  # whether the last frame adopted its precomputed_track
        self._lost_count = 0  # consecutive lost frames (relocalization)
        self._reloc_next_attempt = 0  # failed-relocalization backoff (_handle_lost)

        # reference keyframe state
        self._ref_slot = None
        self._ref_bank = None
        self._ref_frame_id = -1
        self._last_keyframe_pose = np.eye(4, dtype=np.float32)
        self._last_keyframe_frame_id = -1
        self._last_keyframe_time = 0.0

        self._gen.manual_seed(self.cfg.runtime.seed + 7)

    def reset_state(self) -> None:
        """Clear all per-sequence state and re-seed every sampler, so a
        reset run reproduces a fresh engine."""
        self.backend.reset_state()
        self._reset_fields()
        if hasattr(self.extractor, "reset_state"):
            self.extractor.reset_state()

    # ------------------------------------------------------------------
    # Device programs
    # ------------------------------------------------------------------

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _optimize(self, R0, t0, obs: PoseObs, rounds: int = 4):
        cam, topt = self.camera, self.cfg.tracking_optimization
        self._pose_calls += 1
        return optimize_pose(
            R0, t0, obs, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            chi2_mono=topt.mono_point, chi2_stereo=topt.stereo_point, rounds=rounds, plain=self._plain,
        )

    @torch.no_grad()
    def _track_kernel(self, X, uvr, valid, R_last_cw, t_last_cw):
        """PnP prior + pose-only refinement on the device. ``uvr``: (K, 3)
        with u_right < 0 for mono rows. Falls back to the last pose when
        the PnP support is too weak: fewer than 6 correspondences leave the
        DLT minimal problem underdetermined, and a non-finite pose must
        never be carried forward."""
        rt = self.cfg.runtime
        pnp = ransac_pnp(
            self._gen, X, uvr[:, :2], valid, self.K_mat,
            iterations=rt.pnp_ransac_iterations, threshold_px=rt.pnp_reprojection_threshold,
        )
        weak = (
            (pnp.n_inliers < self.cfg.keyframe.min_num_match)
            | (torch.sum(valid.to(torch.int32)) < 6)
            | ~torch.all(torch.isfinite(pnp.t_cw))
        )
        R0 = torch.where(weak, R_last_cw, pnp.R_cw)
        t0 = torch.where(weak, t_last_cw, pnp.t_cw)
        return self._optimize(R0, t0, PoseObs(X=X, uv=uvr, valid=valid))

    @torch.no_grad()
    def _track_kernel_nopnp(self, X, uvr, valid, R_last_cw, t_last_cw):
        """Pose-only refinement seeded at the last frame's pose: the rescue
        when the PnP prior teleported the optimizer into a garbage basin
        (see the jump guard in _track_frame)."""
        return self._optimize(R_last_cw, t_last_cw, PoseObs(X=X, uv=uvr, valid=valid))

    @torch.no_grad()
    def _local_map_kernel(self, R_cw, t_cw, mp_pos, mp_desc, mp_valid, bank):
        """Project the local map points, associate them by descriptor and
        refine the pose once more on the expanded set: one round of pose GN
        (Huber on) over the (capacity,) observations, seeded at the tracked
        pose. Returns (LocalMapMatches, PoseOptResult), on the device."""
        cam, lmt = self.camera, self.cfg.local_map_tracking
        mm = search_by_projection(
            R_cw, t_cw, mp_pos, mp_desc, mp_valid, bank,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
            radius_px=lmt.radius_px, min_similarity=lmt.min_similarity, ratio=lmt.ratio,
        )
        idx = torch.clamp(mm.feat_idx, min=0).to(torch.int64)
        uv = torch.cat([bank.kpts[idx], -torch.ones((mp_pos.shape[0], 1), dtype=torch.float32, device=mp_pos.device)], 1)
        return mm, self._optimize(R_cw, t_cw, PoseObs(X=mp_pos, uv=uv, valid=mm.valid), rounds=1)

    def _two_view(self, p1, p2, valid):
        init_cfg = self.cfg.initializer
        return two_view_init(
            self._gen, p1, p2, valid, self.K_mat,
            iterations=init_cfg.ransac_iterations, sigma=init_cfg.sigma,
            min_triangulated=50, min_parallax_deg=init_cfg.min_parallax_deg,
        )

    @torch.no_grad()
    def _fused_init(self, b0, b1) -> torch.Tensor:
        """Fused mono-init attempt: match + two-view epipolar init on the
        device with ONE packed result, [success, R21(9), t21(3), idx1(K),
        mvalid(K), tri(K), X(3K)]. The init-only NN floor
        (``superglue.nn_fallback_min_matches_init``) rescues attempts that
        starve for matches without taxing tracking frames."""
        floor = self.cfg.superglue.nn_fallback_min_matches_init or None
        m = self.extractor.match(b0, b1, True, floor=floor)
        p2 = b1.kpts[torch.clamp(m.idx1, min=0).to(torch.int64)]
        res = self._two_view(b0.kpts, p2, m.valid)
        f32 = torch.float32
        return torch.cat([
            res.success.to(f32)[None],
            res.R21.reshape(-1), res.t21,
            m.idx1.to(f32), m.valid.to(f32),
            res.triangulated.to(f32),
            res.points3d.reshape(-1),
        ])

    def _stereo_gate(self, bank, bank_right, m: Matches):
        """Right x of each left feature whose left-right match passes the
        calibration's disparity band, bf/depth_upper_thr < dx <
        bf/depth_lower_thr, and row gate |dy| <= max_y_diff; -1 elsewhere.
        On the device, without a host sync."""
        cam = self.camera
        ridx = torch.clamp(m.idx1, min=0).to(torch.int64)
        rx = bank_right.kpts[ridx, 0]
        ry = bank_right.kpts[ridx, 1]
        dx = bank.kpts[:, 0] - rx
        dy = torch.abs(bank.kpts[:, 1] - ry)
        ok = m.valid & (dx > cam.bf / cam.depth_upper_thr) & (dx < cam.bf / cam.depth_lower_thr) & (dy <= cam.max_y_diff)
        return torch.where(ok, rx, torch.full_like(rx, -1.0))

    @torch.no_grad()
    def _fused_kernel(self, ref_bank, bank, snapshot: torch.Tensor, bank_right=None):
        """Fused frame step: match-vs-ref + correspondence scatter + PnP
        prior + pose refinement + jump-guard rescue, queued on the device
        with ONE packed f32 result and what it read of the last pose (see
        :func:`fused_track_core`). With ``bank_right`` the left-right match
        and its gate run in the same step and fill the third column of
        ``uvr``."""
        cam, topt, rt, kf = self.camera, self.cfg.tracking_optimization, self.cfg.runtime, self.cfg.keyframe
        K = bank.kpts.shape[0]
        if bank_right is None:
            uvr = torch.cat([bank.kpts, -torch.ones((K, 1), dtype=torch.float32, device=bank.kpts.device)], dim=1)
        else:
            with self.timer.span("match"):
                m_lr = self.extractor.match(bank, bank_right, True)
            uvr = torch.cat([bank.kpts, self._stereo_gate(bank, bank_right, m_lr)[:, None]], dim=1)
        with self.timer.span("match"):
            m = self.extractor.match(ref_bank, bank, True)
        self._pose_calls += 1
        return fused_track_core(
            self._gen, m, uvr, snapshot, self.K_mat,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            topt.mono_point, topt.stereo_point,
            rt.pnp_ransac_iterations, rt.pnp_reprojection_threshold,
            kf.min_num_match, 4.0 * kf.max_distance, plain=self._plain,
        )

    # ------------------------------------------------------------------

    def process(self, bank, timestamp: float, depth_lookup=None, bank_right=None,
                precomputed_match=None, precomputed_track=None) -> Optional[np.ndarray]:
        """One frame. ``bank``: FeatureBank (already extracted);
        ``bank_right``: the right image's FeatureBank (stereo);
        ``depth_lookup``: keypoints (K, 2) -> metric depth (K,), <= 0 where
        unknown (RGB-D). ``precomputed_match``: the Matches (reference or
        init bank -> ``bank``) that a batching caller already computed
        (``parallel/multi_seq.py``); it replaces the first match of the
        frame and takes the two-program flow. ``precomputed_track``: that
        caller's fused-step row for this frame, parsed
        (:meth:`parse_fused_packed`); adopted unless tracking was weak, when
        the frame falls through to the two-program flow. Returns the 4x4
        keyframe pose when a keyframe was inserted, else None."""
        frame_id = self._frame_counter
        self._frame_counter += 1
        self.adopted_track = False

        if not self._initialized:
            if bank_right is not None:
                return self._init_stereo(bank, self._stereo_uvr(bank, bank_right), timestamp, frame_id)
            return self._try_initialize(bank, timestamp, frame_id, depth_lookup, precomputed_match=precomputed_match)

        min_match = self.cfg.keyframe.min_num_match
        uvr = None  # the fused step RETURNS uvr in its packed output

        if precomputed_track is not None:
            # the caller ran the fused core for this lane: adopt its result,
            # unless tracking was weak (the promote / lost ladder below)
            num_match, num_inliers, pose, frame_track, p_uvr = precomputed_track
            if num_match >= min_match and num_inliers >= min_match:
                self.adopted_track = True
                ref_frame_id = self._ref_frame_id
                if self.cfg.local_map_tracking.enabled:
                    with self.timer.span("local_map"):
                        pose, frame_track, num_inliers = self._track_local_map(bank, pose, frame_track, num_inliers)
                return self._finish_tracked_frame(bank, p_uvr, pose, frame_track, num_inliers, timestamp, frame_id,
                                                  ref_frame_id, depth_lookup)

        # without a baseline there is no disparity gate: stereo then takes
        # the two-program flow, as in the JAX package; so does a frame of
        # local-map tracking (its init attempts stay fused) and one whose
        # match was precomputed
        if (self._fused and not self.cfg.local_map_tracking.enabled and (bank_right is None or self.camera.bf > 0)
                and precomputed_match is None):
            num_match, num_inliers, pose, frame_track, uvr = self._track_frame_fused(bank, bank_right)
            if num_match < min_match:
                promoted = self._promote_last_frame(timestamp)
                if promoted is None:
                    return self._handle_lost(bank, timestamp, frame_id, depth_lookup, uvr=uvr)
                num_match, num_inliers, pose, frame_track, uvr = self._track_frame_fused(bank, bank_right)
            elif num_inliers < min_match:
                promoted = self._promote_last_frame(timestamp)
                if promoted is not None:
                    num_match, num_inliers, pose, frame_track, uvr = self._track_frame_fused(bank, bank_right)
            ref_frame_id = self._ref_frame_id
        else:
            uvr = self._stereo_uvr(bank, bank_right)
            with self.timer.span("match"):
                matches = precomputed_match if precomputed_match is not None else self.extractor.match(self._ref_bank, bank)
                num_match = int(matches.num_valid())

            ref_track = self.backend.store.kf_track[self._ref_slot]
            ref_frame_id = self._ref_frame_id

            if num_match < min_match:
                promoted = self._promote_last_frame(timestamp)
                if promoted is None:
                    return self._handle_lost(bank, timestamp, frame_id, depth_lookup, uvr=uvr)
                ref_track = self.backend.store.kf_track[self._ref_slot]
                ref_frame_id = self._ref_frame_id
                matches = self.extractor.match(self._ref_bank, bank)
                num_inliers, pose, frame_track = self._track_frame(bank, uvr, ref_track, matches)
            else:
                num_inliers, pose, frame_track = self._track_frame(bank, uvr, ref_track, matches)
                if num_inliers < min_match:
                    promoted = self._promote_last_frame(timestamp)
                    if promoted is not None:
                        ref_track = self.backend.store.kf_track[self._ref_slot]
                        ref_frame_id = self._ref_frame_id
                        matches = self.extractor.match(self._ref_bank, bank)
                        num_inliers, pose, frame_track = self._track_frame(bank, uvr, ref_track, matches)

        if num_inliers < min_match:
            return self._handle_lost(bank, timestamp, frame_id, depth_lookup, uvr=uvr)

        if self.cfg.local_map_tracking.enabled:
            with self.timer.span("local_map"):
                pose, frame_track, num_inliers = self._track_local_map(bank, pose, frame_track, num_inliers)

        return self._finish_tracked_frame(bank, uvr, pose, frame_track, num_inliers, timestamp, frame_id, ref_frame_id,
                                          depth_lookup)

    def _finish_tracked_frame(self, bank, uvr, pose, frame_track, num_inliers, timestamp, frame_id, ref_frame_id,
                              depth_lookup=None):
        """Shared tail of a successfully tracked frame: keyframe decision
        + insertion, publishing, last-frame bookkeeping."""
        pose_out = None
        # keyframe decision, only when the ref keyframe is still the
        # latest keyframe
        if self._add_keyframe_decision(pose, num_inliers, frame_id) and (
            ref_frame_id == self._last_keyframe_frame_id
        ):
            pose_out = self._insert_keyframe(bank, uvr, pose, frame_track, timestamp, frame_id,
                                             depth_lookup=depth_lookup)

        # BA may have refined the pose of a just-inserted keyframe; carry
        # the optimized one forward
        final_pose = pose_out if pose_out is not None else pose
        self._publish_tracked(final_pose, timestamp, pose_out is not None)
        self._after_track(bank, final_pose, timestamp, frame_id, track_well=True, track=frame_track, uvr=uvr)
        return pose_out

    def _publish_tracked(self, final_pose, timestamp, is_keyframe: bool) -> None:
        self.publisher.publish_frame_pose(FramePoseMessage(time=timestamp, pose=final_pose))
        if is_keyframe:
            st = self.backend.store
            if self.publisher.has_listeners("keyframe"):
                slots = st.keyframe_slots()
                n = len(slots)
                poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
                poses[:, :3, :3] = st.kf_R[slots]
                poses[:, :3, 3] = st.kf_t[slots]
                self.publisher.publish_keyframe(
                    KeyframeMessage(ids=st.kf_frame_id[slots].tolist(), poses=list(poses)))
            if self.publisher.has_listeners("map"):
                good = st.mp_good & ~st.mp_bad
                self.publisher.publish_map(MapMessage(ids=np.nonzero(good)[0], points=st.mp_pos[good]))

    # ------------------------------------------------------------------
    # Multi-frame chunk tracking: the device work of up to C frames queued
    # at once, one packed readback, the host replaying the rows
    # ------------------------------------------------------------------

    def chunk_available(self, stereo: bool = False) -> bool:
        """Whether :meth:`process_chunk` can take the next frames: a neural
        extractor (whose match stays on the device), an initialized tracker
        with a reference bank, local-map tracking off (the chunk has no
        local-map step) and no resolution buckets (the chunk extracts at
        the base size). ``stereo`` also asks for a baseline: without one
        the per-frame path takes the two-program flow."""
        return (
            self._fused
            and self._initialized
            and self._ref_bank is not None
            and not self.cfg.local_map_tracking.enabled
            and getattr(self.extractor, "_buckets", None) is None
            and (not stereo or self.camera.bf > 0)
        )

    @torch.no_grad()
    def process_chunk(self, images, timestamps, depth_lookups=None, n_valid=None, images_right=None):
        """Track up to C frames with ONE readback.

        ``images``: (C, H, W) uint8; the first ``n_valid`` are real (the
        tail may be padding); ``images_right``: the right images (stereo);
        ``depth_lookups``: one per frame (RGB-D). Every real frame's
        extraction, match and fused track step (:meth:`_fused_kernel`, the
        per-frame path's own) is queued on the device, each row seeded at
        the last row's pose, carried on the device through the host's
        float32 round trip (T_wc, then its R_cw, t_cw); then one readback,
        and the host replays the rows in order through the per-frame tail
        (:meth:`_finish_tracked_frame`) up to the cut:

        - a keyframe row is consumed and ends the chunk (the map changed);
        - a weak row (too few matches or inliers, or a non-finite pose) is
          not consumed: its bank is handed back for the per-frame retry
          (whose promote-keyframe recovery is host logic);
        - a row that read the carried pose (a weak PnP prior seeds at it,
          the rescue took over, or the jump guard's margin is within
          rounding) where that pose differs in any bit from the host's is
          not consumed either: the next call starts there from the host's
          state.

        Both samplers (the tracker's and the extractor's) are then set to
        their state before the first row not consumed, so the rest of the
        run draws what the per-frame path draws: a consumed row is the
        per-frame path's frame bit for bit. Returns ``(results, consumed,
        weak_bank)``: the keyframe pose (or None) of each consumed frame,
        how many were consumed, and the weak row's bank or None."""
        C = int(images.shape[0])
        n_valid = C if n_valid is None else int(n_valid)
        stereo = images_right is not None
        if not self.chunk_available(stereo):
            raise ValueError("process_chunk: the chunk path is not available (see chunk_available)")
        K = self.cfg.superpoint.capacity
        min_match = self.cfg.keyframe.min_num_match
        max_jump = 4.0 * self.cfg.keyframe.max_distance
        ext = self.extractor
        snap0 = self._upload(self.fused_snapshot())
        R_last, t_last = snap0[0:9, 5].reshape(3, 3), snap0[9:12, 5]
        banks, rows, states = [], [], []
        with self.timer.span("track"):
            for j in range(n_valid):
                states.append((self._gen.get_state(), ext._gen.get_state()))
                bank = ext.extract(images[j])
                bank_right = ext.extract(images_right[j], right=True) if stereo else None
                posecol = torch.cat([R_last.reshape(-1), t_last, snap0.new_zeros(K - 12)])
                packed, read = self._fused_kernel(self._ref_bank, bank, torch.cat([snap0[:, :5], posecol[:, None]], 1),
                                                  bank_right)
                banks.append(bank)
                rows.append(torch.cat([packed, posecol[:12], read]))
                well = (packed[0] >= min_match) & (packed[1] >= min_match)
                R_cw = packed[2:11].reshape(3, 3)
                R_last = torch.where(well, R_cw, R_last)
                t_last = torch.where(well, mv(-R_cw, mv(-R_cw.transpose(0, 1), packed[11:14])), t_last)
            states.append((self._gen.get_state(), ext._gen.get_state()))
            outs = torch.stack(rows).cpu().numpy()  # ONE readback for the chunk
        results, consumed, weak_bank = [], 0, None
        for j in range(n_valid):
            row, used, (prior_weak, rescued, jump) = outs[j, : 14 + 4 * K], outs[j, 14 + 4 * K : -3], outs[j, -3:]
            num_match, n_inl = int(row[0]), int(row[1])
            if num_match < min_match or n_inl < min_match or not np.all(np.isfinite(row[2:14])):
                weak_bank = banks[j]
                break
            last = self.fused_snapshot_pose()
            if not np.array_equal(used.view(np.uint32), last.view(np.uint32)):
                # the row's bits depend on the carried pose where the prior
                # or the rescue start from it, or where its ulps could move
                # the jump guard's verdict
                margin = 1e-5 * (1.0 + max_jump + float(np.abs(self._last_pose[:3, 3]).sum()))
                if prior_weak > 0.5 or rescued > 0.5 or not abs(jump - max_jump) > margin:
                    self.chunk_stats["pose_cuts"] += 1
                    break
            _, _, pose, frame_track, uvr = self.parse_fused_packed(row)
            self.adopted_track = False
            fid = self._frame_counter
            self._frame_counter += 1
            pose_out = self._finish_tracked_frame(banks[j], uvr, pose, frame_track, n_inl, timestamps[j], fid,
                                                  self._ref_frame_id,
                                                  depth_lookups[j] if depth_lookups is not None else None)
            results.append(pose_out)
            consumed += 1
            if pose_out is not None:
                break  # a keyframe changed the map: the next chunk starts from it
        if consumed < n_valid:
            self._gen.set_state(states[consumed][0])
            ext._gen.set_state(states[consumed][1])
        for k, v in (("chunks", 1), ("rows", n_valid), ("consumed", consumed), ("weak", weak_bank is not None)):
            self.chunk_stats[k] += int(v)
        return results, consumed, weak_bank

    def adopt_map(self) -> None:
        """Enter localization mode against the backend's current map
        (typically one loaded from a snapshot): the tracker starts
        initialized with the newest stored keyframe as its reference, its
        feature bank rebuilt from the store's descriptor banks, and
        relocalization pre-armed, so the first frame either tracks against
        that keyframe (resume) or re-anchors anywhere in the map through
        ``Backend.relocalize``."""
        st = self.backend.store
        slots = st.keyframe_slots()
        if len(slots) == 0:
            raise ValueError("adopt_map: the map has no keyframes")
        newest = int(slots[np.argmax(st.kf_frame_id[slots])])
        bank_np = st.kf_desc.get(newest)
        if bank_np is None:
            raise ValueError("adopt_map: map was stored without descriptor banks")
        desc = bank_np.astype(np.float32)
        valid = np.linalg.norm(desc, axis=1) > 0.5  # unit rows = real features
        # the persisted detection scores where there are some: SuperGlue's
        # keypoint encoder saw small probabilities in training, so all-ones
        # would be out of distribution
        sc = st.kf_scores.get(newest)
        scores = (sc.astype(np.float32) * valid) if sc is not None else valid.astype(np.float32)
        self._ref_bank = FeatureBank(
            scores=self._upload(scores),
            kpts=self._upload(st.kf_kpts[newest, :, :2].astype(np.float32)),
            desc=self._upload(desc),
            valid=self._upload(valid),
        )
        self._ref_slot = newest
        self._ref_frame_id = int(st.kf_frame_id[newest])
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = st.kf_R[newest]
        pose[:3, 3] = st.kf_t[newest]
        self._last_keyframe_pose = pose
        self._last_keyframe_frame_id = self._ref_frame_id
        self._last_keyframe_time = float(st.kf_timestamp[newest])
        self._last_pose = pose.copy()
        self._last_track_well = False
        # new frame ids must not collide with the stored sessions'
        self._frame_counter = int(st.kf_frame_id[slots].max()) + 1
        # pre-arm relocalization: a view that cannot be tracked against the
        # newest keyframe re-anchors on the FIRST lost frame
        self._lost_count = max(0, self.cfg.backend.reloc_after_failures - 1)
        self._initialized = True

    def _mono_uvr(self, bank) -> np.ndarray:
        """(K, 3) per-feature [u, v, -1] on the host."""
        kpts = bank.kpts.cpu().numpy()
        return np.concatenate([kpts, -np.ones((bank.capacity, 1), np.float32)], axis=1)

    def _stereo_uvr(self, bank, bank_right) -> np.ndarray:
        """(K, 3) per-left-feature [u, v, u_right] on the host; u_right = -1
        where no left-right match passes the disparity and row gates
        (:meth:`_stereo_gate`). Without ``bank_right``, :meth:`_mono_uvr`."""
        if bank_right is None:
            return self._mono_uvr(bank)
        m = self.extractor.match(bank, bank_right)
        return torch.cat([bank.kpts, self._stereo_gate(bank, bank_right, m)[:, None]], dim=1).cpu().numpy()

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------

    def _init_stereo(self, bank, uvr, timestamp, frame_id) -> Optional[np.ndarray]:
        """Single-frame stereo initialization: needs >= 150 features and
        >= 100 gated stereo points; the keyframe insertion seeds every
        stereo point as a map point from its disparity."""
        valid = bank.valid.cpu().numpy()
        if valid.sum() < 150:
            return None
        if (valid & (uvr[:, 2] > 0)).sum() < 100:
            return None
        pose = np.eye(4, dtype=np.float32)
        self._insert_keyframe(bank, uvr, pose, np.full(bank.capacity, -1, np.int32), timestamp, frame_id)
        self._initialized = True
        st = self.backend.store
        frame_track = st.kf_track[st.frame_id_to_slot[frame_id]].copy()
        self._after_track(bank, pose, timestamp, frame_id, track_well=True, track=frame_track, uvr=uvr)
        self._num_since_last_keyframe = 0
        return pose

    def _init_rgbd(self, bank, timestamp, frame_id, depth_lookup) -> Optional[np.ndarray]:
        """Single-frame RGB-D initialization: needs >= 250 features and
        >= 100 of them with a depth inside the camera's band; those become
        map points at their back-projected depth."""
        if int(bank.num_valid()) < 250:
            return None
        kpts, valid, desc, scores = self._materialize_bank(bank)
        d = depth_lookup(kpts)  # (K,) metric depth, <= 0 unknown
        good = valid & (d > self.camera.depth_lower_thr) & (d < self.camera.depth_upper_thr)
        if good.sum() < 100:
            return None
        K = bank.capacity
        cam = self.camera
        st = self.backend.store
        uvr = np.concatenate([kpts, -np.ones((K, 1), np.float32)], axis=1)
        slot = st.alloc_keyframe(frame_id, timestamp, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), uvr, valid,
                                 desc=desc, scores=scores)
        rays = np.stack([(kpts[:, 0] - cam.cx) / cam.fx, (kpts[:, 1] - cam.cy) / cam.fy, np.ones(K, np.float32)], axis=1)
        Xw = rays * d[:, None]
        mp_ids = st.alloc_mappoints(int(good.sum()))
        st.mp_pos[mp_ids] = Xw[good]
        st.mp_good[mp_ids] = True
        st.add_observations(slot, mp_ids, np.nonzero(good)[0])
        st.snapshot_keyframe_geometry(slot)
        # representative descriptors for the init-born map points
        st.update_descriptors(mp_ids)

        frame_track = np.full(K, -1, np.int32)
        frame_track[np.nonzero(good)[0]] = mp_ids
        pose = np.eye(4, dtype=np.float32)
        self._initialized = True
        self._ref_slot = slot
        self._ref_bank = bank
        self._ref_frame_id = frame_id
        self._last_keyframe_pose = pose
        self._last_keyframe_frame_id = frame_id
        self._last_keyframe_time = timestamp
        self._after_track(bank, pose, timestamp, frame_id, track_well=True, track=frame_track)
        self._num_since_last_keyframe = 0
        return pose

    def _try_initialize(self, bank, timestamp, frame_id, depth_lookup=None,
                        precomputed_match=None) -> Optional[np.ndarray]:
        """Two-view mono initialization against the held init bank (or the
        single-frame RGB-D one). ``precomputed_match`` (init bank ->
        ``bank``) replaces the attempt's match and skips the fused init."""
        if depth_lookup is not None:
            return self._init_rgbd(bank, timestamp, frame_id, depth_lookup)
        n_feat = int(bank.num_valid())
        init_cfg = self.cfg.initializer

        if self._init_bank is None:
            if n_feat < init_cfg.min_features_first:
                return None
            self._init_bank = bank
            self._init_time = timestamp
            self._init_frame_id = frame_id
            return None

        if timestamp - self._init_time > init_cfg.reseed_time:
            # re-seed
            if n_feat < 300:
                self._init_bank = None
                return None
            self._init_bank = bank
            self._init_time = timestamp
            self._init_frame_id = frame_id
            return None

        K = bank.capacity
        if self._fused and precomputed_match is None:
            # ONE packed readback per init attempt
            flat = self._fused_init(self._init_bank, bank).cpu().numpy()
            success = flat[0] > 0.5
            R21 = flat[1:10].reshape(3, 3)
            t21 = flat[10:13]
            idx1 = flat[13 : 13 + K].astype(np.int32)
            tri = flat[13 + 2 * K : 13 + 3 * K] > 0.5
            X = flat[13 + 3 * K :].reshape(K, 3)
            # the banks are read only on success; until then nothing else
            # crosses the link
            if not success or int(tri.sum()) < init_cfg.min_matches:
                return None
            kpts0, valid0, desc0, scores0 = self._materialize_bank(self._init_bank)
            kpts1, valid1b, desc1, scores1 = self._materialize_bank(bank)
            p1 = kpts0
        else:
            matches = precomputed_match if precomputed_match is not None else self.extractor.match(self._init_bank, bank)
            idx1 = matches.idx1.cpu().numpy()
            p1, valid0, desc0, scores0 = self._materialize_bank(self._init_bank)
            kpts1, valid1b, desc1, scores1 = self._materialize_bank(bank)
            p2 = kpts1[np.maximum(idx1, 0)]
            with torch.no_grad():
                res = self._two_view(self._upload(p1), self._upload(p2), matches.valid)
            tri = res.triangulated.cpu().numpy()
            if not bool(res.success) or int(tri.sum()) < init_cfg.min_matches:
                return None
            X = res.points3d.cpu().numpy()
            R21 = res.R21.cpu().numpy()
            t21 = res.t21.cpu().numpy()

        # scale = median_depth_scale / median depth
        depths = np.sort(X[tri][:, 2])
        med = depths[(len(depths) - 1) // 2]
        scale = float(init_cfg.median_depth_scale) / max(med, 1e-6)
        Xw = X * scale  # world == first camera frame
        t21 = t21 * scale
        # T_wc2 = inv(T21) since world == cam1
        R_wc2 = R21.T
        t_wc2 = -R21.T @ t21

        st = self.backend.store
        # first keyframe (identity, fixed). Keypoint slots are valid for
        # ALL detected features (observations reference a subset; other
        # slots stay available for later association).
        uvr1 = np.concatenate([p1, -np.ones((K, 1), np.float32)], axis=1)
        slot0 = st.alloc_keyframe(self._init_frame_id, self._init_time, np.eye(3, dtype=np.float32),
                                  np.zeros(3, np.float32), uvr1, valid0, desc=desc0, scores=scores0)
        mp_ids = st.alloc_mappoints(int(tri.sum()))
        st.mp_pos[mp_ids] = Xw[tri]
        st.mp_good[mp_ids] = True
        st.add_observations(slot0, mp_ids, np.nonzero(tri)[0])
        st.snapshot_keyframe_geometry(slot0)

        # second keyframe
        uvr2 = np.concatenate([kpts1, -np.ones((K, 1), np.float32)], axis=1)
        slot1 = st.alloc_keyframe(frame_id, timestamp, R_wc2.astype(np.float32), t_wc2.astype(np.float32), uvr2,
                                  valid1b, desc=desc1, scores=scores1)
        # observed feature slots in frame2 are idx1 of the matched slots
        feat2 = idx1[np.nonzero(tri)[0]]
        st.add_observations(slot1, mp_ids, feat2)
        st.snapshot_keyframe_geometry(slot1)
        # representative descriptors for the init-born mappoints
        st.update_descriptors(mp_ids)

        # frame track table for the new frame
        frame_track = np.full(K, -1, np.int32)
        frame_track[feat2] = mp_ids

        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = R_wc2
        pose[:3, 3] = t_wc2

        self._initialized = True
        self._ref_slot = slot1
        self._ref_bank = bank
        self._ref_frame_id = frame_id
        self._last_keyframe_pose = pose
        self._last_keyframe_frame_id = frame_id
        self._last_keyframe_time = timestamp
        self._after_track(bank, pose, timestamp, frame_id, track_well=True, track=frame_track)
        self._num_since_last_keyframe = 0
        return pose

    # ------------------------------------------------------------------
    # Tracking
    # ------------------------------------------------------------------

    def _track_frame(self, bank, uvr, ref_track: np.ndarray, matches: Matches):
        """Two-program flow: host-side candidate gather, then the track
        program and, when the pose jumped, the rescue program."""
        st = self.backend.store
        idx1 = matches.idx1.cpu().numpy()
        mvalid = matches.valid.cpu().numpy()
        K = idx1.shape[0]
        min_match = self.cfg.keyframe.min_num_match

        # candidate mappoints via the reference keyframe's track table.
        # LIVE ids (untriangulated included) propagate so points can
        # accumulate observers and triangulate at later keyframes; only
        # triangulated (Good) ones become 3D constraints for the pose solve.
        cand_mp = np.where(mvalid, ref_track, -1)
        safe = np.maximum(cand_mp, 0)
        cand_live = mvalid & (cand_mp >= 0) & ~st.mp_bad[safe]
        cand_ok = cand_live & st.mp_good[safe]

        # per-current-frame-slot correspondence arrays
        packed = np.zeros((K, 7), np.float32)  # [X | uvr | valid]
        packed[:, 5] = -1.0
        mp_of_slot = np.full(K, -1, np.int32)
        src_live = np.nonzero(cand_live)[0]
        mp_of_slot[idx1[src_live]] = cand_mp[src_live]
        src = np.nonzero(cand_ok)[0]
        dst = idx1[src]
        packed[dst, 0:3] = st.mp_pos[cand_mp[src]]
        packed[dst, 3:6] = uvr[dst]
        packed[dst, 6] = 1.0
        valid = packed[:, 6] > 0.5

        R_last_cw = self._last_pose[:3, :3].T
        t_last_cw = -R_last_cw @ self._last_pose[:3, 3]
        last = np.zeros(12, np.float32)
        last[:9] = R_last_cw.reshape(-1)
        last[9:] = t_last_cw

        def run(kernel):
            """One packed upload, one packed readback."""
            flat = self._upload(np.concatenate([packed.reshape(-1), last]))
            p = flat[: 7 * K].reshape(K, 7)
            res = kernel(p[:, 0:3], p[:, 3:6], p[:, 6] > 0.5,
                         flat[7 * K : 7 * K + 9].reshape(3, 3), flat[7 * K + 9 :])
            out = torch.cat([res.n_inliers.to(torch.float32)[None], res.R_cw.reshape(-1), res.t_cw,
                             res.inliers.to(torch.float32)]).cpu().numpy()
            R_cw, t_cw = out[1:10].reshape(3, 3), out[10:13]
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = R_cw.T
            pose[:3, 3] = -R_cw.T @ t_cw
            return int(out[0]), pose, out[13:] > 0.5

        with self.timer.span("track"):
            n_inl, pose, inl = run(self._track_kernel)
        if n_inl >= min_match:
            # Pose-jump guard. With very permissive inlier gates a couple
            # of wrong correspondences can teleport the PnP prior, and the
            # pose optimizer then polishes a garbage basin. Declaring a
            # hard tracking failure here is worse than the disease (the
            # promote-keyframe recovery inserts a keyframe at a
            # weak-geometry moment and corrupts the map); instead re-refine
            # seeded at the last frame's pose (genuine motion survives the
            # re-refinement, a teleport does not) and only fail if the
            # rescue also jumps.
            max_jump = 4.0 * self.cfg.keyframe.max_distance
            jump = float(np.linalg.norm(pose[:3, 3] - self._last_pose[:3, 3]))
            if not np.isfinite(jump) or jump > max_jump:
                n2, pose2, inl2 = run(self._track_kernel_nopnp)
                jump2 = float(np.linalg.norm(pose2[:3, 3] - self._last_pose[:3, 3]))
                if np.isfinite(jump2) and jump2 <= max_jump and n2 >= min_match:
                    n_inl, pose, inl = n2, pose2, inl2
                else:
                    n_inl = 0
                    pose = self._last_pose.copy()
                    inl = np.zeros(K, bool)
        else:
            pose = self._last_pose.copy()
            inl = np.zeros(K, bool)

        # chi2 classification applies only to 3D-constrained slots;
        # matched untriangulated ids survive
        track_ok = np.where(valid, inl, mp_of_slot >= 0)
        if n_inl < min_match:
            track_ok[:] = False
        frame_track = np.where(track_ok, mp_of_slot, -1).astype(np.int32)
        return n_inl, pose, frame_track

    def _track_local_map(self, bank, pose, frame_track, num_inliers):
        """Associate the covisibility window's map points with this frame by
        projection and refine the pose on the expanded set; the new pose is
        kept only when the inliers grow, and the new associations fill the
        frame's track where it has none. One packed upload, one packed
        readback."""
        st = self.backend.store
        if st.mp_desc is None or self._ref_slot is None:
            return pose, frame_track, num_inliers
        window = st.window_frames(self._ref_slot, self.cfg.backend.window_opt_frames)
        tracks = st.kf_track[window]
        mp_ids = np.unique(tracks[tracks >= 0])
        mp_ids = mp_ids[st.mp_good[mp_ids] & ~st.mp_bad[mp_ids]]
        cap = bank.capacity
        if len(mp_ids) == 0:
            return pose, frame_track, num_inliers
        mp_ids = mp_ids[:cap]
        D = st.cfg.descriptor_dim
        n = len(mp_ids)
        # [R_cw (9) | t_cw (3) | pos (3 cap) | desc (D cap) | valid (cap)]
        packed = np.zeros(12 + cap * (4 + D), np.float32)
        R_cw = pose[:3, :3].T
        packed[0:9] = R_cw.reshape(-1)
        packed[9:12] = -R_cw @ pose[:3, 3]
        o = 12
        packed[o : o + 3 * n] = st.mp_pos[mp_ids].reshape(-1)
        o += 3 * cap
        packed[o : o + D * n] = st.mp_desc[mp_ids].astype(np.float32).reshape(-1)
        o += D * cap
        packed[o : o + n] = 1.0
        flat = self._upload(packed)
        matches, res = self._local_map_kernel(
            flat[0:9].reshape(3, 3), flat[9:12], flat[12 : 12 + 3 * cap].reshape(cap, 3),
            flat[12 + 3 * cap : o].reshape(cap, D), flat[o:] > 0.5, bank,
        )
        out = torch.cat([
            res.n_inliers.to(torch.float32)[None], res.R_cw.reshape(-1), res.t_cw,
            matches.feat_idx.to(torch.float32), (matches.valid & res.inliers).to(torch.float32),
        ]).cpu().numpy()
        n_inl = int(out[0])
        if n_inl <= num_inliers:
            return pose, frame_track, num_inliers
        R_cw2, t_cw2 = out[1:10].reshape(3, 3), out[10:13]
        new_pose = np.eye(4, dtype=np.float32)
        new_pose[:3, :3] = R_cw2.T
        new_pose[:3, 3] = -R_cw2.T @ t_cw2
        # extend the frame's track table with the new associations
        feat_idx = out[13 : 13 + cap].astype(np.int32)
        ok = out[13 + cap :] > 0.5
        new_track = frame_track.copy()
        sel = np.nonzero(ok[:n])[0]
        slots = feat_idx[sel]
        fresh = new_track[slots] < 0
        new_track[slots[fresh]] = mp_ids[sel[fresh]]
        return new_pose, new_track, n_inl

    def fused_snapshot(self) -> np.ndarray:
        """(K, 6) f32 host-side input of the fused frame step: candidate
        mappoint positions/flags/track ids for the reference keyframe +
        the last pose (numpy gathers over the store)."""
        st = self.backend.store
        ref_track = st.kf_track[self._ref_slot]
        safe = np.maximum(ref_track, 0)
        live = (ref_track >= 0) & ~st.mp_bad[safe]
        ok = live & st.mp_good[safe]
        K = ref_track.shape[0]
        snap = np.zeros((K, 6), np.float32)
        snap[:, 0:3] = st.mp_pos[safe]
        # 2 = triangulated candidate (3D usable), 1 = live id to carry
        # forward (untriangulated), 0 = none — see fused_track_core
        snap[:, 3] = live.astype(np.float32) + ok.astype(np.float32)
        snap[:, 4] = ref_track
        snap[0:12, 5] = self.fused_snapshot_pose()
        return snap

    def fused_snapshot_pose(self) -> np.ndarray:
        """The last pose as the fused step takes it: [R_cw (9), t_cw (3)],
        f32, from the host's T_wc."""
        R_last_cw = self._last_pose[:3, :3].T
        return np.concatenate([R_last_cw.reshape(-1), -R_last_cw @ self._last_pose[:3, 3]]).astype(np.float32)

    def parse_fused_packed(self, arr: np.ndarray):
        """Decode a fused-step packed vector (host array) into
        (num_match, n_inliers, pose T_wc, frame_track, uvr), applying the
        weak-tracking fallback to the last pose (_track_frame semantics)."""
        K = self.cfg.superpoint.capacity
        num_match = int(arr[0])
        n_inl = int(arr[1])
        uvr = arr[14 + K : 14 + 4 * K].reshape(K, 3)
        if n_inl >= self.cfg.keyframe.min_num_match and np.all(np.isfinite(arr[2:14])):
            R_cw = arr[2:11].reshape(3, 3)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = R_cw.T
            pose[:3, 3] = -R_cw.T @ arr[11:14]
            frame_track = arr[14 : 14 + K].astype(np.int32)
        else:
            pose = self._last_pose.copy()
            frame_track = np.full(K, -1, np.int32)
        return num_match, n_inl, pose, frame_track, uvr

    def _track_frame_fused(self, bank, bank_right=None):
        """Host half of the fused frame step: ONE packed upload, ONE packed
        readback (see fused_snapshot/parse_fused_packed)."""
        snap = self._upload(self.fused_snapshot())
        with self.timer.span("track"):
            arr = self._fused_kernel(self._ref_bank, bank, snap, bank_right)[0].cpu().numpy()
        return self.parse_fused_packed(arr)

    def _promote_last_frame(self, timestamp):
        """Tracking-loss fallback: make the last frame a keyframe."""
        if self._num_since_last_keyframe < 1 or not self._last_track_well or self._last_bank is None:
            return None
        return self._insert_keyframe(
            self._last_bank, self._last_uvr, self._last_pose, self._last_track,
            self._last_time, self._last_frame_id, set_ref=True,
        )

    def _add_keyframe_decision(self, pose, num_match, frame_id) -> bool:
        kf = self.cfg.keyframe
        last = self._last_keyframe_pose
        dR = last[:3, :3].T @ pose[:3, :3]
        # host-side 3x3 angle: no launch and readback for this
        angle = float(np.arccos(np.clip((np.trace(dR) - 1.0) * 0.5, -1.0, 1.0)))
        dist = float(np.linalg.norm(pose[:3, 3] - last[:3, 3]))
        passed = frame_id - self._last_keyframe_frame_id
        return (
            num_match < kf.max_num_match
            or angle > kf.max_angle
            or dist > kf.max_distance
            or passed >= kf.max_num_passed_frame
        )

    def _materialize_bank(self, bank):
        """(kpts, valid, desc, scores) as host arrays from ONE packed
        device transfer. Scores ride along so keyframes persist them."""
        K = bank.capacity
        D = bank.desc.shape[-1]
        arr = torch.cat([
            bank.kpts.reshape(-1).to(torch.float32),
            bank.valid.to(torch.float32),
            bank.desc.reshape(-1).to(torch.float32),
            bank.scores.to(torch.float32),
        ]).cpu().numpy()
        kpts = arr[: 2 * K].reshape(K, 2)
        valid = arr[2 * K : 3 * K] > 0.5
        desc = arr[3 * K : 3 * K + K * D].reshape(K, D)
        scores = arr[3 * K + K * D :]
        return kpts, valid, desc, scores

    def _insert_keyframe(self, bank, uvr, pose, frame_track, timestamp, frame_id, set_ref=True, materialized=None,
                         depth_lookup=None):
        """Insert a keyframe, then look for a loop from it.
        ``materialized``: the bank's ``(kpts, valid, desc, scores)`` when
        the caller already read it back (relocalization); ``depth_lookup``
        seeds its new map points from depth (RGB-D)."""
        st = self.backend.store
        if frame_id in st.frame_id_to_slot:
            return None
        K = bank.capacity
        kpts, valid, desc_h, scores_h = materialized if materialized is not None else self._materialize_bank(bank)
        if uvr is None:
            uvr = np.concatenate([kpts, -np.ones((K, 1), np.float32)], axis=1)
        depth = depth_lookup(kpts) if depth_lookup is not None else None
        track = frame_track if frame_track is not None else np.full(K, -1, np.int32)
        with self.timer.span("keyframe_ba"):
            slot, (R_opt, t_opt) = self.backend.insert_keyframe(
                frame_id, timestamp, pose[:3, :3], pose[:3, 3], uvr, valid, track, depth,
                desc=desc_h, scores=scores_h,
            )
        if self.cfg.backend.loop_closure:
            with self.timer.span("loop_detect"):
                self.backend.detect_loop(slot, desc_h, kpts, valid)
        opt_pose = np.eye(4, dtype=np.float32)
        opt_pose[:3, :3] = R_opt
        opt_pose[:3, 3] = t_opt
        if set_ref:
            self._ref_slot = slot
            self._ref_bank = bank
            self._ref_frame_id = frame_id
            self._last_keyframe_pose = opt_pose
            self._last_keyframe_frame_id = frame_id
            self._last_keyframe_time = timestamp
            self._num_since_last_keyframe = 0
        return opt_pose

    def _after_track(self, bank, pose, timestamp, frame_id, track_well, track=None, uvr=None):
        if pose is not None:
            self._last_pose = pose
        self._last_bank = bank
        self._last_track = track if track is not None else np.full(bank.capacity, -1, np.int32)
        # uvr may stay None: only the promote-fallback / keyframe paths
        # consume it, and they build it from the bank then
        self._last_uvr = uvr
        self._last_time = timestamp
        self._last_frame_id = frame_id
        self._last_track_well = track_well
        self._num_since_last_keyframe += 1
        if track_well:
            self._lost_count = 0
            self._reloc_next_attempt = 0

    def _handle_lost(self, bank, timestamp, frame_id, depth_lookup=None, uvr=None):
        """Shared tail of a frame that could not be tracked: after
        ``reloc_after_failures`` consecutive losses, try to re-anchor into
        the existing map (``backend.relocalization``). A FAILED attempt
        backs off for another ``reloc_after_failures`` losses: where
        tracking flickers, an attempt on every lost frame would dominate
        the frame time. A relocalized frame counts as tracked."""
        self._lost_count += 1
        bcfg = self.cfg.backend
        if (bcfg.relocalization and self._initialized
                and self._lost_count >= bcfg.reloc_after_failures
                and self._lost_count >= self._reloc_next_attempt):
            out = self._relocalize(bank, timestamp, frame_id, depth_lookup, uvr=uvr)
            if out is not None:
                self._lost_count = 0
                self._reloc_next_attempt = 0
                return out
            self._reloc_next_attempt = self._lost_count + bcfg.reloc_after_failures
        self._frames_lost += 1
        self._after_track(bank, None, timestamp, frame_id, track_well=False, uvr=uvr)
        return None

    def _relocalize(self, bank, timestamp, frame_id, depth_lookup=None, uvr=None):
        """Recover from tracking loss by re-anchoring into the existing map
        (``Backend.relocalize``): the current frame enters as a keyframe
        observing the verified mappoints and becomes the new reference, so
        trajectory and map stay in ONE world frame."""
        with self.timer.span("relocalize"):
            mat = self._materialize_bank(bank)
            kpts, valid, desc_h, _ = mat
            res = self.backend.relocalize(desc_h, kpts, valid)
        if res is None:
            return None
        self._relocalizations += 1
        pose, frame_track, _ = res
        pose_out = self._insert_keyframe(bank, uvr, pose, frame_track, timestamp, frame_id, set_ref=True,
                                         materialized=mat, depth_lookup=depth_lookup)
        final = pose_out if pose_out is not None else pose
        self._publish_tracked(final, timestamp, pose_out is not None)
        self._after_track(bank, final, timestamp, frame_id, track_well=True, track=frame_track, uvr=uvr)
        return pose_out

    # ------------------------------------------------------------------

    @property
    def initialized(self) -> bool:
        return self._initialized

    @property
    def frames_lost(self) -> int:
        """Frames since the last reset that could not be tracked (a
        relocalized frame counts as tracked)."""
        return self._frames_lost

    @property
    def relocalizations(self) -> int:
        """Frames since the last reset re-anchored by relocalization."""
        return self._relocalizations

    @property
    def pose_calls(self) -> int:
        """``optimize_pose`` calls (one pose-GN launch each on the card)
        since the last reset made by this tracker's own flow and its
        backend's place verification; a batching caller's calls for its
        ``precomputed_track`` are not among them."""
        return self._pose_calls + self.backend.pose_calls

    def current_pose(self) -> np.ndarray:
        return self._last_pose.copy()
