"""VO tracking front end: the host state machine (port of
``ur_mvo_tpu.runtime.frontend``, monocular slice).

Orchestration parity with the reference's ``Tracking``: monocular
two-view initialization, frame-to-keyframe tracking with a PnP prior and
pose-only refinement, the tracking-loss fallback that promotes the last
frame to keyframe, relocalization into the existing map after repeated
losses (with backoff), the keyframe policy, and keyframe insertion into the
mapping backend (with loop detection after it), which is the only event
that emits a pose to the caller (non-keyframe frames are interpolated by
the engine).

A single-owner host loop queues device work (matching, PnP, pose
refinement all stay on ``device``) and reads back ONE packed vector a
frame; decisions (init success, fallback, keyframe) are taken on the host
from it. Not ported, raising if asked for: stereo (``bank_right``), RGB-D
(``depth_lookup``), local-map tracking, chunked processing, map adoption,
precomputed matches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ur_mvo_tpu_torch.camera import Camera
from ur_mvo_tpu_torch.config import Configs
from ur_mvo_tpu_torch.device import DeviceLike, resolve_device
from ur_mvo_tpu_torch.ops.epipolar import two_view_init
from ur_mvo_tpu_torch.ops.lie import mv
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
    ``Tracker.parse_fused_packed``). ``pnp_sets`` injects the PnP minimal
    sets; ``plain`` asks for the plain pose optimizer on any device."""
    K = m.idx1.shape[0]
    dev = snapshot.device
    cand_pos = snapshot[:, 0:3]
    cand_ok = snapshot[:, 3] > 1.5
    cand_live = snapshot[:, 3] > 0.5
    ref_track = snapshot[:, 4]
    R_last_cw = snapshot[0:9, 5].reshape(3, 3)
    t_last_cw = snapshot[9:12, 5]
    num_match = m.num_valid()
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
    # problem 0: seeded at the PnP prior; problem 1: the rescue, seeded at
    # the last frame's pose
    obs2 = PoseObs(X=X.expand(2, K, 3), uv=uvr.expand(2, K, 3), valid=valid_cur.expand(2, K))
    res = optimize_pose(
        torch.stack([R0, R_last_cw]), torch.stack([t0, t_last_cw]), obs2, fx, fy, cx, cy, bf,
        chi2_mono=chi2_mono, chi2_stereo=chi2_stereo, plain=plain,
    )
    # jump guard + rescue (see Tracker._track_frame for the rationale)
    t_wc_last = _t_wc(R_last_cw, t_last_cw)
    jumps = torch.sqrt(torch.sum((_t_wc(res.R_cw, res.t_cw) - t_wc_last) ** 2, dim=-1))  # (2,)
    jump_ok = torch.isfinite(jumps) & (jumps <= max_jump)
    enough = res.n_inliers >= min_match
    take_rescue = enough[0] & ~jump_ok[0]
    ok2 = jump_ok[1] & enough[1]
    R_f = torch.where(take_rescue, res.R_cw[1], res.R_cw[0])
    t_f = torch.where(take_rescue, res.t_cw[1], res.t_cw[0])
    inl_f = torch.where(take_rescue, res.inliers[1] & ok2, res.inliers[0])
    n_f = torch.where(take_rescue, torch.where(ok2, res.n_inliers[1], torch.zeros_like(res.n_inliers[1])),
                      res.n_inliers[0])
    # chi2 inlier classification applies only to slots that carried a 3D
    # constraint; matched-but-untriangulated ids are kept as they are
    keep_id = torch.where(valid_cur, inl_f, mp_slot >= 0)
    frame_track = torch.where(keep_id, mp_slot, torch.full_like(mp_slot, -1.0))
    return torch.cat([
        torch.stack([num_match.to(torch.float32), n_f.to(torch.float32)]),
        R_f.reshape(-1), t_f, frame_track, uvr.reshape(-1),
    ])


class Tracker:
    """``device`` defaults to the extractor's device, else ``cuda`` (raises
    without CUDA). ``kernels=False`` runs the pose optimizer's plain version
    on any device (the on-card comparison asks for it; the main path never
    does)."""

    def __init__(self, cfg: Configs, camera: Camera, extractor, backend: Optional[Backend] = None,
                 publisher: Optional[Publisher] = None, device: DeviceLike = None, kernels: bool = True):
        if cfg.local_map_tracking.enabled:
            raise NotImplementedError("local_map_tracking.enabled: local-map tracking is not ported yet")
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

    def _optimize(self, R0, t0, obs: PoseObs):
        cam, topt = self.camera, self.cfg.tracking_optimization
        return optimize_pose(
            R0, t0, obs, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            chi2_mono=topt.mono_point, chi2_stereo=topt.stereo_point, plain=self._plain,
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

    @torch.no_grad()
    def _fused_kernel(self, ref_bank, bank, snapshot: torch.Tensor) -> torch.Tensor:
        """Fused frame step: match-vs-ref + correspondence scatter + PnP
        prior + pose refinement + jump-guard rescue, queued on the device
        with ONE packed f32 result (see :func:`fused_track_core`)."""
        cam, topt, rt, kf = self.camera, self.cfg.tracking_optimization, self.cfg.runtime, self.cfg.keyframe
        K = bank.kpts.shape[0]
        uvr = torch.cat([bank.kpts, -torch.ones((K, 1), dtype=torch.float32, device=bank.kpts.device)], dim=1)
        with self.timer.span("match"):
            m = self.extractor.match(ref_bank, bank, True)
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
        """One frame. ``bank``: FeatureBank (already extracted). Returns the
        4x4 keyframe pose when a keyframe was inserted, else None."""
        if bank_right is not None:
            raise NotImplementedError("Tracker.process(bank_right=...): stereo is not ported yet")
        if depth_lookup is not None:
            raise NotImplementedError("Tracker.process(depth_lookup=...): RGB-D is not ported yet")
        if precomputed_match is not None or precomputed_track is not None:
            raise NotImplementedError("Tracker.process: precomputed matches / tracks are not ported yet")
        frame_id = self._frame_counter
        self._frame_counter += 1

        if not self._initialized:
            return self._try_initialize(bank, timestamp, frame_id)

        min_match = self.cfg.keyframe.min_num_match
        uvr = None  # the fused step RETURNS uvr in its packed output

        if self._fused:
            num_match, num_inliers, pose, frame_track, uvr = self._track_frame_fused(bank)
            if num_match < min_match:
                promoted = self._promote_last_frame(timestamp)
                if promoted is None:
                    return self._handle_lost(bank, timestamp, frame_id, uvr=uvr)
                num_match, num_inliers, pose, frame_track, uvr = self._track_frame_fused(bank)
            elif num_inliers < min_match:
                promoted = self._promote_last_frame(timestamp)
                if promoted is not None:
                    num_match, num_inliers, pose, frame_track, uvr = self._track_frame_fused(bank)
            ref_frame_id = self._ref_frame_id
        else:
            uvr = self._mono_uvr(bank)
            with self.timer.span("match"):
                matches = self.extractor.match(self._ref_bank, bank)
                num_match = int(matches.num_valid())

            ref_track = self.backend.store.kf_track[self._ref_slot]
            ref_frame_id = self._ref_frame_id

            if num_match < min_match:
                promoted = self._promote_last_frame(timestamp)
                if promoted is None:
                    return self._handle_lost(bank, timestamp, frame_id, uvr=uvr)
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
            return self._handle_lost(bank, timestamp, frame_id, uvr=uvr)

        return self._finish_tracked_frame(bank, uvr, pose, frame_track, num_inliers, timestamp, frame_id, ref_frame_id)

    def _finish_tracked_frame(self, bank, uvr, pose, frame_track, num_inliers, timestamp, frame_id, ref_frame_id):
        """Shared tail of a successfully tracked frame: keyframe decision
        + insertion, publishing, last-frame bookkeeping."""
        pose_out = None
        # keyframe decision, only when the ref keyframe is still the
        # latest keyframe
        if self._add_keyframe_decision(pose, num_inliers, frame_id) and (
            ref_frame_id == self._last_keyframe_frame_id
        ):
            pose_out = self._insert_keyframe(bank, uvr, pose, frame_track, timestamp, frame_id)

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

    def process_chunk(self, *args, **kwargs):
        raise NotImplementedError("Tracker.process_chunk: chunked processing is not ported yet")

    def adopt_map(self) -> None:
        raise NotImplementedError("Tracker.adopt_map: map adoption is not ported yet")

    def _mono_uvr(self, bank) -> np.ndarray:
        """(K, 3) per-feature [u, v, -1] on the host."""
        kpts = bank.kpts.cpu().numpy()
        return np.concatenate([kpts, -np.ones((bank.capacity, 1), np.float32)], axis=1)

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------

    def _try_initialize(self, bank, timestamp, frame_id) -> Optional[np.ndarray]:
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
        if self._fused:
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
            matches = self.extractor.match(self._init_bank, bank)
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
        R_last_cw = self._last_pose[:3, :3].T
        snap[0:9, 5] = R_last_cw.reshape(-1)
        snap[9:12, 5] = -R_last_cw @ self._last_pose[:3, 3]
        return snap

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

    def _track_frame_fused(self, bank):
        """Host half of the fused frame step: ONE packed upload, ONE packed
        readback (see fused_snapshot/parse_fused_packed)."""
        snap = self._upload(self.fused_snapshot())
        with self.timer.span("track"):
            arr = self._fused_kernel(self._ref_bank, bank, snap).cpu().numpy()
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

    def _insert_keyframe(self, bank, uvr, pose, frame_track, timestamp, frame_id, set_ref=True, materialized=None):
        """Insert a keyframe, then look for a loop from it.
        ``materialized``: the bank's ``(kpts, valid, desc, scores)`` when
        the caller already read it back (relocalization)."""
        st = self.backend.store
        if frame_id in st.frame_id_to_slot:
            return None
        K = bank.capacity
        kpts, valid, desc_h, scores_h = materialized if materialized is not None else self._materialize_bank(bank)
        if uvr is None:
            uvr = np.concatenate([kpts, -np.ones((K, 1), np.float32)], axis=1)
        track = frame_track if frame_track is not None else np.full(K, -1, np.int32)
        with self.timer.span("keyframe_ba"):
            slot, (R_opt, t_opt) = self.backend.insert_keyframe(
                frame_id, timestamp, pose[:3, :3], pose[:3, 3], uvr, valid, track, None,
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

    def _handle_lost(self, bank, timestamp, frame_id, uvr=None):
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
            out = self._relocalize(bank, timestamp, frame_id, uvr=uvr)
            if out is not None:
                self._lost_count = 0
                self._reloc_next_attempt = 0
                return out
            self._reloc_next_attempt = self._lost_count + bcfg.reloc_after_failures
        self._frames_lost += 1
        self._after_track(bank, None, timestamp, frame_id, track_well=False, uvr=uvr)
        return None

    def _relocalize(self, bank, timestamp, frame_id, uvr=None):
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
                                         materialized=mat)
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

    def current_pose(self) -> np.ndarray:
        return self._last_pose.copy()
