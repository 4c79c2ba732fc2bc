"""Mapping backend: keyframe insertion, triangulation, windowed BA, loop
closure, relocalization and global optimization (port of
``ur_mvo_tpu.runtime.backend``).

Per keyframe: create mappoints for unmatched features, multi-view
triangulate once a point has > 2 observers, covisibility-window local BA
with <= 15 optimizable + <= 20 extra fixed frames, outlier observation
removal with covisibility decay. Place recognition (``detect_loop``,
``relocalize``) retrieves keyframes by centered global descriptors and
verifies them with mutual-NN matching, PnP-RANSAC, the pose-only optimizer
and a structure-aware refinement BA. ``global_optimize`` consumes the loop
edges: Sim3 scale ramp, SE(3) pose graph, point correction, full BA
(on a mesh: ``parallel/dist_ba``, every rank solving rank 0's problem).

The numeric work runs on ``device`` (``ops/triangulation.py``,
``ops/ba.py``); this module does vectorized numpy gathers between the
store and those programs. Each program takes ONE packed float32 upload
and gives ONE packed readback. BA problems are padded to the capacities
in ``BackendConfig``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ur_mvo_tpu_torch.camera import Camera
from ur_mvo_tpu_torch.config import BackendConfig, OptimizationConfig
from ur_mvo_tpu_torch.device import resolve_device
from ur_mvo_tpu_torch.ops.ba import BAConfig, BAProblem, bundle_adjust, resolve_assembly
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank
from ur_mvo_tpu_torch.ops.nn_matcher import match_nn
from ur_mvo_tpu_torch.ops.pnp import ransac_pnp
from ur_mvo_tpu_torch.ops.pose_graph import PoseGraph, optimize_pose_graph, sequential_edges_from_trajectory
from ur_mvo_tpu_torch.ops.pose_opt import PoseObs, PoseOptResult, optimize_pose
from ur_mvo_tpu_torch.ops.triangulation import triangulate_bearings
from ur_mvo_tpu_torch.parallel.dist_ba import dist_bundle_adjust, shard_assembly, shard_problem
from ur_mvo_tpu_torch.parallel.mesh import gather_objects, replicate_object
from ur_mvo_tpu_torch.runtime.map_store import MapStore, StoreConfig
from ur_mvo_tpu_torch.utils.timing import StageTimer


class Backend:
    """``kernels=False`` runs the kernels' plain versions on any device (the
    on-card comparison asks for it; the main path never does). ``timer``
    holds the parts of ``global_optimize``; ``last_full_ba`` the size and
    assembly of the last full BA. ``bf16_point_side``: every BA rounds its
    point side's summands to bf16 (``BAConfig.bf16_point_side``), the JAX
    package's window numerics. The tracker asks for it in the stereo and
    RGB-D setups. In RGB-D the keyframes hold mono rows, so a window with
    one fixed keyframe leaves the scale free, and with exact float32
    summands the RGB-D runs drifted along it more than the JAX package's
    do. In stereo the exact summands gave another window solution than the
    JAX package's on the same problem (the bf16 summands give its bits);
    the monocular setup still sums exact float32 summands (ROADMAP C7)."""

    def __init__(
        self,
        camera: Camera,
        backend_cfg: BackendConfig,
        opt_cfg: OptimizationConfig,
        store: Optional[MapStore] = None,
        keypoints_per_frame: int = 1024,
        device="cuda",
        kernels: bool = True,
        bf16_point_side: bool = False,
    ):
        self.device = resolve_device(device)
        self._plain = not kernels
        self.camera = camera
        self.cfg = backend_cfg
        self.opt_cfg = opt_cfg
        self.store = store or MapStore(
            StoreConfig(
                max_keyframes=backend_cfg.max_keyframes,
                max_mappoints=backend_cfg.max_mappoints,
                keypoints_per_frame=keypoints_per_frame,
            )
        )
        self._ba_cfg = BAConfig(
            chi2_mono=opt_cfg.mono_point,
            chi2_stereo=opt_cfg.stereo_point,
            iters_phase1=backend_cfg.ba_iterations_phase1,
            iters_phase2=backend_cfg.ba_iterations_phase2,
            tol=backend_cfg.ba_tol,
            # free frames are bounded by both the window size and the
            # fix-older-than horizon (only keyframes within the last
            # fix_older_than frame ids stay free), +1 for the new frame
            max_free_frames=((min(backend_cfg.window_opt_frames, backend_cfg.fix_older_than) + 1 + 7) // 8) * 8,
            bf16_point_side=bf16_point_side,
        )
        F_pad = self._round_up(backend_cfg.window_opt_frames + backend_cfg.window_fixed_frames + 1, 4)
        self._ba_dims = (F_pad, backend_cfg.ba_max_points, backend_cfg.ba_max_observations)
        # Async keyframe BA (cfg.ba_async): the result tensor stays on the
        # device and is read one keyframe later.
        self._pending_ba = None
        # Loop / relocalization refinement: a BA at the window padding with
        # the FULL schedule (10+5) and no convergence exit. The window
        # program's tol exits at once there: moving one pose barely moves
        # the summed point residuals.
        self._refine_cfg = BAConfig(
            chi2_mono=opt_cfg.mono_point, chi2_stereo=opt_cfg.stereo_point,
            iters_phase1=10, iters_phase2=5, tol=0.0, max_free_frames=8, bf16_point_side=bf16_point_side,
        )
        self.K_mat = torch.as_tensor(np.asarray(camera.intrinsic_matrix(), np.float32), device=self.device)
        self._loop_cooldown = 0
        # one sampler for loop and relocalization verification, re-seeded
        # by reset_state
        self._loop_gen = torch.Generator(device=self.device)
        self._loop_gen.manual_seed(1234)
        self.pose_calls = 0  # optimize_pose calls of place verification since the last reset
        self.timer = StageTimer()
        self.last_full_ba: Optional[dict] = None

    def _tri_batch(self, packed: np.ndarray) -> np.ndarray:
        """Batched ray triangulation with packed I/O: (n, M, 7) rows
        [origin | bearing | valid] up, (n, 4) [xyz | ok] back."""
        p = torch.from_numpy(packed).to(self.device)
        pts, ok = triangulate_bearings(p[..., 0:3], p[..., 3:6], p[..., 6] > 0.5)
        return torch.cat([pts, ok[:, None].to(torch.float32)], dim=1).cpu().numpy()

    def _ba(self, flat: np.ndarray, cfg: Optional[BAConfig] = None) -> torch.Tensor:
        """Windowed BA with PACKED I/O: ONE flat float32 upload
        [frames (F,14) | points (P,4) | observations (O,6)] and one
        float32 result [R_wc(9F), t_wc(3F), X(3P), obs_inlier(O)], left on
        the device for the caller to read. ``cfg``: the window BA's by
        default."""
        F_pad, P_pad, O_pad = self._ba_dims
        cam = self.camera
        flat = torch.from_numpy(flat).to(self.device)
        fpack = flat[: 14 * F_pad].reshape(F_pad, 14)
        ppack = flat[14 * F_pad : 14 * F_pad + 4 * P_pad].reshape(P_pad, 4)
        opack = flat[14 * F_pad + 4 * P_pad :].reshape(O_pad, 6)
        prob = BAProblem(
            R_wc=fpack[:, 0:9].reshape(-1, 3, 3),
            t_wc=fpack[:, 9:12],
            frame_valid=fpack[:, 12] > 0.5,
            frame_fixed=fpack[:, 13] > 0.5,
            X=ppack[:, 0:3],
            point_valid=ppack[:, 3] > 0.5,
            obs_frame=opack[:, 0].to(torch.int64),
            obs_point=opack[:, 1].to(torch.int64),
            obs_uv=opack[:, 2:5],
            obs_valid=opack[:, 5] > 0.5,
        )
        res = bundle_adjust(prob, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cfg or self._ba_cfg, plain=self._plain)
        return torch.cat([
            res.R_wc.reshape(-1), res.t_wc.reshape(-1), res.X.reshape(-1),
            res.obs_inlier.to(torch.float32),
        ])

    def reset_state(self) -> None:
        """Fresh map and bookkeeping; the loop sampler re-seeded."""
        self.flush_pending_ba()
        self.store = MapStore(self.store.cfg)
        self._pending_ba = None
        self._loop_cooldown = 0
        self._loop_gen.manual_seed(1234)
        self.pose_calls = 0

    # ------------------------------------------------------------------
    # Place recognition: loop closure and relocalization (beyond the
    # reference, which has neither)
    # ------------------------------------------------------------------

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _bank(self, kpts: np.ndarray, desc: np.ndarray, valid: np.ndarray) -> FeatureBank:
        return FeatureBank(scores=self._upload(valid.astype(np.float32)), kpts=self._upload(kpts.astype(np.float32)),
                           desc=self._upload(desc.astype(np.float32)), valid=self._upload(valid))

    @torch.no_grad()
    def _loop_verify(self, X: np.ndarray, uv3: np.ndarray, valid: np.ndarray) -> PoseOptResult:
        """PnP-RANSAC (100 hypotheses, 8 px) + pose-only refinement of a
        place hypothesis, with no prior pose to fall back on: a failed
        hypothesis reports 0 inliers. One packed readback; numpy out."""
        cam, opt = self.camera, self.opt_cfg
        Xd, uvd, vd = self._upload(X), self._upload(uv3), self._upload(valid)
        pnp = ransac_pnp(self._loop_gen, Xd, uvd[:, :2], vd, self.K_mat, iterations=100, threshold_px=8.0)
        self.pose_calls += 1
        res = optimize_pose(pnp.R_cw, pnp.t_cw, PoseObs(X=Xd, uv=uvd, valid=vd), cam.fx, cam.fy, cam.cx, cam.cy,
                            cam.bf, chi2_mono=opt.mono_point, chi2_stereo=opt.stereo_point, plain=self._plain)
        ok = torch.all(torch.isfinite(pnp.t_cw))
        n = torch.where(ok, res.n_inliers, torch.zeros_like(res.n_inliers))
        arr = torch.cat([res.R_cw.reshape(-1), res.t_cw, res.inliers.to(torch.float32),
                         n.to(torch.float32)[None]]).cpu().numpy()
        K = len(valid)
        return PoseOptResult(R_cw=arr[:9].reshape(3, 3), t_cw=arr[9:12], inliers=arr[12 : 12 + K] > 0.5,
                             n_inliers=int(arr[-1]))

    def _match_and_verify(self, bank_a, bank_kpts, bank_valid, ids, X_of_ids):
        """Shared geometric verification for place-recognition hits
        (detect_loop and relocalize): centered mutual-NN match of the query
        bank against the candidate's mappoint descriptors, then PnP-RANSAC
        + pose refinement against ``X_of_ids`` (insertion-time snapshot
        positions for loop EDGES, live positions for relocalization).
        Returns ``(res, idx1, mvalid)`` or None below the inlier gates."""
        st = self.store
        cfg = self.cfg
        K = st.cfg.keypoints_per_frame
        desc_b = np.zeros((K, st.cfg.descriptor_dim), np.float32)
        valid_b = np.zeros(K, bool)
        desc_b[: len(ids)] = st.mp_desc[ids].astype(np.float32)
        # zero-norm rows are points with no representative descriptor yet:
        # they must not drag the centering mean or win as a degenerate hub
        valid_b[: len(ids)] = np.linalg.norm(desc_b[: len(ids)], axis=1) > 0.5
        bank_b = self._bank(np.zeros((K, 2), np.float32), desc_b, valid_b)
        # center=True: collapsed descriptor spaces (the shipped v3
        # detector's) have no raw contrast, and a spurious edge poisons the
        # whole trajectory through the pose graph
        m = match_nn(bank_a, bank_b, 0.2, 0.95, center=True)
        arr = torch.cat([m.idx1.to(torch.float32), m.valid.to(torch.float32)]).cpu().numpy()
        idx1 = arr[:K].astype(np.int64)
        mvalid = (arr[K:] > 0.5) & bank_valid & (idx1 >= 0) & (idx1 < len(ids))
        if mvalid.sum() < cfg.loop_min_inliers:
            return None
        X = np.zeros((K, 3), np.float32)
        uv3 = np.concatenate([bank_kpts.astype(np.float32), -np.ones((K, 1), np.float32)], 1)
        rows = np.nonzero(mvalid)[0]
        X[rows] = X_of_ids[idx1[rows]]
        res = self._loop_verify(X, uv3, mvalid)
        if res.n_inliers < cfg.loop_min_inliers:
            return None
        return res, idx1, mvalid

    def _refine_pose_ba(self, poses_wc, fixed, X0, obs, free_idx=1):
        """Structure-aware refinement of a verified loop / relocalization
        pose: a joint solve over (the query pose, the matched points)
        against observations from the query PLUS fixed reference views.
        One candidate view alone has little parallax to a revisit, so the
        depth error of its points is unobservable; callers add covisible
        keyframes to restore the baseline that triangulated them. Runs
        the full-schedule refinement BA at the window padding.
        ``poses_wc``: list of (R_wc, t_wc); ``fixed``: per-frame bool (the
        query at ``free_idx`` is the free one); ``obs``: parallel arrays
        ``(obs_frame, obs_point, obs_uvr)``. Returns ``(R_wc, t_wc,
        n_inl_free)`` or None."""
        F, P, O = self._ba_dims
        obs_frame, obs_point, obs_uvr = obs
        n_f = len(poses_wc)
        n_p = min(len(X0), P)
        keep = obs_point < n_p
        obs_frame, obs_point, obs_uvr = obs_frame[keep], obs_point[keep], obs_uvr[keep]
        if len(obs_frame) > O:
            # round-robin interleave rows by within-view rank before the
            # O-row cap, so truncation thins EVERY view evenly instead of
            # dropping whole trailing views (which carry the baseline)
            rank = np.empty(len(obs_frame), np.int64)
            for f in np.unique(obs_frame):
                rows = np.nonzero(obs_frame == f)[0]
                rank[rows] = np.arange(len(rows))
            order = np.argsort(rank, kind="stable")
            obs_frame, obs_point, obs_uvr = obs_frame[order], obs_point[order], obs_uvr[order]
        n_o = min(len(obs_frame), O)
        if n_f > F:
            return None
        fpack = np.zeros((F, 14), np.float32)
        fpack[:, 0:9] = np.eye(3, dtype=np.float32).reshape(1, 9)
        for i, (R, t) in enumerate(poses_wc):
            fpack[i, 0:9] = np.asarray(R, np.float32).reshape(-1)
            fpack[i, 9:12] = t
        fpack[:n_f, 12] = 1.0
        fpack[:n_f, 13] = np.asarray(fixed, np.float32)
        ppack = np.zeros((P, 4), np.float32)
        ppack[:n_p, 0:3] = X0[:n_p]
        ppack[:n_p, 3] = 1.0
        opack = np.zeros((O, 6), np.float32)
        opack[:n_o, 0] = obs_frame[:n_o]
        opack[:n_o, 1] = obs_point[:n_o]
        opack[:n_o, 2:5] = obs_uvr[:n_o]
        opack[:n_o, 5] = 1.0
        flat = np.concatenate([fpack.reshape(-1), ppack.reshape(-1), opack.reshape(-1)])
        arr = self._ba(flat, self._refine_cfg).cpu().numpy()
        R1 = arr[: 9 * F].reshape(F, 3, 3)[free_idx]
        t1 = arr[9 * F : 12 * F].reshape(F, 3)[free_idx]
        inl = arr[12 * F + 3 * P :][:n_o] > 0.5
        n_inl_free = int((inl & (obs_frame[:n_o] == free_idx)).sum())
        if not (np.all(np.isfinite(R1)) and np.all(np.isfinite(t1))):
            return None
        return R1, t1, n_inl_free

    def _covisible_views(self, ids_m, candidates, poses, obs_f, obs_p, obs_uv, fixed, snapshot):
        """Add up to 4 of ``candidates`` that observe >= 8 of the matched
        mappoints ``ids_m`` as extra fixed views of the refinement, with
        their snapshot (``snapshot``) or live poses."""
        st = self.store
        sub = st.obs_slot[ids_m][:, candidates]  # (n_m, B)
        has = sub >= 0
        counts = has.sum(0)
        for bi in np.argsort(-counts)[:4]:
            if counts[bi] < 8:
                break
            B = int(candidates[bi])
            rows_b = np.nonzero(has[:, bi])[0]
            feat_b = sub[rows_b, bi].astype(np.int64)
            if snapshot:
                ok_b = st.kf_snap_ok[B, feat_b]
                rows_b, feat_b = rows_b[ok_b], feat_b[ok_b]
                if len(rows_b) < 8:
                    continue
            obs_f.append(np.full(len(rows_b), len(poses)))
            obs_p.append(rows_b)
            obs_uv.append(st.kf_kpts[B, feat_b])
            poses.append((st.kf_snap_R[B], st.kf_snap_t[B]) if snapshot else (st.kf_R[B], st.kf_t[B]))
            fixed.append(True)

    def detect_loop(self, slot: int, bank_desc: np.ndarray, bank_kpts: np.ndarray, bank_valid: np.ndarray):
        """Place recognition for the just-inserted keyframe ``slot``.

        Retrieval: cosine over per-keyframe global descriptors, centered by
        the all-keyframe mean. Candidates must be non-covisible and >=
        ``loop_min_gap_frames`` old. Verification: descriptor NN match of
        the current features against the candidate's mappoints,
        PnP-RANSAC + pose refinement against the candidate's
        INSERTION-TIME snapshot, then a Sim3 scale from points seen by
        both legs. Accepted edges (T_ij between the candidate and this
        keyframe, weight, scale) are appended to ``store.loop_edges`` for
        :meth:`global_optimize`. Returns the edge tuple or None."""
        cfg = self.cfg
        if not cfg.loop_closure:
            return None
        if self._loop_cooldown > 0:
            self._loop_cooldown -= 1
            return None
        st = self.store
        slots = st.keyframe_slots()
        cur_fid = int(st.kf_frame_id[slot])
        # candidates: old enough and not covisibility-CONNECTED (weight >=
        # 15 is the reference's connection MinWeight)
        cand_mask = (cur_fid - st.kf_frame_id[slots] > cfg.loop_min_gap_frames) & (st.covis[slot][slots] < 15) & (
            slots != slot
        )
        cands = slots[cand_mask]
        if len(cands) == 0:
            return None
        mu = st.kf_gdesc[slots].mean(0)

        def centered(x):
            c = x - mu
            return c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-8)

        sims = centered(st.kf_gdesc[cands]) @ centered(st.kf_gdesc[slot][None])[0]
        K = st.cfg.keypoints_per_frame
        bank_a = self._bank(bank_kpts, bank_desc, bank_valid)
        for idx in np.argsort(-sims)[: cfg.loop_top_k]:
            if sims[idx] < cfg.loop_min_similarity:
                break
            cand = int(cands[idx])
            # verify against the candidate's insertion-time snapshot (pose
            # and tracked-point positions as a self-consistent pair): BA
            # drags early points toward drifted observers while gauge-fixed
            # early poses stay put, and PnP against that pair is biased
            snap_ok = st.kf_snap_ok[cand]
            slots_c = np.nonzero(snap_ok)[0]
            mp = st.kf_track[cand]
            ids = mp[slots_c]
            alive = ids >= 0
            alive[alive] &= ~st.mp_bad[ids[alive]]
            slots_c, ids = slots_c[alive], ids[alive]
            if len(ids) < cfg.loop_min_inliers or st.mp_desc is None:
                continue
            slots_c, ids = slots_c[:K], ids[:K]
            out = self._match_and_verify(bank_a, bank_kpts, bank_valid, ids, st.kf_snap_pos[cand, slots_c])
            if out is None:
                continue
            res, idx1, mvalid = out
            R_wc_cur = res.R_cw.T
            t_wc_cur = -res.R_cw.T @ res.t_cw
            R_i = st.kf_snap_R[cand]
            t_i = st.kf_snap_t[cand]
            # refinement support: ALL descriptor matches (the BA's Huber
            # phase and chi2 re-gate handle the outliers), observed from
            # the candidate, the query and covisible snapshot keyframes of
            # the same visit (a later keyframe's snapshot carries the
            # accumulated drift)
            rows = np.nonzero(mvalid)[0]
            ci = idx1[rows]
            n_m = len(rows)
            X0 = st.kf_snap_pos[cand, slots_c[ci]]
            poses = [(R_i, t_i), (R_wc_cur, t_wc_cur)]
            fixed = [True, False]
            obs_f = [np.zeros(n_m), np.ones(n_m)]
            obs_p = [np.arange(n_m), np.arange(n_m)]
            uv_q = np.concatenate([bank_kpts[rows].astype(np.float32), -np.ones((n_m, 1), np.float32)], 1)
            obs_uv = [st.kf_kpts[cand, slots_c[ci]], uv_q]
            fid_c = int(st.kf_frame_id[cand])
            sl_all = st.keyframe_slots()
            near = sl_all[
                (np.abs(st.kf_frame_id[sl_all] - fid_c) <= 2 * self.cfg.fix_older_than)
                & (sl_all != cand) & (sl_all != slot)
            ]
            if len(near):
                self._covisible_views(ids[ci], near, poses, obs_f, obs_p, obs_uv, fixed, snapshot=True)
            ref = self._refine_pose_ba(
                poses, fixed, X0,
                (np.concatenate(obs_f).astype(np.float32), np.concatenate(obs_p).astype(np.int64),
                 np.concatenate(obs_uv).astype(np.float32)),
            )
            if ref is not None and ref[2] >= cfg.loop_min_inliers:
                R_wc_cur, t_wc_cur = ref[0], ref[1]
            s_ij = self._loop_scale(slot, bank_kpts, res, mvalid, rows, X0)
            # edge: T_ij = T_i^-1 T_j in the SNAPSHOT frame (i = candidate,
            # j = this keyframe)
            R_ij = R_i.T @ R_wc_cur
            t_ij = R_i.T @ (t_wc_cur - t_i)
            edge = (cand, int(slot), R_ij.astype(np.float32), t_ij.astype(np.float32),
                    float(cfg.loop_edge_weight), s_ij)
            st.loop_edges.append(edge)
            self._loop_cooldown = cfg.loop_cooldown_keyframes
            return edge
        return None

    def _loop_scale(self, slot, bank_kpts, res, mvalid, rows, X0) -> float:
        """Sim3 inter-leg scale of a verified loop: query features matched
        to candidate-snapshot points (``X0``, one per matched row) that
        also carry a live current-leg mappoint give the same physical
        points in both legs' scales; the median of pairwise-distance
        ratios is a rotation/translation-invariant, outlier-robust scale.
        The pairs come from projecting the query window's local map into
        the query view (associated to PnP-inlier rows within 3 px) united
        with the query's own track table. As in the reference package, a
        point found by both routes enters twice (no dedup)."""
        st = self.store
        inl_rows = res.inliers & mvalid
        rows_inl = np.nonzero(inl_rows)[0]
        row_of = {int(r): k for k, r in enumerate(rows)}
        sel = np.asarray([row_of[int(r)] for r in rows_inl if int(r) in row_of])
        Xa_c, Xb_c = [], []
        if len(sel) >= 4:
            win = st.window_frames(int(slot), self.cfg.window_opt_frames)
            tr_w = st.kf_track[win]
            ids_w = np.unique(tr_w[tr_w >= 0])
            ids_w = ids_w[st.mp_good[ids_w] & ~st.mp_bad[ids_w]]
            if len(ids_w) >= 8:
                Rq = st.kf_R[slot].T  # R_cw of the query (live)
                tq = -Rq @ st.kf_t[slot]
                Xc = st.mp_pos[ids_w] @ Rq.T + tq
                z = Xc[:, 2]
                front = z > 1e-3
                cam = self.camera
                u = cam.fx * Xc[:, 0] / np.maximum(z, 1e-3) + cam.cx
                v = cam.fy * Xc[:, 1] / np.maximum(z, 1e-3) + cam.cy
                pts_uv = np.stack([u, v], 1)[front]
                ids_f = ids_w[front]
                q_uv = bank_kpts[rows[sel]]
                if len(pts_uv):
                    d2 = ((q_uv[:, None, :] - pts_uv[None, :, :]) ** 2).sum(-1)
                    nn_j = d2.argmin(1)
                    ok_px = d2[np.arange(len(sel)), nn_j] < 3.0**2
                    Xa_c.append(X0[sel[ok_px]])
                    Xb_c.append(st.mp_pos[ids_f[nn_j[ok_px]]])
        # union with the direct track-table pairs
        cur_ids = st.kf_track[slot][rows]
        have = (cur_ids >= 0) & inl_rows[rows]
        have[have] &= st.mp_good[cur_ids[have]] & ~st.mp_bad[cur_ids[have]]
        Xa_c.append(X0[have])
        Xb_c.append(st.mp_pos[cur_ids[have]])
        Xa = np.concatenate(Xa_c)
        Xb = np.concatenate(Xb_c)
        if len(Xa) < 8:
            return 1.0
        rng = np.random.default_rng(0)
        n_h = len(Xa)
        p_i = rng.integers(0, n_h, 256)
        q_i = rng.integers(0, n_h, 256)
        dif = p_i != q_i
        da = np.linalg.norm(Xa[p_i[dif]] - Xa[q_i[dif]], axis=1)
        db = np.linalg.norm(Xb[p_i[dif]] - Xb[q_i[dif]], axis=1)
        ok_r = (da > 1e-6) & (db > 1e-6)
        if ok_r.sum() < 16:
            return 1.0
        return float(np.median(da[ok_r] / db[ok_r]))

    def relocalize(self, bank_desc: np.ndarray, bank_kpts: np.ndarray, bank_valid: np.ndarray):
        """Re-anchor a lost camera into the LIVE map.

        Retrieval and verification are the loop-closure machinery with two
        differences: every keyframe is a candidate (the most recently seen
        place is the most likely), and PnP runs against LIVE mappoint
        positions, because the recovered pose must land in the current
        world frame for tracking and BA to continue.

        Returns ``(T_wc (4,4), frame_track (K,), n_inliers)`` mapping
        verified bank slots to existing mappoint ids, or None."""
        cfg = self.cfg
        st = self.store
        slots = st.keyframe_slots()
        if len(slots) == 0 or st.mp_desc is None or not bank_valid.any():
            return None
        K = st.cfg.keypoints_per_frame
        q = bank_desc[bank_valid].astype(np.float32).mean(0)
        mu = st.kf_gdesc[slots].mean(0)

        def centered(x):
            c = x - mu
            return c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-8)

        sims = centered(st.kf_gdesc[slots]) @ centered(q[None])[0]
        bank_a = self._bank(bank_kpts, bank_desc, bank_valid)
        for idx in np.argsort(-sims)[: cfg.loop_top_k]:
            if sims[idx] < cfg.loop_min_similarity:
                break
            cand = int(slots[idx])
            mp = st.kf_track[cand]
            slots_c = np.nonzero(mp >= 0)[0]
            ids = mp[slots_c]
            keep = st.mp_good[ids] & ~st.mp_bad[ids]
            slots_c, ids = slots_c[keep], ids[keep]
            if len(ids) < cfg.loop_min_inliers:
                continue
            slots_c, ids = slots_c[:K], ids[:K]
            out = self._match_and_verify(bank_a, bank_kpts, bank_valid, ids, st.mp_pos[ids])
            if out is None:
                continue
            res, idx1, mvalid = out
            n_inl = res.n_inliers
            inl = res.inliers & mvalid
            frame_track = np.full(K, -1, np.int32)
            rows_in = np.nonzero(inl)[0]
            frame_track[rows_in] = ids[idx1[rows_in]]
            R_wc = res.R_cw.T
            t_wc = -res.R_cw.T @ res.t_cw
            # structure-aware refinement against the candidate's LIVE pose
            # and its live covisible observers (one gauge). Pose only: the
            # refit points are not written back.
            ci = idx1[rows_in]
            ids_m = ids[ci]
            n_m = len(rows_in)
            poses = [(st.kf_R[cand], st.kf_t[cand]), (R_wc, t_wc)]
            fixed = [True, False]
            obs_f = [np.zeros(n_m), np.ones(n_m)]
            obs_p = [np.arange(n_m), np.arange(n_m)]
            uv_q = np.concatenate([bank_kpts[rows_in].astype(np.float32), -np.ones((n_m, 1), np.float32)], 1)
            obs_uv = [st.kf_kpts[cand, slots_c[ci]], uv_q]
            others = slots[slots != cand]
            if len(others):
                self._covisible_views(ids_m, others, poses, obs_f, obs_p, obs_uv, fixed, snapshot=False)
            ref = self._refine_pose_ba(
                poses, fixed, st.mp_pos[ids_m],
                (np.concatenate(obs_f).astype(np.float32), np.concatenate(obs_p).astype(np.int64),
                 np.concatenate(obs_uv).astype(np.float32)),
            )
            if ref is not None and ref[2] >= cfg.loop_min_inliers:
                R_wc, t_wc = ref[0], ref[1]
                # report the inlier count of the pose actually adopted
                n_inl = int(ref[2])
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = R_wc
            pose[:3, 3] = t_wc
            return pose, frame_track, n_inl
        return None

    # ------------------------------------------------------------------
    # Keyframe insertion
    # ------------------------------------------------------------------

    def insert_keyframe(
        self,
        frame_id: int,
        timestamp: float,
        R_wc: np.ndarray,
        t_wc: np.ndarray,
        kpts_uvr: np.ndarray,  # (K, 3) u, v, u_right(-1 for mono)
        valid_slots: np.ndarray,  # (K,) bool
        track_mp: np.ndarray,  # (K,) int32 existing mappoint ids or -1
        depth: Optional[np.ndarray] = None,  # (K,) metric depth or None
        desc: Optional[np.ndarray] = None,  # (K, D) feature descriptors
        scores: Optional[np.ndarray] = None,  # (K,) detection scores
    ) -> tuple:
        """Insert a keyframe, create/triangulate mappoints, run local BA.

        Returns (kf_slot, optimized (R_wc, t_wc)).
        """
        st = self.store
        slot = st.alloc_keyframe(frame_id, timestamp, R_wc, t_wc, kpts_uvr, valid_slots, desc=desc,
                                 scores=scores)
        track = np.asarray(track_mp)

        # New mappoints for features without a track.
        new_mask = valid_slots & (track < 0)
        new_idx = np.nonzero(new_mask)[0]
        if len(new_idx):
            mp_ids = st.alloc_mappoints(len(new_idx))
            track = track.copy()
            track[new_idx] = mp_ids
            if desc is not None and st.mp_desc is not None:
                st.mp_desc[mp_ids] = desc[new_idx].astype(np.float16)
            # Stereo / depth-seeded points are Good immediately; mono ones
            # stay untriangulated.
            uvr = kpts_uvr[new_idx]
            if depth is not None:
                d = depth[new_idx]
                seeded = d > 0
            else:
                disparity = uvr[:, 0] - uvr[:, 2]
                seeded = (uvr[:, 2] > 0) & (disparity > 1e-3)
                d = np.where(seeded, self.camera.bf / np.maximum(disparity, 1e-6), 0.0)
            if seeded.any():
                rays = np.stack(
                    [
                        (uvr[:, 0] - self.camera.cx) / self.camera.fx,
                        (uvr[:, 1] - self.camera.cy) / self.camera.fy,
                        np.ones(len(new_idx)),
                    ],
                    axis=1,
                )
                pc = rays * d[:, None]
                pw = pc @ np.asarray(R_wc).T + t_wc
                sel = mp_ids[seeded]
                st.mp_pos[sel] = pw[seeded]
                st.mp_good[sel] = True

        # Register all observations of this keyframe.
        obs_idx = np.nonzero(valid_slots & (track >= 0))[0]
        st.add_observations(slot, track[obs_idx], obs_idx)
        if desc is not None:
            # representative-descriptor refresh
            st.update_descriptors(track[obs_idx], desc[obs_idx])

        # Triangulate untriangulated points with > 2 observers.
        self._triangulate_pending(track[obs_idx])

        # insertion-time geometry snapshot (pose + tracked-point positions
        # as a self-consistent pair)
        st.snapshot_keyframe_geometry(slot)

        if st.num_keyframes() >= 2:
            self.local_bundle_adjustment(slot)

        if self.cfg.enable_culling:
            # culling compacts slots: a pending async BA holds slot
            # indices, so it must land first
            self.flush_pending_ba()
            st.cull(self.cfg.cull_max_keyframes, self.cfg.cull_max_mappoints)

        s = st.frame_id_to_slot[frame_id]
        return slot, (st.kf_R[s].copy(), st.kf_t[s].copy())

    def _triangulate_pending(self, candidate_mps: np.ndarray) -> None:
        st = self.store
        cand = np.unique(candidate_mps)
        cand = cand[(~st.mp_good[cand]) & (~st.mp_bad[cand]) & (st.mp_obs_count[cand] > 2)]
        if len(cand) == 0:
            return
        # Padded ray bundles: observers per point capped at 8 (enough for
        # the triangulation least squares; the reference uses all).
        MAX_OBS = 8
        n = len(cand)
        packed = np.zeros((n, MAX_OBS, 7), np.float32)
        for i, mp in enumerate(cand):
            kfs = np.nonzero(st.obs_slot[mp] >= 0)[0][:MAX_OBS]
            slots = st.obs_slot[mp, kfs]
            uv = st.kf_kpts[kfs, slots][:, :2]
            rays = np.stack(
                [
                    (uv[:, 0] - self.camera.cx) / self.camera.fx,
                    (uv[:, 1] - self.camera.cy) / self.camera.fy,
                    np.ones(len(kfs)),
                ],
                axis=1,
            )
            packed[i, : len(kfs), 0:3] = st.kf_t[kfs]
            packed[i, : len(kfs), 3:6] = np.einsum("kij,kj->ki", st.kf_R[kfs], rays)
            packed[i, : len(kfs), 6] = 1.0
        out = self._tri_batch(packed)
        ok = out[:, 3] > 0.5
        good = cand[ok]
        st.mp_pos[good] = out[ok, :3]
        st.mp_good[good] = True

    # ------------------------------------------------------------------
    # Local BA
    # ------------------------------------------------------------------

    def flush_pending_ba(self) -> None:
        """Block on and write back an in-flight async BA result (no-op
        when nothing is pending). Called before the next BA dispatch and
        before any trajectory/map read that must see optimized state."""
        if self._pending_ba is None:
            return
        res, meta = self._pending_ba
        self._pending_ba = None
        self._apply_ba_result(res, *meta)

    def local_bundle_adjustment(self, new_slot: int) -> None:
        st = self.store
        cfg = self.cfg
        self.flush_pending_ba()
        window = st.window_frames(new_slot, cfg.window_opt_frames)
        new_frame_id = st.kf_frame_id[new_slot]

        # fix frames: old ones or the first two
        fixed = (st.kf_frame_id[window] <= new_frame_id - cfg.fix_older_than) | (
            st.kf_frame_id[window] <= 2
        )

        # local mappoints: Good points observed by window frames
        tracks = st.kf_track[window]  # (W, K)
        mp_ids = np.unique(tracks[tracks >= 0])
        mp_ids = mp_ids[st.mp_good[mp_ids] & ~st.mp_bad[mp_ids]]
        if len(mp_ids) == 0 or len(window) < 2:
            return

        # extra fixed frames: observers of local points outside the window
        inc = st.obs_slot[mp_ids] >= 0  # (n, KF)
        in_window = np.zeros(st.cfg.max_keyframes, bool)
        in_window[window] = True
        outside_slots = np.nonzero(~in_window & st.kf_valid)[0]
        counts = inc[:, outside_slots].sum(axis=0)
        budget = max(0, cfg.window_fixed_frames - int(fixed.sum()))
        extra = outside_slots[np.argsort(-counts)][:budget]
        extra = extra[counts[np.argsort(-counts)][:budget] > 0]

        frames = np.concatenate([window, extra]).astype(np.int64)
        frame_fixed = np.concatenate([fixed, np.ones(len(extra), bool)])

        # gather observations of local mappoints in selected frames
        sub = st.obs_slot[mp_ids][:, frames]  # (n, W+E)
        pi, fi = np.nonzero(sub >= 0)
        feat = sub[pi, fi]
        uvr = st.kf_kpts[frames[fi], feat]
        # a constraint needs >= 2 observations (mono) or a stereo row
        n_obs_per_p = np.bincount(pi, minlength=len(mp_ids))
        has_stereo = np.zeros(len(mp_ids), bool)
        np.logical_or.at(has_stereo, pi, uvr[:, 2] > 0)
        keep_p = (n_obs_per_p >= 2) | has_stereo
        keep_obs = keep_p[pi]
        pi, fi, uvr = pi[keep_obs], fi[keep_obs], uvr[keep_obs]
        mp_used = np.nonzero(keep_p)[0]
        if len(pi) == 0:
            return
        # re-index points compactly
        remap = np.full(len(mp_ids), -1, np.int32)
        remap[mp_used] = np.arange(len(mp_used), dtype=np.int32)
        p_idx = remap[pi]
        mp_sel = mp_ids[mp_used]

        # Constant padded shapes: one problem size for every keyframe.
        F, P, O = self._ba_dims
        if len(mp_sel) > P or len(pi) > O or len(frames) > F:
            # capacity overflow: keep the newest observations (should not
            # happen at reference operating points)
            keep = slice(max(0, len(pi) - O), len(pi))
            pi, fi, uvr, p_idx = pi[keep], fi[keep], uvr[keep], p_idx[keep]
            frames = frames[:F]
            frame_fixed = frame_fixed[:F]
            mp_sel = mp_sel[:P]
            sel_ok = (p_idx < len(mp_sel)) & (fi < len(frames))
            pi, fi, uvr, p_idx = pi[sel_ok], fi[sel_ok], uvr[sel_ok], p_idx[sel_ok]

        def pad(a, n, tail=(), dtype=np.float32):
            out = np.zeros((n,) + tail, dtype)
            out[: len(a)] = a[:n]
            return out

        fpack = np.zeros((F, 14), np.float32)
        fpack[:, 0:9] = pad(st.kf_R[frames], F, (3, 3)).reshape(F, 9) + np.where(
            (np.arange(F) >= len(frames))[:, None], np.eye(3, dtype=np.float32).reshape(1, 9), 0.0
        )
        fpack[:, 9:12] = pad(st.kf_t[frames], F, (3,))
        fpack[:, 12] = np.arange(F) < len(frames)
        fpack[:, 13] = pad(frame_fixed, F, (), bool)
        ppack = np.zeros((P, 4), np.float32)
        ppack[:, 0:3] = pad(st.mp_pos[mp_sel], P, (3,))
        ppack[:, 3] = np.arange(P) < len(mp_sel)
        opack = np.zeros((O, 6), np.float32)
        opack[:, 0] = pad(fi, O, (), np.int32)
        opack[:, 1] = pad(p_idx, O, (), np.int32)
        opack[:, 2:5] = pad(uvr, O, (3,))
        opack[:, 5] = np.arange(O) < len(pi)
        res = self._ba(np.concatenate([fpack.reshape(-1), ppack.reshape(-1), opack.reshape(-1)]))

        meta = (frames, frame_fixed, mp_sel, pi, fi, p_idx, uvr)
        if self.cfg.ba_async:
            # CUDA work is queued asynchronously: stash the on-device
            # result and return without reading it on the host.
            self._pending_ba = (res, meta)
        else:
            self._apply_ba_result(res, *meta)

    def _apply_ba_result(self, res, frames, frame_fixed, mp_sel, pi, fi, p_idx, uvr) -> None:
        st = self.store
        # ONE packed readback (see _ba), then host slicing
        arr = res.cpu().numpy()
        # layout: [R_wc(9F), t_wc(3F), X(3P), obs_inlier(O)]
        F, P, O = self._ba_dims
        R_all = arr[: 9 * F].reshape(F, 3, 3)
        t_all = arr[9 * F : 12 * F].reshape(F, 3)
        X_all = arr[12 * F : 12 * F + 3 * P].reshape(P, 3)
        inl_all = arr[12 * F + 3 * P :] > 0.5
        free = ~frame_fixed
        st.kf_R[frames[free]] = R_all[: len(frames)][free]
        st.kf_t[frames[free]] = t_all[: len(frames)][free]
        st.mp_pos[mp_sel] = X_all[: len(mp_sel)]

        # outlier removal, batched: one vectorized store update
        inlier = inl_all[: len(pi)]
        bad = np.nonzero(~inlier)[0]
        if len(bad):
            kf_slots = frames[fi[bad]]
            mps = mp_sel[p_idx[bad]]
            st.remove_observations(kf_slots, mps)
            # stereo mappoint kill: evaluated after the whole batch (the
            # reference checks per removal; post-batch counts can only be
            # lower, so this kills a superset of near-dead points)
            stereo_mps = np.unique(mps[uvr[bad, 2] > 0])
            kill = stereo_mps[st.mp_obs_count[stereo_mps] < 2]
            st.mp_bad[kill] = True
            st.mp_good[kill] = False

    @staticmethod
    def _round_up(x: int, m: int) -> int:
        return ((x + m - 1) // m) * m

    @staticmethod
    def _bucket_pow2(x: int, mult: int) -> int:
        """Smallest mult * 2^k >= x (shape-bucketed padding)."""
        m = mult
        while m < x:
            m *= 2
        return m

    # ------------------------------------------------------------------
    # Global optimization (beyond the reference: pose graph + full BA)
    # ------------------------------------------------------------------

    def global_optimize(self, pose_graph_iterations: int = 15, full_ba: bool = True, mesh=None) -> None:
        """Whole-trajectory refinement: the loop edges' Sim3 scale ramp,
        an SE(3) pose graph over the odometry chain plus the loop edges,
        the map carried with its keyframes, then a full BA over all
        keyframes and points (keyframes with frame id <= 2 fixed as gauge).
        Each part is a span of ``self.timer``: ``global_scale``,
        ``global_pose_graph``, ``global_points``, ``global_full_ba``.
        ``mesh``: a 1-D ``DeviceMesh`` (``parallel/mesh.make_mesh``); every
        rank calls this on its store, and the full BA runs sharded over the
        ranks (``parallel/dist_ba``) on rank 0's problem, whose result every
        rank writes into its own store."""
        self.flush_pending_ba()
        st = self.store
        slots = st.keyframe_slots()
        order = slots[np.argsort(st.kf_frame_id[slots])]
        n = len(order)
        if n < 3:
            return
        # Sim3 scale correction BEFORE the SE(3) pose graph: loop edges
        # carry the measured inter-leg scale (detect_loop)
        with self.timer.span("global_scale"):
            self._apply_loop_scale(order)
        with self.timer.span("global_pose_graph"):
            Fp = self._round_up(n, 8)
            R = np.tile(np.eye(3, dtype=np.float32), (Fp, 1, 1))
            t = np.zeros((Fp, 3), np.float32)
            R[:n] = st.kf_R[order]
            t[:n] = st.kf_t[order]
            ei, ej, Rm, tm, w = sequential_edges_from_trajectory(R, t, n, Fp)
            # loop constraints after the odometry chain: the (residual-zero)
            # sequential edges become the spring chain the pose graph
            # distributes the loop error along
            slot_to_node = {int(s): k for k, s in enumerate(order)}
            loops = [e for e in st.loop_edges if e[0] in slot_to_node and e[1] in slot_to_node]
            if loops:
                E = self._round_up(Fp + len(loops), 8)
                ei = np.concatenate([ei, np.zeros(E - Fp, np.int32)])
                ej = np.concatenate([ej, np.zeros(E - Fp, np.int32)])
                Rm = np.concatenate([Rm, np.tile(np.eye(3, dtype=np.float32), (E - Fp, 1, 1))])
                tm = np.concatenate([tm, np.zeros((E - Fp, 3), np.float32)])
                w = np.concatenate([w, np.zeros(E - Fp, np.float32)])
                for k, e in enumerate(loops):
                    si, sj, R_ij, t_ij, wt = e[:5]
                    ei[Fp + k] = slot_to_node[si]
                    ej[Fp + k] = slot_to_node[sj]
                    Rm[Fp + k] = R_ij
                    tm[Fp + k] = t_ij
                    w[Fp + k] = wt
            ar = torch.arange(Fp, device=self.device)
            g = PoseGraph(
                R_wc=self._upload(R), t_wc=self._upload(t), node_valid=ar < n, node_fixed=ar < 1,
                edge_i=self._upload(ei.astype(np.int64)), edge_j=self._upload(ej.astype(np.int64)),
                R_ij=self._upload(Rm), t_ij=self._upload(tm), edge_weight=self._upload(w),
            )
            res = optimize_pose_graph(g, iterations=pose_graph_iterations)
            arr = torch.cat([res.R_wc.reshape(-1), res.t_wc.reshape(-1)]).cpu().numpy()
            R_old = st.kf_R[order].copy()
            t_old = st.kf_t[order].copy()
            st.kf_R[order] = arr[: 9 * Fp].reshape(Fp, 3, 3)[:n]
            st.kf_t[order] = arr[9 * Fp :].reshape(Fp, 3)[:n]
        # carry each map point rigidly with its first observing keyframe's
        # correction, so the map agrees with the trajectory even without
        # full BA (and full BA starts closer)
        with self.timer.span("global_points"):
            self._correct_points_after_pgo(order, R_old, t_old)
        if full_ba:
            with self.timer.span("global_full_ba"):
                self._full_bundle_adjustment(order, mesh=mesh)

    def _apply_loop_scale(self, order: np.ndarray) -> None:
        """Distribute each loop edge's measured inter-leg scale along the
        odometry chain: the per-step factor ramps geometrically from 1 at
        the loop's old end to ``s`` at its new end, nodes past it take the
        full factor. Map points follow their first observing keyframe
        (depth about it scaled by its node factor). Consumed edges are
        rewritten with scale 1 so a second global_optimize does not
        re-apply them. Edges are applied one after the other; as in the
        reference package, overlapping spans are rescaled again."""
        st = self.store
        slot_to_node = {int(s): k for k, s in enumerate(order)}
        n = len(order)
        new_edges = []
        for e in st.loop_edges:
            # 5% deadband: scale-consistent maps measure s within a few
            # percent of 1 from triangulation noise alone; real inter-leg
            # mono scale drift measures tens of percent
            s_ij = float(e[5]) if len(e) > 5 else 1.0
            if e[0] in slot_to_node and e[1] in slot_to_node and abs(np.log(max(s_ij, 1e-6))) > 0.05:
                a, b = slot_to_node[e[0]], slot_to_node[e[1]]
                if a > b:
                    a, b = b, a
                    s_ij = 1.0 / s_ij
                if b > a:
                    c = np.ones(n, np.float64)
                    ramp = np.arange(1, b - a + 1) / (b - a)
                    c[a + 1 : b + 1] = s_ij**ramp
                    c[b + 1 :] = s_ij
                    t_old = st.kf_t[order].astype(np.float64)
                    steps = np.diff(t_old, axis=0) * c[1:, None]
                    t_new = np.concatenate([t_old[:1], t_old[0] + np.cumsum(steps, axis=0)])
                    st.kf_t[order] = t_new.astype(np.float32)
                    self._carry_points_scaled(order, t_old.astype(np.float32), c)
                e = e[:5] + (1.0,)
            new_edges.append(e)
        st.loop_edges = new_edges

    def _first_observer(self, order: np.ndarray):
        """(mappoint ids, index into ``order`` of each one's first
        observing keyframe) for the good points observed in ``order``."""
        st = self.store
        mp_ids = np.nonzero(st.mp_alloc & st.mp_good & ~st.mp_bad)[0]
        obs = st.obs_slot[mp_ids][:, order] >= 0
        has = obs.any(1)
        return mp_ids[has], obs[has].argmax(1)

    def _carry_points_scaled(self, order: np.ndarray, t_old: np.ndarray, c: np.ndarray) -> None:
        """X' = t'_ref + c_ref * (X - t_ref) per map point, ref = its first
        observing keyframe (rotations unchanged by scale correction)."""
        st = self.store
        mp_ids, ref = self._first_observer(order)
        if len(mp_ids) == 0:
            return
        X = st.mp_pos[mp_ids]
        st.mp_pos[mp_ids] = (st.kf_t[order][ref] + c[ref, None].astype(np.float32) * (X - t_old[ref])).astype(
            np.float32
        )

    def _correct_points_after_pgo(self, order: np.ndarray, R_old: np.ndarray, t_old: np.ndarray) -> None:
        """X' = T_new_ref * T_old_ref^-1 * X per map point, with ref = its
        first observing keyframe (insertion order)."""
        st = self.store
        mp_ids, ref = self._first_observer(order)
        if len(mp_ids) == 0:
            return
        Ro, to_ = R_old[ref], t_old[ref]
        Rn, tn = st.kf_R[order][ref], st.kf_t[order][ref]
        Xc = np.einsum("nji,nj->ni", Ro, st.mp_pos[mp_ids] - to_)  # old camera frame (R^T @ .)
        st.mp_pos[mp_ids] = (np.einsum("nij,nj->ni", Rn, Xc) + tn).astype(np.float32)

    def _full_ba_selection(self, order: np.ndarray):
        """The full BA's points and observations: ``(mp_sel, fi, p_idx,
        uvr)`` (map points; per observation its keyframe's place in
        ``order``, its point's place in ``mp_sel`` and its keypoint), or None
        under 16 observations."""
        st = self.store
        mp_ids = np.unique(st.kf_track[order][st.kf_track[order] >= 0])
        mp_ids = mp_ids[st.mp_good[mp_ids] & ~st.mp_bad[mp_ids]]
        sub = st.obs_slot[mp_ids][:, order]
        pi, fi = np.nonzero(sub >= 0)
        feat = sub[pi, fi]
        uvr = st.kf_kpts[order[fi], feat]
        n_per = np.bincount(pi, minlength=len(mp_ids))
        has_st = np.zeros(len(mp_ids), bool)
        np.logical_or.at(has_st, pi, uvr[:, 2] > 0)
        keep_p = (n_per >= 2) | has_st
        keep_o = keep_p[pi]
        pi, fi, uvr = pi[keep_o], fi[keep_o], uvr[keep_o]
        mp_used = np.nonzero(keep_p)[0]
        if len(pi) < 16:
            return None
        remap = np.full(len(mp_ids), -1, np.int32)
        remap[mp_used] = np.arange(len(mp_used), dtype=np.int32)
        return mp_ids[mp_used], fi, remap[pi], uvr

    def _replicate_full_ba(self, order: np.ndarray, sel, mesh):
        """Rank 0's full-BA problem on every rank: its keyframe order and
        selection, and the poses, frame ids and point positions they read,
        written into this rank's store (equal stores are left as they
        were)."""
        st = self.store
        mp_sel = sel[0] if sel is not None else np.zeros(0, np.int64)
        order, sel, kf_R, kf_t, kf_id, X = replicate_object(
            (order, sel, st.kf_R[order], st.kf_t[order], st.kf_frame_id[order], st.mp_pos[mp_sel]), mesh)
        mp_sel = sel[0] if sel is not None else mp_sel
        st.kf_R[order], st.kf_t[order], st.kf_frame_id[order], st.mp_pos[mp_sel] = kf_R, kf_t, kf_id, X
        return order, sel

    def _full_bundle_adjustment(self, order: np.ndarray, mesh=None) -> None:
        """BA over every keyframe and every good map point, padded to
        power-of-two buckets of points and observations (multiples of 8
        a rank). Its ``"auto"`` assembly is the sorted point reduction once
        O x P passes 128M. On a mesh the problem is rank 0's, sharded by
        ``shard_problem`` and solved by ``dist_bundle_adjust``; its points
        come back through ``shard_problem``'s permutation."""
        st = self.store
        sel = self._full_ba_selection(order)
        if mesh is not None:
            order, sel = self._replicate_full_ba(order, sel, mesh)
        if sel is None:
            return
        mp_sel, fi, p_idx, uvr = sel
        n = len(order)
        mult = 8 if mesh is None else 8 * mesh.size()

        F = self._round_up(n, 8)
        P = self._bucket_pow2(len(mp_sel), mult)
        O = self._bucket_pow2(len(fi), mult)

        def pad(a, m, tail=(), dtype=np.float32):
            out = np.zeros((m,) + tail, dtype)
            out[: len(a)] = a[:m]
            return self._upload(out)

        frame_fixed = np.concatenate([st.kf_frame_id[order] <= 2, np.ones(F - n, bool)])
        dev = self.device
        prob = BAProblem(
            R_wc=self._upload(np.concatenate([st.kf_R[order], np.tile(np.eye(3, dtype=np.float32), (F - n, 1, 1))])),
            t_wc=pad(st.kf_t[order], F, (3,)),
            frame_valid=torch.arange(F, device=dev) < n,
            frame_fixed=self._upload(frame_fixed),
            X=pad(st.mp_pos[mp_sel], P, (3,)),
            point_valid=torch.arange(P, device=dev) < len(mp_sel),
            obs_frame=pad(fi, O, (), np.int64),
            obs_point=pad(p_idx, O, (), np.int64),
            obs_uv=pad(uvr, O, (3,)),
            obs_valid=torch.arange(O, device=dev) < len(fi),
        )
        cam = self.camera
        ba_cfg = BAConfig(
            chi2_mono=self.opt_cfg.mono_point,
            chi2_stereo=self.opt_cfg.stereo_point,
            iters_phase1=self.cfg.ba_iterations_phase1,
            iters_phase2=self.cfg.ba_iterations_phase2,
            tol=self.cfg.ba_tol,
            # full BA optimizes (almost) every keyframe: the free-frame
            # bound must cover them all
            max_free_frames=F,
            bf16_point_side=self._ba_cfg.bf16_point_side,
        )
        size = {"keyframes": n, "points": len(mp_sel), "observations": len(fi)}
        if mesh is None:
            self.last_full_ba = {**size, "padded": [F, P, O],
                                 "assembly": resolve_assembly(ba_cfg, n_obs=O, n_points=P)}
            res = bundle_adjust(prob, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, ba_cfg, plain=self._plain)
            X = res.X
        else:
            w = mesh.size()
            prob_s, perm = shard_problem(prob, w)
            O = prob_s.obs_frame.shape[0]
            self.last_full_ba = {**size, "padded": [F, P, O], "assembly": "dist", "world": w,
                                 "rank_assembly": gather_objects(shard_assembly(ba_cfg, O // w, P // w), mesh)}
            res = dist_bundle_adjust(prob_s, mesh, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, ba_cfg)
            X = torch.empty_like(res.X).index_put_((torch.from_numpy(perm).to(res.X.device),), res.X)
        arr = torch.cat([res.R_wc.reshape(-1), res.t_wc.reshape(-1), X.reshape(-1)]).cpu().numpy()
        free = ~frame_fixed[:n]
        st.kf_R[order[free]] = arr[: 9 * F].reshape(F, 3, 3)[:n][free]
        st.kf_t[order[free]] = arr[9 * F : 12 * F].reshape(F, 3)[:n][free]
        st.mp_pos[mp_sel] = arr[12 * F :].reshape(P, 3)[: len(mp_sel)]
