"""Mapping backend: keyframe insertion, triangulation, windowed BA (port of
``ur_mvo_tpu.runtime.backend``; loop closure, relocalization and global
optimization are not ported yet).

Per keyframe: create mappoints for unmatched features, multi-view
triangulate once a point has > 2 observers, covisibility-window local BA
with <= 15 optimizable + <= 20 extra fixed frames, outlier observation
removal with covisibility decay.

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
from ur_mvo_tpu_torch.ops.ba import BAConfig, BAProblem, bundle_adjust
from ur_mvo_tpu_torch.ops.triangulation import triangulate_bearings
from ur_mvo_tpu_torch.runtime.map_store import MapStore, StoreConfig


class Backend:
    def __init__(
        self,
        camera: Camera,
        backend_cfg: BackendConfig,
        opt_cfg: OptimizationConfig,
        store: Optional[MapStore] = None,
        keypoints_per_frame: int = 1024,
        device="cuda",
    ):
        if backend_cfg.loop_closure:
            raise NotImplementedError("backend.loop_closure: loop closure is not ported yet")
        if backend_cfg.relocalization:
            raise NotImplementedError("backend.relocalization: relocalization is not ported yet")
        self.device = resolve_device(device)
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
        )
        F_pad = self._round_up(backend_cfg.window_opt_frames + backend_cfg.window_fixed_frames + 1, 4)
        self._ba_dims = (F_pad, backend_cfg.ba_max_points, backend_cfg.ba_max_observations)
        # Async keyframe BA (cfg.ba_async): the result tensor stays on the
        # device and is read one keyframe later.
        self._pending_ba = None

    def _tri_batch(self, packed: np.ndarray) -> np.ndarray:
        """Batched ray triangulation with packed I/O: (n, M, 7) rows
        [origin | bearing | valid] up, (n, 4) [xyz | ok] back."""
        p = torch.from_numpy(packed).to(self.device)
        pts, ok = triangulate_bearings(p[..., 0:3], p[..., 3:6], p[..., 6] > 0.5)
        return torch.cat([pts, ok[:, None].to(torch.float32)], dim=1).cpu().numpy()

    def _ba(self, flat: np.ndarray) -> torch.Tensor:
        """Windowed BA with PACKED I/O: ONE flat float32 upload
        [frames (F,14) | points (P,4) | observations (O,6)] and one
        float32 result [R_wc(9F), t_wc(3F), X(3P), obs_inlier(O)], left on
        the device for the caller to read."""
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
        res = bundle_adjust(prob, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, self._ba_cfg)
        return torch.cat([
            res.R_wc.reshape(-1), res.t_wc.reshape(-1), res.X.reshape(-1),
            res.obs_inlier.to(torch.float32),
        ])

    def reset_state(self) -> None:
        """Fresh map and bookkeeping."""
        self.flush_pending_ba()
        self.store = MapStore(self.store.cfg)
        self._pending_ba = None

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
