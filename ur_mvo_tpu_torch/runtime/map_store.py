"""Fixed-capacity map store: keyframes, map points, observations,
covisibility.

Own copy of ``ur_mvo_tpu.runtime.map_store`` (numpy on the host, as
there), without the snapshot save/load. An array-based redesign of the
reference's pointer-graph map: keyframes live in slots of dense numpy arrays, mappoints in a flat
table, the observer relation is a dense (MP, KF) slot matrix, and
covisibility is a dense integer weight matrix — so window selection,
observation gathering and BA-problem assembly are vectorized gathers that
feed the device programs with zero per-element Python.

The store is the single host-side mutable state object of the engine
(the reference shares its map across threads with hand-rolled mutexes —
SURVEY §5 'race detection'; here there is exactly one owner).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class StoreConfig:
    max_keyframes: int = 512
    max_mappoints: int = 32768
    keypoints_per_frame: int = 1024
    # Per-mappoint descriptors (f16) enable projection-guided local-map
    # association (ops/local_map.py). The reference stores a medoid
    # descriptor per mappoint (mappoint.h, mapping.cc:207-258); the
    # store keeps per-keyframe descriptor banks and recomputes the exact
    # medoid over live observers (update_descriptors).
    store_descriptors: bool = True
    descriptor_dim: int = 256


class MapStore:
    def __init__(self, cfg: StoreConfig):
        KF, MP, K = cfg.max_keyframes, cfg.max_mappoints, cfg.keypoints_per_frame
        self.cfg = cfg
        # keyframes
        self.kf_valid = np.zeros(KF, bool)
        self.kf_frame_id = np.full(KF, -1, np.int64)
        self.kf_timestamp = np.zeros(KF, np.float64)
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (KF, 1, 1))  # R_wc
        self.kf_t = np.zeros((KF, 3), np.float32)
        self.kf_kpts = np.zeros((KF, K, 3), np.float32)  # u, v, u_right(-1 mono)
        self.kf_track = np.full((KF, K), -1, np.int32)  # mappoint slot per feature
        # mappoints
        self.mp_alloc = np.zeros(MP, bool)
        self.mp_good = np.zeros(MP, bool)  # triangulated (reference 'Good')
        self.mp_bad = np.zeros(MP, bool)
        self.mp_pos = np.zeros((MP, 3), np.float32)
        self.mp_obs_count = np.zeros(MP, np.int32)
        self.mp_desc = (
            np.zeros((MP, cfg.descriptor_dim), np.float16) if cfg.store_descriptors else None
        )
        # per-keyframe feature-descriptor banks, (K, D) f16 each, filled
        # lazily at insertion (~0.5 MB/keyframe) — the observer
        # descriptors behind the exact medoid in update_descriptors
        self.kf_desc: Dict[int, np.ndarray] = {}
        # per-keyframe detection scores (K,) f16: adopt_map rebuilds a
        # reference bank whose scores the SuperGlue keypoint encoder
        # actually saw in training (all-ones is out-of-distribution)
        self.kf_scores: Dict[int, np.ndarray] = {}
        # observer relation: slot of mappoint in keyframe, -1 when absent
        self.obs_slot = np.full((MP, KF), -1, np.int16)
        # covisibility weights between keyframes
        self.covis = np.zeros((KF, KF), np.int32)
        # per-keyframe global descriptor (raw mean of its feature
        # descriptors) for loop-closure retrieval; queries re-center by
        # the all-keyframe mean (see Backend.detect_loop) so collapsed
        # descriptor spaces still discriminate places
        self.kf_gdesc = np.zeros((KF, cfg.descriptor_dim), np.float32)
        # accepted loop-closure constraints:
        # (slot_i, slot_j, R_ij (3,3), t_ij (3,), weight) with
        # T_ij = T_i^-1 T_j measured by geometric verification
        self.loop_edges: list = []
        # Self-consistent geometry snapshot taken at insertion time:
        # the keyframe's pose + the positions of its tracked Good
        # mappoints AT THAT MOMENT. Loop-closure verification solves PnP
        # in this frame (Backend.detect_loop): later BA can drag early
        # points toward drifted observers while the gauge-fixed early
        # POSES stay put, and PnP against that inconsistent pair lands
        # in between — measured as a 0.26 m bias on a 3 m square whose
        # true closure offset is 0.
        self.kf_snap_pos = np.zeros((KF, K, 3), np.float32)
        self.kf_snap_ok = np.zeros((KF, K), bool)
        self.kf_snap_R = np.tile(np.eye(3, dtype=np.float32), (KF, 1, 1))
        self.kf_snap_t = np.zeros((KF, 3), np.float32)

        self._next_kf = 0
        self._next_mp = 0
        # Culling returns slots/ids for reuse so a bounded-capacity store
        # sustains unbounded-length runs (without reuse, a 512-capacity
        # store exhausts after ~85 s of 30 fps video even when culling
        # keeps only 30 keyframes live). Mappoint ids are recycled ONLY
        # when they had zero live observations at cull time — any id the
        # tracker still carries has a live observation in a live
        # keyframe (see cull()), so recycling cannot relink stale
        # references.
        self._free_kf: list = []
        self._free_mp: list = []
        self.frame_id_to_slot: Dict[int, int] = {}

    # -- allocation ---------------------------------------------------------

    def num_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    def alloc_keyframe(self, frame_id: int, timestamp: float, R_wc: np.ndarray, t_wc: np.ndarray,
                       kpts: np.ndarray, valid_slots: np.ndarray,
                       desc: np.ndarray = None, scores: np.ndarray = None) -> int:
        """Insert a keyframe; returns its store slot. ``kpts``: (K, 3).
        ``desc`` (K, D) fills the place-recognition global descriptor
        (mean of valid feature descriptors; see Backend.detect_loop);
        ``scores`` (K,) detection scores persist for reference-bank
        reconstruction (Tracker.adopt_map)."""
        if self._free_kf:
            s = self._free_kf.pop()
        elif self._next_kf < self.cfg.max_keyframes:
            s = self._next_kf
            self._next_kf += 1
        else:
            raise RuntimeError("keyframe capacity exceeded; enable culling for unbounded runs")
        self.kf_valid[s] = True
        self.kf_frame_id[s] = frame_id
        self.kf_timestamp[s] = timestamp
        self.kf_R[s] = R_wc
        self.kf_t[s] = t_wc
        self.kf_kpts[s] = np.where(valid_slots[:, None], kpts, 0.0)
        if desc is not None and valid_slots.any():
            self.kf_gdesc[s] = np.asarray(desc)[valid_slots].astype(np.float32).mean(0)
        if desc is not None and self.mp_desc is not None:
            self.kf_desc[s] = np.asarray(desc).astype(np.float16)
        if scores is not None:
            self.kf_scores[s] = np.asarray(scores).astype(np.float16)
        self.frame_id_to_slot[frame_id] = s
        return s

    def snapshot_keyframe_geometry(self, slot: int) -> None:
        """Record the keyframe's insertion-time (pose, tracked-point
        positions) pair — call once after its observations/triangulations
        are registered. See the kf_snap_* field comment."""
        track = self.kf_track[slot]
        safe = np.maximum(track, 0)
        ok = (track >= 0) & self.mp_good[safe] & ~self.mp_bad[safe]
        self.kf_snap_pos[slot] = np.where(ok[:, None], self.mp_pos[safe], 0.0)
        self.kf_snap_ok[slot] = ok
        self.kf_snap_R[slot] = self.kf_R[slot]
        self.kf_snap_t[slot] = self.kf_t[slot]

    def alloc_mappoints(self, n: int) -> np.ndarray:
        n_reuse = min(len(self._free_mp), n)
        reused = np.asarray(self._free_mp[len(self._free_mp) - n_reuse:], np.int32)
        del self._free_mp[len(self._free_mp) - n_reuse:]
        n_fresh = n - n_reuse
        if self._next_mp + n_fresh > self.cfg.max_mappoints:
            raise RuntimeError("mappoint capacity exceeded; enable culling for unbounded runs")
        fresh = np.arange(self._next_mp, self._next_mp + n_fresh, dtype=np.int32)
        self._next_mp += n_fresh
        ids = np.concatenate([reused, fresh]) if n_reuse else fresh
        if n_reuse:
            # recycled rows carry a dead point's state — scrub it
            self.mp_good[reused] = False
            self.mp_bad[reused] = False
            self.mp_pos[reused] = 0.0
            self.mp_obs_count[reused] = 0
            if self.mp_desc is not None:
                self.mp_desc[reused] = 0.0
        self.mp_alloc[ids] = True
        return ids

    # -- observations -------------------------------------------------------

    def add_observations(self, kf_slot: int, mp_ids: np.ndarray, feat_slots: np.ndarray) -> None:
        """Register mappoint ``mp_ids`` observed at ``feat_slots`` of
        keyframe ``kf_slot``; updates track table, observer matrix,
        observation counts and covisibility."""
        mp_ids = np.asarray(mp_ids, np.int32)
        feat_slots = np.asarray(feat_slots, np.int64)
        self.kf_track[kf_slot, feat_slots] = mp_ids
        fresh = self.obs_slot[mp_ids, kf_slot] < 0
        self.obs_slot[mp_ids, kf_slot] = feat_slots.astype(np.int16)
        self.mp_obs_count[mp_ids[fresh]] += 1
        # covisibility: this kf now shares mp with every other observer kf
        other = self.obs_slot[mp_ids] >= 0  # (n, KF)
        counts = other.sum(axis=0).astype(np.int32)
        counts[kf_slot] = 0
        self.covis[kf_slot] += counts
        self.covis[:, kf_slot] += counts

    def update_descriptors(self, mp_ids: np.ndarray, descs: np.ndarray = None) -> None:
        """Per-mappoint *sum*-medoid descriptor recompute.

        Deliberate divergence from ``Mapping::UpdateMappointDescriptor``
        (``mapping.cc:207-258``): the reference picks the observer with
        the least MEDIAN distance to the others (integer-truncated
        median index, ``mapping.cc:244-256``) and simply keeps the FIRST
        observation when there are ≤2 observers. We instead minimize the
        SUMMED distance ``Σ_j 2(1 - f_i·f_j)`` — for L2-normalized
        descriptors that argmin is exactly ``argmax_i f_i·S`` with
        ``S = Σ_j f_j`` (the ``f_i·f_i`` term is constant across
        candidates), so the medoid over ALL live observers is one gather
        + one batched dot against the group sum, no pairwise distance
        matrix. The two rules can pick different representatives under
        multimodal viewpoint distributions (the sum-medoid favors the
        densest mode overall, the median-medoid is insensitive to the
        far tail); the sum-medoid is better-behaved on fixed-shape data
        and at ≤2 observers degenerates to the higher-scoring of the two
        rather than an arbitrary first pick. Because it reads only LIVE
        observations (``obs_slot``), outlier removals drop out of the
        medoid the next time the point is touched, matching the
        reference's full recompute. ``descs`` is accepted for call-site
        compatibility but unused: observer descriptors come from the
        per-keyframe banks (``kf_desc``).
        """
        if self.mp_desc is None or len(mp_ids) == 0:
            return
        umps = np.unique(np.asarray(mp_ids, np.int64))
        obs = self.obs_slot[umps]  # (n, KF)
        pi, pk = np.nonzero(obs >= 0)  # row-major: pi is non-decreasing
        if len(pi) == 0:
            return
        slots = obs[pi, pk].astype(np.int64)
        f = np.zeros((len(pi), self.cfg.descriptor_dim), np.float32)
        have = np.zeros(len(pi), bool)
        for k in np.unique(pk):
            bank = self.kf_desc.get(int(k))
            if bank is None:
                continue  # keyframe inserted without descriptors
            m = pk == k
            f[m] = bank[slots[m]].astype(np.float32)
            have[m] = True
        new_group = np.r_[True, pi[1:] != pi[:-1]]
        starts = np.nonzero(new_group)[0]
        S = np.add.reduceat(f, starts, axis=0)  # per-mappoint Σ f_j
        group_of = np.cumsum(new_group) - 1
        score = np.einsum("od,od->o", f, S[group_of])
        score[~have] = -np.inf
        order = np.lexsort((score, pi))
        pi_s, score_s = pi[order], score[order]
        last = np.nonzero(np.r_[pi_s[1:] != pi_s[:-1], True])[0]
        win = order[last]
        upd = np.isfinite(score_s[last])  # groups with ≥1 real observer
        self.mp_desc[umps[pi_s[last][upd]]] = f[win[upd]].astype(np.float16)

    def remove_observation(self, kf_slot: int, mp_id: int) -> None:
        """Detach one observation (outlier removal, ``mapping.cc:550-603``)."""
        slot = self.obs_slot[mp_id, kf_slot]
        if slot < 0:
            return
        self.obs_slot[mp_id, kf_slot] = -1
        if self.kf_track[kf_slot, slot] == mp_id:
            self.kf_track[kf_slot, slot] = -1
        self.mp_obs_count[mp_id] -= 1
        # decrease covisibility with remaining observers
        others = np.nonzero(self.obs_slot[mp_id] >= 0)[0]
        self.covis[kf_slot, others] -= 1
        self.covis[others, kf_slot] -= 1
        np.maximum(self.covis, 0, out=self.covis)

    def remove_observations(self, kf_slots: np.ndarray, mp_ids: np.ndarray) -> None:
        """Batch outlier detachment: net-identical to sequential
        :meth:`remove_observation` over the pairs (already-detached and
        duplicate pairs are skipped), but the covisibility accounting is
        two small matmuls instead of per-observation row updates — BA
        write-back removes hundreds of outliers per keyframe and the
        Python loop was a measurable share of the host budget.

        Covisibility semantics: per mappoint, every unordered keyframe
        pair that loses this shared observation is decremented exactly
        once — pairs (removed, surviving) and (removed, removed) alike,
        matching the sequential order-processing."""
        kf = np.asarray(kf_slots, np.int64).ravel()
        mp = np.asarray(mp_ids, np.int64).ravel()
        if len(kf) == 0:
            return
        pairs = np.unique(np.stack([mp, kf], 1), axis=0)
        mp, kf = pairs[:, 0], pairs[:, 1]
        live = self.obs_slot[mp, kf] >= 0
        mp, kf = mp[live], kf[live]
        if len(kf) == 0:
            return
        umps, inv = np.unique(mp, return_inverse=True)
        KF = self.covis.shape[0]
        P = (self.obs_slot[umps] >= 0).astype(np.float32)  # observers before removal
        D = np.zeros((len(umps), KF), np.float32)
        D[inv, kf] = 1.0

        slots = self.obs_slot[mp, kf].astype(np.int64)
        self.obs_slot[mp, kf] = -1
        match = self.kf_track[kf, slots] == mp
        self.kf_track[kf[match], slots[match]] = -1
        np.subtract.at(self.mp_obs_count, mp, 1)

        # delta[a, b] = sum_mp (D_a P_b + P_a D_b - D_a D_b): 1 per
        # unordered observer pair with at least one side removed
        M = D.T @ P
        delta = M + M.T - D.T @ D
        np.fill_diagonal(delta, 0.0)
        self.covis -= delta.astype(self.covis.dtype)
        np.maximum(self.covis, 0, out=self.covis)

    # -- queries ------------------------------------------------------------

    def keyframe_slots(self) -> np.ndarray:
        return np.nonzero(self.kf_valid)[0]

    def window_frames(self, kf_slot: int, target: int = 15) -> np.ndarray:
        """Covisibility neighborhood of a keyframe, reference semantics
        (``mapping.cc:260-322``): all keyframes when few, else the top
        covisible first layer then BFS deeper layers until ``target``."""
        slots = self.keyframe_slots()
        if len(slots) <= target:
            return slots
        selected = [kf_slot]
        in_sel = np.zeros(self.cfg.max_keyframes, bool)
        in_sel[kf_slot] = True
        # first layer: strongest direct connections
        w = self.covis[kf_slot].copy()
        w[~self.kf_valid] = 0
        order = np.argsort(-w)
        for s in order:
            if len(selected) >= target:
                break
            if w[s] > 0 and not in_sel[s]:
                selected.append(int(s))
                in_sel[s] = True
        # deeper layers
        while len(selected) < target:
            acc = self.covis[selected].sum(axis=0)
            acc[in_sel] = 0
            acc[~self.kf_valid] = 0
            if acc.max() <= 0:
                break
            order = np.argsort(-acc)
            added = False
            for s in order:
                if len(selected) >= target:
                    break
                if acc[s] > 0:
                    selected.append(int(s))
                    in_sel[s] = True
                    added = True
            if not added:
                break
        return np.asarray(sorted(selected))

    def observers_of(self, mp_ids: np.ndarray) -> np.ndarray:
        """(n, KF) boolean observer incidence for the given mappoints."""
        return self.obs_slot[mp_ids] >= 0

    def trajectory(self) -> tuple:
        """All keyframe (timestamps, R_wc, t_wc) in insertion order."""
        slots = self.keyframe_slots()
        order = slots[np.argsort(self.kf_frame_id[slots])]
        return self.kf_timestamp[order], self.kf_R[order], self.kf_t[order]

    def cull(self, max_keyframes: int, max_mappoints: int) -> None:
        """Oldest-first culling (``Mapping::KeyFrameCulling``,
        ``mapping.cc:26-39`` — caps 30 keyframes / 10k points; the
        reference ships it disabled, ``tracking.cc:317``). Removed
        keyframe slots go to the free list for reuse.

        Mappoints: zero-live-observation orphans are reaped first
        (outlier-removal leftovers and points whose observers were all
        culled); if the cap is still exceeded, the LEAST-OBSERVED older
        points are detached (observations removed, then reaped) — but
        never points observed by the NEWEST keyframe. That exclusion is
        what makes id recycling safe: every id the tracker still
        references (frame track tables, candidate snapshots,
        untriangulated carries) is registered as an observation in the
        newest keyframe, so a reaped id is unreachable from any live
        state."""
        slots = self.keyframe_slots()
        if len(slots) > max_keyframes:
            order = slots[np.argsort(self.kf_frame_id[slots])]
            for s in order[: len(slots) - max_keyframes]:
                self._remove_keyframe(int(s))
        alive = self.mp_alloc & ~self.mp_bad
        n_over = int(alive.sum()) - max_mappoints
        if n_over > 0:
            orphan = np.nonzero(alive & ~(self.obs_slot >= 0).any(axis=1))[0]
            kill = orphan[:n_over]
            self.mp_bad[kill] = True
            self.mp_good[kill] = False
            n_over -= len(kill)
        if n_over > 0:
            # orphans were not enough: detach least-observed points,
            # protecting the newest keyframe's tracks (see docstring)
            slots = self.keyframe_slots()
            cand = np.nonzero(self.mp_alloc & ~self.mp_bad)[0]
            if len(slots):
                newest = int(slots[np.argmax(self.kf_frame_id[slots])])
                cand = cand[self.obs_slot[cand, newest] < 0]
            obs_n = (self.obs_slot[cand] >= 0).sum(axis=1)
            for mp in cand[np.argsort(obs_n, kind="stable")][:n_over]:
                self._remove_mappoint(int(mp))
        # reap dead zero-observation points onto the free list
        dead = np.nonzero(self.mp_alloc & self.mp_bad & ~(self.obs_slot >= 0).any(axis=1))[0]
        if len(dead):
            self.mp_alloc[dead] = False
            self._free_mp.extend(int(m) for m in dead)

    def _remove_keyframe(self, s: int) -> None:
        mps = np.nonzero(self.obs_slot[:, s] >= 0)[0]
        self.remove_observations(np.full(len(mps), s), mps)
        self.kf_valid[s] = False
        fid = int(self.kf_frame_id[s])
        self.frame_id_to_slot.pop(fid, None)
        self.kf_frame_id[s] = -1
        self.kf_track[s] = -1
        self.covis[s, :] = 0
        self.covis[:, s] = 0
        self.kf_gdesc[s] = 0.0
        self.kf_desc.pop(s, None)
        self.kf_scores.pop(s, None)
        self.kf_snap_pos[s] = 0.0
        self.kf_snap_ok[s] = False
        self.kf_snap_R[s] = np.eye(3, dtype=np.float32)
        self.kf_snap_t[s] = 0.0
        self.loop_edges = [e for e in self.loop_edges if e[0] != s and e[1] != s]
        self._free_kf.append(s)

    def _remove_mappoint(self, mp: int) -> None:
        kfs = np.nonzero(self.obs_slot[mp] >= 0)[0]
        self.remove_observations(kfs, np.full(len(kfs), mp))
        self.mp_bad[mp] = True
        self.mp_good[mp] = False
