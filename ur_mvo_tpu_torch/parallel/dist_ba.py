"""Distributed bundle adjustment: points and observations sharded over the
ranks of a mesh, the Schur-reduced camera system summed with one
``all_reduce`` a step (port of ``ur_mvo_tpu.parallel.dist_ba``).

Keyframe poses are small and replicated; map points and their
observations are partitioned (each point's observations live on its
owner rank, so its camera-point coupling blocks are complete there). Every
rank builds its partial ``H_cc``, ``b_c``, the partial Schur reduction
``U Hpp^-1 U^T`` and its right-hand side, one ``all_reduce`` forms the
global (6 FF, 6 FF) system, every rank solves it redundantly (cheaper than
gathering), and the point updates back-substitute locally. The LM loop is
``ops/ba.bundle_adjust`` itself, given the mesh's sum (a fixed count of
masked iterations, nothing read back to the host), so every branch is
taken on all-reduced values and the ranks meet at every collective.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ur_mvo_tpu_torch.ops.ba import ONE_HOT_LIMIT, BAConfig, BAProblem, BAResult, bundle_adjust
from ur_mvo_tpu_torch.parallel.mesh import all_sum, gather_batch


def shard_problem(prob: BAProblem, n_shards: int):
    """Host-side repartition for a mesh of ``n_shards`` ranks. Returns
    ``(prob_s, perm_p)``: ``prob_s`` has shard ``s``'s points in the block
    ``[s*Pl, (s+1)*Pl)`` and its observations in ``[s*Ol, (s+1)*Ol)``;
    ``perm_p[k]`` is the old index of new point ``k`` (so the caller writes
    results back with ``X_old[perm_p] = X_new``).

    Points go to shards greedily by descending observation count, each to
    the lightest shard with a free point slot, so that the shards' point and
    observation counts stay balanced. Where the heaviest shard's
    observations overflow ``O / n``, the observation padding grows to fit
    it. Padding rows fill each block's tail and point at the block's first
    point (their weight is zero). Frame arrays stay replicated. The integer
    layout is that of ``ur_mvo_tpu/parallel/dist_ba.py:45-145``."""
    P_ = prob.X.shape[0]
    O = prob.obs_frame.shape[0]
    if P_ % n_shards or O % n_shards:
        raise ValueError(f"shard_problem: pad P ({P_}) and O ({O}) to multiples of the mesh size {n_shards}")
    Pl = P_ // n_shards
    obs_p_old = prob.obs_point.cpu().numpy().astype(np.int64)
    valid = prob.obs_valid.cpu().numpy()

    obs_count = np.bincount(obs_p_old[valid], minlength=P_)
    point_order = np.argsort(-obs_count, kind="stable")
    load, fill = [0] * n_shards, [0] * n_shards
    new_p = np.empty(P_, np.int64)
    for p in point_order.tolist():
        # the lightest shard with room; the lowest index among equals
        s = min((load[k], k) for k in range(n_shards) if fill[k] < Pl)[1]
        new_p[p] = s * Pl + fill[s]
        load[s] += int(obs_count[p])
        fill[s] += 1
    perm_p = np.empty(P_, np.int64)
    perm_p[new_p] = np.arange(P_)

    obs_p_new = new_p[obs_p_old]
    obs_shard = obs_p_new // Pl
    cap = O // n_shards
    by_shard = [np.nonzero((obs_shard == s) & valid)[0] for s in range(n_shards)]
    grow = max(0, max(len(b) for b in by_shard) - cap) * n_shards
    if grow:
        # lumpy track lengths defeat the balance: grow the padding so the
        # heaviest shard fits
        cap += grow // n_shards

        def extend(t):
            return torch.cat([t, torch.zeros((grow,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)])

        prob = prob._replace(obs_frame=extend(prob.obs_frame), obs_point=extend(prob.obs_point),
                             obs_uv=extend(prob.obs_uv), obs_valid=extend(prob.obs_valid))
        valid = np.concatenate([valid, np.zeros(grow, bool)])
        obs_p_new = np.concatenate([obs_p_new, np.zeros(grow, np.int64)])
    pad_pool = np.nonzero(~valid)[0].tolist()
    order, pad_point = [], []
    for s in range(n_shards):
        take = by_shard[s].tolist()
        need = cap - len(take)
        order += take + [pad_pool.pop() for _ in range(need)]
        pad_point += [-1] * len(take) + [s * Pl] * need
    order = np.asarray(order, np.int64)
    pad_point = np.asarray(pad_point, np.int64)
    obs_point = np.where(pad_point >= 0, pad_point, obs_p_new[order])

    dev = prob.X.device
    perm_t, order_t = torch.from_numpy(perm_p).to(dev), torch.from_numpy(order).to(dev)
    prob_s = prob._replace(
        X=prob.X[perm_t], point_valid=prob.point_valid[perm_t],
        obs_frame=prob.obs_frame[order_t], obs_point=torch.from_numpy(obs_point).to(dev),
        obs_uv=prob.obs_uv[order_t], obs_valid=prob.obs_valid[order_t],
    )
    return prob_s, perm_p


def shard_assembly(cfg: BAConfig, n_obs: int, n_points: int) -> str:
    """A shard's point-side assembly, by the JAX package's shard rule
    (``ur_mvo_tpu/parallel/dist_ba.py:218-230``): below the one-hot bound
    and unless ``"scatter"`` is asked for, bf16 summands with float32 sums
    (``"bf16_point_side"``, the one-hot matmul's numerics); else exact
    float32 ``index_add_`` (``"scatter"``). The point-reduce kernels do not
    run on a shard."""
    if cfg.assembly != "scatter" and n_obs * n_points <= ONE_HOT_LIMIT:
        return "bf16_point_side"
    return "scatter"


def _local_block(prob: BAProblem, n: int, rank: int) -> BAProblem:
    """Rank ``rank``'s points and observations of a :func:`shard_problem`
    layout, its observations pointing at local point indices."""
    Pl, Ol = prob.X.shape[0] // n, prob.obs_frame.shape[0] // n
    ps, os_ = slice(rank * Pl, (rank + 1) * Pl), slice(rank * Ol, (rank + 1) * Ol)
    return prob._replace(X=prob.X[ps], point_valid=prob.point_valid[ps], obs_frame=prob.obs_frame[os_],
                         obs_point=prob.obs_point[os_] - rank * Pl, obs_uv=prob.obs_uv[os_],
                         obs_valid=prob.obs_valid[os_])


def dist_bundle_adjust(prob: BAProblem, mesh: DeviceMesh, fx: float, fy: float, cx: float, cy: float,
                       bf: float = 0.0, cfg: BAConfig = BAConfig()) -> BAResult:
    """Sharded two-phase LM BA over ``mesh``. ``prob`` comes from
    :func:`shard_problem` with ``n_shards`` = the mesh size, the same on
    every rank; each rank runs ``bundle_adjust`` on its block with the
    assembly :func:`shard_assembly` names, summing the reduced camera system
    (``H_cc``, ``b_c``, the partial Schur and its right-hand side) in ONE
    ``all_reduce`` a step and each cost in one more. Returns ``R_wc``,
    ``t_wc`` and ``cost`` replicated, ``X`` and ``obs_inlier`` gathered to
    their full length (in ``prob``'s sharded order) on every rank."""
    n, rank = mesh.size(), mesh.get_local_rank()
    P_, O_ = prob.X.shape[0], prob.obs_frame.shape[0]
    if P_ % n or O_ % n:
        raise ValueError(f"dist_bundle_adjust: P ({P_}) and O ({O_}) must split over {n} ranks (shard_problem)")
    bf16 = shard_assembly(cfg, O_ // n, P_ // n) == "bf16_point_side"
    res = bundle_adjust(_local_block(prob, n, rank), fx, fy, cx, cy, bf,
                        cfg._replace(assembly="scatter", bf16_point_side=bf16), psum=lambda ts: all_sum(ts, mesh))
    return res._replace(X=gather_batch(res.X, mesh), obs_inlier=gather_batch(res.obs_inlier, mesh))
