"""Parameters carried across from the JAX package.

Each function takes a JAX parameter pytree as numpy arrays
(``jax.tree.map(np.asarray, params)``: nested dicts and lists of arrays)
and returns the state dict of the port's module, so both packages can run
on the same weights. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def superpoint_from_numpy(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``superpoint`` pytree ({name: {"w": HWIO, "b"}}) -> ``SuperPoint``
    state dict (OIHW kernels)."""
    state = {}
    for name, p in params.items():
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(p["b"], np.float32).copy())
    return state


def _flatten(node, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    if isinstance(node, dict):
        for k, v in node.items():
            flat.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            flat.update(_flatten(v, f"{prefix}{i}."))
    else:
        flat[prefix[:-1]] = np.asarray(node)
    return flat


def superglue_from_numpy(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``superglue`` pytree (``kenc``, ``layers`` with ``q/k/v/merge/mlp``,
    folded ``scale``/``shift``, ``final_proj``, ``bin_score``, optional
    ``desc_center``) -> ``SuperGlue`` state dict. The pytree's flat keys
    are the module's keys; weights stay (in, out)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in _flatten(params).items()}


# ---------------------------------------------------------------------------
# State carried across: the JAX package's NamedTuples, given as numpy
# (``jax.tree.map(np.asarray, value)``), into the port's tensors. A field's
# position decides its meaning, so any tuple with the same field order does.
# ---------------------------------------------------------------------------

def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))  # a writable copy (JAX hands out read-only buffers)
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def feature_bank_from_numpy(bank, device="cpu"):
    """(scores, kpts, desc, valid) -> ``ops.keypoints.FeatureBank``."""
    from ur_mvo_tpu_torch.ops.keypoints import FeatureBank

    scores, kpts, desc, valid = bank
    f32 = torch.float32
    return FeatureBank(scores=_tensor(scores, device, f32), kpts=_tensor(kpts, device, f32),
                       desc=_tensor(desc, device, f32), valid=_tensor(valid, device, torch.bool))


def matches_from_numpy(matches, device="cpu"):
    """(idx1, score, valid) -> ``ops.matching.Matches``."""
    from ur_mvo_tpu_torch.ops.matching import Matches

    idx1, score, valid = matches
    return Matches(idx1=_tensor(idx1, device, torch.int32), score=_tensor(score, device, torch.float32),
                   valid=_tensor(valid, device, torch.bool))


def pose_obs_from_numpy(obs, device="cpu"):
    """(X, uv, valid) -> ``ops.pose_opt.PoseObs``."""
    from ur_mvo_tpu_torch.ops.pose_opt import PoseObs

    X, uv, valid = obs
    return PoseObs(X=_tensor(X, device, torch.float32), uv=_tensor(uv, device, torch.float32),
                   valid=_tensor(valid, device, torch.bool))


def ba_problem_from_numpy(prob, device="cpu"):
    """The ten fields of a ``BAProblem`` -> ``ops.ba.BAProblem`` (indices
    as int64, masks as bool)."""
    from ur_mvo_tpu_torch.ops.ba import BAProblem

    R_wc, t_wc, frame_valid, frame_fixed, X, point_valid, obs_frame, obs_point, obs_uv, obs_valid = prob
    f32, b, i64 = torch.float32, torch.bool, torch.int64
    return BAProblem(
        R_wc=_tensor(R_wc, device, f32), t_wc=_tensor(t_wc, device, f32),
        frame_valid=_tensor(frame_valid, device, b), frame_fixed=_tensor(frame_fixed, device, b),
        X=_tensor(X, device, f32), point_valid=_tensor(point_valid, device, b),
        obs_frame=_tensor(obs_frame, device, i64), obs_point=_tensor(obs_point, device, i64),
        obs_uv=_tensor(obs_uv, device, f32), obs_valid=_tensor(obs_valid, device, b),
    )


def pose_graph_from_numpy(g, device="cpu"):
    """The nine fields of a ``PoseGraph`` -> ``ops.pose_graph.PoseGraph``."""
    from ur_mvo_tpu_torch.ops.pose_graph import PoseGraph

    R_wc, t_wc, node_valid, node_fixed, edge_i, edge_j, R_ij, t_ij, edge_weight = g
    f32, b, i64 = torch.float32, torch.bool, torch.int64
    return PoseGraph(
        R_wc=_tensor(R_wc, device, f32), t_wc=_tensor(t_wc, device, f32),
        node_valid=_tensor(node_valid, device, b), node_fixed=_tensor(node_fixed, device, b),
        edge_i=_tensor(edge_i, device, i64), edge_j=_tensor(edge_j, device, i64),
        R_ij=_tensor(R_ij, device, f32), t_ij=_tensor(t_ij, device, f32),
        edge_weight=_tensor(edge_weight, device, f32),
    )


def map_store_from(src):
    """A copy of a JAX ``MapStore`` (numpy on the host there too) as the
    port's ``runtime.map_store.MapStore``: every array, the per-keyframe
    descriptor and score banks, the loop edges, the insertion-time
    snapshots (``kf_snap_*``) and the allocation state, so both packages
    can run the same backend call on the same map."""
    import copy

    from ur_mvo_tpu_torch.runtime.map_store import MapStore, StoreConfig

    c = src.cfg
    st = MapStore(StoreConfig(max_keyframes=c.max_keyframes, max_mappoints=c.max_mappoints,
                              keypoints_per_frame=c.keypoints_per_frame, store_descriptors=c.store_descriptors,
                              descriptor_dim=c.descriptor_dim))
    for name, value in vars(src).items():
        if name != "cfg":
            setattr(st, name, copy.deepcopy(value))
    return st
