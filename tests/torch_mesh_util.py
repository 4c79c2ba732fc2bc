"""Helpers shared by the port's mesh tests (``tests/test_torch_parallel.py``,
``tests/test_torch_loop.py``, ``tests/test_torch_multi_seq.py``): a world of
one rank in the calling process, and the drifted map that
``global_optimize`` is held on. A rank of ``tests/test_torch_parallel.py``
imports this module and must not import JAX: ``make_drifted_map`` imports
the JAX package's store where it is called."""

import contextlib

import numpy as np
import torch

from ur_mvo_tpu_torch.parallel import mesh as tmesh
from ur_mvo_tpu_torch.utils.synthscene import so3_exp

N_KF, N_PTS, K_FEAT = 12, 240, 256
CAM = (320, 240, 260.0, 260.0, 160.0, 120.0)


@contextlib.contextmanager
def one_rank_mesh(workdir):
    """A world of this process alone (gloo on the CPU, a ``file://``
    rendezvous in ``workdir``) and its mesh, torn down on exit."""
    tmesh.init_distributed("gloo", init_method=f"file://{workdir}/one_rank", world_size=1, rank=0, device="cpu")
    try:
        yield tmesh.make_mesh(1)
    finally:
        torch.distributed.destroy_process_group()


def make_drifted_map():
    """A JAX store over a forward path: 12 keyframes (frame ids 0, 2, 7,
    12, ...: the first two are the full BA's gauge) with scale and heading
    drift that grows along the path, 240 triangulated points
    observed by every keyframe that sees them (0.5 px noise), and one
    loop edge from the first to the last keyframe measured from the truth
    with an inter-leg scale of 1.25."""
    from ur_mvo_tpu.runtime.map_store import MapStore as JaxStore
    from ur_mvo_tpu.runtime.map_store import StoreConfig as JaxStoreConfig

    rng = np.random.default_rng(5)
    st = JaxStore(JaxStoreConfig(max_keyframes=16, max_mappoints=512, keypoints_per_frame=K_FEAT))
    fx, fy, cx, cy = CAM[2:]
    X = np.stack([rng.uniform(-2, 5, N_PTS), rng.uniform(-1.5, 1.5, N_PTS), rng.uniform(4, 8, N_PTS)], 1)
    R_true = [so3_exp(np.array([0.0, 0.04 * k, 0.0])) for k in range(N_KF)]
    t_true = [np.array([0.25 * k, 0.02 * np.sin(k), 0.0]) for k in range(N_KF)]
    mp = st.alloc_mappoints(N_PTS)
    st.mp_good[mp] = True
    slots = []
    for k in range(N_KF):
        pc = (X - t_true[k]) @ R_true[k]
        u, v = fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy
        seen = (pc[:, 2] > 0.5) & (u > 0) & (u < CAM[0]) & (v > 0) & (v < CAM[1])
        kpts = np.zeros((K_FEAT, 3), np.float32)
        kpts[:N_PTS] = np.stack([u + rng.normal(0, 0.5, N_PTS), v + rng.normal(0, 0.5, N_PTS), -np.ones(N_PTS)], 1)
        drift = 1.0 + 0.02 * k
        R_est = so3_exp(np.array([0.0, 0.004 * k, 0.002 * k])) @ R_true[k]
        s = st.alloc_keyframe(max(5 * k - 3, 0), k / 6.0, R_est.astype(np.float32), (drift * t_true[k]).astype(np.float32),
                              kpts, np.arange(K_FEAT) < N_PTS)
        ids = np.nonzero(seen)[0]
        st.add_observations(s, mp[ids], ids)
        slots.append(s)
    st.mp_pos[mp] = (X + rng.normal(0, 0.03, X.shape)).astype(np.float32)
    for s in slots:
        st.snapshot_keyframe_geometry(s)
    R_ij = (R_true[0].T @ R_true[-1]).astype(np.float32)
    t_ij = (R_true[0].T @ (t_true[-1] - t_true[0])).astype(np.float32)
    st.loop_edges.append((slots[0], slots[-1], R_ij, t_ij, 3.0, 1.25))
    return st, np.asarray(slots)
