"""The port's loop-closure machinery against the JAX package on the CPU:
loop detection on the collapsed-descriptor store of
``tests/test_loop_closure.py``, the Sim3 scale helpers and
``global_optimize`` (scale ramp, pose graph, point correction, full BA) on
one map carried into both packages (``weights.map_store_from``), and the
loop-bearing trajectory of the long protocol.

The helpers are numpy in both packages: equal to 1e-6. Loop verification
draws its PnP hypotheses from different samplers (``jax.random`` and a
``torch.Generator``), so the two edges are each held to the truth at the
JAX test's tolerance (R 0.02, t 0.05) and to each other at that of the
refinement (5e-3). ``global_optimize`` agrees to float32 rounding
up to its full BA, which both packages then run in float32 (1e-4).
"""

import numpy as np
import pytest
import torch

from tests.test_loop_closure import _collapsed_descriptor_views
from ur_mvo_tpu import camera as jcamera
from ur_mvo_tpu import config as jconfig
from ur_mvo_tpu.runtime.backend import Backend as JaxBackend
from ur_mvo_tpu.runtime.map_store import MapStore as JaxStore
from ur_mvo_tpu.runtime.map_store import StoreConfig as JaxStoreConfig
from ur_mvo_tpu.utils.synthscene import out_and_back_trajectory as jax_out_and_back
from ur_mvo_tpu_torch import camera as tcamera
from ur_mvo_tpu_torch import config as tconfig
from ur_mvo_tpu_torch.runtime.backend import Backend
from ur_mvo_tpu_torch.utils.synthscene import out_and_back_trajectory, so3_exp
from ur_mvo_tpu_torch.weights import map_store_from
from tests.torch_mesh_util import CAM, N_KF, make_drifted_map, one_rank_mesh


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: PyTorch's
    intra-op thread pool costs several times what it gives there, most of
    all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_backend(cam_args, jstore, **bcfg):
    """The port's backend on a copy of the JAX store ``jstore``."""
    return Backend(tcamera.make_pinhole(*cam_args), tconfig.BackendConfig(**bcfg), tconfig.OptimizationConfig(),
                   store=map_store_from(jstore), keypoints_per_frame=jstore.cfg.keypoints_per_frame, device="cpu")


def _backends(cam_args, jstore, **bcfg):
    """A JAX backend on ``jstore`` and the port's on a copy of it."""
    jb = JaxBackend(jcamera.make_pinhole(*cam_args), jconfig.BackendConfig(**bcfg), jconfig.OptimizationConfig(),
                    store=jstore, keypoints_per_frame=jstore.cfg.keypoints_per_frame)
    return jb, _port_backend(cam_args, jstore, **bcfg)


def _assert_same_store(a, b, atol):
    for f in ("kf_R", "kf_t", "mp_pos"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), atol=atol, err_msg=f)
    assert [e[:2] + e[4:] for e in a.loop_edges] == [e[:2] + e[4:] for e in b.loop_edges]


def test_out_and_back_trajectory_matches_jax():
    np.testing.assert_allclose(out_and_back_trajectory(120), jax_out_and_back(120), atol=1e-6)


# ---------------------------------------------------------------------------
# detect_loop on a collapsed descriptor space
# ---------------------------------------------------------------------------

def test_detect_loop_on_collapsed_descriptors_matches_jax():
    """``tests/test_loop_closure.py::test_loop_verification_survives_collapsed_descriptors``:
    the store is built by the JAX backend, carried into the port, and the
    revisit keyframe runs ``detect_loop`` in both."""
    rng = np.random.default_rng(3)
    K, D = 64, 256
    desc_cand, desc_query = _collapsed_descriptor_views(rng, K=K, D=D)
    cam = (256, 256, 400.0, 400.0, 128.0, 128.0)
    bcfg = dict(window_opt_frames=4, window_fixed_frames=4, ba_max_points=256, ba_max_observations=512,
                ba_iterations_phase1=2, ba_iterations_phase2=1, max_keyframes=16, max_mappoints=1024,
                loop_closure=True, loop_min_gap_frames=30, loop_min_inliers=25)
    jstore = JaxStore(JaxStoreConfig(max_keyframes=16, max_mappoints=1024, keypoints_per_frame=K))
    jb = JaxBackend(jcamera.make_pinhole(*cam), jconfig.BackendConfig(**bcfg), jconfig.OptimizationConfig(),
                    store=jstore, keypoints_per_frame=K)
    X = np.stack([rng.uniform(-0.7, 0.7, K), rng.uniform(-0.7, 0.7, K), rng.uniform(4.0, 8.0, K)], 1).astype(np.float32)

    def project(t_wc):
        Xc = X - t_wc[None]
        return np.stack([400.0 * Xc[:, 0] / Xc[:, 2] + 128.0, 400.0 * Xc[:, 1] / Xc[:, 2] + 128.0], 1).astype(np.float32)

    I3 = np.eye(3, dtype=np.float32)
    valid = np.ones(K, bool)
    none = np.full(K, -1, np.int32)
    uvr0 = np.concatenate([project(np.zeros(3)), -np.ones((K, 1), np.float32)], 1)
    slot_c, _ = jb.insert_keyframe(0, 0.0, I3, np.zeros(3, np.float32), uvr0, valid, none, depth=X[:, 2].copy(),
                                   desc=desc_cand)
    for k in range(1, 5):  # distractors with unrelated, equally collapsed descriptors
        jb.insert_keyframe(k, k * 0.1, I3, np.array([0, 0, 0.01 * k], np.float32), uvr0, valid, none,
                           desc=_collapsed_descriptor_views(rng, K=K, D=D)[0])
    t_true = np.array([0.3, 0.0, 0.0], np.float32)
    uv1 = project(t_true)
    uvr1 = np.concatenate([uv1, -np.ones((K, 1), np.float32)], 1)
    slot_q, _ = jb.insert_keyframe(100, 5.0, I3, t_true + np.array([0.15, 0, 0], np.float32), uvr1, valid, none,
                                   desc=desc_query)

    _, tb = _backends(cam, jstore, **bcfg)
    edges = [b.detect_loop(slot_q, desc_query, uv1, valid) for b in (tb, jb)]
    for edge in edges:
        assert edge is not None, "loop not detected on collapsed descriptors"
        i, j, R_ij, t_ij, w, s = edge
        assert (i, j, w) == (slot_c, slot_q, 3.0)
        np.testing.assert_allclose(R_ij, I3, atol=0.02)
        np.testing.assert_allclose(t_ij, t_true, atol=0.05)
    (_, _, R_t, t_t, _, s_t), (_, _, R_j, t_j, _, s_j) = edges
    np.testing.assert_allclose(R_t, R_j, atol=5e-3)
    np.testing.assert_allclose(t_t, t_j, atol=5e-3)
    assert s_t == s_j  # the scale harvest is numpy on the same store
    assert len(tb.store.loop_edges) == 1 and tb._loop_cooldown == 5


# ---------------------------------------------------------------------------
# The Sim3 helpers and global_optimize on one map
# ---------------------------------------------------------------------------

@pytest.fixture()
def drifted_map():
    """``make_drifted_map()``."""
    return make_drifted_map()


def test_loop_scale_helpers_match_jax(drifted_map):
    jstore, order = drifted_map
    jb, tb = _backends(CAM, jstore)
    jb._apply_loop_scale(order)
    tb._apply_loop_scale(order)
    _assert_same_store(jb.store, tb.store, 1e-6)
    assert jb.store.loop_edges[0][5] == tb.store.loop_edges[0][5] == 1.0  # consumed
    # a rigid correction of every keyframe, carried to the points
    R_old, t_old = jb.store.kf_R[order].copy(), jb.store.kf_t[order].copy()
    for st in (jb.store, tb.store):
        st.kf_R[order] = np.einsum("ij,njk->nik", so3_exp(np.array([0.01, -0.02, 0.03])), R_old).astype(np.float32)
        st.kf_t[order] = t_old + np.float32(0.1)
    jb._correct_points_after_pgo(order, R_old, t_old)
    tb._correct_points_after_pgo(order, R_old, t_old)
    _assert_same_store(jb.store, tb.store, 1e-6)
    c = 1.0 + 0.1 * np.arange(len(order))
    jb._carry_points_scaled(order, t_old, c)
    tb._carry_points_scaled(order, t_old, c)
    _assert_same_store(jb.store, tb.store, 1e-6)


@pytest.mark.parametrize("full_ba", [False, True])
def test_global_optimize_matches_jax(drifted_map, monkeypatch, full_ba, tmp_path):
    """Scale ramp, pose graph and point correction agree to float32
    rounding (1e-5). The full BA's ``"auto"`` is JAX's one-hot matmul with
    bf16 point-side summands and the port's float32 ``index_add_``; the JAX
    side is pinned to its exact ``"scatter"`` route so both solve in
    float32, and 1e-4 is the tolerance ``tests/test_torch_ba.py`` holds the
    two float32 routes to (2e-4 there, on a harder window)."""
    from ur_mvo_tpu.ops import ba as jba

    monkeypatch.setattr(jba, "resolve_assembly", lambda cfg, n_obs=0, n_points=0: "scatter")
    jstore, order = drifted_map
    bcfg = dict(ba_iterations_phase1=4, ba_iterations_phase2=2)
    jb, tb = _backends(CAM, jstore, **bcfg)
    on_mesh, alone = (_port_backend(CAM, jstore, **bcfg) for _ in range(2))
    before = tb.store.kf_t[order].copy()
    jb.global_optimize(full_ba=full_ba)
    tb.global_optimize(full_ba=full_ba)
    _assert_same_store(jb.store, tb.store, 1e-4 if full_ba else 1e-5)
    assert not np.allclose(tb.store.kf_t[order], before)
    parts = {"global_scale", "global_pose_graph", "global_points"} | ({"global_full_ba"} if full_ba else set())
    assert set(tb.timer.summary()) == parts
    if full_ba:
        assert tb.last_full_ba["assembly"] == "scatter" and tb.last_full_ba["keyframes"] == N_KF
    else:
        # the mesh path at one rank (gloo, this process): the full BA through
        # shard_problem and dist_bundle_adjust with each shard's bf16
        # point-side summands, against the port's own full BA
        with one_rank_mesh(tmp_path) as mesh:
            on_mesh.global_optimize(mesh=mesh)
        alone.global_optimize()
        full = on_mesh.last_full_ba
        assert full["assembly"] == "dist" and full["world"] == 1 and full["rank_assembly"] == ["bf16_point_side"]
        for f in ("kf_R", "kf_t"):
            np.testing.assert_allclose(getattr(on_mesh.store, f)[order], getattr(alone.store, f)[order], atol=1e-3)
