"""The port's SE(3) pose graph against the JAX package on the CPU, on the
chain and loop problems of ``tests/test_pose_graph.py``.

Both sides take the edge Jacobians by forward-mode differentiation of the
same residual and solve the same dense damped system in float32, so the
poses agree to 1e-5 (float32 rounding of 15-25 Gauss-Newton steps); each
also meets the JAX tests' own bounds against the truth.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_pose_graph import make_chain_graph
from ur_mvo_tpu.ops import pose_graph as jpg
from ur_mvo_tpu_torch.ops import pose_graph as tpg
from ur_mvo_tpu_torch.weights import pose_graph_from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: PyTorch's
    intra-op thread pool costs several times what it gives there, most of
    all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    # name: (make_chain_graph kwargs, iterations, bound on the truth)
    "chain": (dict(n=12, noise=0.05), 15, 1e-3),
    "loop": (dict(n=15, noise=0.08, loop=True, seed=2), 25, 5e-3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimize_pose_graph_matches_jax(case):
    kwargs, iters, bound = CASES[case]
    g, R_true, t_true = make_chain_graph(**kwargs)
    ref = jax.jit(lambda g: jpg.optimize_pose_graph(g, iterations=iters))(g)
    tg = pose_graph_from_numpy(jax.tree.map(np.asarray, g))
    out = tpg.optimize_pose_graph(tg, iterations=iters)
    np.testing.assert_allclose(out.R_wc.numpy(), np.asarray(ref.R_wc), atol=1e-5)
    np.testing.assert_allclose(out.t_wc.numpy(), np.asarray(ref.t_wc), atol=1e-5)
    assert float(out.cost) < 1e-8 and float(ref.cost) < 1e-8
    assert np.abs(out.t_wc.numpy() - np.asarray(t_true)).max() < bound
    # the gauge node does not move
    np.testing.assert_array_equal(out.R_wc[0].numpy(), tg.R_wc[0].numpy())
    np.testing.assert_array_equal(out.t_wc[0].numpy(), tg.t_wc[0].numpy())


def test_edge_jacobians_match_jax():
    g, _, _ = make_chain_graph(n=6, noise=0.1, loop=True, seed=1)
    gn = jax.tree.map(np.asarray, g)
    E = gn.edge_i.shape[0]
    args = (gn.R_wc[gn.edge_i], gn.t_wc[gn.edge_i], gn.R_wc[gn.edge_j], gn.t_wc[gn.edge_j], gn.R_ij, gn.t_ij)
    z = np.zeros((E, 6), np.float32)
    ref = jax.vmap(jax.jacfwd(_jax_residual, argnums=(0, 1)))(z, z, *args)
    out = tpg._edge_jacobians(*(torch.from_numpy(np.array(a)) for a in (z, z) + args))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5)


def _jax_residual(xi_i, xi_j, Ri, ti, Rj, tj, Rm, tm):
    """``ur_mvo_tpu.ops.pose_graph.optimize_pose_graph``'s per-edge residual."""
    from ur_mvo_tpu.ops.lie import se3_exp, se3_log

    dRi, dti = se3_exp(xi_i)
    dRj, dtj = se3_exp(xi_j)
    Ri2, ti2 = jpg.mm(dRi, Ri), jpg.einsum("ij,j->i", dRi, ti) + dti
    Rj2, tj2 = jpg.mm(dRj, Rj), jpg.einsum("ij,j->i", dRj, tj) + dtj
    R_rel = jpg.mm(Ri2.T, Rj2)
    t_rel = jpg.einsum("ji,j->i", Ri2, tj2 - ti2)
    return se3_log(jpg.mm(Rm.T, R_rel), jpg.einsum("ji,j->i", Rm, t_rel - tm))


def test_padding_is_invisible():
    """Padded nodes and zero-weight edges leave the valid nodes as they are
    (``tests/test_pose_graph.py::test_pose_graph_padding_invariance``)."""
    g, _, _ = make_chain_graph(n=10)
    gn = jax.tree.map(np.asarray, g)
    n, Fp, Ep = 10, 16, 20
    pad = lambda a, m, fill=0: np.concatenate([a, np.full((m - len(a),) + a.shape[1:], fill, a.dtype)])
    eye = lambda m: np.tile(np.eye(3, dtype=np.float32), (m, 1, 1))
    padded = (np.concatenate([gn.R_wc, eye(Fp - n)]), pad(gn.t_wc, Fp), pad(gn.node_valid, Fp, False),
              pad(gn.node_fixed, Fp, False), pad(gn.edge_i, Ep), pad(gn.edge_j, Ep),
              np.concatenate([gn.R_ij, eye(Ep - len(gn.R_ij))]), pad(gn.t_ij, Ep), pad(gn.edge_weight, Ep))
    a = tpg.optimize_pose_graph(pose_graph_from_numpy(gn), iterations=10)
    b = tpg.optimize_pose_graph(pose_graph_from_numpy(padded), iterations=10)
    np.testing.assert_allclose(b.t_wc.numpy()[:n], a.t_wc.numpy(), atol=1e-5)
    np.testing.assert_array_equal(b.t_wc.numpy()[n:], 0.0)


def test_sequential_edges_match_jax():
    rng = np.random.default_rng(0)
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(8)]).astype(np.float32)
    R *= np.sign(np.linalg.det(R))[:, None, None]
    t = rng.normal(size=(8, 3)).astype(np.float32)
    for a, b in zip(tpg.sequential_edges_from_trajectory(R, t, 6, 8), jpg.sequential_edges_from_trajectory(R, t, 6, 8)):
        np.testing.assert_array_equal(a, b)
