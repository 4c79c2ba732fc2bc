"""BA's point-side segment sums and the assemblies built on them: the port
against the JAX package on the CPU.

The plain versions of the two point-reduce kernels (``ops/cuda_ba.py``)
are held to the JAX Pallas reductions in interpret mode on the
collision-heavy problem of ``tests/test_ba.py::test_point_reduce_pallas_segments``
(O = 700, P = 40, FF = 4). Both sides round the summands to bf16 the same
way and accumulate in float32, so they agree to float32 summation order
(1e-6 of scale); against the float32 numpy sums the bf16 rounding shows
(5e-3 of scale, the JAX test's bound). The sorted and pallas builders are
held to the JAX builders at ``tests/test_ba.py``'s tolerances (1e-5 of
scale on the frame side and the cost, 5e-3 on the bf16 point side), and the
whole ``bundle_adjust(assembly="sorted")`` to the JAX one at R, t 1e-3 with
inlier verdicts agreeing on >= 98% in the caller's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ba import CX, CY, FX, FY, build_problem
from ur_mvo_tpu.ops import ba as jba
from ur_mvo_tpu.ops.pallas_ba import point_reduce_pallas, point_reduce_sorted_pallas
from ur_mvo_tpu_torch import weights as tweights
from ur_mvo_tpu_torch.ops import ba as tba
from ur_mvo_tpu_torch.ops import cuda_ba


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: PyTorch's
    intra-op thread pool costs several times what it gives there, most of
    all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GEOM = (FX, FY, CX, CY, 0.0)
O, P, FF = 700, 40, 4


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(O, 18)).astype(np.float32)
    Vp = rng.normal(size=(O, 12)).astype(np.float32)
    pts = rng.integers(0, P, O).astype(np.int32)
    slots = rng.integers(0, FF, O).astype(np.int32)
    ref = np.zeros((P, FF * 18 + 12), np.float32)
    for o in range(O):
        ref[pts[o], slots[o] * 18 : slots[o] * 18 + 18] += A[o]
        ref[pts[o], FF * 18 :] += Vp[o]
    return A, Vp, pts, slots, ref


def _scaled_close(out, ref, tol, what):
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(out / scale, ref / scale, atol=tol, err_msg=what)


def test_plain_reducers_match_the_pallas_reductions(rows):
    A, Vp, pts, slots, ref = rows
    jA, jVp = jnp.asarray(A), jnp.asarray(Vp)
    j_unsorted = np.asarray(point_reduce_pallas(jA, jVp, jnp.asarray(pts), jnp.asarray(slots), P, FF, interpret=True))
    # the sorted Pallas reduction on compact ranks, back onto points
    order = np.argsort(pts, kind="stable")
    pt_s = pts[order]
    first = np.concatenate([[True], pt_s[1:] != pt_s[:-1]])
    rank = np.cumsum(first) - 1
    win = (rank[::512] // 8) * 8
    n_ranks_pad = ((P + 528 + 7) // 8) * 8
    j_sorted = np.asarray(point_reduce_sorted_pallas(
        jA[order], jVp[order], jnp.asarray(rank, jnp.int32), jnp.asarray(slots[order]), jnp.asarray(win, jnp.int32),
        n_ranks_pad, FF, interpret=True))
    rank_of_point = np.full(P, n_ranks_pad - 1)
    rank_of_point[pt_s] = rank
    j_sorted = j_sorted[rank_of_point]

    t = lambda a: torch.from_numpy(a)
    out_u = cuda_ba.point_reduce(t(A), t(Vp), t(pts), t(slots), P, FF).numpy()
    seg = np.searchsorted(pt_s, np.arange(P + 1))
    out_s = cuda_ba.point_reduce_sorted(t(A[order]), t(Vp[order]), t(pt_s), t(slots[order]), t(seg), FF).numpy()
    for name, out, jref in (("unsorted", out_u, j_unsorted), ("sorted", out_s, j_sorted)):
        assert out.shape == (P, FF * 18 + 12)
        _scaled_close(out, jref, 1e-6, f"{name} vs Pallas")
        _scaled_close(out, ref, 5e-3, f"{name} vs float32 sums")
    # the two routes sum the same bf16 summands in the same row order
    np.testing.assert_array_equal(out_s, out_u)


def test_plain_reducers_clip_ids_and_leave_unobserved_points_zero(rows):
    A, Vp, pts, slots, _ = rows
    t = lambda a: torch.from_numpy(a)
    few = pts % 7  # points 7..P-1 see nothing
    out = cuda_ba.point_reduce(t(A), t(Vp), t(few), t(slots), P, FF)
    assert (out[7:] == 0).all()
    clipped = cuda_ba.point_reduce(t(A), t(Vp), t(few), t(slots + FF), P, FF)
    top = cuda_ba.point_reduce(t(A), t(Vp), t(few), t(np.full_like(slots, FF - 1)), P, FF)
    assert torch.equal(clipped, top)


@pytest.fixture(scope="module")
def problem():
    prob, R_true, t_true, X_true, n_obs = build_problem(jax.random.PRNGKey(6))
    return jax.tree.map(np.asarray, prob), n_obs


NAMES = ["H_cc", "b_c", "H_pp", "b_p", "U", "cost"]


@pytest.mark.parametrize("assembly", ["sorted", "pallas"])
def test_builders_match_jax(problem, assembly):
    fields, _ = problem
    jp = jba.BAProblem(*[jnp.asarray(a) for a in fields])
    tp = tweights.ba_problem_from_numpy(fields)
    jcfg, tcfg = jba.BAConfig(), tba.BAConfig()
    if assembly == "sorted":
        _, jp, layout = jba.make_sorted_layout(jp, jcfg)
        order, tp, tlayout = tba.make_sorted_layout(tp, tcfg)
        # a stable sort: the valid rows in jnp.argsort's order (the port
        # moves the padding rows behind them, out of every point's rows)
        for f in ("obs_point", "obs_frame", "obs_uv"):
            np.testing.assert_array_equal(np.asarray(getattr(jp, f))[np.asarray(jp.obs_valid)],
                                          getattr(tp, f).numpy()[tp.obs_valid.numpy()])
        n_valid = int(fields[9].sum())
        assert tp.obs_valid[:n_valid].all() and tlayout.seg_start[-1] == n_valid
    Rj, tj = jba._invert_poses(jp.R_wc, jp.t_wc)
    act_j = jp.obs_valid.astype(jnp.float32)
    if assembly == "sorted":
        ref = jba.build_normal_terms_sorted(jp, Rj, tj, jp.X, *GEOM, jcfg, act_j, True, layout=layout, interpret=True)
    else:
        ref = jba.build_normal_terms_pallas(jp, Rj, tj, jp.X, *GEOM, jcfg, act_j, True, interpret=True)
    Rt, tt = tba._invert_poses(tp.R_wc, tp.t_wc)
    act_t = tp.obs_valid.to(torch.float32)
    if assembly == "sorted":
        out = tba.build_normal_terms_sorted(tp, Rt, tt, tp.X, *GEOM, tcfg, act_t, True, layout=tlayout)
    else:
        out = tba.build_normal_terms_pallas(tp, Rt, tt, tp.X, *GEOM, tcfg, act_t, True)
    for name, x, y in zip(NAMES, ref, out):
        x, y = np.asarray(x), y.numpy()
        assert x.shape == y.shape, name
        _scaled_close(y, x, 1e-5 if name in ("H_cc", "b_c", "cost") else 5e-3, name)


def test_bundle_adjust_sorted_matches_jax(problem):
    fields, n_obs = problem
    # the caller's order is NOT point-sorted: reverse the real rows, so the
    # verdicts must come back through the inverse permutation
    rev = np.concatenate([np.arange(n_obs)[::-1], np.arange(n_obs, len(fields[6]))])
    fields = fields[:6] + tuple(f[rev] for f in fields[6:])
    jp = jba.BAProblem(*[jnp.asarray(a) for a in fields])
    ref = jax.jit(lambda p: jba.bundle_adjust(p, *GEOM, jba.BAConfig(assembly="sorted")))(jp)
    out = tba.bundle_adjust(tweights.ba_problem_from_numpy(fields), *GEOM, tba.BAConfig(assembly="sorted"))
    np.testing.assert_allclose(out.R_wc.numpy(), np.asarray(ref.R_wc), atol=1e-3)
    np.testing.assert_allclose(out.t_wc.numpy(), np.asarray(ref.t_wc), atol=1e-3)
    assert (out.obs_inlier.numpy() == np.asarray(ref.obs_inlier)).mean() >= 0.98
    assert not out.obs_inlier.numpy()[n_obs:].any()
    # and against the port's own exact float32 route
    scatter = tba.bundle_adjust(tweights.ba_problem_from_numpy(fields), *GEOM, tba.BAConfig(assembly="scatter"))
    assert (out.obs_inlier == scatter.obs_inlier).float().mean() >= 0.98


@pytest.mark.parametrize("n_obs,n_points,assembly,expect", [
    (8192, 2048, "auto", "scatter"),
    (500_000, 65_536, "auto", "sorted"),
    (500_000, 65_536, "scatter", "scatter"),
    (8192, 2048, "pallas", "pallas"),
])
def test_resolve_assembly(n_obs, n_points, assembly, expect):
    """``tests/test_ba.py::test_auto_assembly_large_problem_fallback``; the
    port's window-scale route is its float32 ``index_add_`` (JAX: the
    one-hot matmul)."""
    cfg = tba.BAConfig(assembly=assembly)
    assert tba.resolve_assembly(cfg, n_obs=n_obs, n_points=n_points) == expect
    jexpect = {"scatter": "matmul"}.get(expect, expect) if assembly == "auto" else assembly
    assert jba.resolve_assembly(jba.BAConfig(assembly=assembly), n_obs=n_obs, n_points=n_points) == jexpect
