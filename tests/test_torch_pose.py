"""The port's pose optimizer (the plain version of the pose-GN kernel
``csrc/pose_gn.cu``) against both JAX routes on the CPU: the XLA schedule
of ``ops/pose_opt.py`` and the Pallas kernel ``ops/pallas_pose.py`` in
interpret mode.

Both problems are padded with invalid mono slots to N = 1024, so that each
JAX route (jitted) compiles once: tracing the kernel's unrolled 40 steps
in interpret mode is most of this file's time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ur_mvo_tpu.ops import lie as jlie
from ur_mvo_tpu.ops import pose_opt as jpose
from ur_mvo_tpu.ops.pallas_pose import optimize_pose_pallas
from ur_mvo_tpu_torch import weights as tweights
from ur_mvo_tpu_torch.ops import pose_opt as tpose


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: PyTorch's
    intra-op thread pool costs several times what it gives there, most of
    all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FX = FY = 400.0
CX, CY = 320.0, 240.0
BF = 40.0
NPAD = 1024


def T(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _so3(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(w, jnp.float32)))


# ---------------------------------------------------------------------------
# pose optimizer: the plain version of the pose-GN kernel against both JAX
# routes. R 2e-5, t 2e-4: the two JAX routes agree to that among themselves
# (tests/test_pallas_kernels.py), and the accept test `cost1 <= cost0`
# compares two float sums whose order differs between implementations.
# ---------------------------------------------------------------------------

def _pose_problem(kind, outliers=True):
    """'mixed': N = 300, half stereo rows, 30 outliers, 20 invalid (the
    problem of tests/test_pallas_kernels.py); 'mono1024': mono only at the
    main path's capacity. ``outliers=False``: the same tracks without the
    outliers."""
    rng = np.random.default_rng(3)
    N = 300 if kind == "mixed" else 1024
    X = rng.uniform([-2, -2, 4], [2, 2, 9], (N, 3)).astype(np.float32)
    R_true = _so3([0.03, -0.05, 0.02])
    t_true = np.array([0.1, -0.05, 0.03], np.float32)
    bf = BF  # mono rows never read it
    pc = X @ R_true.T + t_true
    u = FX * pc[:, 0] / pc[:, 2] + CX + rng.normal(0, 0.5, N)
    v = FY * pc[:, 1] / pc[:, 2] + CY + rng.normal(0, 0.5, N)
    ur = u - bf / pc[:, 2]
    if kind == "mixed":
        ur[: N // 2] = -1.0  # half mono
    else:
        ur[:] = -1.0
    n_out = N // 10
    if outliers:
        u[:n_out] += rng.uniform(20, 60, n_out)
    uv = np.stack([u, v, ur], 1).astype(np.float32)
    valid = np.ones(N, bool)
    valid[N - N // 15:] = False
    # pad to NPAD with invalid mono slots: the same problem
    pad = NPAD - N
    X = np.concatenate([X, np.zeros((pad, 3), np.float32)])
    uv = np.concatenate([uv, np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (pad, 1))])
    valid = np.concatenate([valid, np.zeros(pad, bool)])
    return X, uv, valid, R_true, t_true


_jax_xla = jax.jit(lambda R, t, obs: jpose.optimize_pose(R, t, obs, FX, FY, CX, CY, BF))
_jax_pallas = jax.jit(
    lambda R, t, obs: optimize_pose_pallas(R, t, obs.X, obs.uv, obs.valid, FX, FY, CX, CY, BF, interpret=True)
)


@pytest.fixture(scope="module", params=["mixed", "mono1024"])
def pose_case(request):
    X, uv, valid, R_true, t_true = _pose_problem(request.param)
    obs = jpose.PoseObs(X=jnp.asarray(X), uv=jnp.asarray(uv), valid=jnp.asarray(valid))
    xla = _jax_xla(jnp.eye(3), jnp.zeros(3), obs)
    pal = _jax_pallas(jnp.eye(3), jnp.zeros(3), obs)
    tobs = tweights.pose_obs_from_numpy((X, uv, valid))
    out = tpose.optimize_pose(torch.eye(3), torch.zeros(3), tobs, FX, FY, CX, CY, BF)
    return dict(xla=(xla.R_cw, xla.t_cw, xla.inliers), pallas=pal, out=out, tobs=tobs, bf=BF,
                truth=(R_true, t_true))


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_optimize_pose_plain_matches_jax(pose_case, route):
    R, t, inl = pose_case[route]
    out = pose_case["out"]
    np.testing.assert_allclose(out.R_cw.numpy(), np.asarray(R), atol=2e-5)
    np.testing.assert_allclose(out.t_cw.numpy(), np.asarray(t), atol=2e-4)
    assert (out.inliers.numpy() == np.asarray(inl)).mean() >= 0.99
    assert int(out.n_inliers) == int(out.inliers.sum())


def test_optimize_pose_plain_converges_to_truth(pose_case):
    out = pose_case["out"]
    R_true, t_true = pose_case["truth"]
    assert np.abs(out.R_cw.numpy() - R_true).max() < 5e-3
    assert np.abs(out.t_cw.numpy() - t_true).max() < 2e-2
    n_valid = int(pose_case["tobs"].valid.sum())
    assert 0.8 * n_valid < int(out.n_inliers) <= n_valid


def test_optimize_pose_batch_of_two_equals_two_calls(pose_case):
    """B = 2 with two seeds (the fused frame step's layout) against the
    two single calls."""
    tobs, bf = pose_case["tobs"], pose_case["bf"]
    R1 = T(_so3([0.01, 0.02, -0.01]))
    t1 = torch.tensor([0.05, 0.0, -0.02])
    obs2 = tpose.PoseObs(X=tobs.X.expand(2, -1, -1), uv=tobs.uv.expand(2, -1, -1), valid=tobs.valid.expand(2, -1))
    both = tpose.optimize_pose(torch.stack([torch.eye(3), R1]), torch.stack([torch.zeros(3), t1]), obs2,
                               FX, FY, CX, CY, bf)
    singles = [pose_case["out"], tpose.optimize_pose(R1, t1, tobs, FX, FY, CX, CY, bf)]
    assert both.R_cw.shape == (2, 3, 3) and both.inliers.shape == (2, tobs.X.shape[0]) and both.n_inliers.shape == (2,)
    for b, one in enumerate(singles):
        np.testing.assert_allclose(both.R_cw[b].numpy(), one.R_cw.numpy(), atol=1e-6)
        np.testing.assert_allclose(both.t_cw[b].numpy(), one.t_cw.numpy(), atol=1e-5)
        assert (both.inliers[b] == one.inliers).all()


def test_optimize_pose_schedule_cut_to_one_round_differs(pose_case):
    """The on-card check's negative control: without the later rounds'
    reclassification the outliers keep their Huber weight and the pose
    moves by more than the comparison's limits."""
    tobs, bf = pose_case["tobs"], pose_case["bf"]
    cut = tpose.optimize_pose(torch.eye(3), torch.zeros(3), tobs, FX, FY, CX, CY, bf, rounds=1)
    out = pose_case["out"]
    assert (cut.R_cw - out.R_cw).abs().max() > 2e-5 or (cut.t_cw - out.t_cw).abs().max() > 2e-4


# ---------------------------------------------------------------------------
# the kernel's two exact shortcuts in the plain version: a round stops at its
# first fixed point (a rejected step, or one onto the bits it started from)
# and a round whose inputs repeat the previous round's is skipped. Both must
# leave every output bit of the full 4 x 10 schedule.
# ---------------------------------------------------------------------------

def _frame_step_batch(X, uv, valid):
    """The fused frame step's layout: one problem, two seeds (the PnP
    prior's stand-in and the last pose)."""
    R0 = torch.stack([torch.eye(3), T(_so3([0.01, 0.02, -0.01]))])
    t0 = torch.stack([torch.zeros(3), torch.tensor([0.05, 0.0, -0.02])])
    return R0, t0, T(X)[None].expand(2, -1, -1), T(uv)[None].expand(2, -1, -1), T(valid, torch.bool)[None].expand(2, -1)


def _plain(args, **kw):
    return tpose.optimize_pose_plain(*args, FX, FY, CX, CY, BF, **kw)


def _assert_same_bits(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["mixed", "mono1024"])
def test_fixed_point_shortcuts_keep_bits(kind):
    args = _frame_step_batch(*_pose_problem(kind)[:3])
    short, full = _plain(args), _plain(args, full_schedule=True)
    _assert_same_bits(short, full)
    assert full[3].tolist() == [40, 40]


def test_shortcuts_fire_on_mono1024():
    """Fewer than 40 steps for each problem, and round 2 skipped: with three
    rounds the steps and the result are those of two."""
    args = _frame_step_batch(*_pose_problem("mono1024")[:3])
    out = _plain(args)
    assert (out[3] < 40).all() and (out[3] > 0).all()
    two, three = _plain(args, rounds=2), _plain(args, rounds=3)
    assert torch.equal(two[3], three[3])
    _assert_same_bits(two, three)


@pytest.mark.parametrize("point", ["depth_crossing", "depth_zero"])
def test_pathological_point_keeps_full_schedule_bits(point):
    """One valid track that no step handles well: a point 1e12 away whose
    depth crosses zero under a step's rotation (its cost at the candidate is
    not finite, so the step is rejected and the round stops there), or a
    point at depth 0 of the start pose (its Jacobian swamps the system)."""
    X, uv, valid, _, _ = _pose_problem("mono1024")
    X, uv, valid = X.copy(), uv.copy(), valid.copy()
    X[500] = (-1e12, 0.0, 5e10) if point == "depth_crossing" else (1.0, 0.0, 0.0)
    uv[500] = (300.0, 200.0, -1.0)
    valid[500] = True
    if point == "depth_crossing":
        assert np.isfinite(FX * X[500, 0] / X[500, 2]) and X[500, 2] > 0  # finite at the start
    args = _frame_step_batch(X, uv, valid)
    short, full = _plain(args), _plain(args, full_schedule=True)
    _assert_same_bits(short, full)
    assert torch.isfinite(short[0]).all() and torch.isfinite(short[1]).all()


@pytest.mark.parametrize("rounds", [2, 3, 4])
def test_batch_whose_problems_disagree_on_skipping_keeps_bits(rounds):
    """A batch in which one problem repeats its rounds and the other does
    not: the same tracks without outliers (round 1 repeats round 0) beside
    the 'mixed' problem (round 1 does not), on the frame step's two seeds.
    The repeating problem keeps its pose through the rounds it skips while
    the other steps, and each problem runs the steps it runs alone."""
    dirty, clean = _pose_problem("mixed")[:3], _pose_problem("mixed", outliers=False)[:3]
    R0, t0, *_ = _frame_step_batch(*dirty)
    X, uv, valid = (np.stack(pair) for pair in zip(dirty, clean))
    args = (R0, t0, T(X), T(uv), T(valid, torch.bool))
    one, two = _plain(args, rounds=1), _plain(args, rounds=2)
    assert two[3][0] > one[3][0] and two[3][1] == one[3][1]  # only the outlier-free problem skips round 1
    short, full = _plain(args, rounds=rounds), _plain(args, rounds=rounds, full_schedule=True)
    _assert_same_bits(short, full)
    alone = [_plain(tuple(a[b:b + 1] for a in args), rounds=rounds)[3] for b in range(2)]
    assert torch.equal(short[3], torch.cat(alone))
