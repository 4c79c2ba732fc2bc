"""The port's tracking geometry against the JAX package on the CPU: Lie
maps, the small-matrix routines, triangulation, PnP, the two-view
initializer and the fused frame step (the pose optimizer has its own
file, ``test_torch_pose.py``).

Inputs are made with numpy from a seed and go through both packages.
Samplers differ (JAX's counter-based keys against a torch generator), so
each RANSAC gets the SAME minimal sets on both sides: JAX's own draw for
the key it is called with. The JAX side runs jitted: op by op on the CPU it
compiles every small op of the unrolled solvers on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ur_mvo_tpu.ops import epipolar as jepi
from ur_mvo_tpu.ops import lie as jlie
from ur_mvo_tpu.ops import linalg as jlin
from ur_mvo_tpu.ops import pnp as jpnp
from ur_mvo_tpu.ops import ransac as jransac
from ur_mvo_tpu.ops import triangulation as jtri
from ur_mvo_tpu.ops.matching import Matches as JMatches
from ur_mvo_tpu.runtime.frontend import fused_track_core as jax_fused_track_core
from ur_mvo_tpu_torch import weights as tweights
from ur_mvo_tpu_torch.ops import epipolar as tepi
from ur_mvo_tpu_torch.ops import lie as tlie
from ur_mvo_tpu_torch.ops import linalg as tlin
from ur_mvo_tpu_torch.ops import pnp as tpnp
from ur_mvo_tpu_torch.ops import ransac as transac
from ur_mvo_tpu_torch.ops import triangulation as ttri
from ur_mvo_tpu_torch.runtime.frontend import fused_track_core


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: PyTorch's
    intra-op thread pool costs several times what it gives there, most of
    all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _so3(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(w, jnp.float32)))


# ---------------------------------------------------------------------------
# lie + linalg: 1e-5
# ---------------------------------------------------------------------------

def _tangents(rng, n, scale):
    """Tangents whose rotation stays under 2.5 rad, so that log(exp) is
    the identity."""
    xi = scale * rng.normal(size=(n, 6))
    norm = np.linalg.norm(xi[:, :3], axis=1, keepdims=True)
    xi[:, :3] *= np.minimum(1.0, 2.5 / np.maximum(norm, 1e-12))
    return xi.astype(np.float32)


@pytest.mark.parametrize("scale", [1e-5, 0.3, 1.5])
def test_se3_exp_log_match_jax_and_round_trip(scale):
    xi = _tangents(np.random.default_rng(0), 16, scale)
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    Rt, tt = tlie.se3_exp(T(xi))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(tlie.se3_log(Rt, tt).numpy(), np.asarray(jlie.se3_log(Rj, tj)), atol=1e-5)
    np.testing.assert_allclose(tlie.se3_log(Rt, tt).numpy(), xi, atol=2e-5)
    np.testing.assert_allclose(tlie.so3_log(tlie.so3_exp(T(xi[:, :3]))).numpy(), xi[:, :3], atol=2e-5)


def test_quaternions_and_group_ops_match_jax():
    rng = np.random.default_rng(1)
    xi = _tangents(rng, 32, 1.0)
    xi[0, :3] = [np.pi - 1e-3, 0, 0]  # near pi: another quaternion pivot
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    Rt, tt = T(Rj), T(tj)
    q = tlie.rotmat_to_quat(Rt)
    np.testing.assert_allclose(q.numpy(), np.asarray(jlie.rotmat_to_quat(Rj)), atol=1e-5)
    np.testing.assert_allclose(tlie.quat_to_rotmat(q).numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tlie.rotation_angle(Rt).numpy(), np.asarray(jlie.rotation_angle(Rj)), atol=1e-5)
    np.testing.assert_allclose(tlie.vee(tlie.hat(T(xi[:, :3]))).numpy(), xi[:, :3])
    Ri, ti = tlie.se3_inverse(Rt, tt)
    Rc, tc = tlie.se3_compose(Rt, tt, Ri, ti)
    np.testing.assert_allclose(Rc.numpy(), np.broadcast_to(np.eye(3), Rc.shape), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), 0.0, atol=1e-5)
    p = rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(tlie.se3_apply(Rt, tt, T(p)).numpy(), np.asarray(jlie.se3_apply(Rj, tj, jnp.asarray(p))), atol=1e-5)
    M = tlie.se3_matrix(Rt, tt).numpy()
    np.testing.assert_allclose(M, np.asarray(jlie.se3_matrix(Rj, tj)), atol=1e-6)


@pytest.mark.parametrize("n", [3, 6])
def test_cholesky_and_spd_inverse_match_jax(n):
    rng = np.random.default_rng(2)
    A = rng.normal(size=(8, n, n + 3)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(n, dtype=np.float32)
    np.testing.assert_allclose(tlin.cholesky_small(T(M)).numpy(), np.asarray(jlin.cholesky_small(jnp.asarray(M))), atol=1e-5)
    inv = tlin.spd_inverse_small(T(M)).numpy()
    scale = np.abs(inv).max()
    np.testing.assert_allclose(inv / scale, np.asarray(jlin.spd_inverse_small(jnp.asarray(M))) / scale, atol=1e-5)


def test_nearest_rotation_matches_jax():
    rng = np.random.default_rng(3)
    R = _so3(rng.normal(size=(8, 3)))
    M = (R * rng.uniform(0.5, 2.0, (8, 1, 1)) + 0.05 * rng.normal(size=(8, 3, 3))).astype(np.float32)
    M[1] = -M[1]  # det < 0
    M[2] = 1.7 * R[2]  # exact scaled rotation: degenerate eigenvalues, the polish must recover it
    Rj, sj = jlin.nearest_rotation(jnp.asarray(M))
    Rt, st = tlin.nearest_rotation(T(M))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    np.testing.assert_allclose(Rt[2].numpy(), R[2], atol=1e-5)


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------

FX = FY = 400.0
CX, CY = 320.0, 240.0
KMAT = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)


def _project(X, R_cw, t_cw):
    pc = X @ R_cw.T + t_cw
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], 1).astype(np.float32)


def test_triangulate_dlt_matches_jax_single_and_batched():
    rng = np.random.default_rng(4)
    X = rng.uniform([-2, -2, 4], [2, 2, 9], (50, 3)).astype(np.float32)
    R = _so3([0.02, -0.04, 0.01])
    t = np.array([0.4, 0.05, 0.02], np.float32)
    P1 = np.concatenate([KMAT, np.zeros((3, 1), np.float32)], 1)
    P2 = KMAT @ np.concatenate([R, t[:, None]], 1)
    x1, x2 = _project(X, np.eye(3, dtype=np.float32), np.zeros(3, np.float32)), _project(X, R, t)
    ref = np.asarray(jax.jit(jtri.triangulate_dlt)(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(x1), jnp.asarray(x2)))
    out = ttri.triangulate_dlt(T(P1), T(P2), T(x1), T(x2)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(out, X, atol=2e-2)
    # a leading hypothesis dimension on P2 equals separate calls
    P2b = np.stack([P2, KMAT @ np.concatenate([R, -t[:, None]], 1)])
    outb = ttri.triangulate_dlt(T(P1), T(P2b), T(x1), T(x2)).numpy()
    np.testing.assert_allclose(outb[0], out, atol=1e-6)
    np.testing.assert_allclose(outb[1], ttri.triangulate_dlt(T(P1), T(P2b[1]), T(x1), T(x2)).numpy(), atol=1e-6)


def test_triangulate_bearings_matches_jax_vmap():
    rng = np.random.default_rng(5)
    n, m = 12, 8
    X = rng.uniform([-2, -2, 4], [2, 2, 9], (n, 3)).astype(np.float32)
    origins = (0.5 * rng.normal(size=(n, m, 3))).astype(np.float32)
    bearings = X[:, None, :] - origins + 0.01 * rng.normal(size=(n, m, 3)).astype(np.float32)
    valid = rng.random((n, m)) > 0.3
    valid[0] = False  # too few rays
    valid[1, 1:] = False
    bearings[2] = bearings[2, :1]  # parallel rays from different origins: rank-deficient
    pj, okj = jax.vmap(jtri.triangulate_bearings)(jnp.asarray(origins), jnp.asarray(bearings), jnp.asarray(valid))
    pt, okt = ttri.triangulate_bearings(T(origins), T(bearings), T(valid, torch.bool))
    assert (okt.numpy() == np.asarray(okj)).all() and not okt[0] and not okt[1]
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)


# ---------------------------------------------------------------------------
# PnP, homography, two-view init: injected minimal sets
# ---------------------------------------------------------------------------

def _pnp_problem(rng, n=256, n_out=40, n_invalid=30, noise=0.5):
    X = rng.uniform([-2, -2, 4], [2, 2, 9], (n, 3)).astype(np.float32)
    R = _so3([0.03, -0.05, 0.02])
    t = np.array([0.1, -0.05, 0.03], np.float32)
    uv = _project(X, R, t) + rng.normal(0, noise, (n, 2)).astype(np.float32)
    uv[:n_out] += rng.uniform(30, 80, (n_out, 2)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n - n_invalid:] = False
    return X, uv, valid, R, t


def test_dlt_pnp_on_exact_data_matches_jax_and_truth():
    rng = np.random.default_rng(6)
    X, uv, _, R, t = _pnp_problem(rng, n=12, n_out=0, n_invalid=0, noise=0.0)
    rays = ((uv - [CX, CY]) / [FX, FY]).astype(np.float32)
    Rj, tj = jax.jit(jpnp.dlt_pnp)(jnp.asarray(X), jnp.asarray(rays))
    Rt, tt = tpnp.dlt_pnp(T(X), T(rays))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), R, atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), t, atol=5e-3)


def test_ransac_pnp_matches_jax_on_injected_sets():
    X, uv, valid, R, t = _pnp_problem(np.random.default_rng(7))
    key = jax.random.PRNGKey(11)
    ref = jax.jit(jpnp.ransac_pnp)(key, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(KMAT))
    sets = np.asarray(jransac.sample_minimal_sets(key, jnp.asarray(valid), 100, 6))
    out = tpnp.ransac_pnp(None, T(X), T(uv), T(valid, torch.bool), T(KMAT), sets=T(sets, torch.int64))
    np.testing.assert_allclose(out.R_cw.numpy(), np.asarray(ref.R_cw), atol=1e-4)
    np.testing.assert_allclose(out.t_cw.numpy(), np.asarray(ref.t_cw), atol=1e-4)
    assert (out.inliers.numpy() == np.asarray(ref.inliers)).mean() >= 0.99
    assert abs(int(out.n_inliers) - int(ref.n_inliers)) <= 2
    # and from its own generator it finds the pose too
    own = tpnp.ransac_pnp(torch.Generator().manual_seed(0), T(X), T(uv), T(valid, torch.bool), T(KMAT))
    assert int(own.n_inliers) >= 180
    assert not own.inliers[-30:].any()


def test_ransac_pnp_refuses_tf32_matmul():
    X, uv, valid, _, _ = _pnp_problem(np.random.default_rng(7), n=32, n_out=0, n_invalid=0)
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            tpnp.ransac_pnp(torch.Generator().manual_seed(0), T(X), T(uv), T(valid, torch.bool), T(KMAT))
    finally:
        torch.set_float32_matmul_precision("highest")


def _two_view_problem(rng, planar, n=400, n_out=40, n_invalid=40):
    if planar:
        xy = rng.uniform(-2.5, 2.5, (n, 2))
        X = np.concatenate([xy, 6.0 + 0.15 * xy[:, :1]], 1).astype(np.float32)
    else:
        X = rng.uniform([-2.5, -2, 3], [2.5, 2, 9], (n, 3)).astype(np.float32)
    R = _so3([0.01, -0.03, 0.005])
    t = np.array([0.5, 0.03, 0.05], np.float32)
    p1 = _project(X, np.eye(3, dtype=np.float32), np.zeros(3, np.float32)) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    p2 = _project(X, R, t) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    p2[:n_out] += rng.uniform(15, 60, (n_out, 2)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n - n_invalid:] = False
    return p1, p2, valid, R, t


def test_ransac_homography_matches_jax_on_injected_sets():
    p1, p2, valid, _, _ = _two_view_problem(np.random.default_rng(8), planar=True)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(jransac.ransac_homography)(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid))
    sets = np.asarray(jransac.sample_minimal_sets(key, jnp.asarray(valid), 200, 8))
    out = transac.ransac_homography(None, T(p1), T(p2), T(valid, torch.bool), sets=T(sets, torch.int64))
    np.testing.assert_allclose(out.model.numpy(), np.asarray(ref.model), atol=1e-4 * np.abs(np.asarray(ref.model)).max())
    np.testing.assert_allclose(float(out.score), float(ref.score), rtol=1e-3)
    assert (out.inliers.numpy() == np.asarray(ref.inliers)).mean() >= 0.99
    assert int(out.inliers.sum()) >= 280


_jax_two_view = jax.jit(jepi.two_view_init)  # one compilation for both cases


@pytest.mark.parametrize("planar", [False, True])
def test_two_view_init_matches_jax_on_injected_sets(planar):
    p1, p2, valid, R, t = _two_view_problem(np.random.default_rng(9), planar)
    key = jax.random.PRNGKey(3)
    ref = _jax_two_view(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), jnp.asarray(KMAT))
    kF, kH = jax.random.split(key)
    sets_f = np.asarray(jransac.sample_minimal_sets(kF, jnp.asarray(valid), 200, 8))
    sets_h = np.asarray(jransac.sample_minimal_sets(kH, jnp.asarray(valid), 200, 8))
    out = tepi.two_view_init(None, T(p1), T(p2), T(valid, torch.bool), T(KMAT),
                             sets_f=T(sets_f, torch.int64), sets_h=T(sets_h, torch.int64))
    assert bool(out.success) == bool(ref.success) and bool(out.success)
    assert bool(out.used_homography) == bool(ref.used_homography)
    np.testing.assert_allclose(out.R21.numpy(), np.asarray(ref.R21), atol=1e-4)
    np.testing.assert_allclose(out.t21.numpy(), np.asarray(ref.t21), atol=1e-4)
    assert (out.triangulated.numpy() == np.asarray(ref.triangulated)).mean() >= 0.99
    both = out.triangulated.numpy() & np.asarray(ref.triangulated)
    np.testing.assert_allclose(out.points3d.numpy()[both], np.asarray(ref.points3d)[both], rtol=2e-3, atol=2e-3)
    # the motion is the true one up to scale, as far as an unrefined
    # 8-point model on 0.3 px noise goes
    np.testing.assert_allclose(out.R21.numpy(), R, atol=0.08)
    assert float(out.t21.numpy() @ t) / np.linalg.norm(t) > 0.9


def test_essential_and_homography_decompositions_match_jax_as_sets():
    """A singular vector's sign is free, so the hypothesis LIST may come in
    another order than JAX's; as a set it is the same."""
    rng = np.random.default_rng(10)
    R = _so3([0.02, -0.05, 0.01])
    t = np.array([0.6, 0.1, -0.2], np.float32)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32)
    E = tx @ R
    n = np.array([0.1, -0.05, 1.0], np.float32)
    Hn = R + np.outer(t, n / np.linalg.norm(n)) / 5.0
    H21 = KMAT @ Hn @ np.linalg.inv(KMAT)

    def as_set(Rs, ts):
        rows = np.concatenate([np.asarray(Rs).reshape(len(Rs), 9), np.asarray(ts)], 1)
        return rows[np.lexsort(np.round(rows, 3).T[::-1])]

    Rj, tj = jepi.decompose_essential(jnp.asarray(E))
    Rt, tt = tepi.decompose_essential(T(E))
    np.testing.assert_allclose(as_set(Rt.numpy(), tt.numpy()), as_set(Rj, tj), atol=1e-4)
    assert np.abs(Rt.numpy() - R).reshape(4, -1).max(1).min() < 1e-4
    Rj, tj, fj = jepi.decompose_homography(jnp.asarray(H21), jnp.asarray(KMAT))
    Rt, tt, ft = tepi.decompose_homography(T(H21), T(KMAT))
    assert bool(ft.all()) and bool(np.asarray(fj).all())
    np.testing.assert_allclose(as_set(Rt.numpy(), tt.numpy()), as_set(Rj, tj), atol=2e-4)
    assert np.abs(Rt.numpy() - R).reshape(8, -1).max(1).min() < 1e-3


# ---------------------------------------------------------------------------
# fused frame step
# ---------------------------------------------------------------------------

KF = 64
WF = HF = 256
FXF = 100.0
KMAT_F = np.array([[FXF, 0, WF / 2], [0, FXF, HF / 2], [0, 0, 1]], np.float32)
FUSED_ARGS = (FXF, FXF, WF / 2, HF / 2, 0.0, 10.0, 75.0, 100, 20.0, 1, 2.0)


def _fused_scene(seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.0, 5.0, KF), rng.uniform(-1.0, 1.0, KF), rng.uniform(6.0, 10.0, KF)], 1).astype(np.float32)


def _fused_project(X, t_wc):
    Xc = X - np.asarray(t_wc, np.float32)[None]
    return np.stack([FXF * Xc[:, 0] / Xc[:, 2] + WF / 2, FXF * Xc[:, 1] / Xc[:, 2] + HF / 2], 1).astype(np.float32)


def _fused_snapshot(X):
    snap = np.zeros((KF, 6), np.float32)
    snap[:, 0:3] = X
    snap[:, 3] = 2.0
    snap[:, 4] = np.arange(KF) + 100  # mappoint ids, distinct from slots
    snap[0:9, 5] = np.eye(3, dtype=np.float32).reshape(-1)
    return snap


_jax_fused = jax.jit(lambda key, m, uvr, snap, K: jax_fused_track_core(key, m, uvr, snap, K, *FUSED_ARGS))


def _run_fused_both(snap, idx1, mvalid, uvr, seed=0):
    """(jax packed, torch packed) with the same PnP sets."""
    key = jax.random.PRNGKey(seed)
    jm = JMatches(idx1=jnp.asarray(idx1), score=jnp.asarray(mvalid.astype(np.float32)), valid=jnp.asarray(mvalid))
    ref = np.asarray(_jax_fused(key, jm, jnp.asarray(uvr), jnp.asarray(snap), jnp.asarray(KMAT_F)))
    # the JAX core draws its sets from `key` over the scattered validity
    src_ok = mvalid & (snap[:, 3] > 1.5)
    valid_cur = np.zeros(KF, bool)
    valid_cur[idx1[src_ok]] = True
    sets = np.asarray(jransac.sample_minimal_sets(key, jnp.asarray(valid_cur), 100, 6))
    tm = tweights.matches_from_numpy((idx1, mvalid.astype(np.float32), mvalid))
    out = fused_track_core(None, tm, T(uvr), T(snap), T(KMAT_F), *FUSED_ARGS, pnp_sets=T(sets, torch.int64))[0].numpy()
    return ref, out


def _unpack(arr):
    R_cw = arr[2:11].reshape(3, 3)
    return int(arr[0]), int(arr[1]), R_cw, -R_cw.T @ arr[11:14], arr[14 : 14 + KF].astype(np.int32), arr[14 + KF :].reshape(KF, 3)


def test_fused_track_core_matches_jax():
    X = _fused_scene(0)
    t_true = np.array([0.1, 0.0, 0.0], np.float32)
    rng = np.random.default_rng(0)
    perm = rng.permutation(KF).astype(np.int32)  # ref slot i -> current slot perm[i]
    mvalid = rng.random(KF) > 0.15
    idx1 = np.where(mvalid, perm, -1).astype(np.int32)
    kp = np.zeros((KF, 2), np.float32)
    kp[perm] = _fused_project(X, t_true) + rng.normal(0, 0.05, (KF, 2)).astype(np.float32)
    uvr = np.concatenate([kp, -np.ones((KF, 1), np.float32)], 1)
    ref, out = _run_fused_both(_fused_snapshot(X), idx1, mvalid, uvr)
    assert out.shape == ref.shape == (14 + 4 * KF,)
    assert out[0] == ref[0] == mvalid.sum() and out[1] == ref[1]
    np.testing.assert_allclose(out[2:11], ref[2:11], atol=2e-5)
    np.testing.assert_allclose(out[11:14], ref[11:14], atol=2e-4)
    assert (out[14 : 14 + KF] == ref[14 : 14 + KF]).mean() >= 0.99
    np.testing.assert_array_equal(out[14 + KF :], ref[14 + KF :])
    num_match, n_inl, R_cw, t_wc, track, _ = _unpack(out)
    np.testing.assert_allclose(t_wc, t_true, atol=2e-2)
    kept = track >= 0
    assert kept.sum() > 40 and (track[perm[mvalid]][kept[perm[mvalid]]] == (np.arange(KF) + 100)[mvalid][kept[perm[mvalid]]]).all()


def test_fused_track_core_propagates_untriangulated_ids():
    X = _fused_scene(2)
    t_true = np.array([0.1, 0.0, 0.0], np.float32)
    snap = _fused_snapshot(X)
    live_only = np.arange(KF) % 3 == 0  # id, no 3D
    snap[live_only, 3] = 1.0
    snap[live_only, 0:3] = 777.0  # garbage position: must never be used
    idx1 = np.arange(KF, dtype=np.int32)
    uvr = np.concatenate([_fused_project(X, t_true), -np.ones((KF, 1), np.float32)], 1)
    ref, out = _run_fused_both(snap, idx1, np.ones(KF, bool), uvr)
    np.testing.assert_array_equal(out[14 : 14 + KF], ref[14 : 14 + KF])
    _, n_inl, _, t_wc, track, _ = _unpack(out)
    np.testing.assert_allclose(t_wc, t_true, atol=2e-2)
    assert (track[live_only] == (np.arange(KF) + 100)[live_only]).all()
    assert n_inl <= (~live_only).sum()


def test_fused_track_core_jump_guard_hard_fails_teleport():
    """Correspondences consistent with a camera 4 x max_distance away: the
    PnP prior finds the far pose, the rescue (the batch's second problem)
    lands far again, and the step reports 0 inliers."""
    X = _fused_scene(1)
    t_far = np.array([2.0 + 3.0, 0.0, 0.0], np.float32)
    idx1 = np.arange(KF, dtype=np.int32)
    uvr = np.concatenate([_fused_project(X, t_far), -np.ones((KF, 1), np.float32)], 1)
    ref, out = _run_fused_both(_fused_snapshot(X), idx1, np.ones(KF, bool), uvr)
    assert out[0] == ref[0] == KF
    assert out[1] == ref[1] == 0
    assert (out[14 : 14 + KF] == -1).all() and (ref[14 : 14 + KF] == -1).all()


def test_fused_track_core_dump_row_takes_duplicate_writes():
    """Most ref slots unmatched: all of them scatter to the dump row K.
    Real rows keep exactly their own candidate, whatever order the dump
    row's writes land in."""
    X = _fused_scene(3)
    t_true = np.array([0.05, 0.0, 0.0], np.float32)
    mvalid = np.zeros(KF, bool)
    mvalid[::4] = True  # 16 matches, 48 sources on the dump row
    idx1 = np.where(mvalid, (np.arange(KF) + 1) % KF, -1).astype(np.int32)
    kp = np.zeros((KF, 2), np.float32)
    kp[(np.arange(KF) + 1) % KF] = _fused_project(X, t_true)
    uvr = np.concatenate([kp, -np.ones((KF, 1), np.float32)], 1)
    ref, out = _run_fused_both(_fused_snapshot(X), idx1, mvalid, uvr)
    np.testing.assert_array_equal(out[14 : 14 + KF], ref[14 : 14 + KF])
    _, n_inl, _, t_wc, track, _ = _unpack(out)
    assert n_inl == 16 and out[1] == ref[1]
    expect = np.full(KF, -1)
    expect[idx1[mvalid]] = (np.arange(KF) + 100)[mvalid]
    np.testing.assert_array_equal(track, expect)
    np.testing.assert_allclose(t_wc, t_true, atol=2e-2)


def test_chunk_rows_hold_to_jax_fused_track_core(monkeypatch):
    """``Tracker.process_chunk``'s rows against the JAX package's fused
    step: the oracle chunk of ``tests/torch_chunk_util.py`` (K = 64, the
    camera and parameters of ``FUSED_ARGS``, blocks of 4) records each
    queued row's matches, uvr and snapshot (the carried last pose in its
    last column), and both packages' steps run on them with JAX's minimal
    sets for one key, at this file's fused-step tolerances. On every
    consumed row the JAX chunk's keyframe predicate
    (``ur_mvo_tpu/runtime/frontend.py:515-531``, in numpy against the last
    keyframe's pose and the frames passed) equals the port's decision: the
    chunk cuts where it inserted a keyframe."""
    from tests import torch_chunk_util as U
    from ur_mvo_tpu_torch.runtime import frontend

    vo, _ = U.engine(12, KF, 60, chunk=4)
    tr, kf = vo.tracker, vo.config.keyframe
    assert (tr.camera.fx, tr.camera.cx, KF) == (FXF, WF / 2, vo.config.superpoint.capacity)
    chunks, queued = [], []
    core, process_chunk = frontend.fused_track_core, tr.process_chunk

    def spy_core(gen, m, uvr, snap, *a, **k):
        queued.append((m.idx1.numpy().copy(), m.valid.numpy().copy(), uvr.numpy().copy(), snap.numpy().copy()))
        return core(gen, m, uvr, snap, *a, **k)

    def spy_chunk(*a, **k):
        start = (tr._last_keyframe_pose.copy(), tr._frame_counter - tr._last_keyframe_frame_id, len(queued))
        out = process_chunk(*a, **k)
        chunks.append((start, out[0]))
        return out

    monkeypatch.setattr(frontend, "fused_track_core", spy_core)
    tr.process_chunk = spy_chunk
    vo.process_sequence([U.frame(i) for i in range(12)])
    assert tr.chunk_stats["consumed"] >= 4 and len(chunks) >= 2
    n_rows = n_kf = 0
    for (kfp, passed0, first), results in chunks:
        for j, pose_out in enumerate(results):
            idx1, mvalid, uvr, snap = queued[first + j]
            ref, out = _run_fused_both(snap, idx1, mvalid, uvr, seed=first + j)
            assert out[0] == ref[0] and out[1] == ref[1]
            np.testing.assert_allclose(out[2:11], ref[2:11], atol=2e-5)
            np.testing.assert_allclose(out[11:14], ref[11:14], atol=2e-4)
            assert (out[14 : 14 + KF] == ref[14 : 14 + KF]).mean() >= 0.99
            np.testing.assert_array_equal(out[14 + KF :], ref[14 + KF :])
            # the JAX chunk's predicate on the JAX row
            n_inl, R_cw = ref[1], ref[2:11].reshape(3, 3)
            t_wc = -R_cw.T @ ref[11:14]
            ang = np.arccos(np.clip((np.trace(kfp[:3, :3].T @ R_cw.T) - 1.0) * 0.5, -1.0, 1.0))
            is_kf = (ref[0] >= kf.min_num_match) & (n_inl >= kf.min_num_match) & (
                (n_inl < kf.max_num_match) | (ang > kf.max_angle) | (np.linalg.norm(t_wc - kfp[:3, 3]) > kf.max_distance)
                | (passed0 + j >= kf.max_num_passed_frame))
            assert bool(is_kf) == (pose_out is not None), (first + j, is_kf)
            n_rows, n_kf = n_rows + 1, n_kf + bool(is_kf)
    assert n_rows >= 4 and n_kf >= 1
