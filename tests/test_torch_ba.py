"""The port's windowed bundle adjustment against the JAX package on the CPU.

One window problem is built with numpy from a seed (8 frames, 256 points,
about 2k observations, planted outliers) and goes through both packages.
The port assembles the normal equations with float32 ``index_add_``; that
is the JAX package's ``"scatter"`` assembly, so terms are held to 1e-5 of
their scale and the solve to 1e-4. JAX's default ``"auto"`` multiplies the
point side in bf16 (5e-3 on the terms, ``tests/test_ba.py``), so the full
adjustment is compared with it at optimizer-noise tolerance (1e-3, the
tolerance ``tests/test_ba.py`` holds its two schedules to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ur_mvo_tpu.ops import ba as jba
from ur_mvo_tpu.ops import lie as jlie
from ur_mvo_tpu_torch import weights as tweights
from ur_mvo_tpu_torch.ops import ba as tba


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
CX, CY = 320.0, 256.0
NF, NP, N_OUT = 8, 256, 40
F, P, O = 12, 320, 2560
GEOM = (FX, FY, CX, CY, 0.0)


def _so3(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(w, jnp.float32)))


@pytest.fixture(scope="module")
def window():
    """(BAProblem fields as numpy, truth, n_obs)."""
    rng = np.random.default_rng(12)
    X_true = rng.uniform([-3, -3, 6], [3, 3, 12], (NP, 3)).astype(np.float32)
    ts = np.linspace(0.0, 1.0, NF)
    t_true = np.stack([2.0 * ts, 0.1 * np.sin(3 * ts), 0.05 * ts], 1).astype(np.float32)
    R_true = _so3(np.stack([0.03 * np.sin(2 * ts), 0.1 * ts, 0.02 * ts], 1))
    obs_f, obs_p, obs_uv = [], [], []
    for f in range(NF):
        pc = (X_true - t_true[f]) @ R_true[f]
        u = FX * pc[:, 0] / pc[:, 2] + CX
        v = FY * pc[:, 1] / pc[:, 2] + CY
        ok = (pc[:, 2] > 0.1) & (u > 0) & (u < 640) & (v > 0) & (v < 512)
        idx = np.nonzero(ok)[0]
        obs_f += [f] * len(idx)
        obs_p += idx.tolist()
        obs_uv += np.stack([u[idx] + 0.3 * rng.normal(size=len(idx)), v[idx] + 0.3 * rng.normal(size=len(idx)),
                            -np.ones(len(idx))], 1).tolist()
    n_obs = len(obs_f)
    assert 1500 < n_obs <= O, n_obs
    obs_uv = np.asarray(obs_uv, np.float32)
    obs_uv[:N_OUT, 0] += 50.0  # gross outliers
    obs_uv[:N_OUT, 1] -= 40.0

    R0 = np.einsum("fij,fjk->fik", _so3(0.02 * rng.normal(size=(NF, 3))), R_true)
    t0 = t_true + 0.1 * rng.normal(size=(NF, 3)).astype(np.float32)
    R0[:2], t0[:2] = R_true[:2], t_true[:2]  # gauge
    X0 = X_true + 0.05 * rng.normal(size=X_true.shape).astype(np.float32)

    def pad(a, n, tail=(), dtype=np.float32):
        out = np.zeros((n,) + tail, dtype)
        out[: len(a)] = a
        return out

    fields = (
        np.concatenate([R0, np.tile(np.eye(3, dtype=np.float32)[None], (F - NF, 1, 1))]).astype(np.float32),
        pad(t0, F, (3,)),
        np.arange(F) < NF,
        np.arange(F) < 2,
        pad(X0, P, (3,)),
        np.arange(P) < NP,
        pad(obs_f, O, (), np.int32),
        pad(obs_p, O, (), np.int32),
        pad(obs_uv, O, (3,)),
        np.arange(O) < n_obs,
    )
    return fields, (R_true, t_true, X_true), n_obs


def _jax_problem(fields):
    return jba.BAProblem(*[jnp.asarray(a) for a in fields])


NAMES = ["H_cc", "b_c", "H_pp", "b_p", "U", "cost"]


@pytest.mark.parametrize("use_huber", [True, False])
def test_normal_terms_match_jax_scatter(window, use_huber):
    fields, _, _ = window
    jp, tp = _jax_problem(fields), tweights.ba_problem_from_numpy(fields)
    jcfg, tcfg = jba.BAConfig(max_free_frames=8), tba.BAConfig(max_free_frames=8)
    Rj, tj = jba._invert_poses(jp.R_wc, jp.t_wc)
    ref = jax.jit(lambda R, t, X, a: jba.build_normal_terms(jp, R, t, X, *GEOM, jcfg, a, use_huber))(
        Rj, tj, jp.X, jp.obs_valid.astype(jnp.float32))
    Rt, tt = tba._invert_poses(tp.R_wc, tp.t_wc)
    out = tba.build_normal_terms(tp, Rt, tt, tp.X, *GEOM, tcfg, tp.obs_valid.to(torch.float32), use_huber)
    for name, x, y in zip(NAMES, ref, out):
        x, y = np.asarray(x), y.numpy()
        assert x.shape == y.shape, name
        scale = max(np.abs(x).max(), 1.0)
        np.testing.assert_allclose(y / scale, x / scale, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("use_huber", [True, False])
def test_bf16_point_side_matches_jax_matmul(window, use_huber):
    """``BAConfig.bf16_point_side`` (the RGB-D setup) rounds
    the point side's summands to bf16 as the JAX package's window route
    (its one-hot matmul) does: >= 99% of every term's entries agree with
    that route to 1e-6 of the term's scale (the rest: a summand that one
    float32 ulp rounds to the other bf16 neighbour), the frame side and the
    cost to 1e-5. The exact float32 summands agree so on < 60% of the
    point side's entries."""
    fields, _, _ = window
    jp, tp = _jax_problem(fields), tweights.ba_problem_from_numpy(fields)
    jcfg = jba.BAConfig(max_free_frames=8)
    Rj, tj = jba._invert_poses(jp.R_wc, jp.t_wc)
    ref = jax.jit(lambda R, t, X, a: jba.build_normal_terms_matmul(jp, R, t, X, *GEOM, jcfg, a, use_huber))(
        Rj, tj, jp.X, jp.obs_valid.astype(jnp.float32))
    Rt, tt = tba._invert_poses(tp.R_wc, tp.t_wc)
    active = tp.obs_valid.to(torch.float32)
    out = tba.build_normal_terms(tp, Rt, tt, tp.X, *GEOM, tba.BAConfig(max_free_frames=8, bf16_point_side=True),
                                 active, use_huber)
    exact = tba.build_normal_terms(tp, Rt, tt, tp.X, *GEOM, tba.BAConfig(max_free_frames=8), active, use_huber)
    for name, x, y, z in zip(NAMES, ref, out, exact):
        x, y, z = np.asarray(x), y.numpy(), z.numpy()
        scale = max(np.abs(x).max(), 1.0)
        assert (np.abs(y - x) <= 1e-6 * scale).mean() >= 0.99, name
        if name in ("H_pp", "b_p", "U"):
            assert (np.abs(z - x) <= 1e-6 * scale).mean() < 0.6, name
        else:
            np.testing.assert_allclose(y / scale, x / scale, atol=1e-5, err_msg=name)


def test_solve_schur_matches_jax(window):
    fields, _, _ = window
    jp = _jax_problem(fields)
    cfg = jba.BAConfig(max_free_frames=8)
    Rj, tj = jba._invert_poses(jp.R_wc, jp.t_wc)
    terms = jax.jit(lambda R, t, X, a: jba.build_normal_terms(jp, R, t, X, *GEOM, cfg, a, True))(
        Rj, tj, jp.X, jp.obs_valid.astype(jnp.float32))[:5]
    slot_active = np.arange(8) < NF - 2
    point_free = fields[5]
    ref_c, ref_p = jax.jit(jba.solve_schur)(*terms, jnp.asarray(slot_active), jnp.asarray(point_free), jnp.float32(1e-4))
    out_c, out_p = tba.solve_schur(*[torch.from_numpy(np.array(x)) for x in terms], torch.from_numpy(slot_active),
                                   torch.from_numpy(point_free), torch.tensor(1e-4))
    np.testing.assert_allclose(out_c.numpy(), np.asarray(ref_c), atol=1e-4)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(ref_p), atol=1e-4)
    assert (out_c.numpy()[NF - 2:] == 0).all() and (out_p.numpy()[NP:] == 0).all()


def test_solve_schur_flags_a_non_spd_system_with_nan():
    FFt, Pt = 2, 3
    H_cc = -torch.eye(6).expand(FFt, 6, 6).clone()  # negative definite
    dc, _ = tba.solve_schur(H_cc, torch.ones(FFt, 6), torch.eye(3).expand(Pt, 3, 3).clone(), torch.zeros(Pt, 3),
                            torch.zeros(Pt, FFt, 6, 3), torch.ones(FFt, dtype=torch.bool),
                            torch.ones(Pt, dtype=torch.bool), torch.tensor(1e-4))
    assert torch.isnan(dc).all()


@pytest.fixture(scope="module")
def adjusted(window):
    fields, _, _ = window
    jp, tp = _jax_problem(fields), tweights.ba_problem_from_numpy(fields)
    out = {}
    for name, assembly in (("scatter", "scatter"), ("auto", "auto")):
        cfg = jba.BAConfig(assembly=assembly, max_free_frames=8)
        out[name] = jax.jit(lambda p: jba.bundle_adjust(p, *GEOM, cfg))(jp)
    out["torch"] = tba.bundle_adjust(tp, *GEOM, tba.BAConfig(max_free_frames=8))
    return out


@pytest.mark.parametrize("ref_name,tol", [("scatter", 2e-4), ("auto", 1e-3)])
def test_bundle_adjust_matches_jax(window, adjusted, ref_name, tol):
    _, _, n_obs = window
    ref, out = adjusted[ref_name], adjusted["torch"]
    np.testing.assert_allclose(out.R_wc.numpy(), np.asarray(ref.R_wc), atol=tol)
    np.testing.assert_allclose(out.t_wc.numpy(), np.asarray(ref.t_wc), atol=tol)
    np.testing.assert_allclose(out.X.numpy(), np.asarray(ref.X), atol=5 * tol)
    assert (out.obs_inlier.numpy() == np.asarray(ref.obs_inlier)).mean() >= 0.99
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=5e-3)


def test_bundle_adjust_solves_the_window(window, adjusted):
    fields, (R_true, t_true, _), n_obs = window
    out = adjusted["torch"]
    assert np.abs(out.R_wc.numpy()[:NF] - R_true).max() < 1e-2
    assert np.abs(out.t_wc.numpy()[:NF] - t_true).max() < 5e-2
    inl = out.obs_inlier.numpy()
    assert inl[:N_OUT].mean() < 0.1  # planted outliers rejected
    assert inl[N_OUT:n_obs].mean() > 0.9
    assert not inl[n_obs:].any()
    # gauge frames and padding untouched
    np.testing.assert_allclose(out.R_wc.numpy()[:2], fields[0][:2], atol=1e-7)
    np.testing.assert_allclose(out.t_wc.numpy()[:2], fields[1][:2], atol=1e-7)
    np.testing.assert_array_equal(out.X.numpy()[NP:], 0.0)


def test_masked_fixed_schedule_equals_early_exit(window):
    """The port runs every LM iteration with updates masked after
    convergence; stopping the loop there instead (what the JAX while_loop
    does) must give the same state. tol=0 never converges early, tol=1
    converges at the first accepted step: the two bracket the masking."""
    fields, _, _ = window
    tp = tweights.ba_problem_from_numpy(fields)
    one = tba.bundle_adjust(tp, *GEOM, tba.BAConfig(max_free_frames=8, tol=1.0))
    # reference: a single accepted iteration per phase is what tol=1 allows
    jp = _jax_problem(fields)
    ref = jax.jit(lambda p: jba.bundle_adjust(p, *GEOM, jba.BAConfig(assembly="scatter", max_free_frames=8, tol=1.0)))(jp)
    np.testing.assert_allclose(one.t_wc.numpy(), np.asarray(ref.t_wc), atol=2e-4)
    np.testing.assert_allclose(one.R_wc.numpy(), np.asarray(ref.R_wc), atol=2e-4)
    full = tba.bundle_adjust(tp, *GEOM, tba.BAConfig(max_free_frames=8, tol=0.0))
    assert float(full.cost) <= float(one.cost) * (1 + 1e-6)


@pytest.mark.parametrize("assembly", ["pallas", "sorted"])
def test_unported_assemblies_raise(window, adjusted, assembly):
    """The kernel assemblies (bf16 point-side summands) solve the window as
    the float32 route does, at optimizer-noise tolerance; only a name that
    is no assembly raises."""
    tp = tweights.ba_problem_from_numpy(window[0])
    out = tba.bundle_adjust(tp, *GEOM, tba.BAConfig(assembly=assembly, max_free_frames=8))
    ref = adjusted["torch"]
    np.testing.assert_allclose(out.R_wc.numpy(), ref.R_wc.numpy(), atol=1e-3)
    np.testing.assert_allclose(out.t_wc.numpy(), ref.t_wc.numpy(), atol=1e-3)
    assert (out.obs_inlier == ref.obs_inlier).float().mean() >= 0.99
    with pytest.raises(ValueError, match="assembly"):
        tba.bundle_adjust(tp, *GEOM, tba.BAConfig(assembly="matmul"))


def test_solve_schur_refuses_tf32_matmul():
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            tba.solve_schur(torch.eye(6)[None], torch.ones(1, 6), torch.eye(3)[None], torch.zeros(1, 3),
                            torch.zeros(1, 1, 6, 3), torch.ones(1, dtype=torch.bool),
                            torch.ones(1, dtype=torch.bool), torch.tensor(1e-4))
    finally:
        torch.set_float32_matmul_precision("highest")
