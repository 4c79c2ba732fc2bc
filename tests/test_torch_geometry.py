"""The PyTorch port's geometry (``ur_mvo_tpu_torch.ops.linalg``,
``ops.ransac``, ``camera.remap_bilinear``) against the JAX package on the
same numpy inputs, on the CPU.

Torch cannot reproduce JAX's counter-based Gumbel draws, so RANSAC is
compared on the JAX sampler's minimal sets, injected into both."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ur_mvo_tpu.camera import remap_bilinear as jax_remap
from ur_mvo_tpu.ops import linalg as jlin
from ur_mvo_tpu.ops import ransac as jr
from ur_mvo_tpu_torch.camera import remap_bilinear
from ur_mvo_tpu_torch.ops import linalg as tlin
from ur_mvo_tpu_torch.ops import ransac as tr
from ur_mvo_tpu_torch.utils.synthscene import so3_exp


def _two_view(seed: int, n: int = 128, n_valid: int = 110, outliers: int = 15):
    """Projections of random 3D points into two views (400 px focal,
    640x480), 0.5 px noise, ``outliers`` corrupted pairs, and ``n - n_valid``
    invalid padded slots."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 9], (n, 3))
    R = so3_exp(np.array([0.02, -0.05, 0.03]))
    t = np.array([0.4, 0.05, 0.02])

    def proj(P):
        return np.stack([400 * P[:, 0] / P[:, 2] + 320, 400 * P[:, 1] / P[:, 2] + 240], 1)

    p1 = proj(X) + rng.normal(0, 0.5, (n, 2))
    p2 = proj(X @ R.T + t) + rng.normal(0, 0.5, (n, 2))
    p2[:outliers] += rng.uniform(20, 60, (outliers, 2))
    valid = np.arange(n) < n_valid
    return p1.astype(np.float32), p2.astype(np.float32), valid


def _unit_f(F):
    """F / ||F|| with the sign fixed by its largest-magnitude entry."""
    F = F / np.linalg.norm(F, axis=(-2, -1), keepdims=True)
    flat = F.reshape(F.shape[:-2] + (9,))
    sign = np.sign(np.take_along_axis(flat, np.abs(flat).argmax(-1)[..., None], -1))
    return F * sign[..., None]


def test_eigh3x3_and_inv3x3_match_jax():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(3, dtype=np.float32)  # SPD
    ej, Vj = jlin.eigh3x3(jnp.asarray(A))
    et, Vt = tlin.eigh3x3(torch.from_numpy(A))
    # float32 closed forms evaluated in another order: 1e-4 relative on
    # eigenvalues, eigenvectors up to sign
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-4, atol=1e-4)
    dots = np.abs(np.sum(np.asarray(Vj) * Vt.numpy(), axis=-2))
    np.testing.assert_allclose(dots, 1.0, atol=1e-3)
    np.testing.assert_allclose(tlin.inv3x3(torch.from_numpy(A)).numpy(), np.asarray(jlin.inv3x3(jnp.asarray(A))),
                               rtol=1e-5, atol=1e-5)


def test_smallest_singular_vector_matches_jax():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(32, 8, 9)).astype(np.float32)  # eight-point shaped
    vj = np.asarray(jax.jit(jlin.smallest_singular_vector)(jnp.asarray(A)))
    vt = tlin.smallest_singular_vector(torch.from_numpy(A)).numpy()
    # same null vector up to sign, to float32 inverse-iteration accuracy
    np.testing.assert_allclose(np.abs(np.sum(vj * vt, -1)), 1.0, atol=1e-5)


def test_fit_and_score_fundamental_match_jax():
    p1, p2, valid = _two_view(2)
    sets = np.asarray(jr.sample_minimal_sets(jax.random.PRNGKey(3), jnp.asarray(valid), 200, 8))
    fit = jax.jit(jax.vmap(jr.fit_fundamental_8pt))
    Fj = np.asarray(fit(jnp.asarray(p1)[sets], jnp.asarray(p2)[sets]))
    Ft = tr.fit_fundamental_8pt(torch.from_numpy(p1[sets]), torch.from_numpy(p2[sets])).numpy()
    # F agrees to 1e-4 after normalisation
    np.testing.assert_allclose(_unit_f(Ft), _unit_f(Fj), atol=1e-4)

    sj, inl_j = jr.score_fundamental(jnp.asarray(Fj), jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid))
    st, inl_t = tr.score_fundamental(torch.from_numpy(Fj.copy()), torch.from_numpy(p1), torch.from_numpy(p2),
                                     torch.from_numpy(valid))
    # a pair at the chi^2 gate can flip with the last float32 bit, moving
    # its hypothesis' score by up to the cap: >= 99% of scores agree to
    # 1e-4 relative, and >= 99% of the inlier verdicts
    assert np.isclose(st.numpy(), np.asarray(sj), rtol=1e-4, atol=1e-3).mean() >= 0.99
    assert (inl_t.numpy() == np.asarray(inl_j)).mean() >= 0.99


def test_ransac_fundamental_matches_jax_on_injected_sets():
    p1, p2, valid = _two_view(4)
    key = jax.random.PRNGKey(5)
    sets = np.array(jr.sample_minimal_sets(key, jnp.asarray(valid), 200, 8))
    rj = jax.jit(jr.ransac_fundamental)(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid))
    rt = tr.ransac_fundamental(None, torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid),
                               sets=torch.from_numpy(sets))
    np.testing.assert_allclose(_unit_f(rt.model.numpy()), _unit_f(np.asarray(rj.model)), atol=1e-4)
    inl_j, inl_t = np.asarray(rj.inliers), rt.inliers.numpy()
    assert (inl_t == inl_j).mean() >= 0.99
    # the planted outliers are rejected, the clean valid pairs kept
    assert not inl_t[:15].any() and inl_t[15:110].mean() > 0.9


def test_sample_minimal_sets_draws_distinct_valid_slots():
    valid = torch.arange(64) < 40
    gen = torch.Generator().manual_seed(0)
    sets = tr.sample_minimal_sets(gen, valid, 200, 8)
    assert sets.shape == (200, 8)
    assert bool((sets < 40).all())
    assert all(len(set(row.tolist())) == 8 for row in sets)
    # the generator is the only source of randomness
    again = tr.sample_minimal_sets(torch.Generator().manual_seed(0), valid, 200, 8)
    assert torch.equal(sets, again)


def test_remap_bilinear_matches_jax():
    rng = np.random.default_rng(6)
    img = rng.random((24, 32)).astype(np.float32)
    yy, xx = np.mgrid[0:24, 0:32].astype(np.float32)
    src = np.stack([xx * 1.03 - 0.7 + rng.normal(0, 0.3, xx.shape), yy * 0.97 + 0.4], -1).astype(np.float32)
    ours = remap_bilinear(torch.from_numpy(img), torch.from_numpy(src)).numpy()
    ref = np.asarray(jax_remap(jnp.asarray(img), jnp.asarray(src)))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
