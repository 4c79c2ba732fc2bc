"""The PyTorch port's SuperGlue path (attention and Sinkhorn plain
versions, the module on the shipped checkpoint, decoding, mutual-NN,
weight import) against the JAX package on the same numpy inputs, on the
CPU.

The attention and Sinkhorn CUDA kernels cannot run here; their plain
versions, which the wrappers run for CPU tensors, are held against the
JAX XLA ops and the Pallas kernels in interpret mode. The kernels
themselves are held against the plain versions on the card by
``chip_smoke.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ur_mvo_tpu.models import superglue as JG
from ur_mvo_tpu.models import superpoint as JS
from ur_mvo_tpu.ops import matching as jm
from ur_mvo_tpu.ops import nn_matcher as jnn
from ur_mvo_tpu.ops.keypoints import FeatureBank as JBank
from ur_mvo_tpu.ops.keypoints import select_keypoints
from ur_mvo_tpu.ops.pallas_kernels import attention_pallas, log_optimal_transport_pallas
from ur_mvo_tpu.ops.sinkhorn import log_optimal_transport as jax_lot
from ur_mvo_tpu_torch.models.superglue import SuperGlue, load_weights
from ur_mvo_tpu_torch.ops import matching as tm
from ur_mvo_tpu_torch.ops import nn_matcher as tnn
from ur_mvo_tpu_torch.ops.cuda_kernels import attention, attention_plain, log_optimal_transport_kernel
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank
from ur_mvo_tpu_torch.ops.sinkhorn import log_optimal_transport
from ur_mvo_tpu_torch.utils.synthscene import render_sequence
from ur_mvo_tpu_torch.weights import superglue_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP_V3 = os.path.join(REPO, "weights", "superpoint_scratch_v3.npz")
SG_CKPT = os.path.join(REPO, "weights", "superglue_v3scene.npz")
SG_STEREO = os.path.join(REPO, "weights", "superglue_v4stereo.npz")


def _to_torch(bank) -> FeatureBank:
    return FeatureBank(*(torch.from_numpy(np.array(a)) for a in bank))


@pytest.mark.parametrize("K,valid_counts", [(64, (40, 33)), (64, (0, 0)), (100, (37, 30)), (100, (100, 100))],
                         ids=["40", "0", "K100-37", "K100-all"])
def test_attention_plain_matches_pallas_and_xla(K, valid_counts):
    """float32 at the JAX test's bound (2e-5, test_pallas_kernels.py:56),
    batched over a pair of banks with these valid counts; (0, 0) has no valid
    key, where the softmax over all -1e9 logits is uniform. K=100 is ragged
    against the CUDA kernel's 64-key tiles: it pins the plain version that
    the kernel is held to on the card there."""
    rng = np.random.default_rng(2)
    B, H, D = 2, 4, 32
    q, k, v = (rng.normal(size=(B, K, H, D)).astype(np.float32) for _ in range(3))
    valid = np.stack([np.arange(K) < n for n in valid_counts])
    out = attention(*(torch.from_numpy(a) for a in (q, k, v, valid))).numpy()
    np.testing.assert_array_equal(out, attention_plain(*(torch.from_numpy(a) for a in (q, k, v, valid))).numpy())

    pal = np.asarray(jax.vmap(lambda *a: attention_pallas(*a, interpret=True))(*(jnp.asarray(a) for a in (q, k, v, valid))))
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / jnp.sqrt(jnp.asarray(D, jnp.float32))
    logits = jnp.where(jnp.asarray(valid)[:, None, None, :], logits, -1e9)
    xla = np.asarray(jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(logits, -1), v))
    np.testing.assert_allclose(out, xla, atol=2e-5)
    np.testing.assert_allclose(out, pal, atol=2e-5)
    if valid_counts == (0, 0):
        np.testing.assert_allclose(out, np.broadcast_to(v.mean(axis=1, keepdims=True), out.shape), atol=2e-5)


@pytest.mark.parametrize("M,N,m,n,alpha,iters", [(48, 40, 30, 25, 0.7, 30), (33, 33, 33, 33, 1.0, 50),
                                                 (129, 257, 100, 200, 1.2, 20), (40, 50, 0, 30, 1.0, 20),
                                                 (1, 40, 1, 30, 0.5, 20)])
def test_sinkhorn_plain_matches_jax_and_pallas(M, N, m, n, alpha, iters):
    """The kernel path's transport and the plain masked one against JAX's
    ``log_optimal_transport`` and the Pallas kernel in interpret mode: 1e-4
    on the valid block plus the dustbins (test_pallas_kernels.py:26,36).
    Beside the first two: the shapes the one-launch kernel's bands must
    carry, M != N with both sides ragged against its 256-wide row sweep and
    32 row groups; m = 0, where every real row's max clamps to -1e9 and only
    the dustbins carry mass; a single row."""
    rng = np.random.default_rng(M)
    scores = (rng.normal(size=(M, N)) * 2.0).astype(np.float32)
    v0, v1 = np.arange(M) < m, np.arange(N) < n
    args_t = (torch.from_numpy(scores), torch.from_numpy(v0), torch.from_numpy(v1), torch.tensor(alpha))
    args_j = (jnp.asarray(scores), jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(alpha))
    mask = np.concatenate([v0, [True]])[:, None] & np.concatenate([v1, [True]])[None, :]
    ref = np.asarray(jax_lot(*args_j, iterations=iters))
    pal = np.asarray(log_optimal_transport_pallas(*args_j, iterations=iters, interpret=True))
    kern = log_optimal_transport_kernel(*args_t, iterations=iters).numpy()
    plain = log_optimal_transport(*args_t, iterations=iters).numpy()
    for ours in (kern, plain):
        np.testing.assert_allclose(ours[mask], ref[mask], atol=1e-4)
        np.testing.assert_allclose(ours[mask], pal[mask], atol=1e-4)
        assert (ours[~mask] == -1e9).all()


@pytest.fixture(scope="module")
def shipped_banks():
    """Two capacity-256 banks of rendered 120x160 frames (the JAX extractor's
    SuperPoint + selection)."""
    images, _, _ = render_sequence(2, 120, 160, 130.0, seed=11)
    sp = JS.load_torch_weights(SP_V3)
    banks = []
    for im in images:
        s, d = JS.forward(sp, jnp.asarray(im.astype(np.float32) / 255.0)[None, :, :, None])
        banks.append(select_keypoints(s[0], d[0], capacity=256, threshold=1e-4, max_keypoints=200))
    return banks


def _match_scores_hold_to_jax(banks, ckpt):
    """The shipped matcher ``ckpt`` in both packages on the same banks,
    float32: Z agrees to 1e-3 on the valid entries and the dustbins;
    ``decode_assignment`` gives the same ``idx1`` in >= 99% of slots."""
    jp = JG.load_weights(ckpt)
    tg = SuperGlue.from_state_dict(load_weights(ckpt)).eval()
    Zj = np.asarray(jax.jit(lambda p, a, b: JG.match_scores(p, a, b, 160, 120))(jp, *banks))
    with torch.no_grad():
        Zt = tg.match_scores(_to_torch(banks[0]), _to_torch(banks[1]), 160, 120).numpy()
    v0, v1 = (np.concatenate([np.asarray(b.valid), [True]]) for b in banks)
    mask = v0[:, None] & v1[None, :]
    np.testing.assert_allclose(Zt[mask], Zj[mask], atol=1e-3)
    mj = jm.decode_assignment(jnp.asarray(Zj), banks[0].valid, banks[1].valid, 0.2)
    mt = tm.decode_assignment(torch.from_numpy(Zt), torch.from_numpy(np.array(banks[0].valid)),
                              torch.from_numpy(np.array(banks[1].valid)), 0.2)
    assert int(mt.num_valid()) > 20
    assert (mt.idx1.numpy() == np.asarray(mj.idx1)).mean() >= 0.99


def test_superglue_match_scores_match_jax_on_shipped_weights(shipped_banks):
    """float32, identical banks: Z agrees to 1e-3 on the valid entries and
    the dustbins; ``decode_assignment`` gives the same ``idx1`` in >= 99% of
    slots."""
    _match_scores_hold_to_jax(shipped_banks, SG_CKPT)


def test_superglue_match_scores_match_jax_on_shipped_stereo_weights(shipped_banks):
    """The shipped stereo checkpoint (``superglue_v4stereo.npz``, the
    ``--sg-weights`` opt-in for a distorted right lens) carried across at
    the mono checkpoint's limits, on the same banks."""
    _match_scores_hold_to_jax(shipped_banks, SG_STEREO)


def test_superglue_weights_round_trip_reproduces_jax():
    """JAX ``init_params`` (2 layer pairs) -> ``superglue_from_numpy`` -> the
    port's module gives the JAX log-assignment (float32, 1e-3 on valid
    entries and dustbins). ``init_params`` zero-initialises each message
    MLP's output layer, which would make the GNN an identity: those, the
    biases and the folded norms are drawn at random here."""
    rng = np.random.default_rng(8)
    pn = jax.tree.map(np.asarray, JG.init_params(jax.random.PRNGKey(1), num_layers=2))
    for layer in pn["layers"]:
        layer["mlp"][-1]["w"] = rng.normal(0, 0.02, layer["mlp"][-1]["w"].shape).astype(np.float32)
        for lin in (layer["q"], layer["k"], layer["v"], layer["merge"], *layer["mlp"]):
            lin["b"] = rng.normal(0, 0.05, lin["b"].shape).astype(np.float32)
        layer["mlp"][0]["scale"] = rng.uniform(0.8, 1.2, 512).astype(np.float32)
        layer["mlp"][0]["shift"] = rng.normal(0, 0.05, 512).astype(np.float32)
    pn["desc_center"] = rng.normal(0, 0.05, 256).astype(np.float32)
    K = 64
    banks = []
    for n in (50, 41):
        d = rng.normal(size=(K, 256)).astype(np.float32)
        banks.append(JBank(
            scores=jnp.asarray(rng.random(K).astype(np.float32)),
            kpts=jnp.asarray(rng.uniform(0, 150, (K, 2)).astype(np.float32)),
            desc=jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True)),
            valid=jnp.asarray(np.arange(K) < n),
        ))
    Zj = np.asarray(jax.jit(lambda p, a, b: JG.match_scores(p, a, b, 160, 120))(jax.tree.map(jnp.asarray, pn), *banks))
    tg = SuperGlue.from_state_dict(superglue_from_numpy(pn)).eval()
    with torch.no_grad():
        Zt = tg.match_scores(_to_torch(banks[0]), _to_torch(banks[1]), 160, 120).numpy()
    v0, v1 = (np.concatenate([np.asarray(b.valid), [True]]) for b in banks)
    mask = v0[:, None] & v1[None, :]
    np.testing.assert_allclose(Zt[mask], Zj[mask], atol=1e-3)


@pytest.mark.parametrize("margin", [0.0, 0.5])
def test_decode_assignment_matches_jax(margin):
    rng = np.random.default_rng(9)
    K = 96
    Z = rng.normal(size=(K + 1, K + 1)).astype(np.float32)
    Z[np.arange(K), rng.permutation(K)] += 4.0  # confident pairs
    v0, v1 = np.arange(K) < 80, np.arange(K) < 90
    mj = jm.decode_assignment(jnp.asarray(Z), jnp.asarray(v0), jnp.asarray(v1), 0.5, margin=margin)
    mt = tm.decode_assignment(torch.from_numpy(Z), torch.from_numpy(v0), torch.from_numpy(v1), 0.5, margin=margin)
    assert int(mt.num_valid()) > 10
    np.testing.assert_array_equal(mt.idx1.numpy(), np.asarray(mj.idx1))
    np.testing.assert_allclose(mt.score.numpy(), np.asarray(mj.score), rtol=1e-6)


@pytest.mark.parametrize("center", [False, True])
def test_match_nn_matches_jax(center):
    rng = np.random.default_rng(10)
    K = 128
    d0 = rng.normal(size=(K, 256)).astype(np.float32)
    d1 = d0[rng.permutation(K)] + rng.normal(0, 0.3, (K, 256)).astype(np.float32)
    banks = []
    for d, n in ((d0, 100), (d1, 110)):
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        banks.append((np.ones(K, np.float32), np.zeros((K, 2), np.float32), d, np.arange(K) < n))
    mj = jnn.match_nn(*(JBank(*map(jnp.asarray, b)) for b in banks), center=center)
    mt = tnn.match_nn(*(FeatureBank(*map(torch.from_numpy, b)) for b in banks), center=center)
    assert int(mt.num_valid()) > 20
    np.testing.assert_array_equal(mt.idx1.numpy(), np.asarray(mj.idx1))
