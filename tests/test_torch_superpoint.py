"""The PyTorch port's SuperPoint path (stage-conv plain version, NMS,
descriptor sampling, the module, keypoint selection, weight import)
against the JAX package on the same numpy inputs, on the CPU.

The stage-conv CUDA kernel cannot run here; its plain version
(``stage_conv_plain``), which the wrapper runs for CPU tensors, is held
against the JAX XLA stages and the Pallas slab kernels in interpret mode.
The kernel itself is held against the plain version on the card by
``chip_smoke.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ur_mvo_tpu.models import superpoint as JS
from ur_mvo_tpu.ops import gridsample as jgs
from ur_mvo_tpu.ops import keypoints as jkp
from ur_mvo_tpu.ops import nms as jnms
from ur_mvo_tpu.ops import pallas_conv
from ur_mvo_tpu_torch.models.superpoint import SuperPoint, load_torch_weights
from ur_mvo_tpu_torch.ops import gridsample as tgs
from ur_mvo_tpu_torch.ops import keypoints as tkp
from ur_mvo_tpu_torch.ops import nms as tnms
from ur_mvo_tpu_torch.ops.cuda_conv import pack_stage, stage_conv, stage_conv_plain
from ur_mvo_tpu_torch.utils.synthscene import render_sequence
from ur_mvo_tpu_torch.weights import superpoint_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP_V3 = os.path.join(REPO, "weights", "superpoint_scratch_v3.npz")
STAGES = (("conv1a", "conv1b"), ("conv2a", "conv2b"), ("conv3a", "conv3b"))


def _random_params(seed: int, biases: bool = True):
    """JAX ``init_params`` as numpy, and the port's state dict of it. With
    ``biases`` the zero biases are replaced by random ones, so that the
    literal-zero halo (not conv_a of padded pixels) is what conv_b must see
    at the image border."""
    pn = jax.tree.map(np.asarray, JS.init_params(jax.random.PRNGKey(seed)))
    if biases:
        rng = np.random.default_rng(seed)
        for v in pn.values():
            v["b"] = rng.normal(0, 0.1, v["b"].shape).astype(np.float32)
    return pn, superpoint_from_numpy(pn)


def _plain_stages(state, x, n):
    for na, nb in STAGES[:n]:
        x = stage_conv_plain(x, state[f"{na}.weight"], state[f"{na}.bias"], state[f"{nb}.weight"], state[f"{nb}.bias"])
    return x


@pytest.mark.parametrize("n_stages,H,W,tol", [(2, 64, 80, 6e-3), (3, 64, 80, 8e-3)])
def test_stage_conv_plain_matches_jax_xla_stages(n_stages, H, W, tol):
    """bf16 stages 1-2 / 1-3 against ``_stage12_xla`` / ``_stage123_xla``
    with the JAX tests' own scaled bounds and parameters (``init_params``,
    zero biases; test_pallas_kernels.py:116,167). The XLA stages round each
    conv output to bf16 before the bias add, the kernel after it: these
    bounds cover that difference."""
    pn, state = _random_params(0, biases=False)
    img = np.random.default_rng(1).random((1, H, W, 1)).astype(np.float32)
    xla = JS._stage12_xla if n_stages == 2 else JS._stage123_xla
    ref = np.asarray(xla(pn, jnp.asarray(img).astype(jnp.bfloat16)).astype(jnp.float32))
    out = _plain_stages(state, torch.from_numpy(img).to(torch.bfloat16), n_stages).float().numpy()
    assert out.shape == ref.shape
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=tol)


def test_stage_conv_plain_matches_pallas_slab_interpret():
    """Stages 1-2 against the Pallas slab kernels in interpret mode at their
    smallest supported shape (32x128), scaled bound 6e-3."""
    pn, state = _random_params(2)
    img = np.random.default_rng(3).random((32, 128)).astype(np.float32)
    slab = pallas_conv.stage12_slab(pn, jnp.asarray(img), interpret=True)  # (H/4, 64, W/4)
    ref = np.transpose(np.asarray(slab.astype(jnp.float32)), (0, 2, 1))[None]
    out = _plain_stages(state, torch.from_numpy(img)[None, :, :, None].to(torch.bfloat16), 2).float().numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=6e-3)


def test_stage_conv_wrapper_runs_plain_version_on_cpu_tensors():
    _, state = _random_params(4)
    x = torch.rand((1, 16, 24, 1), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    args = (x, state["conv1a.weight"], state["conv1a.bias"], state["conv1b.weight"], state["conv1b.bias"])
    out = stage_conv(*args)
    assert out.shape == (1, 8, 12, 64) and out.dtype == torch.bfloat16
    assert torch.equal(out, stage_conv_plain(*args))


def test_superpoint_packs_stage_weights_once_per_weight_set():
    """The stage kernel's weight packing is cached on the module and redone
    only when a stage parameter changes (``load_state_dict``, ``.to()``, an
    in-place update). The bf16 packing holds W[tap][k][n] at the
    mma.m16n8k16 B-fragment position [tap][k // 16][n // 8][lane 4 (n % 8) +
    (k % 8) // 2][register (k % 16) // 8][half k % 2]."""
    _, state = _random_params(6)
    sp = SuperPoint()
    sp.load_state_dict(state)
    p1 = sp._packed_stages()
    assert sp._packed_stages() is p1
    assert torch.equal(p1[0].ba, state["conv1a.bias"]) and p1[1].wa.dtype == torch.float32
    _, state2 = _random_params(7)
    sp.load_state_dict(state2)
    p2 = sp._packed_stages()
    assert p2 is not p1 and torch.equal(p2[0].ba, state2["conv1a.bias"])
    sp.to(torch.bfloat16)
    p3 = sp._packed_stages()
    assert p3 is not p2 and p3[1].dtype == torch.bfloat16
    assert p3[0].wa.dtype == torch.float32 and p3[1].wa.dtype == torch.int32  # Cin = 1 stays a 9-tap filter
    with torch.no_grad():
        sp.conv2b.weight.mul_(2)
    p4 = sp._packed_stages()
    assert p4 is not p3 and sp._packed_stages() is p4

    w = sp.conv2b.weight  # (co, ci, 3, 3)
    co, ci = w.shape[:2]
    frag = p4[1].wb.view(torch.bfloat16).reshape(9, ci // 16, co // 8, 32, 2, 2)
    tap, k, n = torch.meshgrid(torch.arange(9), torch.arange(ci), torch.arange(co), indexing="ij")
    got = frag[tap, k // 16, n // 8, 4 * (n % 8) + (k % 8) // 2, (k % 16) // 8, k % 2]
    assert torch.equal(got, w.permute(2, 3, 1, 0).reshape(9, ci, co))


@pytest.mark.parametrize("stage", [0, 1, 2], ids=["stage1", "stage2", "stage3"])
def test_stage_weight_packing_unpacks_to_oihw(stage):
    """The stage kernel's bf16 weight layout, unpacked in numpy from its
    definition back to OIHW, gives the bf16-rounded shipped weights bit for
    bit (each mma.m16n8k16 B-fragment word [tap][k16][n8][lane 4g + c][register
    r] holds (k = 16 k16 + 8 r + 2 c + half, n = 8 n8 + g) in its two halves);
    conv_a with Cin = 1 is a float [tap][co] filter of the same values. The
    kernel stages per block the n8 columns of its channel slice, so every
    column must sit where this says."""
    na, nb = STAGES[stage]
    state = load_torch_weights(SP_V3)
    packed = pack_stage(state[f"{na}.weight"], state[f"{na}.bias"], state[f"{nb}.weight"], state[f"{nb}.bias"],
                        torch.bfloat16)

    def bits(w):  # bf16 bit patterns as uint16
        return w.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)

    def unpack(words, co, ci):
        half = words.numpy().view(np.uint16).reshape(9, ci // 16, co // 8, 8, 4, 2, 2)
        tap, ks, nt, g, c, r, h = np.meshgrid(*(np.arange(n) for n in half.shape), indexing="ij")
        oihw = np.zeros((co, ci, 3, 3), np.uint16)
        oihw[8 * nt + g, 16 * ks + 8 * r + 2 * c + h, tap // 3, tap % 3] = half
        return oihw

    for name, packed_w in ((nb, packed.wb), (na, packed.wa)):
        w = state[f"{name}.weight"]
        co, ci = w.shape[:2]
        if ci == 1:
            assert packed_w.dtype == torch.float32 and packed_w.shape == (3, 3, 1, co)  # [tap][co]
            np.testing.assert_array_equal(bits(packed_w.permute(3, 2, 0, 1)), bits(w))
        else:
            assert packed_w.dtype == torch.int32 and packed_w.shape == (9, ci // 16, co // 8, 32, 2)
            np.testing.assert_array_equal(unpack(packed_w, co, ci), bits(w))
    np.testing.assert_array_equal(bits(packed.ba), bits(state[f"{na}.bias"]))
    np.testing.assert_array_equal(bits(packed.bb), bits(state[f"{nb}.bias"]))


def test_simple_nms_and_sample_descriptors_match_jax():
    rng = np.random.default_rng(5)
    scores = rng.random((48, 64)).astype(np.float32) ** 4
    np.testing.assert_array_equal(tnms.simple_nms(torch.from_numpy(scores)).numpy(),
                                  np.asarray(jnms.simple_nms(jnp.asarray(scores))))
    dmap = rng.normal(size=(6, 8, 16)).astype(np.float32)
    kpts = np.stack([rng.uniform(0, 63, 40), rng.uniform(0, 47, 40)], 1).astype(np.float32)
    np.testing.assert_allclose(tgs.sample_descriptors(torch.from_numpy(dmap), torch.from_numpy(kpts)).numpy(),
                               np.asarray(jgs.sample_descriptors(jnp.asarray(dmap), jnp.asarray(kpts))), atol=1e-6)


@pytest.fixture(scope="module")
def shipped():
    """The shipped detector in both packages and one rendered 120x160 frame."""
    images, _, _ = render_sequence(1, 120, 160, 130.0, seed=3)
    img = images[0].astype(np.float32)[None, :, :, None] / 255.0
    jp = JS.load_torch_weights(SP_V3)
    sp = SuperPoint()
    sp.load_state_dict(load_torch_weights(SP_V3))
    return jp, sp.eval(), img


def test_superpoint_forward_matches_jax_on_shipped_weights(shipped):
    """float32: scaled backbone, scores and descriptors agree to 1e-4."""
    jp, sp, img = shipped
    feat_j = np.asarray(JS.backbone(jp, jnp.asarray(img)))
    scores_j, desc_j = (np.asarray(a) for a in JS.forward(jp, jnp.asarray(img)))
    with torch.no_grad():
        x = torch.from_numpy(img)
        feat_t = sp.backbone(x).numpy()
        scores_t, desc_t = (a.numpy() for a in sp(x))
    scale = np.abs(feat_j).max()
    np.testing.assert_allclose(feat_t / scale, feat_j / scale, atol=1e-4)
    np.testing.assert_allclose(scores_t, scores_j, atol=1e-4)
    np.testing.assert_allclose(desc_t, desc_j, atol=1e-4)


def test_select_keypoints_matches_jax_slots(shipped):
    """float32: equal valid counts; the same keypoint in the same slot in
    >= 99% of the valid slots."""
    jp, sp, img = shipped
    scores_j, desc_j = JS.forward(jp, jnp.asarray(img))
    bj = jkp.select_keypoints(scores_j[0], desc_j[0], capacity=256, threshold=1e-4, max_keypoints=200)
    with torch.no_grad():
        scores_t, desc_t = sp(torch.from_numpy(img))
    bt = tkp.select_keypoints(scores_t[0], desc_t[0], capacity=256, threshold=1e-4, max_keypoints=200)
    vj, vt = np.asarray(bj.valid), bt.valid.numpy()
    assert vj.sum() == vt.sum() > 100
    same = (np.asarray(bj.kpts) == bt.kpts.numpy()).all(-1) & vj
    assert same.sum() / vj.sum() >= 0.99
    np.testing.assert_allclose(bt.desc.numpy()[same], np.asarray(bj.desc)[same], atol=1e-4)


def test_top_k_ordered_lists_ties_lowest_index_first():
    flat = torch.tensor([0.5, 0.75, 0.5, 0.75, 0.125, 0.5])
    vals, idx = tkp.top_k_ordered(flat, 4)
    assert idx.tolist() == [1, 3, 0, 2] and vals.tolist() == [0.75, 0.75, 0.5, 0.5]
    ref = jax.lax.approx_max_k(jnp.asarray(flat.numpy()), 4, recall_target=0.98)[1]
    assert np.asarray(ref).tolist() == idx.tolist()


def test_bf16_keypoint_sets_overlap_jax(shipped):
    """bf16 compute (the main path's dtype): keypoint-set overlap >= 95%."""
    jp, sp, img = shipped
    scores_j, desc_j = JS.forward(jp, jnp.asarray(img), compute_dtype=jnp.bfloat16)
    bj = jkp.select_keypoints(scores_j[0], desc_j[0], capacity=256, threshold=1e-4, max_keypoints=200)
    sp16 = SuperPoint()
    sp16.load_state_dict(sp.state_dict())
    sp16 = sp16.to(torch.bfloat16).eval()
    with torch.no_grad():
        scores_t, desc_t = sp16(torch.from_numpy(img))
    bt = tkp.select_keypoints(scores_t[0], desc_t[0], capacity=256, threshold=1e-4, max_keypoints=200)
    kj = set(map(tuple, np.asarray(bj.kpts)[np.asarray(bj.valid)]))
    kt = set(map(tuple, bt.kpts.numpy()[bt.valid.numpy()]))
    assert len(kj) > 100
    assert len(kj & kt) / max(len(kj), len(kt)) >= 0.95


def test_weights_round_trip_reproduces_jax_forward():
    """JAX ``init_params`` -> ``superpoint_from_numpy`` -> the port's module
    gives the JAX forward (float32, 1e-4)."""
    pn, state = _random_params(6)
    img = np.random.default_rng(7).random((1, 64, 80, 1)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, pn)
    scores_j, desc_j = (np.asarray(a) for a in JS.forward(jp, jnp.asarray(img)))
    sp = SuperPoint()
    sp.load_state_dict(state)
    with torch.no_grad():
        scores_t, desc_t = (a.numpy() for a in sp.eval()(torch.from_numpy(img)))
    np.testing.assert_allclose(scores_t, scores_j, atol=1e-4)
    np.testing.assert_allclose(desc_t, desc_j, atol=1e-4)
