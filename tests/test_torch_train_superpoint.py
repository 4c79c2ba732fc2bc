"""The port's SuperPoint trainers (``models/train_superpoint.py``,
``models/pretrain_superpoint.py``) and the stage kernel's op
(``ur_mvo_tpu_torch::stage_conv``) against the JAX package on the CPU, at
64x80, B = 2, full width, with JAX's ``superpoint.init_params`` carried
across (``weights.superpoint_from_numpy``).

The two packages draw different random numbers, so every port function is
fed the JAX package's own draws: its ``make_batch`` (homographies, warped
images, masks, photometric noise) and its rendered batches. All JAX
references come from ONE jitted function (``_jax_references``, a module
fixture): unjitted, the JAX package compiles each op on first use, which
costs more than the whole file may take.

Tolerances (float32; the two packages sum convolutions and reductions in
other orders): losses rtol 1e-4; gradients and warped images atol 1e-3 of
the largest magnitude (the JAX package's own Pallas-vs-XLA tests hold bf16
stages to 6e-3 / 8e-3 of the scale, ``tests/test_torch_superpoint.py``);
one Adam step within 1e-5 of optax's (a step moves a weight by ~lr =
1e-3) where the gradient is not within 100x of Adam's epsilon, frozen
parameters bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ur_mvo_tpu.models import pretrain_superpoint as JP
from ur_mvo_tpu.models import superpoint as JS
from ur_mvo_tpu.models import train_superpoint as JT
from ur_mvo_tpu_torch.models import pretrain_superpoint as TP
from ur_mvo_tpu_torch.models import train_superpoint as TT
from ur_mvo_tpu_torch.models.superpoint import SuperPoint
from ur_mvo_tpu_torch.ops.cuda_conv import stage_conv, stage_conv_op, stage_conv_plain
from ur_mvo_tpu_torch.weights import superpoint_from_numpy, superpoint_to_numpy

B, H, W = 2, 64, 80
LOSS_RTOL = 1e-4
GRAD_ATOL = 1e-3  # of the largest |gradient|


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is many small eager ops: one intra-op thread is
    faster beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _inputs():
    """numpy inputs: images, a detector batch, random descriptor maps."""
    rng = np.random.default_rng(0)
    imgs = rng.random((B, H, W)).astype(np.float32)
    det = JP.make_pretrain_batch(np.random.default_rng(1), B, H, W)
    d0 = rng.normal(size=(B, H // 8, W // 8, 256)).astype(np.float32)
    d1 = rng.normal(size=(B, H // 8, W // 8, 256)).astype(np.float32)
    return imgs, det, d0, d1


@functools.lru_cache(maxsize=None)
def _jax_references():
    """Every JAX value the file compares with, from one jitted call, as
    numpy: the parameters, ``make_batch``, the warps of image 0 by its
    homography, ``loss_fn`` with its gradient and one masked Adam step,
    ``detector_loss``, ``pretrain_loss`` (nce, hinge) and the two descriptor
    losses with their gradients, each on the JAX package's own batch."""
    imgs, det, d0, d1 = _inputs()

    @jax.jit
    def refs(imgs, det, d0, d1):
        params = JS.init_params(jax.random.PRNGKey(0))
        batch = JT.make_batch(jax.random.PRNGKey(1), imgs, translation=0.35, scale=0.25, rotation=0.3)
        out = {"params": params, "batch": batch}
        pts = jnp.stack(jnp.meshgrid(jnp.arange(0.0, W, 7.5), jnp.arange(0.0, H, 6.5)), -1).reshape(-1, 2)
        out["warp_points"] = JT.warp_points_xy(pts, batch["H"][0])
        out["warp_image"] = JT.warp_image(imgs[0], batch["H"][0])
        out["loss_fn"] = jax.value_and_grad(JT.loss_fn)(params, batch)
        tx = JT.make_optimizer(1e-3)
        updates, _ = tx.update(out["loss_fn"][1], tx.init(params), params)
        out["adam"] = optax.apply_updates(params, updates)
        out["det"] = jax.value_and_grad(JP.detector_loss)(params, det["image"], det["labels"])
        for obj in ("nce", "hinge"):
            out[obj] = jax.value_and_grad(JP.pretrain_loss, has_aux=True)(params, det, batch, 0.001, obj)
        for name, fn in (("hinge_desc", JT.descriptor_loss), ("nce_desc", JT.descriptor_loss_nce)):
            out[name] = jax.value_and_grad(fn, argnums=(0, 1))(d0, d1, batch["H"], batch["mask"])
        return out

    out = refs(jnp.asarray(imgs), jax.tree.map(jnp.asarray, det), jnp.asarray(d0), jnp.asarray(d1))
    return jax.tree.map(np.asarray, out), out["params"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(ref):
    return {k: _t(v) for k, v in ref["batch"].items()}


def _model(ref):
    sp = SuperPoint()
    sp.load_state_dict(superpoint_from_numpy(ref["params"]))
    return sp


def _close_grads(got: dict, want: dict):
    """``got`` (port state-dict gradients) vs JAX's pytree, every
    parameter, atol GRAD_ATOL of the largest."""
    scale = max(np.abs(v).max() for p in want.values() for v in p.values())
    assert scale > 0
    got_np = superpoint_to_numpy(got)
    for name, p in want.items():
        for f in ("w", "b"):
            np.testing.assert_allclose(got_np[name][f] / scale, p[f] / scale, atol=GRAD_ATOL, err_msg=f"{name}.{f}")


def _grads(model, loss):
    """Every parameter's gradient, zeros where the loss does not reach it."""
    model.zero_grad(set_to_none=True)
    loss.backward()
    return {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p)) for n, p in model.named_parameters()}


def test_warps_on_a_shared_homography():
    """``warp_points_xy`` (atol 1e-3 px) and ``warp_image`` (image and mask:
    the image atol 1e-4, the mask equal but for pixels within float32
    rounding of the border, at most 0.5%) on the JAX package's homography."""
    ref, _ = _jax_references()
    imgs, _, _, _ = _inputs()
    Hm = _t(ref["batch"]["H"][0])
    pts = torch.stack(torch.meshgrid(torch.arange(0.0, W, 7.5), torch.arange(0.0, H, 6.5), indexing="xy"), -1)
    np.testing.assert_allclose(TT.warp_points_xy(pts.reshape(-1, 2), Hm).numpy(), ref["warp_points"], atol=1e-3)
    warped, mask = TT.warp_image(_t(imgs[0]), Hm)
    want_img, want_mask = ref["warp_image"]
    same = mask.numpy() == want_mask
    assert same.mean() >= 0.995
    np.testing.assert_allclose(warped.numpy()[same], want_img[same], atol=1e-4)
    assert 0.2 < want_mask.mean() < 1.0  # the warp moved the border into view
    # batched: the two homographies at once equal the single calls
    both, _ = TT.warp_image(_t(imgs), _t(ref["batch"]["H"]))
    torch.testing.assert_close(both[0], warped, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["hinge_desc", "nce_desc"])
def test_descriptor_losses_value_and_gradient(name):
    """``descriptor_loss`` / ``descriptor_loss_nce`` on random descriptor maps
    and the JAX batch's homographies and masks: the value (rtol 1e-4) and
    the gradient with respect to both maps (atol 1e-3 of the largest)."""
    ref, _ = _jax_references()
    _, _, d0, d1 = _inputs()
    fn = TT.descriptor_loss if name == "hinge_desc" else TT.descriptor_loss_nce
    a, b = _t(d0).requires_grad_(), _t(d1).requires_grad_()
    batch = _batch(ref)
    value = fn(a, b, batch["H"], batch["mask"])
    value.backward()
    want, (ga, gb) = ref[name]
    np.testing.assert_allclose(value.item(), want, rtol=LOSS_RTOL)
    for got, g in ((a.grad, ga), (b.grad, gb)):
        scale = np.abs(g).max()
        assert scale > 0
        np.testing.assert_allclose(got.numpy() / scale, g / scale, atol=GRAD_ATOL)


def test_loss_fn_value_and_every_gradient():
    """``loss_fn`` (the hinge loss of the descriptor branch) on the JAX
    package's ``make_batch`` output: the value and the gradient of every
    parameter (the detector head's, which the loss does not reach, zero in
    both)."""
    ref, _ = _jax_references()
    model = _model(ref)
    value = TT.loss_fn(model, _batch(ref))
    grads = _grads(model, value)
    want, want_g = ref["loss_fn"]
    np.testing.assert_allclose(value.item(), want, rtol=LOSS_RTOL)
    assert model.convPa.weight.grad is None and not np.any(want_g["convPa"]["w"])
    _close_grads(grads, want_g)


def test_masked_adam_step_against_optax():
    """One step of ``make_train_step(make_optimizer(model))`` against
    ``optax.multi_transform(adam / set_to_zero)``: convDa/convDb within 1e-5
    of optax's, every other parameter bit for bit as it was."""
    ref, _ = _jax_references()
    model = _model(ref)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = TT.make_train_step(TT.make_optimizer(model, 1e-3))(model, _batch(ref))
    np.testing.assert_allclose(loss.item(), ref["loss_fn"][0], rtol=LOSS_RTOL)
    after = superpoint_to_numpy(model.state_dict())
    for name, p in ref["adam"].items():
        for f in ("w", "b"):
            if name in TT.TRAINABLE:
                # Adam's first step is lr * g / (|g| + 1e-8): +-lr wherever
                # |g| >> 1e-8, but where |g| is within 100x of that epsilon
                # the step follows the last digits of g; there the limit
                # is the step's own size, lr
                g = np.abs(ref["loss_fn"][1][name][f])
                limit = np.where(g > 1e-6, 1e-5, 1e-3)
                assert np.all(np.abs(after[name][f] - p[f]) <= limit), f"{name}.{f}"
                assert not np.array_equal(after[name][f], ref["params"][name][f])
            else:
                np.testing.assert_array_equal(p[f], ref["params"][name][f])
    for k, v in model.state_dict().items():
        if k.split(".")[0] not in TT.TRAINABLE:
            assert torch.equal(v, before[k]), k
            assert not model.get_parameter(k).requires_grad


def test_rendered_batches_equal_jax():
    """``render_shapes``, ``corners_to_cell_labels``, ``make_pretrain_batch``
    and ``make_texture_batch``: numpy copies, the same arrays from the same
    generator."""
    def arrays(x):
        return list(x.values()) if isinstance(x, dict) else list(x) if isinstance(x, tuple) else [x]

    for name, args in (("render_shapes", (64, 96)), ("make_pretrain_batch", (3, H, W)),
                       ("make_texture_batch", (2, H, W))):
        want = arrays(getattr(JP, name)(np.random.default_rng(7), *args))
        got = arrays(getattr(TP, name)(np.random.default_rng(7), *args))
        assert len(got) == len(want)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)
    img, pts = JP.render_shapes(np.random.default_rng(3), 64, 96)
    np.testing.assert_array_equal(TP.corners_to_cell_labels(pts, 64, 96), JP.corners_to_cell_labels(pts, 64, 96))
    assert (TP.corners_to_cell_labels(pts, 64, 96) != 64).sum() >= 2


@pytest.mark.parametrize("name", ["det", "nce", "hinge"])
def test_detector_and_pretrain_losses(name):
    """``detector_loss`` and ``pretrain_loss`` ("nce", "hinge"; lambda_desc
    0.001) on the JAX package's detector and descriptor batches: values
    (with the detector and descriptor terms) rtol 1e-4, every gradient atol
    1e-3 of the largest."""
    ref, _ = _jax_references()
    _, det, _, _ = _inputs()
    model = _model(ref)
    det_t = {k: _t(v) for k, v in det.items()}
    if name == "det":
        value = TP.detector_loss(model, det_t["image"], det_t["labels"])
        want, want_g = ref["det"]
    else:
        value, (d, s) = TP.pretrain_loss(model, det_t, _batch(ref), 0.001, name)
        (want, (want_d, want_s)), want_g = ref[name]
        np.testing.assert_allclose([d.item(), s.item()], [want_d, want_s], rtol=LOSS_RTOL)
    grads = _grads(model, value)
    np.testing.assert_allclose(value.item(), want, rtol=LOSS_RTOL)
    _close_grads(grads, want_g)


def test_head_masks_select_the_same_layers():
    """``detector_head_mask`` / ``descriptor_head_mask`` / ``trainable_mask``
    name the JAX masks' layers."""
    _, params = _jax_references()
    model = SuperPoint()
    for jfn, tfn in ((JP.detector_head_mask, TP.detector_head_mask), (JP.descriptor_head_mask, TP.descriptor_head_mask),
                     (JT.trainable_mask, TT.trainable_mask)):
        want = {n for n, m in jfn(params).items() if all(jax.tree.leaves(m))}
        got = {k.split(".")[0] for k, on in tfn(model).items() if on}
        assert got == want and want
        assert all(not any(jax.tree.leaves(m)) for n, m in jfn(params).items() if n not in want)


def test_stage_conv_op_opcheck_and_gradient():
    """``ur_mvo_tpu_torch::stage_conv`` passes ``torch.library.opcheck`` on
    the CPU (schema, fake tensor, autograd registration, AOT dispatch) for
    stage 1, and its gradient (stages 1 and 2) (the plain version recomputed) is
    ``stage_conv_plain``'s own autograd bit for bit."""
    g = torch.Generator().manual_seed(0)
    for cin, cm, cout in ((1, 64, 64), (64, 64, 64)):
        x = torch.rand((2, 8, 10, cin), generator=g, requires_grad=True)
        w = [torch.randn((cm, cin, 3, 3), generator=g) * 0.3, torch.randn((cm,), generator=g) * 0.1,
             torch.randn((cout, cm, 3, 3), generator=g) * 0.05, torch.randn((cout,), generator=g) * 0.1]
        w = [t.requires_grad_() for t in w]
        if cin == 1:  # opcheck traces the op five ways: one stage is enough
            torch.library.opcheck(stage_conv_op, (x, *w, []))
        out = stage_conv(x, *w)
        proj = torch.randn(out.shape, generator=g)
        got = torch.autograd.grad((out * proj).sum(), [x, *w])
        ref = stage_conv_plain(x, *w)
        want = torch.autograd.grad((ref * proj).sum(), [x, *w])
        assert torch.equal(out, ref)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_training_command_lines(tmp_path):
    """``cli.pretrain_superpoint`` and ``cli.train_superpoint`` on the CPU
    at a tiny size write checkpoints the JAX package's loader reads; the
    fine-tuned one differs from its base only in convDa/convDb. Without
    CUDA the default ``--device`` raises."""
    from ur_mvo_tpu_torch.cli import pretrain_superpoint as pre_cli
    from ur_mvo_tpu_torch.cli import train_superpoint as ft_cli
    from ur_mvo_tpu_torch.models.superpoint import load_torch_weights

    out = str(tmp_path / "sp.npz")
    pre_cli.main(["--out", out, "--steps", "1", "--batch", "1", "--size", "32", "32", "--device", "cpu"])
    assert set(JS.load_torch_weights(out)) == {layer[0] for layer in JS._ENCODER + JS._HEADS}
    (tmp_path / "imgs").mkdir()
    for i in range(2):
        np.save(tmp_path / "imgs" / f"{i}.npy", (np.random.default_rng(i).random((40, 50)) * 255).astype(np.uint8))
    ft = str(tmp_path / "ft.npz")
    ft_cli.main(["--images", str(tmp_path / "imgs"), "--weights", out, "--out", ft, "--epochs", "1",
                 "--steps-per-epoch", "1", "--batch", "1", "--crop", "32", "32", "--device", "cpu"])
    base, tuned = load_torch_weights(out), load_torch_weights(ft)
    assert {k.split(".")[0] for k in base if not torch.equal(base[k], tuned[k])} == set(TT.TRAINABLE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pre_cli.main(["--out", str(tmp_path / "x.npz"), "--steps", "1"])
