"""The port's SuperGlue trainer (``models/train_superglue.py``) and the
checkpoints that cross between the packages (``superglue.save_npz``,
``superpoint.save_npz``, ``weights.*_to_numpy``) against the JAX package on
the CPU: 2 GNN layers (4 layers of attention), 4 heads, capacity 32, a
128x96 image, B = 2, with JAX's ``superglue.init_params`` carried across.

``make_batch`` is numpy in both packages (the same draws); the port's
device generator (``make_batch_device``) draws other numbers than
``jax.random``, so it is held to the JAX test's consistency checks. The JAX
references come from one jitted function (a module fixture).

Tolerances (float32; other summation orders, and the JAX package's XLA
Sinkhorn against the port's plain one): losses rtol 1e-4, gradients atol
1e-3 of the largest, one clip + Adam step within 1e-5 of optax's where the
gradient is not within 100x of Adam's epsilon (there, the step's own size,
lr); checkpoints bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ur_mvo_tpu.models import superglue as JG
from ur_mvo_tpu.models import superpoint as JS
from ur_mvo_tpu.models import train_superglue as JTG
from ur_mvo_tpu_torch.models import superglue as TG
from ur_mvo_tpu_torch.models import superpoint as TS
from ur_mvo_tpu_torch.models import train_superglue as TTG
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank
from ur_mvo_tpu_torch.weights import superglue_from_numpy, superglue_to_numpy, superpoint_from_numpy, superpoint_to_numpy

W, H = 128, 96
CAP, LAYERS, HEADS, SINKHORN, B = 32, 2, 4, 20, 2
LR = 1e-3
LOSS_RTOL = 1e-4
GRAD_ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is many small eager ops: one intra-op thread is
    faster beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_references():
    """The JAX package's batch (numpy, seed 0), and from one jitted call its
    parameters, ``batch_loss`` with its gradient, one
    ``chain(clip_by_global_norm(1), adam)`` step and ``matching_loss`` with
    its gradient on a random log-transport matrix."""
    batch = JTG.make_batch(np.random.default_rng(0), B, CAP, W, H)
    log_p = np.random.default_rng(1).normal(size=(CAP + 1, CAP + 1)).astype(np.float32) - 3.0

    @jax.jit
    def refs(batch, log_p):
        params = JG.init_params(jax.random.PRNGKey(0), LAYERS, HEADS)
        out = {"params": params}
        out["batch_loss"] = jax.value_and_grad(JTG.batch_loss)(params, *batch, W, H, SINKHORN, HEADS)
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
        updates, _ = tx.update(out["batch_loss"][1], tx.init(params), params)
        out["step"] = optax.apply_updates(params, updates)
        b0, b1, t0, t1 = batch
        out["matching_loss"] = jax.value_and_grad(JTG.matching_loss)(log_p, t0[0], t1[0], b0.valid[0], b1.valid[0])
        return out

    out = refs(batch, jnp.asarray(log_p))
    return jax.tree.map(np.asarray, batch), log_p, jax.tree.map(np.asarray, out)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_batch(batch):
    b0, b1, t0, t1 = batch
    return FeatureBank(*(_t(f) for f in b0)), FeatureBank(*(_t(f) for f in b1)), _t(t0), _t(t1)


def _model(params):
    return TTG.make_model(LAYERS, 0, superglue_from_numpy(params), torch.device("cpu"))


def test_make_batch_equals_jax():
    """The numpy generator's banks and targets, array for array, from the
    same ``np.random.Generator``."""
    want = JTG.make_batch(np.random.default_rng(3), 3, CAP, W, H, drop_frac=0.3, desc_noise=0.5)
    got = TTG.make_batch(np.random.default_rng(3), 3, CAP, W, H, drop_frac=0.3, desc_noise=0.5)
    for jw, tg in ((want[0], got[0]), (want[1], got[1])):
        for a, b in zip(jw, tg):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(want[2:], got[2:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_matching_loss_value_and_gradient():
    """``matching_loss`` on one pair's targets and a random log-transport
    matrix: value rtol 1e-4, gradient atol 1e-3 of the largest; the
    batched form (a leading axis) gives each item's value."""
    batch, log_p, ref = _jax_references()
    b0, b1, t0, t1 = _port_batch(batch)
    lp = _t(log_p).requires_grad_()
    value = TTG.matching_loss(lp, t0[0], t1[0], b0.valid[0], b1.valid[0])
    value.backward()
    want, g = ref["matching_loss"]
    np.testing.assert_allclose(value.item(), want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(lp.grad.numpy() / np.abs(g).max(), g / np.abs(g).max(), atol=GRAD_ATOL)
    both = TTG.matching_loss(torch.stack([lp.detach()] * 2), t0, t1, b0.valid, b1.valid)
    assert both[0].item() == value.item()


def test_batch_loss_value_and_every_gradient():
    """``batch_loss`` (``match_scores`` on the B pairs as lanes, plain
    attention and Sinkhorn) against JAX's vmapped one: value rtol 1e-4,
    the gradient of every parameter atol 1e-3 of the largest."""
    batch, _, ref = _jax_references()
    model = _model(ref["params"])
    value = TTG.batch_loss(model, *_port_batch(batch), W, H, SINKHORN, HEADS)
    value.backward()
    want, want_g = ref["batch_loss"]
    np.testing.assert_allclose(value.item(), want, rtol=LOSS_RTOL)
    want_g = superglue_from_numpy(want_g)
    scale = max(float(v.abs().max()) for v in want_g.values())
    grads = dict(model.named_parameters())
    assert set(grads) == set(want_g)
    for k, g in want_g.items():
        got = grads[k].grad if grads[k].grad is not None else torch.zeros_like(g)
        np.testing.assert_allclose(got.numpy() / scale, g.numpy() / scale, atol=GRAD_ATOL, err_msg=k)


def test_clip_and_adam_step_against_optax():
    """One step of ``make_train_step`` (``clip_grad_norm_(1.0)``, then Adam)
    against ``optax.chain(clip_by_global_norm(1.0), adam)``. PyTorch scales
    by 1 / (norm + 1e-6) where optax scales by 1 / norm, which moves a
    gradient by ~1e-6 of itself: under the step's limit."""
    batch, _, ref = _jax_references()
    model = _model(ref["params"])
    step = TTG.make_train_step(W, H, SINKHORN, HEADS, torch.optim.Adam(model.parameters(), lr=LR))
    loss = step(model, *_port_batch(batch))
    np.testing.assert_allclose(loss.item(), ref["batch_loss"][0], rtol=LOSS_RTOL)
    got = model.state_dict()
    want = superglue_from_numpy(ref["step"])
    grads = superglue_from_numpy(ref["batch_loss"][1])
    moved = 0
    for k, w in want.items():
        limit = torch.where(grads[k].abs() > 1e-6, 1e-5, LR)
        assert torch.all((got[k] - w).abs() <= limit), k
        moved += int((w != superglue_from_numpy(ref["params"])[k]).sum())
    assert moved > 0


def test_make_batch_device_consistency():
    """``tests/test_train_superglue.py::test_make_batch_device_consistency``
    on the port's generator: targets mutually inverse over kept points,
    matched descriptors at the prescribed cosine (> 0.8 for noise 0.5),
    matched keypoints where ``tgt0`` says, distractors at the dustbin."""
    K = 32
    b0, b1, t0, t1 = TTG.make_batch_device(torch.Generator().manual_seed(0), 3, K, W, H, desc_noise=0.5)
    for b in range(3):
        t0n, t1n = t0[b].numpy(), t1[b].numpy()
        kept = np.nonzero(t0n < K)[0]
        assert len(kept) > K // 3
        np.testing.assert_array_equal(t1n[t0n[kept]], kept)
        sims = np.sum(b0.desc[b].numpy()[kept] * b1.desc[b].numpy()[t0n[kept]], axis=-1)
        assert sims.min() > 0.8
        distract = np.nonzero(t1n == K)[0]
        assert not np.any(np.isin(distract, t0n[kept]))
        assert b0.valid[b].all() and b1.valid[b].all()


def test_checkpoints_cross_between_packages(tmp_path):
    """A port SuperGlue saved with ``superglue.save_npz`` loads in the JAX
    package (``load_npz``, ``load_weights``) and back in the port bit for
    bit; the same for SuperPoint (``superpoint.save_npz``, read by both
    packages' ``load_torch_weights``); ``*_to_numpy`` inverts
    ``*_from_numpy``."""
    _, _, ref = _jax_references()
    model = _model(ref["params"])
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.25)  # a "trained" model: not the init the loader's template draws
    path = str(tmp_path / "sg.npz")
    TG.save_npz(path, model)
    state = model.state_dict()
    jax_loaded = JG.load_npz(path, LAYERS, HEADS)
    for k, v in superglue_from_numpy(jax.tree.map(np.asarray, jax_loaded)).items():
        assert torch.equal(v, state[k]), k
    assert set(superglue_from_numpy(jax.tree.map(np.asarray, JG.load_weights(path, LAYERS, HEADS)))) == set(state)
    for k, v in TG.load_weights(path, LAYERS, HEADS).items():
        assert torch.equal(v, state[k]), k
    for k, v in superglue_from_numpy(superglue_to_numpy(state)).items():
        assert torch.equal(v, state[k]), k

    sp = TS.SuperPoint().init_random(torch.Generator().manual_seed(4))
    sp_path = str(tmp_path / "sp.npz")
    TS.save_npz(sp, sp_path)
    sp_state = sp.state_dict()
    for k, v in superpoint_from_numpy(jax.tree.map(np.asarray, JS.load_torch_weights(sp_path))).items():
        assert torch.equal(v, sp_state[k]), k
    for k, v in TS.load_torch_weights(sp_path).items():
        assert torch.equal(v, sp_state[k]), k
    for k, v in superpoint_from_numpy(superpoint_to_numpy(sp_state)).items():
        assert torch.equal(v, sp_state[k]), k


def test_train_on_device_learns():
    """``train_on_device`` (two chunks of 15 steps, the JAX test's easy
    regime) lowers the loss on a fixed batch drawn apart, and ``train``
    (host-fed) runs its steps; every parameter stays finite."""
    easy = dict(desc_noise=0.5, drop_frac=0.1)
    g = torch.Generator().manual_seed(99)
    held = TTG.make_batch_device(g, 4, CAP, W, H, **easy)
    model0 = TTG.make_model(LAYERS, 0, None, torch.device("cpu"))
    with torch.no_grad():
        before = TTG.batch_loss(model0, *held, W, H, SINKHORN, HEADS).item()
    model = TTG.train_on_device(steps=30, chunk=15, batch=4, capacity=CAP, width=W, height=H, num_layers=LAYERS,
                                num_heads=HEADS, sinkhorn_iterations=SINKHORN, lr=LR, seed=0, log_fn=None,
                                batch_kwargs=easy, device="cpu")
    with torch.no_grad():
        after = TTG.batch_loss(model, *held, W, H, SINKHORN, HEADS).item()
    assert after < 0.8 * before, (before, after)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    host = TTG.train(steps=2, batch=2, capacity=CAP, width=W, height=H, num_layers=LAYERS, num_heads=HEADS,
                     sinkhorn_iterations=SINKHORN, lr=LR, seed=1, log_every=0, device="cpu")
    assert not host.kernels and all(torch.isfinite(p).all() for p in host.parameters())


def test_training_command_lines(tmp_path):
    """``cli.train_superglue`` (host-fed and ``--on-device``) and
    ``cli.train_superglue_v3`` (``data`` on one rendered stereo scene,
    ``train`` with gap balancing, ``eval``) on the CPU at a tiny size; the
    checkpoints load in the JAX package with the ``__meta_*__`` keys
    ``train`` embeds."""
    from ur_mvo_tpu_torch.cli import train_superglue as sg_cli
    from ur_mvo_tpu_torch.cli import train_superglue_v3 as v3_cli

    for extra in ([], ["--on-device", "--chunk", "1"]):
        out = str(tmp_path / f"sg{len(extra)}.npz")
        sg_cli.main(["--out", out, "--steps", "1", "--batch", "1", "--capacity", "16", "--layers", "1",
                     "--device", "cpu", *extra])
        assert len(jax.tree.leaves(JG.load_weights(out, 1, HEADS))) > 0
    data, ckpt = str(tmp_path / "d.npz"), str(tmp_path / "v3.npz")
    v3_cli.main(["data", "--out", data, "--scenes", "1", "--frames", "3", "--stereo", "--device", "cpu"])
    with np.load(data) as d:
        assert len(d["pair_fi"]) >= 2 and d["kpts"].shape[1:] == (v3_cli.CAP, 2)
    v3_cli.main(["train", "--data", data, "--out", ckpt, "--steps", "1", "--chunk", "1", "--layers", "1",
                 "--batch", "2", "--balance-gaps", "--aug", "vo-hard", "--device", "cpu"])
    assert JG.checkpoint_meta(ckpt) == (1, HEADS) and JG.checkpoint_operating_point(ckpt)["capacity"] == 512
    assert "desc_center" in JG.load_weights(ckpt)
    stats = v3_cli.main(["eval", "--weights", ckpt, "--scenes", "1", "--frames", "2", "--device", "cpu"])
    assert stats["nn"][0] > 0 and stats["nn"][2] > 0
