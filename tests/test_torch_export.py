"""The port's frame-step export (``models/export.py``) and its
data-parallel train step (``parallel/train_step.py``) on the CPU.

The eager frame step is held against the JAX package's ``build_frame_step``
(jitted once) on the same image pair and random weights (SuperPoint at full
width, SuperGlue with 2 layers, capacity 64, 64x80): keypoints equal, and
``idx1`` equal on >= 95% of the slots (the frame-step parity tests'
agreement, ``chip_smoke.py`` phase 5), matched slots' scores within 1e-4.
The exported program (``torch.export``, saved, reloaded) is held to the
eager step by ``verify_roundtrip``'s ``assert_allclose(rtol=1e-3,
atol=1e-5)``. The data-parallel step at world 1 (``one_rank_mesh``) is the
single-process step bit for bit; world 2 is in ``tests/test_torch_parallel.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_mesh_util import one_rank_mesh
from ur_mvo_tpu.models import export as JE
from ur_mvo_tpu.models import superglue as JG
from ur_mvo_tpu.models import superpoint as JS
from ur_mvo_tpu_torch.models import export as TE
from ur_mvo_tpu_torch.models import train_superpoint as TT
from ur_mvo_tpu_torch.models.superpoint import SuperPoint
from ur_mvo_tpu_torch.parallel.train_step import make_dp_train_step
from ur_mvo_tpu_torch.weights import superglue_from_numpy, superpoint_from_numpy

H, W = 64, 80
KW = dict(capacity=64, max_keypoints=50, sinkhorn_iterations=20, match_threshold=0.2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is many small eager ops: one intra-op thread is
    faster beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights():
    """JAX ``init_params`` (SuperPoint key 0; SuperGlue key 1, 2 layers) as
    the port's state dicts."""
    sp = jax.tree.map(np.asarray, JS.init_params(jax.random.PRNGKey(0)))
    sg = jax.tree.map(np.asarray, JG.init_params(jax.random.PRNGKey(1), num_layers=2))
    return sp, sg, superpoint_from_numpy(sp), superglue_from_numpy(sg)


def _pair():
    """Two views of one texture, 3 px apart."""
    rng = np.random.default_rng(0)
    tex = np.kron(rng.random((H // 4 + 1, W // 4 + 2)), np.ones((4, 4))).astype(np.float32)
    return tex[:H, :W].copy(), tex[1:H + 1, 3:W + 3].copy()


def test_eager_frame_step_matches_jax():
    """``FrameStep`` against the JAX frame step (one ``jax.jit``) on the
    same pair: kpts of both images equal, ``idx1`` equal on >= 95% of the
    slots with matches on both sides, matched scores within 1e-4."""
    sp_np, sg_np, sp, sg = _weights()
    a, b = _pair()
    ref = jax.jit(JE.build_frame_step(sp_np, sg_np, H, W, **KW))(jnp.asarray(a), jnp.asarray(b))
    ref = [np.asarray(r) for r in ref]
    with torch.no_grad():
        got = [t.numpy() for t in TE.build_frame_step(sp, sg, H, W, device="cpu", **KW)(torch.from_numpy(a),
                                                                                          torch.from_numpy(b))]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert (ref[2] >= 0).sum() >= 10 and (got[2] >= 0).sum() >= 10
    assert (got[2] == ref[2]).mean() >= 0.95
    both = (got[2] >= 0) & (ref[2] >= 0)
    np.testing.assert_allclose(got[3][both], ref[3][both], atol=1e-4)


def test_export_save_load_roundtrip(tmp_path):
    """``export_frame_step`` -> ``load_frame_step`` -> ``verify_roundtrip``
    within ``rtol=1e-3, atol=1e-5``; the program holds the stage op's nodes
    (three an image), and the reloaded program reproduces the eager step on
    a second pair."""
    _, _, sp, sg = _weights()
    path = str(tmp_path / "frame_step.pt2")
    exported = TE.export_frame_step(path, sp, sg, H, W, device="cpu", **KW)
    ops = [n for n in exported.graph.nodes if n.op == "call_function" and "stage_conv" in str(n.target)]
    assert len(ops) == 6
    assert TE.verify_roundtrip(path, sp, sg, H, W, device="cpu", **KW) <= 1e-5
    a, b = _pair()
    with torch.no_grad():
        want = TE.build_frame_step(sp, sg, H, W, device="cpu", **KW)(torch.from_numpy(b), torch.from_numpy(a))
        got = TE.load_frame_step(path)(torch.from_numpy(b), torch.from_numpy(a))
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_dp_train_step_world1_is_the_single_step(tmp_path):
    """``make_dp_train_step`` on a world of this process alone: the loss and
    every parameter after one step bit for bit equal to
    ``make_train_step``'s on the same batch."""
    _, _, sp, _ = _weights()
    g = torch.Generator().manual_seed(5)
    batch = TT.make_batch(g, torch.rand((2, H, W), generator=g))
    models = []
    for _ in range(2):
        m = SuperPoint()
        m.load_state_dict(sp)
        models.append(m)
    single = TT.make_train_step(TT.make_optimizer(models[0]))(models[0], batch)
    with one_rank_mesh(tmp_path) as mesh:
        dp = make_dp_train_step(TT.make_optimizer(models[1]), mesh)(models[1], batch)
    assert torch.equal(single, dp)
    for (k, x), y in zip(models[0].state_dict().items(), models[1].state_dict().values()):
        assert torch.equal(x, y), k
