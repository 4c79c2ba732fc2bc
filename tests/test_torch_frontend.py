"""The PyTorch port's front end as a whole (``NeuralExtractor`` extract ->
match -> F-RANSAC) against the JAX package on the same rendered frames and
shipped weights, on the CPU; plus the port's own contracts: no JAX in the
package, explicit devices, copied configuration and renderer."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ur_mvo_tpu import config as jconfig
from ur_mvo_tpu.camera import make_pinhole as jax_pinhole
from ur_mvo_tpu.ops.matching import gather_match_points
from ur_mvo_tpu.ops.ransac import ransac_fundamental as jax_ransac
from ur_mvo_tpu.ops.ransac import sample_minimal_sets
from ur_mvo_tpu.runtime.extractor import NeuralExtractor as JaxExtractor
from ur_mvo_tpu.utils import synthscene as jscene
from ur_mvo_tpu_torch import config as tconfig
from ur_mvo_tpu_torch.camera import make_pinhole
from ur_mvo_tpu_torch.device import resolve_device
from ur_mvo_tpu_torch.ops.matching import gather_match_points as t_gather
from ur_mvo_tpu_torch.ops.ransac import ransac_fundamental
from ur_mvo_tpu_torch.runtime.extractor import NeuralExtractor
from ur_mvo_tpu_torch.utils import synthscene as tscene


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: PyTorch's
    intra-op thread pool costs several times what it gives there, most of
    all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP_V3 = os.path.join(REPO, "weights", "superpoint_scratch_v3.npz")
SG_CKPT = os.path.join(REPO, "weights", "superglue_v3scene.npz")
H, W, FX = 120, 160, 130.0


def _cfg(Configs):
    cfg = Configs()
    cfg.superpoint.weights_path = SP_V3
    cfg.superglue.weights_path = SG_CKPT
    cfg.superpoint.capacity = 512
    cfg.superpoint.max_keypoints = 500
    cfg.superpoint.keypoint_threshold = 1e-4
    cfg.superglue.image_width, cfg.superglue.image_height = W, H
    # the checkpoint's 0.8 leaves ~10 matches a pair on these small frames;
    # 0.2 gives ~100, enough for the RANSAC comparison
    cfg.superglue.matching_threshold = 0.2
    cfg.runtime.compute_dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def both():
    images, _, _ = tscene.render_sequence(3, H, W, FX, seed=0)
    jx = JaxExtractor(_cfg(jconfig.Configs), jax_pinhole(W, H, FX, FX, W / 2, H / 2))
    tx = NeuralExtractor(_cfg(tconfig.Configs), make_pinhole(W, H, FX, FX, W / 2, H / 2), device="cpu")
    jb = [jx.extract(im) for im in images]
    tb = [tx.extract(im) for im in images]
    return jx, tx, jb, tb


def test_extract_banks_match_jax(both):
    """Same valid counts, the same keypoint in the same slot in >= 99% of
    valid slots, scores and descriptors to 1e-4 (float32)."""
    _, _, jb, tb = both
    for a, b in zip(jb, tb):
        va, vb = np.asarray(a.valid), b.valid.numpy()
        assert va.sum() == vb.sum() > 100
        same = (np.asarray(a.kpts) == b.kpts.numpy()).all(-1) & va
        assert same.sum() / va.sum() >= 0.99
        np.testing.assert_allclose(b.desc.numpy()[same], np.asarray(a.desc)[same], atol=1e-4)
        np.testing.assert_allclose(b.scores.numpy()[same], np.asarray(a.scores)[same], atol=1e-4)


def test_match_and_ransac_match_jax(both):
    """``match(outlier_rejection=False)`` gives the same ``idx1`` in >= 99%
    of slots; F-RANSAC on the JAX sampler's sets gives the same model (1e-4
    after normalisation) and inliers in >= 99% of slots."""
    jx, tx, jb, tb = both
    for i in range(2):
        mj = jx.match(jb[i], jb[i + 1], outlier_rejection=False)
        mt = tx.match(tb[i], tb[i + 1], outlier_rejection=False)
        assert int(mt.num_valid()) > 40
        assert (mt.idx1.numpy() == np.asarray(mj.idx1)).mean() >= 0.99

        p0, p1, valid = gather_match_points(mj, jb[i].kpts, jb[i + 1].kpts)
        key = jax.random.PRNGKey(i)
        sets = np.array(sample_minimal_sets(key, valid, 200, 8))
        rj = jax.jit(jax_ransac)(key, p0, p1, valid)
        q0, q1, tvalid = t_gather(mt, tb[i].kpts, tb[i + 1].kpts)
        rt = ransac_fundamental(None, q0, q1, tvalid, sets=torch.from_numpy(sets))
        Fj, Ft = np.asarray(rj.model), rt.model.numpy()
        Fj, Ft = Fj / np.linalg.norm(Fj), Ft / np.linalg.norm(Ft)
        np.testing.assert_allclose(Ft * np.sign((Ft * Fj).sum()), Fj, atol=1e-4)
        assert (rt.inliers.numpy() == np.asarray(rj.inliers)).mean() >= 0.99


def test_match_with_outlier_rejection_keeps_a_subset(both):
    _, tx, _, tb = both
    tx.reset_state()
    raw = tx.match(tb[0], tb[1], outlier_rejection=False)
    kept = tx.match(tb[0], tb[1])
    assert 8 <= int(kept.num_valid()) <= int(raw.num_valid())
    assert bool((~kept.valid | raw.valid).all())
    assert torch.equal(kept.idx1[kept.valid], raw.idx1[kept.valid])
    # reset_state reproduces the RANSAC draws
    tx.reset_state()
    again = tx.match(tb[0], tb[1])
    assert torch.equal(again.valid, kept.valid)


def test_nn_floor_substitutes_mutual_nn(both):
    """A floor above what SuperGlue yields swaps in the mutual-NN matches."""
    _, tx, _, tb = both
    from ur_mvo_tpu_torch.ops.nn_matcher import match_nn

    sg_cfg = tx.cfg.superglue
    floored = tx.match(tb[0], tb[1], outlier_rejection=False, floor=10_000)
    nn = match_nn(tb[0], tb[1], sg_cfg.nn_min_similarity, sg_cfg.nn_ratio, center=sg_cfg.nn_center)
    assert torch.equal(floored.idx1, nn.idx1)


def test_main_operating_point_floors_on_cpu():
    """``chip_smoke.py``'s front-end floors on the plain CPU path: the
    validated mono operating point (240x320, capacity 1024, 1000 keypoints,
    threshold 1e-4, bf16, the shipped weights) on the same 8 rendered
    frames keeps >= 100 keypoints a frame and >= 60 F-RANSAC inliers a pair
    (the checkpoint's ``__meta_op_min_matches__``)."""
    cfg = tconfig.Configs()
    cfg.superpoint.weights_path, cfg.superglue.weights_path = SP_V3, SG_CKPT
    cfg.superpoint.capacity, cfg.superpoint.max_keypoints, cfg.superpoint.keypoint_threshold = 1024, 1000, 1e-4
    images, _, _ = tscene.render_sequence(8, 240, 320, 260.0, seed=0)
    ext = NeuralExtractor(cfg, make_pinhole(320, 240, 260.0, 260.0, 160.0, 120.0), device="cpu")
    banks = [ext.extract(im) for im in images]
    kpts = [int(b.num_valid()) for b in banks]
    inliers = [int(ext.match(banks[i], banks[i + 1]).num_valid()) for i in range(7)]
    print(f"keypoints {kpts} inliers {inliers}")
    assert min(kpts) >= 100 and min(inliers) >= 60


def test_port_imports_no_jax():
    """Every module of the port (walked, so a new one is covered), and
    ``chip_smoke.py`` as far as a machine without a card lets it import,
    pull in neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys, ur_mvo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ur_mvo_tpu_torch.__path__, 'ur_mvo_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "need = ['engine', 'components', 'runtime.frontend', 'runtime.backend', 'runtime.map_store', 'runtime.publisher',\n"
        "        'runtime.extractor', 'ops.lie', 'ops.pnp', 'ops.pose_opt', 'ops.cuda_pose', 'ops.epipolar',\n"
        "        'ops.triangulation', 'ops.ba', 'ops.ransac', 'ops.linalg', 'utils.timing', 'utils.metrics',\n"
        "        'utils.tum_io', 'weights']\n"
        "missing = [n for n in need if 'ur_mvo_tpu_torch.' + n not in names]\n"
        "assert not missing, missing\n"
        "from ur_mvo_tpu_torch.engine import UR_MVO\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'ur_mvo_tpu' "
        "or m.startswith('ur_mvo_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        lines = [ln.strip() for ln in f]
    imports = [ln for ln in lines if ln.startswith(("import ", "from "))]
    assert imports and not [ln for ln in imports if ln.split()[1].split(".")[0] in ("jax", "ur_mvo_tpu")]


def test_entry_points_default_to_cuda():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        from ur_mvo_tpu_torch.engine import UR_MVO

        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            NeuralExtractor(tconfig.Configs(), make_pinhole(W, H, FX, FX, W / 2, H / 2))
        with pytest.raises(RuntimeError, match="CUDA"):
            UR_MVO(tconfig.Configs(), camera=make_pinhole(W, H, FX, FX, W / 2, H / 2))


def test_config_copy_matches_jax_defaults():
    for name in ("SuperPointConfig", "SuperGlueConfig", "RuntimeConfig", "InitializerConfig", "BackendConfig"):
        assert dataclasses.asdict(getattr(tconfig, name)()) == dataclasses.asdict(getattr(jconfig, name)())


def test_renderer_copy_matches_jax():
    """The numpy Rodrigues differs from JAX's float32 ``so3_exp`` in the last
    bits: poses to 1e-6, images to one grey level in >= 99.9% of pixels."""
    np.testing.assert_allclose(tscene.default_trajectory(6), jscene.default_trajectory(6), atol=1e-6)
    ti, tT, _ = tscene.render_sequence(2, 60, 80, 65.0, seed=4)
    ji, jT, _ = jscene.render_sequence(2, 60, 80, 65.0, seed=4)
    diff = np.abs(ti.astype(int) - ji.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
