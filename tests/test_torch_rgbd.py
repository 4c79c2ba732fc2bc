"""The port's RGB-D setup and its ``hybrid`` matcher against the JAX package
on the CPU: the engine's depth lookup, single-frame RGB-D initialization,
``hybrid`` in both of its branches on the shipped weights, and the whole
RGB-D engine with the oracle extractor.

The same numpy inputs (one seed) go through both packages."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import make_landmarks, make_trajectory
from tests.test_torch_engine import _kf_ids, _small
from ur_mvo_tpu import camera as jcamera
from ur_mvo_tpu import components as jcomp
from ur_mvo_tpu import config as jconfig
from ur_mvo_tpu.engine import UR_MVO as JaxEngine
from ur_mvo_tpu.ops.keypoints import FeatureBank as JBank
from ur_mvo_tpu.runtime.extractor import NeuralExtractor as JaxExtractor
from ur_mvo_tpu.runtime.extractor import OracleExtractor as JaxOracle
from ur_mvo_tpu.runtime.frontend import Tracker as JaxTracker
from ur_mvo_tpu_torch import components as tcomp
from ur_mvo_tpu_torch import config as tconfig
from ur_mvo_tpu_torch.camera import make_pinhole
from ur_mvo_tpu_torch.engine import UR_MVO
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank, select_keypoints
from ur_mvo_tpu_torch.ops.nn_matcher import match_nn
from ur_mvo_tpu_torch.runtime.extractor import NeuralExtractor, OracleExtractor
from ur_mvo_tpu_torch.runtime.frontend import Tracker
from ur_mvo_tpu_torch.utils.metrics import ate_rmse
from ur_mvo_tpu_torch.utils.synthscene import render_sequence


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: one intra-op
    thread is several times faster there, most of all beside other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP_V3 = os.path.join(REPO, "weights", "superpoint_scratch_v3.npz")
SG_CKPT = os.path.join(REPO, "weights", "superglue_v3scene.npz")
W, H, F = 640, 512, 400.0
N_FRAMES = 30


def _cams():
    return jcamera.make_pinhole(W, H, F, F, W / 2, H / 2), make_pinhole(W, H, F, F, W / 2, H / 2)


def _oracles(X, jcam, tcam, seed):
    return (JaxOracle(X, jcam, capacity=512, noise_px=0.2, seed=seed),
            OracleExtractor(X, tcam, capacity=512, noise_px=0.2, seed=seed, device="cpu"))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_make_depth_lookup_matches_jax(dtype):
    """``UR_MVO._make_depth_lookup``: a uint8 image maps a pixel p in [50,
    200] to 100 / p and anything else to 0; a metric image passes through.
    Keypoints off the image clamp to its edge. Exact, on both kinds."""
    rng = np.random.default_rng(5)
    if dtype == "uint8":
        depth = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    else:
        depth = rng.uniform(0.0, 12.0, (48, 64)).astype(np.float32)
    kpts = np.stack([rng.uniform(-5, 70, 300), rng.uniform(-5, 55, 300)], 1).astype(np.float32)
    jcam, tcam = jcamera.make_pinhole(64, 48, 50.0, 50.0, 32.0, 24.0), make_pinhole(64, 48, 50.0, 50.0, 32.0, 24.0)
    oracle_t = OracleExtractor(np.zeros((4, 3), np.float32), tcam, capacity=16, device="cpu")
    jvo = JaxEngine(jconfig.Configs(), jconfig.SensorSetup.RGBD, camera=jcam,
                    extractor=JaxOracle(np.zeros((4, 3), np.float32), jcam, capacity=16))
    tvo = UR_MVO(tconfig.Configs(), tconfig.SensorSetup.RGBD, camera=tcam, extractor=oracle_t, device="cpu")
    image = np.zeros((48, 64), np.uint8)
    ref = jvo._make_depth_lookup(jcomp.Frame(image=jcomp.Image(image, 0.0), depth_map=jcomp.DepthMap(depth)))(kpts)
    ours = tvo._make_depth_lookup(tcomp.Frame(image=tcomp.Image(image, 0.0), depth_map=tcomp.DepthMap(depth)))(kpts)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    if dtype == "uint8":
        assert 0 < (ours == 0).sum() < len(ours) and np.all(ours[ours > 0] >= 0.5 - 1e-6)
    # mono frames and frames without a depth image have no lookup
    mono = UR_MVO(tconfig.Configs(), camera=tcam, extractor=oracle_t, device="cpu")
    assert mono._make_depth_lookup(tcomp.Frame(image=tcomp.Image(image, 0.0), depth_map=tcomp.DepthMap(depth))) is None
    assert tvo._make_depth_lookup(tcomp.Frame(image=tcomp.Image(image, 0.0))) is None


def _true_depth(X, T):
    return ((X - T[:3, 3]) @ T[:3, :3])[:, 2]


def test_init_rgbd_matches_jax():
    """One RGB-D frame through ``Tracker.process(bank, ts, depth_lookup)``
    initialises both packages (``_init_rgbd``): the same map points from the
    same features (depths outside the camera's band left out), at positions
    within 1e-5. A frame with too few features in the band does not."""
    jcam, tcam = _cams()
    T_wc, _ = make_trajectory(1)
    X = make_landmarks(400, along=2.0)
    jo, to = _oracles(X, jcam, tcam, seed=5)
    depth = np.zeros(512, np.float32)
    depth[:400] = _true_depth(X, T_wc[0])
    depth[:40] = 0.0  # unknown
    depth[40:60] = 20.0  # beyond depth_upper_thr
    jt = JaxTracker(_small(jconfig.Configs()), jcam, jo)
    tt = Tracker(_small(tconfig.Configs()), tcam, to, device="cpu")
    far = lambda k: np.full(len(k), 20.0, np.float32)  # noqa: E731
    bank_j, bank_t = jo.extract_with_pose(T_wc[0]), to.extract_with_pose(T_wc[0])
    assert jt.process(bank_j, 0.0, far) is None and tt.process(bank_t, 0.0, far) is None
    assert not tt.initialized
    jt.process(bank_j, 0.0, lambda k: depth)
    tt.process(bank_t, 0.0, lambda k: depth)
    assert jt.initialized and tt.initialized
    js, ts = jt.backend.store, tt.backend.store
    jgood, tgood = js.mp_good & ~js.mp_bad, ts.mp_good & ~ts.mp_bad
    assert 250 < tgood.sum() == jgood.sum()
    track = ts.kf_track[ts.frame_id_to_slot[1]]
    np.testing.assert_array_equal(track, js.kf_track[js.frame_id_to_slot[1]])
    assert (track[:60] < 0).all()
    np.testing.assert_allclose(ts.mp_pos[tgood], js.mp_pos[jgood], rtol=0, atol=1e-5)
    # the first keyframe is the world frame (oracle slot i is landmark i)
    slots = np.nonzero(track >= 0)[0]
    np.testing.assert_allclose(ts.mp_pos[track[slots]], ((X - T_wc[0, :3, 3]) @ T_wc[0, :3, :3])[slots], atol=0.05)


@pytest.fixture(scope="module")
def hybrid_pair():
    """Both packages' ``NeuralExtractor`` under ``hybrid`` with the shipped
    weights (float32), and SuperPoint banks of two rendered 120x160 frames
    at 200 and at 60 keypoints (capacity 256; the port's SuperPoint and
    selection, the same numpy banks for both packages)."""
    cfgs = []
    for cfg in (jconfig.Configs(), tconfig.Configs()):
        cfg.superpoint.weights_path, cfg.superglue.weights_path = SP_V3, SG_CKPT
        cfg.superglue.matcher = "hybrid"
        cfg.superglue.image_width, cfg.superglue.image_height = 160, 120
        cfg.superpoint.capacity = 256
        cfg.runtime.compute_dtype = "float32"
        cfgs.append(cfg)
    cam = (160, 120, 130.0, 130.0, 80.0, 60.0)
    exts = (JaxExtractor(cfgs[0], jcamera.make_pinhole(*cam)),
            NeuralExtractor(cfgs[1], make_pinhole(*cam), device="cpu"))
    images, _, _ = render_sequence(2, 120, 160, 130.0, seed=11)
    with torch.no_grad():
        heads = [exts[1].superpoint(torch.from_numpy(im.astype(np.float32) / 255.0)[None, :, :, None], nms_radius=4)
                 for im in images]
    banks = {max_kp: [tuple(np.asarray(a) for a in select_keypoints(s[0], d[0], capacity=256, threshold=1e-4,
                                                                     max_keypoints=max_kp))
                      for s, d in heads] for max_kp in (200, 60)}
    return banks, exts


def _torch_bank(bank):
    return FeatureBank(*(torch.from_numpy(a) for a in bank))


@pytest.mark.parametrize("max_kp,branch", [(200, "nn"), (60, "superglue")], ids=["nn_wins", "nn_starves"])
def test_hybrid_matches_jax(hybrid_pair, max_kp, branch):
    """``hybrid`` (outlier rejection off, so that the two RANSAC samplers do
    not enter): mutual-NN is primary and stands with >= 40 matches (200
    keypoints), where the port's output is NN's exactly and the JAX
    package's ``idx1`` too; with fewer (60 keypoints) SuperGlue's matches
    replace it, and ``idx1`` agrees with the JAX package's in >= 99% of
    slots, the agreement of the SuperGlue parity test
    (``test_torch_superglue.py``)."""
    banks, (jext, text) = hybrid_pair
    cfg = text.cfg.superglue
    jb = [JBank(*(jnp.asarray(a) for a in b)) for b in banks[max_kp]]
    tb = [_torch_bank(b) for b in banks[max_kp]]
    nn = match_nn(*tb, cfg.nn_min_similarity, cfg.nn_ratio, center=cfg.nn_center)
    n_nn = int(nn.num_valid())
    assert (n_nn >= 40) == (branch == "nn"), n_nn
    ref = jext.match(*jb, False)
    ours = text.match(*tb, False)
    if branch == "nn":
        np.testing.assert_array_equal(ours.idx1.numpy(), nn.idx1.numpy())
        np.testing.assert_array_equal(ours.idx1.numpy(), np.asarray(ref.idx1))
    else:
        assert int(ours.num_valid()) > 20 and not torch.equal(ours.idx1, nn.idx1)
        assert (ours.idx1.numpy() == np.asarray(ref.idx1)).mean() >= 0.99
        # (floor or 40): a floor of 0 does not turn the rescue off
        assert torch.equal(text.match(*tb, False, floor=0).idx1, ours.idx1)


def _drive(vo, Frame, Image, DepthMap, cam, X, T_wc, ts):
    """Feed the frames with float depth images: each landmark's true depth
    splatted at its projected pixel."""
    emitted = []
    for i in range(len(ts)):
        pc = (X - T_wc[i, :3, 3]) @ T_wc[i, :3, :3]
        u = (cam.fx * pc[:, 0] / pc[:, 2] + cam.cx).round().astype(int)
        v = (cam.fy * pc[:, 1] / pc[:, 2] + cam.cy).round().astype(int)
        depth = np.zeros((H, W), np.float32)
        ok = (pc[:, 2] > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        depth[v[ok], u[ok]] = pc[ok, 2]
        frame = Frame(image=Image(np.zeros((H, W), np.uint8), ts[i]), depth_map=DepthMap(depth))
        frame.meta["T_wc"] = T_wc[i]
        out = vo.process(frame)
        if out is not None:
            emitted.append((i, out))
    return emitted


def test_rgbd_engine_with_oracle_matches_jax():
    """``UR_MVO(setup=RGBD)`` with the oracle and float depth images against
    the JAX engine on the same draws: the same keyframes, the same emitted
    frames, no frame lost, trajectories within 0.02 m of each other without
    scale correction, and metric scale against the truth."""
    jcam, tcam = _cams()
    T_wc, ts = make_trajectory(N_FRAMES, advance=0.05)
    X = make_landmarks(400, along=N_FRAMES * 0.05)
    jo, to = _oracles(X, jcam, tcam, seed=21)
    jvo = JaxEngine(_small(jconfig.Configs()), jconfig.SensorSetup.RGBD, camera=jcam, extractor=jo)
    tvo = UR_MVO(_small(tconfig.Configs()), tconfig.SensorSetup.RGBD, camera=tcam, extractor=to, device="cpu")
    jem = _drive(jvo, jcomp.Frame, jcomp.Image, jcomp.DepthMap, jcam, X, T_wc, ts)
    tem = _drive(tvo, tcomp.Frame, tcomp.Image, tcomp.DepthMap, tcam, X, T_wc, ts)
    assert tvo.tracker.initialized and tvo.tracker.frames_lost == 0
    assert _kf_ids(tvo) == _kf_ids(jvo) and len(_kf_ids(tvo)) >= 3
    assert [i for i, _ in tem] == [i for i, _ in jem]
    assert [len(o) for _, o in tem] == [len(o) for _, o in jem]
    _, jpos, _ = jvo.keyframe_trajectory()
    kts, tpos, _ = tvo.keyframe_trajectory()
    assert ate_rmse(tpos, jpos, align=True, correct_scale=False) < 0.02
    gt = T_wc[np.clip(np.searchsorted(ts, kts), 0, N_FRAMES - 1), :3, 3]
    assert ate_rmse(tpos, gt, align=True, correct_scale=False) < 0.05


@pytest.mark.parametrize("setup", ["MONO", "STEREO", "RGBD"])
def test_rgbd_sums_the_point_side_as_jax_does(setup):
    """The RGB-D and stereo engines' BAs (keyframe window, loop and
    relocalization refinement, and the full BA, which takes the window's)
    round the point side's summands to bf16 as the JAX package's window
    route does (``test_torch_ba.py`` holds the terms to it; the stereo
    engine's window on a captured problem: ``test_torch_lockstep.py``); the
    monocular engine's sum exact float32 summands (ROADMAP C7)."""
    _, tcam = _cams()
    oracle = OracleExtractor(np.zeros((4, 3), np.float32), tcam, capacity=16, device="cpu")
    backend = UR_MVO(tconfig.Configs(), tconfig.SensorSetup[setup], camera=tcam, extractor=oracle,
                     device="cpu").tracker.backend
    assert backend._ba_cfg.bf16_point_side == backend._refine_cfg.bf16_point_side == (setup != "MONO")
