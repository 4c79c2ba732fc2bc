"""The port's stereo setup against the JAX package on the CPU: the rendered
right images, the left-right disparity gate, single-frame stereo
initialization and the whole stereo engine with the oracle extractor.

The same numpy inputs (one seed) go through both packages. The oracle
matches by slot identity, so both sides see the same correspondences; their
PnP samplers differ, so poses agree to a tolerance, not to the bit."""

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
from ur_mvo_tpu.ops.matching import Matches as JMatches
from ur_mvo_tpu.runtime.extractor import OracleExtractor as JaxOracle
from ur_mvo_tpu.runtime.frontend import Tracker as JaxTracker
from ur_mvo_tpu.utils import synthscene as jscene
from ur_mvo_tpu_torch import components as tcomp
from ur_mvo_tpu_torch import config as tconfig
from ur_mvo_tpu_torch.camera import make_pinhole
from ur_mvo_tpu_torch.engine import UR_MVO
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank
from ur_mvo_tpu_torch.ops.matching import Matches
from ur_mvo_tpu_torch.runtime.extractor import NeuralExtractor, OracleExtractor
from ur_mvo_tpu_torch.runtime.frontend import Tracker
from ur_mvo_tpu_torch.utils import synthscene as tscene
from ur_mvo_tpu_torch.utils.metrics import ate_rmse


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: one intra-op
    thread is several times faster there, most of all beside other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H, F = 640, 512, 400.0
BF = F * 0.12  # a 12 cm baseline
N_FRAMES = 30


def _cams():
    return (jcamera.make_pinhole(W, H, F, F, W / 2, H / 2, bf=BF),
            make_pinhole(W, H, F, F, W / 2, H / 2, bf=BF))


@pytest.mark.parametrize("baseline", [0.0, 0.12])
def test_render_sequence_matches_jax(baseline):
    """On the same camera poses the port's renderer gives the JAX package's
    arrays byte for byte: without a baseline (left images and depth) and
    with one (also the right images and their depth). The default
    trajectories agree to 1e-6 (the port's Rodrigues is numpy float64)."""
    poses, _ = make_trajectory(2, advance=0.1)
    kw = dict(seed=4, n_planes=3, z_background=6.0, baseline=baseline, with_right_depth=True, poses=poses)
    ours = tscene.render_sequence(2, 60, 80, 65.0, **kw)
    ref = jscene.render_sequence(2, 60, 80, 65.0, **kw)
    np.testing.assert_allclose(tscene.default_trajectory(5), jscene.default_trajectory(5), rtol=0, atol=1e-6)
    assert len(ours) == len(ref) == (5 if baseline else 3)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_right_image_takes_the_right_cameras_map():
    """``NeuralExtractor.extract(image, right=True)`` rectifies with the
    camera's ``undistort_map_right`` (here a 2.5 px shift), exactly as the
    left path does with the same map as its own; without a right map it
    falls back to the left one. Random weights, 48x64, on the CPU."""
    rng = np.random.default_rng(2)
    image = rng.integers(0, 255, (48, 64), dtype=np.uint8)
    ys, xs = np.mgrid[0:48, 0:64].astype(np.float32)
    shifted = np.stack([xs + 2.5, ys], -1)
    cfg = tconfig.Configs()
    cfg.superpoint.capacity, cfg.superpoint.max_keypoints = 64, 64
    cfg.superglue.num_layers = 2

    def extractor(left_map, right_map):
        cam = make_pinhole(64, 48, 50.0, 50.0, 32.0, 24.0)
        cam.undistort_map, cam.undistort_map_right = left_map, right_map
        return NeuralExtractor(cfg, cam, device="cpu")

    right = extractor(None, shifted).extract(image, right=True)
    ref = extractor(shifted, None).extract(image)
    plain = extractor(None, None)
    for a, b in zip(right, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(right.kpts, plain.extract(image).kpts)
    for a, b in zip(plain.extract(image, right=True), plain.extract(image)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class _FixedMatch:
    """An extractor whose ``match`` returns one fixed left-right match (in
    the package it stands in for), so that the gate alone is compared."""

    def __init__(self, m):
        self.m = m

    def match(self, bank0, bank1, outlier_rejection=True, floor=None):
        return self.m


@pytest.mark.parametrize("seed", [0, 1])
def test_stereo_uvr_matches_jax(seed):
    """``Tracker._stereo_uvr`` on the same left and right banks and the same
    left-right match (a permutation, some slots unmatched): disparities span
    both edges of the band bf/depth_upper_thr < dx < bf/depth_lower_thr and
    rows both sides of |dy| <= max_y_diff. The same features pass the gate,
    exactly, and their right x agree within 1e-6."""
    rng = np.random.default_rng(seed)
    K = 256
    kpts = np.stack([rng.uniform(0, W, K), rng.uniform(0, H, K)], 1).astype(np.float32)
    valid = rng.random(K) < 0.9
    perm = rng.permutation(K)
    mvalid = valid & (rng.random(K) < 0.85)
    idx1 = np.where(mvalid, perm, -1).astype(np.int32)
    right = np.zeros((K, 2), np.float32)
    disparity = rng.uniform(-5.0, 250.0, K).astype(np.float32)
    dy = rng.uniform(-4.0, 4.0, K).astype(np.float32)
    right[perm] = np.stack([kpts[:, 0] - disparity, kpts[:, 1] + dy], 1)
    desc = np.zeros((K, 256), np.float32)
    scores = valid.astype(np.float32)

    jcam, tcam = _cams()
    tcam.depth_lower_thr = jcam.depth_lower_thr = 0.25  # bf / 0.25 = 192 px inside the disparities drawn
    cfg_t, cfg_j = _small(tconfig.Configs()), _small(jconfig.Configs())
    for c in (cfg_t, cfg_j):
        c.superpoint.capacity = K
    jm = JMatches(idx1=idx1, score=mvalid.astype(np.float32), valid=mvalid)
    tm = Matches(idx1=torch.from_numpy(idx1), score=torch.from_numpy(mvalid.astype(np.float32)),
                 valid=torch.from_numpy(mvalid))
    jt = JaxTracker(cfg_j, jcam, _FixedMatch(jm))
    tt = Tracker(cfg_t, tcam, _FixedMatch(tm), device="cpu")
    jbanks = [JBank(scores=scores, kpts=k, desc=desc, valid=valid) for k in (kpts, right)]
    tbanks = [FeatureBank(*map(torch.from_numpy, (scores, k, desc, valid))) for k in (kpts, right)]
    ref = jt._stereo_uvr(*jbanks)
    ours = tt._stereo_uvr(*tbanks)
    gated = ref[:, 2] > 0
    assert 40 < gated.sum() < mvalid.sum() - 40  # the gates cut on both sides
    np.testing.assert_array_equal(ours[:, 2] > 0, gated)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def _oracles(X, jcam, tcam, seed):
    return (JaxOracle(X, jcam, capacity=512, noise_px=0.2, seed=seed),
            OracleExtractor(X, tcam, capacity=512, noise_px=0.2, seed=seed, device="cpu"))


def test_init_stereo_matches_jax():
    """One stereo frame through ``Tracker.process(bank, ts, bank_right=...)``
    initialises both packages (``_init_stereo``): the same map points, from
    the same features, at positions within 1e-5."""
    jcam, tcam = _cams()
    T_wc, _ = make_trajectory(1)
    X = make_landmarks(400, along=2.0)
    jo, to = _oracles(X, jcam, tcam, seed=3)
    jt = JaxTracker(_small(jconfig.Configs()), jcam, jo)
    tt = Tracker(_small(tconfig.Configs()), tcam, to, device="cpu")
    jt.process(jo.extract_with_pose(T_wc[0]), 0.0, bank_right=jo.extract_with_pose(T_wc[0], right=True))
    tt.process(to.extract_with_pose(T_wc[0]), 0.0, bank_right=to.extract_with_pose(T_wc[0], right=True))
    assert jt.initialized and tt.initialized
    js, ts = jt.backend.store, tt.backend.store
    jgood, tgood = js.mp_good & ~js.mp_bad, ts.mp_good & ~ts.mp_bad
    assert 150 < tgood.sum() == jgood.sum()
    np.testing.assert_array_equal(ts.kf_track[ts.frame_id_to_slot[0]], js.kf_track[js.frame_id_to_slot[0]])
    np.testing.assert_allclose(ts.mp_pos[tgood], js.mp_pos[jgood], rtol=0, atol=1e-5)
    # seeded from disparity at the true metric depth (oracle slot i is landmark i)
    track = ts.kf_track[ts.frame_id_to_slot[0]]
    slots = np.nonzero(track >= 0)[0]
    true_z = ((X - T_wc[0, :3, 3]) @ T_wc[0, :3, :3])[slots, 2]
    assert np.median(np.abs(ts.mp_pos[track[slots], 2] / true_z - 1.0)) < 0.05


def _drive(vo, Frame, Image, T_wc, ts):
    emitted = []
    for i in range(len(ts)):
        frame = Frame(image=Image(np.zeros((H, W), np.uint8), ts[i]))
        frame.meta["T_wc"] = T_wc[i]
        out = vo.process(frame)
        if out is not None:
            emitted.append((i, out))
    return emitted


def test_stereo_engine_with_oracle_matches_jax():
    """``UR_MVO(setup=STEREO)`` with the oracle (left and right banks from
    each frame's true pose) against the JAX engine on the same draws: the
    same keyframes, the same emitted frames, no frame lost, trajectories
    within 0.02 m of each other without scale correction, and metric scale
    against the truth."""
    jcam, tcam = _cams()
    T_wc, ts = make_trajectory(N_FRAMES, advance=0.05)
    X = make_landmarks(400, along=N_FRAMES * 0.05)
    jo, to = _oracles(X, jcam, tcam, seed=3)
    jvo = JaxEngine(_small(jconfig.Configs()), jconfig.SensorSetup.STEREO, camera=jcam, extractor=jo)
    tvo = UR_MVO(_small(tconfig.Configs()), tconfig.SensorSetup.STEREO, camera=tcam, extractor=to, device="cpu")
    jem = _drive(jvo, jcomp.Frame, jcomp.Image, T_wc, ts)
    tem = _drive(tvo, tcomp.Frame, tcomp.Image, T_wc, ts)
    assert tvo.tracker.initialized and tvo.tracker.frames_lost == 0
    assert _kf_ids(tvo) == _kf_ids(jvo) and len(_kf_ids(tvo)) >= 3
    assert [i for i, _ in tem] == [i for i, _ in jem]
    assert [len(o) for _, o in tem] == [len(o) for _, o in jem]
    _, jpos, _ = jvo.keyframe_trajectory()
    kts, tpos, _ = tvo.keyframe_trajectory()
    assert ate_rmse(tpos, jpos, align=True, correct_scale=False) < 0.02
    gt = T_wc[np.clip(np.searchsorted(ts, kts), 0, N_FRAMES - 1), :3, 3]
    assert ate_rmse(tpos, gt, align=True, correct_scale=False) < 0.05
