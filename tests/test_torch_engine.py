"""The slice as a whole on the CPU: the port's ``UR_MVO`` against the JAX
engine with the oracle extractor, one short neural run with the shipped
weights, and what the slice leaves out.
"""

import os

import numpy as np
import pytest
import torch

from tests.synthetic import make_camera, make_landmarks, make_trajectory
from ur_mvo_tpu import components as jcomp
from ur_mvo_tpu import config as jconfig
from ur_mvo_tpu.engine import UR_MVO as JaxEngine
from ur_mvo_tpu.runtime.extractor import OracleExtractor as JaxOracle
from ur_mvo_tpu_torch import components as tcomp
from ur_mvo_tpu_torch import config as tconfig
from ur_mvo_tpu_torch.camera import make_pinhole
from ur_mvo_tpu_torch.engine import UR_MVO
from ur_mvo_tpu_torch.models.superglue import checkpoint_operating_point
from ur_mvo_tpu_torch.runtime.backend import Backend
from ur_mvo_tpu_torch.runtime.extractor import OracleExtractor
from ur_mvo_tpu_torch.runtime.frontend import Tracker
from ur_mvo_tpu_torch.utils import synthscene
from ur_mvo_tpu_torch.utils.metrics import ate_rmse
from ur_mvo_tpu_torch.utils.tum_io import read_tum


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
N_FRAMES = 40


def _small(cfg):
    """``tests/test_e2e_synthetic.py::small_config``."""
    cfg.superpoint.capacity = 512
    cfg.superpoint.max_keypoints = 512
    cfg.backend.window_opt_frames = 8
    cfg.backend.window_fixed_frames = 6
    cfg.backend.ba_max_points = 512
    cfg.backend.ba_max_observations = 4096
    cfg.backend.ba_iterations_phase1 = 6
    cfg.backend.ba_iterations_phase2 = 3
    return cfg


def _drive(vo, Frame, Image, cam, T_wc, ts):
    emitted = []
    for i in range(len(ts)):
        frame = Frame(image=Image(np.zeros((cam.height, cam.width), np.uint8), ts[i]))
        frame.meta["T_wc"] = T_wc[i]
        out = vo.process(frame)
        if out is not None:
            emitted.append((i, out))
    return emitted


@pytest.fixture(scope="module")
def oracle_runs():
    jcam = make_camera()
    tcam = make_pinhole(jcam.width, jcam.height, jcam.fx, jcam.fy, jcam.cx, jcam.cy)
    T_wc, ts = make_trajectory(N_FRAMES, advance=0.05)
    X = make_landmarks(400, along=N_FRAMES * 0.05)
    jvo = JaxEngine(_small(jconfig.Configs()), jconfig.SensorSetup.MONO, camera=jcam,
                    extractor=JaxOracle(X, jcam, capacity=512, noise_px=0.2, seed=3))
    tvo = UR_MVO(_small(tconfig.Configs()), tconfig.SensorSetup.MONO, camera=tcam,
                 extractor=OracleExtractor(X, tcam, capacity=512, noise_px=0.2, seed=3, device="cpu"), device="cpu")
    jem = _drive(jvo, jcomp.Frame, jcomp.Image, jcam, T_wc, ts)
    tem = _drive(tvo, tcomp.Frame, tcomp.Image, tcam, T_wc, ts)
    return dict(jvo=jvo, tvo=tvo, jem=jem, tem=tem, T_wc=T_wc, ts=ts)


def _kf_ids(vo):
    st = vo.tracker.backend.store
    return sorted(st.kf_frame_id[st.keyframe_slots()].tolist())


def test_engine_with_oracle_tracks_the_sequence(oracle_runs):
    vo, T_wc, ts = oracle_runs["tvo"], oracle_runs["T_wc"], oracle_runs["ts"]
    assert vo.tracker.initialized
    assert vo.tracker.frames_lost == 0
    assert len(oracle_runs["tem"]) >= 4
    kts, kpos, kquat = vo.keyframe_trajectory()
    assert len(kpos) >= 4 and kquat.shape == (len(kpos), 4)
    gt = T_wc[np.clip(np.searchsorted(ts, kts), 0, N_FRAMES - 1), :3, 3]
    ate = ate_rmse(kpos, gt, align=True, correct_scale=True)
    assert ate < 0.05, ate
    st = vo.tracker.backend.store
    good = st.mp_good & ~st.mp_bad
    # mono init fixes the median landmark depth at the 4.0 convention
    assert abs(np.median(st.mp_pos[good][:, 2]) - 4.0) < 0.8
    # the map keeps triangulating as points gather observers
    assert int((st.mp_obs_count >= 3).sum()) > 100


def test_engine_with_oracle_matches_jax_engine(oracle_runs):
    """Same oracle draws (numpy, one seed) on both sides, different RANSAC
    samplers. The keyframe policy reads poses that agree to millimetres, so
    both engines insert the same keyframes; the trajectories agree to well
    under the ATE either has against the truth."""
    jvo, tvo = oracle_runs["jvo"], oracle_runs["tvo"]
    assert _kf_ids(tvo) == _kf_ids(jvo)
    assert [i for i, _ in oracle_runs["tem"]] == [i for i, _ in oracle_runs["jem"]]
    _, jpos, _ = jvo.keyframe_trajectory()
    _, tpos, _ = tvo.keyframe_trajectory()
    assert ate_rmse(tpos, jpos, align=True, correct_scale=True) < 0.02
    # emissions fill the frames since the last keyframe, ending at it
    for (_, jout), (_, tout) in zip(oracle_runs["jem"], oracle_runs["tem"]):
        assert len(jout) == len(tout)


def test_engine_reset_reproduces_the_run(oracle_runs):
    vo = oracle_runs["tvo"]
    _, before, _ = vo.keyframe_trajectory()
    vo.reset()
    assert not vo.tracker.initialized and vo.tracker.backend.store.num_keyframes() == 0
    cam = vo.camera
    _drive(vo, tcomp.Frame, tcomp.Image, cam, oracle_runs["T_wc"], oracle_runs["ts"])
    _, after, _ = vo.keyframe_trajectory()
    np.testing.assert_allclose(after, before, atol=1e-5)


def test_async_ba_lands_one_keyframe_later(oracle_runs, tmp_path):
    """``backend.ba_async``: the BA result stays on the device and is
    written back at the next keyframe (or on a flush); the trajectory
    stays within centimetres of the synchronous run."""
    cfg = _small(tconfig.Configs())
    cfg.backend.ba_async = True
    cam = oracle_runs["tvo"].camera
    X = make_landmarks(400, along=N_FRAMES * 0.05)
    vo = UR_MVO(cfg, tconfig.SensorSetup.MONO, camera=cam,
                extractor=OracleExtractor(X, cam, capacity=512, noise_px=0.2, seed=3, device="cpu"), device="cpu")
    _drive(vo, tcomp.Frame, tcomp.Image, cam, oracle_runs["T_wc"], oracle_runs["ts"])
    assert vo.tracker.backend._pending_ba is not None
    assert isinstance(vo.tracker.backend._pending_ba[0], torch.Tensor)
    path = str(tmp_path / "kf.txt")
    vo.save_trajectory(path)  # flushes
    assert vo.tracker.backend._pending_ba is None
    ts, pos, quat = read_tum(path)
    _, sync_pos, _ = oracle_runs["tvo"].keyframe_trajectory()
    assert len(pos) == len(sync_pos)
    assert ate_rmse(pos, sync_pos, align=True, correct_scale=True) < 0.03
    vo.shutdown()


def _production_cfg():
    """The production mono configuration (``scripts/bench_accuracy.py``,
    matcher ``sg``) with relocalization off."""
    cfg = tconfig.Configs()
    sg_path = os.path.join(REPO, "weights", "superglue_v3scene.npz")
    cfg.superpoint.weights_path = os.path.join(REPO, "weights", "superpoint_scratch_v3.npz")
    cfg.superglue.weights_path = sg_path
    op = checkpoint_operating_point(sg_path) or {}
    cfg.superpoint.capacity = op.get("capacity", 1024)
    cfg.superpoint.max_keypoints = op.get("max_keypoints", 1000)
    cfg.superpoint.keypoint_threshold = op.get("keypoint_threshold", 1e-4)
    cfg.initializer.min_matches = op.get("min_matches", 60)
    cfg.initializer.min_features_first = op.get("min_features_first", 100)
    cfg.superglue.nn_fallback_min_matches_init = 40
    return cfg


def test_neural_engine_initialises_and_tracks_on_cpu():
    """The fused path (one packed readback a frame) through
    ``UR_MVO(device="cpu")`` with the shipped weights at the full 240x320
    operating point, cut to 7 frames; the keyframe policy's frame budget is
    cut to 3 so that a tracked keyframe (with its BA) falls inside them."""
    H, W, FX = 240, 320, 260.0
    cfg = _production_cfg()
    cfg.keyframe.max_num_passed_frame = 3
    images, T_wc, _ = synthscene.render_sequence(7, H, W, FX, seed=0, n_planes=3, z_background=6.0)
    vo = UR_MVO(cfg, tconfig.SensorSetup.MONO, camera=make_pinhole(W, H, FX, FX, W / 2, H / 2), device="cpu")
    assert vo.tracker._fused
    frames = [tcomp.Frame(image=tcomp.Image(images[i], i / 30.0)) for i in range(len(images))]
    outs = vo.process_sequence(frames)
    assert vo.tracker.initialized
    assert vo.tracker.frames_lost == 0
    st = vo.tracker.backend.store
    assert st.num_keyframes() >= 3  # two init keyframes and a tracked one
    poses = [p for out in outs if out for p in out]
    assert poses and all(np.isfinite(p.matrix()).all() for p in poses)
    summary = vo.tracker.timer.summary()
    assert summary["track"]["count"] >= 3 and summary["keyframe_ba"]["count"] >= 1 and "match" in summary
    kts, kpos, _ = vo.keyframe_trajectory()
    gt = T_wc[np.clip((kts * 30.0).round().astype(int), 0, len(images) - 1), :3, 3]
    assert np.isfinite(kpos).all() and ate_rmse(kpos, gt, align=True, correct_scale=True) < 0.15


def _cam():
    return make_pinhole(64, 48, 50.0, 50.0, 32.0, 24.0)


def test_what_the_slice_leaves_out_raises():
    cam = _cam()
    oracle = OracleExtractor(np.zeros((4, 3), np.float32), cam, capacity=16, device="cpu")
    for setup in (tconfig.SensorSetup.STEREO, tconfig.SensorSetup.RGBD):
        with pytest.raises(NotImplementedError, match="monocular"):
            UR_MVO(tconfig.Configs(), setup, camera=cam, extractor=oracle, device="cpu")
    cfg = tconfig.Configs()
    cfg.local_map_tracking.enabled = True
    with pytest.raises(NotImplementedError, match="not ported"):
        UR_MVO(cfg, tconfig.SensorSetup.MONO, camera=cam, extractor=oracle, device="cpu")
    cfg = tconfig.Configs()
    cfg.superpoint.capacity = 16
    vo = UR_MVO(cfg, tconfig.SensorSetup.MONO, camera=cam, extractor=oracle, device="cpu")
    bank = oracle.extract_with_pose(np.eye(4, dtype=np.float32))
    with pytest.raises(NotImplementedError, match="stereo"):
        vo.tracker.process(bank, 0.0, bank_right=bank)
    with pytest.raises(NotImplementedError, match="RGB-D"):
        vo.tracker.process(bank, 0.0, depth_lookup=lambda k: k[:, 0])
    with pytest.raises(NotImplementedError, match="precomputed"):
        vo.tracker.process(bank, 0.0, precomputed_match=object())
    with pytest.raises(NotImplementedError):
        vo.tracker.process_chunk([], [])
    with pytest.raises(NotImplementedError):
        vo.tracker.adopt_map()
    frame = tcomp.Frame(image=tcomp.Image(np.zeros((48, 64), np.uint8), 0.0), depth_map=tcomp.DepthMap(np.zeros((48, 64))))
    with pytest.raises(NotImplementedError, match="RGB-D"):
        vo.process(frame)
    assert not hasattr(vo.tracker.backend.store, "save_snapshot")


def test_engine_tracker_backend_default_to_cuda():
    cam = _cam()
    cfg = tconfig.Configs()
    if torch.cuda.is_available():
        assert Backend(cam, cfg.backend, cfg.backend_optimization).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        UR_MVO(cfg, tconfig.SensorSetup.MONO, camera=cam)
    with pytest.raises(RuntimeError, match="CUDA"):
        Backend(cam, cfg.backend, cfg.backend_optimization)
    with pytest.raises(RuntimeError, match="CUDA"):
        Tracker(cfg, cam, extractor=object())
    with pytest.raises(RuntimeError, match="CUDA"):
        OracleExtractor(np.zeros((4, 3), np.float32), cam, capacity=16)
    # a tracker follows its extractor's device when none is named
    oracle = OracleExtractor(np.zeros((4, 3), np.float32), cam, capacity=16, device="cpu")
    assert Tracker(cfg, cam, extractor=oracle).device.type == "cpu"


def test_process_directory_reads_a_euroc_layout(tmp_path):
    """``process_directory`` on ``cam0/data`` with 19-digit ns stems and
    ``.npy`` frames, through the neural extractor at a toy size with
    random weights (no pose is expected from it, only that every frame is
    read, stamped and fed, the next one prefetched)."""
    data = tmp_path / "seq" / "cam0" / "data"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        np.save(data / f"{1_000_000_000_000_000_000 + i * 33_000_000}.npy", rng.integers(0, 255, (48, 64), dtype=np.uint8))
    cfg = tconfig.Configs()
    cfg.superpoint.capacity, cfg.superpoint.max_keypoints = 64, 64
    cfg.superglue.num_layers = 2
    vo = UR_MVO(cfg, camera=_cam(), device="cpu")
    seen = []
    process = vo.tracker.process
    vo.tracker.process = lambda bank, ts, *a, **k: (seen.append(ts), process(bank, ts, *a, **k))[1]
    assert vo.process_directory(str(tmp_path / "seq")) == []
    np.testing.assert_allclose(seen, [1e9, 1e9 + 0.033, 1e9 + 0.066], atol=1e-6)
    with pytest.raises(FileNotFoundError):
        vo.process_directory(str(tmp_path / "nothing"))
