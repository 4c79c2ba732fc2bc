"""Relocalization: the port's engine against the JAX engine on the oracle
corridor of ``tests/test_relocalization.py`` (CPU, both packages).

The camera tracks a corridor for 20 frames, is blacked out for three
(teleported out of the scene), and re-enters at an early, fully disjoint
part of the corridor. Both engines must re-anchor into the existing map
within ``reloc_after_failures`` (3) frames of re-entry and insert the same
keyframes; their keyframe trajectories agree within the 0.02 ATE that
``tests/test_torch_engine.py`` holds the two engines to (different RANSAC
samplers, same oracle draws), and each is within the JAX test's 0.1 of the
truth.
"""

import numpy as np
import pytest
import torch

from tests.synthetic import make_camera, make_trajectory
from tests.test_relocalization import corridor_landmarks
from ur_mvo_tpu import components as jcomp
from ur_mvo_tpu import config as jconfig
from ur_mvo_tpu.engine import UR_MVO as JaxEngine
from ur_mvo_tpu.runtime.extractor import OracleExtractor as JaxOracle
from ur_mvo_tpu_torch import components as tcomp
from ur_mvo_tpu_torch import config as tconfig
from ur_mvo_tpu_torch.camera import make_pinhole
from ur_mvo_tpu_torch.engine import UR_MVO
from ur_mvo_tpu_torch.runtime.extractor import OracleExtractor
from ur_mvo_tpu_torch.utils.metrics import ate_rmse


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: PyTorch's
    intra-op thread pool costs several times what it gives there, most of
    all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_A = 20  # frames before the blackout
RE_ENTRY = N_A + 3  # first frame back in the scene


def _cfg(config):
    cfg = config.Configs()
    cfg.superpoint.capacity = 1024
    cfg.superpoint.max_keypoints = 1024
    cfg.backend.window_opt_frames = 8
    cfg.backend.window_fixed_frames = 6
    cfg.backend.ba_max_points = 2048
    cfg.backend.ba_max_observations = 8192
    cfg.backend.relocalization = True
    cfg.backend.reloc_after_failures = 3
    return cfg


def _sequence():
    T_a, _ = make_trajectory(N_A, advance=0.3)
    far = np.eye(4)
    far[:3, 3] = [1000.0, 0.0, 0.0]
    poses = list(T_a) + [far] * 3 + [T_a[i] for i in range(3, 10)]
    return [(k / 30.0, T) for k, T in enumerate(poses)]


def _drive(vo, comp, cam, seq):
    for ts, T in seq:
        frame = comp.Frame(image=comp.Image(np.zeros((cam.height, cam.width), np.uint8), ts))
        frame.meta["T_wc"] = T
        vo.process(frame)
    st = vo.tracker.backend.store
    kts, kpos, _ = vo.keyframe_trajectory()
    return sorted(st.kf_frame_id[st.keyframe_slots()].tolist()), np.asarray(kts), np.asarray(kpos)


@pytest.fixture(scope="module")
def corridor():
    jcam = make_camera()
    tcam = make_pinhole(jcam.width, jcam.height, jcam.fx, jcam.fy, jcam.cx, jcam.cy)
    X = corridor_landmarks(900, -4.0, 10.0)
    seq = _sequence()
    jvo = JaxEngine(_cfg(jconfig), jconfig.SensorSetup.MONO, camera=jcam,
                    extractor=JaxOracle(X, jcam, capacity=1024, noise_px=0.2, seed=3))
    tvo = UR_MVO(_cfg(tconfig), tconfig.SensorSetup.MONO, camera=tcam,
                 extractor=OracleExtractor(X, tcam, capacity=1024, noise_px=0.2, seed=3, device="cpu"), device="cpu")
    gt = {round(ts, 6): T[:3, 3] for ts, T in seq}
    out = {}
    for name, vo, comp, cam in (("jax", jvo, jcomp, jcam), ("torch", tvo, tcomp, tcam)):
        ids, kts, kpos = _drive(vo, comp, cam, seq)
        out[name] = dict(vo=vo, ids=ids, kpos=kpos, gt=np.stack([gt[round(t, 6)] for t in kts]))
    return out


def test_relocalization_reanchors_as_the_jax_engine_does(corridor):
    j, t = corridor["jax"], corridor["torch"]
    assert t["ids"] == j["ids"]
    post = [f for f in t["ids"] if f >= RE_ENTRY]
    assert len(post) >= 2, t["ids"]
    # re-anchored within reloc_after_failures frames of re-entry
    assert post[0] <= RE_ENTRY + 3, post
    tracker = t["vo"].tracker
    assert tracker.relocalizations >= 1 and tracker.timer.summary()["relocalize"]["count"] >= 1
    # the blackout frames and the re-entry frames before the attempt are
    # lost; the relocalized frame counts as tracked
    assert 3 <= tracker.frames_lost <= 3 + 3
    # one world frame: the first post-loss keyframe shares the map
    st = tracker.backend.store
    slots = st.keyframe_slots()
    order = slots[np.argsort(st.kf_frame_id[slots])]
    first_post = t["ids"].index(post[0])
    assert st.covis[order[first_post]][order[:first_post]].max() >= 15


def test_relocalized_trajectory_matches_jax(corridor):
    j, t = corridor["jax"], corridor["torch"]
    assert ate_rmse(t["kpos"], j["kpos"], align=True, correct_scale=True) < 0.02
    for side in (j, t):
        assert ate_rmse(side["kpos"], side["gt"], align=True, correct_scale=True) < 0.1
