"""Local-map tracking in the port against the JAX package on the CPU:
``ops/local_map.search_by_projection`` on the JAX package's cases and on
rows with no candidate and tied similarities, every local-map step of an
oracle run held against the JAX tracker's step on the same window, and the
engine with ``local_map_tracking.enabled``
(``tests/test_e2e_synthetic.py::test_local_map_tracking_mode``) beside the
JAX engine's keyframes on the same scene."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import make_camera, make_landmarks, make_trajectory
from ur_mvo_tpu import components as jcomp
from ur_mvo_tpu import config as jconfig
from ur_mvo_tpu.engine import UR_MVO as JaxEngine
from ur_mvo_tpu.ops.keypoints import FeatureBank as JaxBank
from ur_mvo_tpu.ops.local_map import search_by_projection as jax_search
from ur_mvo_tpu.runtime.extractor import OracleExtractor as JaxOracle
from ur_mvo_tpu_torch import components as tcomp
from ur_mvo_tpu_torch import config as tconfig
from ur_mvo_tpu_torch.camera import make_pinhole
from ur_mvo_tpu_torch.engine import UR_MVO
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank
from ur_mvo_tpu_torch.ops.local_map import search_by_projection
from ur_mvo_tpu_torch.runtime import frontend
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


FX = FY = 300.0
CX, CY = 160.0, 120.0
W, H = 320, 240
# the pose tests' limits (tests/test_torch_pose.py): the port's solver and
# the JAX package's differ in rounding
R_TOL, T_TOL = 2e-5, 2e-4


def _case(n_pts=40, cap=64, seed=0):
    """``tests/test_local_map.py::make_case``: map points at their own
    features' descriptors, projected at the identity pose."""
    rng = np.random.default_rng(seed)
    X = np.stack(
        [rng.uniform(-1.5, 1.5, n_pts), rng.uniform(-1.0, 1.0, n_pts), rng.uniform(3.0, 6.0, n_pts)], axis=1
    ).astype(np.float32)
    desc = rng.normal(size=(n_pts, 64)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    u = FX * X[:, 0] / X[:, 2] + CX
    v = FY * X[:, 1] / X[:, 2] + CY
    kpts = np.zeros((cap, 2), np.float32)
    bdesc = np.zeros((cap, 64), np.float32)
    valid = np.zeros(cap, bool)
    kpts[:n_pts] = np.stack([u, v], 1)
    bdesc[:n_pts] = desc
    valid[:n_pts] = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    mp_pos = np.zeros((cap, 3), np.float32)
    mp_desc = np.zeros((cap, 64), np.float32)
    mp_valid = np.zeros(cap, bool)
    mp_pos[:n_pts] = X
    mp_desc[:n_pts] = desc
    mp_valid[:n_pts] = True
    return dict(kpts=kpts, desc=bdesc, valid=valid, mp_pos=mp_pos, mp_desc=mp_desc, mp_valid=mp_valid)


def _ties_case():
    """Exact ties: descriptors of a few +-0.5 entries, whose dot products are
    exact in any summation order. Map point 0 sees features 1 and 2 at the
    same similarity (the first must win, and the ratio test then rejects
    it); map points 3 and 4 both pick feature 5 at one similarity (both keep
    it: neither beats the other); map point 6's only match is an invalid
    feature; map point 7 has no feature within the radius, and the unused
    map points are invalid: rows of -inf only."""
    c = _case(n_pts=0, cap=16)
    e = np.zeros((8, 64), np.float32)
    for i in range(8):
        e[i, 4 * i : 4 * i + 4] = 0.5  # unit rows, mutually orthogonal
    c["kpts"][:8] = np.array([[100.0, 100.0]] * 8, np.float32) + np.arange(8, dtype=np.float32)[:, None]
    c["valid"][:8] = True
    c["valid"][6] = False
    c["desc"][1] = e[0]
    c["desc"][2] = e[0]
    c["desc"][5] = e[3]
    c["desc"][6] = e[6]
    # map points project onto the cluster of features (identity pose, z = 4)
    pix = np.array([[103.0, 103.0]] * 7 + [[300.0, 200.0]], np.float32)
    c["mp_pos"][:8] = np.concatenate([(pix - [CX, CY]) / FX * 4.0, np.full((8, 1), 4.0)], 1)
    c["mp_desc"][:8] = np.stack([e[0], e[1], e[2], e[3], e[3], e[5], e[6], e[7]])
    c["mp_valid"][:8] = True
    return c


CASES = {
    "identity": (_case, np.eye(3), [0.0, 0.0, 0.0], 10.0),
    "radius_tight": (_case, np.eye(3), [0.5, 0.0, 0.0], 10.0),
    "radius_wide": (_case, np.eye(3), [0.5, 0.0, 0.0], 80.0),
    "behind_camera": (_case, np.eye(3), [0.0, 0.0, -10.0], 15.0),
    "ties_and_empty_rows": (_ties_case, np.eye(3), [0.0, 0.0, 0.0], 15.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_search_by_projection_matches_jax(name):
    """feat_idx and valid equal, similarity within 1e-5, and the JAX tests'
    own assertions on the port's result."""
    make, R, t, radius = CASES[name]
    c = make()
    R, t = np.asarray(R, np.float32), np.asarray(t, np.float32)
    T = torch.from_numpy
    tb = FeatureBank(scores=T(c["valid"].astype(np.float32)), kpts=T(c["kpts"]), desc=T(c["desc"]), valid=T(c["valid"]))
    jb = JaxBank(scores=jnp.asarray(c["valid"].astype(np.float32)), kpts=jnp.asarray(c["kpts"]),
                 desc=jnp.asarray(c["desc"]), valid=jnp.asarray(c["valid"]))
    mt = search_by_projection(T(R), T(t), T(c["mp_pos"]), T(c["mp_desc"]), T(c["mp_valid"]), tb,
                              FX, FY, CX, CY, W, H, radius_px=radius)
    mj = jax_search(jnp.asarray(R), jnp.asarray(t), jnp.asarray(c["mp_pos"]), jnp.asarray(c["mp_desc"]),
                    jnp.asarray(c["mp_valid"]), jb, FX, FY, CX, CY, W, H, radius_px=radius)
    np.testing.assert_array_equal(mt.feat_idx.numpy(), np.asarray(mj.feat_idx))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    np.testing.assert_allclose(mt.similarity.numpy(), np.asarray(mj.similarity), atol=1e-5)
    fi, mv = mt.feat_idx.numpy(), mt.valid.numpy()
    assert mt.feat_idx.dtype == torch.int32 and (fi[~mv] == -1).all()
    if name == "identity":
        idx = np.nonzero(mv)[0]
        assert mv.sum() >= 0.9 * c["valid"].sum()
        np.testing.assert_array_equal(fi[idx], idx)  # slot identity
        assert mt.similarity.numpy()[idx].min() > 0.99
    elif name == "radius_wide":
        assert mv.sum() > 0.5 * c["valid"].sum()
    elif name == "behind_camera":
        assert mv.sum() == 0
    elif name == "ties_and_empty_rows":
        # the tie at point 0 fails the ratio test (d_best == d_second);
        # points 3 and 4 both keep feature 5; 6 and 7 have no candidate
        np.testing.assert_array_equal(fi[:8], [-1, -1, -1, 5, 5, -1, -1, -1])


def test_radius_gate_widens_matches():
    """``tests/test_local_map.py::test_search_by_projection_radius_gate`` on
    the port: a pose error beyond the radius associates fewer points."""
    c = _case()
    T = torch.from_numpy
    tb = FeatureBank(scores=T(c["valid"].astype(np.float32)), kpts=T(c["kpts"]), desc=T(c["desc"]), valid=T(c["valid"]))
    args = (torch.eye(3), torch.tensor([0.5, 0.0, 0.0]), T(c["mp_pos"]), T(c["mp_desc"]), T(c["mp_valid"]), tb,
            FX, FY, CX, CY, W, H)
    tight = search_by_projection(*args, radius_px=10.0)
    wide = search_by_projection(*args, radius_px=80.0)
    assert int(tight.valid.sum()) < int(wide.valid.sum())


def _small(cfg):
    """``tests/test_e2e_synthetic.py::small_config`` with local-map tracking."""
    cfg.superpoint.capacity = 512
    cfg.superpoint.max_keypoints = 512
    cfg.backend.window_opt_frames = 8
    cfg.backend.window_fixed_frames = 6
    cfg.backend.ba_max_points = 512
    cfg.backend.ba_max_observations = 4096
    cfg.backend.ba_iterations_phase1 = 6
    cfg.backend.ba_iterations_phase2 = 3
    cfg.local_map_tracking.enabled = True
    return cfg


N_FRAMES = 35


def _scene():
    jcam = make_camera()
    T_wc, ts = make_trajectory(N_FRAMES, advance=0.05)
    return jcam, T_wc, ts, make_landmarks(400, along=2.0)


def _drive(vo, comp, T_wc, ts):
    for i in range(N_FRAMES):
        frame = comp.Frame(image=comp.Image(np.zeros((2, 2), np.uint8), ts[i]))
        frame.meta["T_wc"] = T_wc[i]
        vo.process(frame)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine on the same scene: its keyframe timestamps and
    positions, and its tracker, whose compiled local-map step then mirrors
    the port's steps (a second JAX tracker would compile it again)."""
    jcam, T_wc, ts, X = _scene()
    jvo = JaxEngine(_small(jconfig.Configs()), jconfig.SensorSetup.MONO, camera=jcam,
                    extractor=JaxOracle(X, jcam, capacity=512, noise_px=0.3, seed=9))
    _drive(jvo, jcomp, T_wc, ts)
    kts, kpos, _ = jvo.keyframe_trajectory()
    return dict(tracker=jvo.tracker, timestamps=kts, positions=kpos)


@pytest.fixture(scope="module")
def local_map_runs(jax_run):
    """``test_local_map_tracking_mode``'s scene through the port. Each of
    its local-map steps is also handed to the JAX engine's tracker (the JAX
    package's ``Tracker._track_local_map``, after that engine's own run) on
    the port's own store, window, bank and tracked pose; the step reads the
    store without writing it."""
    jcam, T_wc, ts, X = _scene()
    tcam = make_pinhole(jcam.width, jcam.height, jcam.fx, jcam.fy, jcam.cx, jcam.cy)
    tvo = UR_MVO(_small(tconfig.Configs()), tconfig.SensorSetup.MONO, camera=tcam,
                 extractor=OracleExtractor(X, tcam, capacity=512, noise_px=0.3, seed=9, device="cpu"), device="cpu")
    steps = _mirror_steps(tvo, jax_run["tracker"])
    _drive(tvo, tcomp, T_wc, ts)
    return dict(tvo=tvo, steps=steps, T_wc=T_wc, ts=ts)


def _mirror_steps(tvo, jtracker):
    """Wrap the port tracker's ``_track_local_map`` so that each call also
    runs the JAX tracker's step on the same inputs; returns the list of
    (port output, JAX output, inputs) it fills."""
    tt = tvo.tracker
    port_step = tt._track_local_map
    steps = []

    def both(bank, pose, frame_track, num_inliers):
        out = port_step(bank, pose, frame_track, num_inliers)
        jb = JaxBank(*(jnp.asarray(x.numpy()) for x in bank))
        jtracker.backend.store, jtracker._ref_slot = tt.backend.store, tt._ref_slot
        jout = jtracker._track_local_map(jb, pose.copy(), frame_track.copy(), num_inliers)
        steps.append((out, jout, (pose, frame_track, num_inliers)))
        return out

    tt._track_local_map = both
    return steps


def test_local_map_step_matches_jax(local_map_runs):
    """Every local-map step of the run: the port keeps or replaces the pose
    exactly when the JAX step does, the pose within the pose tests' limits,
    the inlier count within 2 and the extended track equal."""
    steps = local_map_runs["steps"]
    assert len(steps) >= 25
    grew = 0
    for (pose, track, n), (jpose, jtrack, jn), (pose0, track0, n0) in steps:
        assert (n > n0) == (jn > n0)
        assert abs(n - jn) <= 2
        np.testing.assert_allclose(pose[:3, :3], jpose[:3, :3], atol=R_TOL)
        np.testing.assert_allclose(pose[:3, 3], jpose[:3, 3], atol=T_TOL)
        np.testing.assert_array_equal(track, jtrack)
        if n > n0:
            grew += 1
            assert (track[track0 >= 0] == track0[track0 >= 0]).all()  # only fresh slots are written
    assert grew >= 3  # the step does add associations on this scene (4 of its steps)


def test_local_map_step_runs_one_round_on_the_bank(local_map_runs, monkeypatch):
    """The device step: pose GN seeded at the tracked pose, ONE round, over
    (capacity,) observations with mono rows; on the CPU the plain version."""
    tvo = local_map_runs["tvo"]
    seen = []
    real = frontend.optimize_pose

    def spy(R0, t0, obs, *args, **kw):
        seen.append((tuple(obs.X.shape), kw.get("rounds"), bool((obs.uv[:, 2] == -1).all())))
        return real(R0, t0, obs, *args, **kw)

    monkeypatch.setattr(frontend, "optimize_pose", spy)
    st = tvo.tracker.backend.store
    bank = tvo.extractor.extract_with_pose(local_map_runs["T_wc"][-1])
    pose = tvo.tracker.current_pose()
    track = np.full(512, -1, np.int32)
    tvo.tracker._track_local_map(bank, pose, track, 0)
    assert seen == [((512, 3), 1, True)]
    assert st.mp_desc is not None


def test_local_map_tracking_mode(local_map_runs, jax_run):
    """``tests/test_e2e_synthetic.py::test_local_map_tracking_mode`` on the
    port (ATE < 0.08), beside the JAX engine's run of the same scene: the
    same keyframes, positions within 1 cm of its after one similarity
    alignment."""
    tvo, T_wc, ts = (local_map_runs[k] for k in ("tvo", "T_wc", "ts"))
    assert tvo.tracker.initialized and tvo.tracker.frames_lost == 0
    kts, kpos, _ = tvo.keyframe_trajectory()
    gt = T_wc[np.clip(np.searchsorted(ts, kts), 0, N_FRAMES - 1), :3, 3]
    assert ate_rmse(kpos, gt, align=True, correct_scale=True) < 0.08
    np.testing.assert_allclose(kts, jax_run["timestamps"])
    assert ate_rmse(kpos, jax_run["positions"], align=True, correct_scale=True) < 0.01
    assert tvo.tracker.timer.summary()["local_map"]["count"] >= 25

