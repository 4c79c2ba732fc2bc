"""Map snapshots, ``Tracker.adopt_map`` and the map-reuse protocols of
``tests/test_map_reuse.py`` in the port, against the JAX package on the
CPU: a snapshot either package writes loads in the other field by field,
both packages rebuild the same reference bank from it, and both protocols
(localization into the early corridor, resume where the map ends) hold the
JAX tests' assertions through the port's ``UR_MVO`` with keyframe poses
beside the JAX engine's on the same scenes."""

import numpy as np
import pytest
import torch

from tests.synthetic import make_camera, make_trajectory
from tests.test_relocalization import corridor_landmarks
from ur_mvo_tpu import components as jcomp
from ur_mvo_tpu import config as jconfig
from ur_mvo_tpu.engine import UR_MVO as JaxEngine
from ur_mvo_tpu.runtime.extractor import OracleExtractor as JaxOracle
from ur_mvo_tpu.runtime.frontend import Tracker as JaxTracker
from ur_mvo_tpu.runtime.map_store import MapStore as JaxStore
from ur_mvo_tpu_torch import components as tcomp
from ur_mvo_tpu_torch import config as tconfig
from ur_mvo_tpu_torch.camera import make_pinhole
from ur_mvo_tpu_torch.engine import UR_MVO
from ur_mvo_tpu_torch.runtime.extractor import OracleExtractor
from ur_mvo_tpu_torch.runtime.map_store import MapStore
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


N_A = 20


def _config(Configs):
    """``tests/test_map_reuse.py::_config``."""
    cfg = Configs()
    cfg.superpoint.capacity = 1024
    cfg.superpoint.max_keypoints = 1024
    cfg.backend.window_opt_frames = 8
    cfg.backend.window_fixed_frames = 6
    cfg.backend.ba_max_points = 2048
    cfg.backend.ba_max_observations = 8192
    return cfg


def _protocol(name):
    """(landmarks, session A's frames, session B's frames, ground truth by
    timestamp) of one protocol of ``tests/test_map_reuse.py``: ``localize``
    starts session B in the EARLY corridor, away from the newest keyframe;
    ``resume`` continues where session A stopped."""
    if name == "localize":
        T_a, _ = make_trajectory(N_A, advance=0.3)
        X = corridor_landmarks(900, -4.0, 10.0)
        seq_b = [((N_A + 2 + k) / 30.0, T_a[i]) for k, i in enumerate(range(3, 10))]
    else:
        T_a, _ = make_trajectory(N_A + 8, advance=0.3)
        X = corridor_landmarks(1000, -4.0, 14.0)
        seq_b = [((N_A + k) / 30.0, T_a[i]) for k, i in enumerate(range(N_A, N_A + 8))]
    seq_a = [(i / 30.0, T_a[i]) for i in range(N_A)]
    gt = {round(ts, 6): T[:3, 3] for ts, T in seq_a + seq_b}
    return X, seq_a, seq_b, gt


def _feed(vo, comp, frames):
    for ts, T in frames:
        f = comp.Frame(image=comp.Image(np.zeros((vo.camera.height, vo.camera.width), np.uint8), ts))
        f.meta["T_wc"] = T
        vo.process(f)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """Both protocols through the port, each session a fresh engine as a
    user runs them: session A maps and saves a snapshot; session B loads it
    into a new engine with a new oracle noise stream and runs on."""
    tmp = tmp_path_factory.mktemp("maps")
    jcam = make_camera()
    tcam = make_pinhole(jcam.width, jcam.height, jcam.fx, jcam.fy, jcam.cx, jcam.cy)
    out = {}
    for name in ("localize", "resume"):
        X, seq_a, seq_b, gt = _protocol(name)
        r = {"gt": gt}
        vo_a = UR_MVO(_config(tconfig.Configs), tconfig.SensorSetup.MONO, camera=tcam,
                      extractor=OracleExtractor(X, tcam, capacity=1024, noise_px=0.2, seed=3, device="cpu"), device="cpu")
        _feed(vo_a, tcomp, seq_a)
        r["path"] = str(tmp / f"{name}.npz")
        vo_a.save_map_snapshot(r["path"])
        r["port_a"] = vo_a
        vo_b = UR_MVO(_config(tconfig.Configs), tconfig.SensorSetup.MONO, camera=tcam,
                      extractor=OracleExtractor(X, tcam, capacity=1024, noise_px=0.2, seed=9, device="cpu"), device="cpu")
        vo_b.load_map_snapshot(r["path"])
        r["port_b_initialized_on_load"] = vo_b.tracker.initialized
        _feed(vo_b, tcomp, seq_b)
        r["port_b"] = vo_b
        out[name] = r
    return out


@pytest.fixture(scope="module")
def jax_sessions(tmp_path_factory):
    """Both protocols through the JAX package as ``tests/test_map_reuse.py``
    runs them: session A's keyframe count, session B's lost count and
    keyframe timestamps and positions. Every session runs in ONE JAX engine
    after a state reset (``UR_MVO.reset`` with the same config keeps the
    compiled programs and re-seeds every stream), with the session's oracle
    swapped in and relocalization back at its default (session B's
    ``load_map_snapshot`` turns it on): the same keyframes, to the bit, as a
    fresh engine a session, whose programs would each compile anew (~45 s on
    the CPU)."""
    tmp = tmp_path_factory.mktemp("jax_maps")
    jcam = make_camera()
    vo, out = None, {}

    def session(X, seed):
        nonlocal vo
        oracle = JaxOracle(X, jcam, capacity=1024, noise_px=0.2, seed=seed)
        if vo is None:
            vo = JaxEngine(_config(jconfig.Configs), jconfig.SensorSetup.MONO, camera=jcam, extractor=oracle)
        else:
            vo.reset()
            vo.extractor = vo.tracker.extractor = oracle
            vo.config.backend.relocalization = False
        return vo

    for name in ("localize", "resume"):
        X, seq_a, seq_b, _ = _protocol(name)
        vo_a = session(X, 3)
        _feed(vo_a, jcomp, seq_a)
        path = str(tmp / f"{name}.npz")
        vo_a.save_map_snapshot(path)
        keyframes_a = vo_a.tracker.backend.store.num_keyframes()
        vo_b = session(X, 9)
        vo_b.load_map_snapshot(path)
        _feed(vo_b, jcomp, seq_b)
        kts, kpos, _ = vo_b.keyframe_trajectory()
        out[name] = {"keyframes_a": keyframes_a, "lost_count_b": vo_b.tracker._lost_count,
                     "timestamps": kts, "positions": kpos}
    return out


def _kf_ate(kts, kpos, gt):
    gt_pos = np.stack([gt[round(t, 6)] for t in kts])
    return ate_rmse(kpos, gt_pos, align=True, correct_scale=True)


def test_localization_mode_into_saved_map(sessions, jax_sessions):
    """``tests/test_map_reuse.py::test_localization_mode_into_saved_map`` on
    the port, and its keyframes beside the JAX engine's."""
    r = sessions["localize"]
    vo_a, vo_b = r["port_a"], r["port_b"]
    assert vo_a.tracker.initialized and r["port_b_initialized_on_load"]
    n_kf_a = vo_a.tracker.backend.store.num_keyframes()
    st = vo_b.tracker.backend.store
    assert st.num_keyframes() > n_kf_a, "session B never localized/keyframed"
    kts, kpos, _ = vo_b.keyframe_trajectory()
    assert _kf_ate(kts, kpos, r["gt"]) < 0.1
    slots = st.keyframe_slots()
    order = slots[np.argsort(st.kf_frame_id[slots])]
    assert st.covis[order[n_kf_a:]][:, order[:n_kf_a]].max() >= 15
    _beside_jax(jax_sessions["localize"], n_kf_a, kts, kpos)


def test_resume_tracks_reconstructed_reference_bank(sessions, jax_sessions):
    """``tests/test_map_reuse.py::test_resume_tracks_reconstructed_reference_bank``
    on the port (tracks on against the rebuilt reference bank: no loss, no
    relocalization), and its keyframes beside the JAX engine's."""
    r = sessions["resume"]
    vo_a, vo_b = r["port_a"], r["port_b"]
    n_kf_a = vo_a.tracker.backend.store.num_keyframes()
    assert r["port_b_initialized_on_load"]
    assert vo_b.tracker.backend.store.num_keyframes() > n_kf_a
    assert vo_b.tracker._lost_count == 0 and vo_b.tracker.relocalizations == 0
    assert jax_sessions["resume"]["lost_count_b"] == 0
    kts, kpos, _ = vo_b.keyframe_trajectory()
    assert _kf_ate(kts, kpos, r["gt"]) < 0.1
    _beside_jax(jax_sessions["resume"], n_kf_a, kts, kpos)


def _beside_jax(ref, n_kf_a, kts, kpos):
    """Both sessions' keyframes beside the JAX engine's: the same count in
    session A, the same frames in session B, and positions within 2 cm
    after one similarity alignment and 5 cm before it (one world frame:
    session A's first keyframe)."""
    assert n_kf_a == ref["keyframes_a"]
    np.testing.assert_allclose(kts, ref["timestamps"])
    assert ate_rmse(kpos, ref["positions"], align=True, correct_scale=True) < 0.02
    assert np.abs(kpos - ref["positions"]).max() < 0.05


def _stores_equal(a, b):
    for f in MapStore._SNAPSHOT_FIELDS + ("mp_desc", "kf_gdesc"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), f
    for f in ("kf_desc", "kf_scores"):
        x, y = getattr(a, f), getattr(b, f)
        assert sorted(x) == sorted(y) and all(np.array_equal(x[k], y[k]) and x[k].dtype == y[k].dtype for k in x), f
    assert (a._next_kf, a._next_mp, a._free_kf, a._free_mp) == (b._next_kf, b._next_mp, b._free_kf, b._free_mp)
    assert a.frame_id_to_slot == b.frame_id_to_slot
    assert len(a.loop_edges) == len(b.loop_edges)
    for e, g in zip(a.loop_edges, b.loop_edges):
        assert e[:2] == g[:2] and np.array_equal(e[2], g[2]) and np.array_equal(e[3], g[3]) and e[4:] == g[4:]


def test_snapshots_interchange_with_jax(sessions, tmp_path):
    """The port's map after session A (with a loop edge and freed slots
    added): port-written -> JAX load equals it field by field, JAX-written
    -> port load likewise; an older snapshot without ``kf_snap_*`` rebuilds
    them as the JAX package does."""
    st = sessions["resume"]["port_a"].tracker.backend.store
    s = st.keyframe_slots()
    st.loop_edges.append((int(s[0]), int(s[-1]), np.eye(3, dtype=np.float32), np.arange(3, dtype=np.float32), 2.0, 0.75))
    st._free_mp.extend([5, 7])
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    st.save_snapshot(port_path)
    in_jax = JaxStore.load_snapshot(port_path, st.cfg)
    _stores_equal(in_jax, st)
    in_jax.save_snapshot(jax_path)
    back = MapStore.load_snapshot(jax_path, st.cfg)
    _stores_equal(back, st)
    assert back.mp_desc.dtype == np.float16 and back.loop_edges[0][5] == 0.75

    with np.load(port_path) as f:
        older = {k: f[k] for k in f.files if not k.startswith("kf_snap_")}
    old_path = str(tmp_path / "older.npz")
    np.savez(old_path, **older)
    tb, jb = MapStore.load_snapshot(old_path, st.cfg), JaxStore.load_snapshot(old_path, st.cfg)
    for f in ("kf_snap_pos", "kf_snap_ok", "kf_snap_R", "kf_snap_t"):
        assert np.array_equal(getattr(tb, f), getattr(jb, f)), f
    with pytest.raises(ValueError, match="missing field"):
        np.savez(old_path, **{k: v for k, v in older.items() if k != "covis"})
        MapStore.load_snapshot(old_path, st.cfg)


def test_adopt_map_matches_jax(sessions):
    """``load_map_snapshot`` of the port-written ``resume`` map against the
    JAX tracker's ``adopt_map`` on the same file: the same reference bank
    (float16 banks widened, unit rows valid, persisted scores), reference
    slot and frame, last pose, frame counter past the stored ids,
    relocalization forced on and pre-armed."""
    path = sessions["resume"]["path"]
    jcam = make_camera()
    cam = make_pinhole(jcam.width, jcam.height, jcam.fx, jcam.fy, jcam.cx, jcam.cy)
    vo = UR_MVO(_config(tconfig.Configs), tconfig.SensorSetup.MONO, camera=cam,
                extractor=OracleExtractor(np.zeros((4, 3), np.float32), cam, capacity=1024, device="cpu"), device="cpu")
    assert not vo.config.backend.relocalization
    vo.load_map_snapshot(path)
    jcfg = _config(jconfig.Configs)
    j = JaxTracker(jcfg, jcam, JaxOracle(np.zeros((4, 3), np.float32), jcam, capacity=1024))
    j.backend.store = JaxStore.load_snapshot(path, j.backend.store.cfg)
    j.adopt_map()
    t = vo.tracker
    assert t.initialized and vo.config.backend.relocalization
    for a, b in zip(t._ref_bank, j._ref_bank):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 100 < int(t._ref_bank.valid.sum()) < 1024
    assert (t._ref_slot, t._ref_frame_id, t._frame_counter, t._lost_count) == (
        j._ref_slot, j._ref_frame_id, j._frame_counter, j._lost_count)
    assert t._frame_counter == N_A and t._lost_count == vo.config.backend.reloc_after_failures - 1
    np.testing.assert_array_equal(t._last_pose, j._last_pose)
    np.testing.assert_array_equal(t._last_keyframe_pose, j._last_keyframe_pose)
    assert vo.last_pose is None and vo._trajectory == []


def test_adopt_map_refuses_an_empty_map():
    cam = make_pinhole(64, 48, 50.0, 50.0, 32.0, 24.0)
    vo = UR_MVO(tconfig.Configs(), tconfig.SensorSetup.MONO, camera=cam,
                extractor=OracleExtractor(np.zeros((4, 3), np.float32), cam, capacity=16, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="no keyframes"):
        vo.tracker.adopt_map()


def test_save_map_ply_writes_the_good_points(sessions, tmp_path):
    vo = sessions["localize"]["port_b"]
    st = vo.tracker.backend.store
    path = str(tmp_path / "map.ply")
    vo.save_map_ply(path)
    with open(path) as f:
        lines = f.read().splitlines()
    good = st.mp_pos[st.mp_good & ~st.mp_bad]
    assert lines[2] == f"element vertex {len(good)}" and len(good) > 100
    body = np.array([[float(x) for x in ln.split()] for ln in lines[lines.index("end_header") + 1:]])
    np.testing.assert_allclose(body, good, atol=1e-5)

