"""The lock-step harness (``tests/jax_lockstep.py``): its draw replay (the
port's sampler, fed through the replay, hands the port exactly the minimal
sets that the JAX package's ``sample_minimal_sets`` drew, with no engine
compiled) and its transplant classes; and the window BAs that the harness
captured where the two engines part on identical inputs (``--save-ba``,
``tests/data/lockstep_ba_*.npz``: the JAX engine's packed problem and
result).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import jax_lockstep
from ur_mvo_tpu.ops import ransac as jransac
from ur_mvo_tpu_torch.ops import pnp as tpnp
from ur_mvo_tpu_torch.ops import ransac as transac

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draw(key, valid, num_sets, set_size):
    return np.asarray(jax.jit(jransac.sample_minimal_sets, static_argnums=(2, 3))(key, valid, num_sets, set_size))


@pytest.mark.parametrize("num_sets,set_size", [(100, 6), (200, 8)])
def test_replay_hands_the_port_the_jax_minimal_sets(num_sets, set_size):
    rng = np.random.default_rng(7)
    valid = rng.random(256) < 0.4
    key = jax.random.PRNGKey(1234)
    want = _jax_draw(key, valid, num_sets, set_size)
    draws = jax_lockstep.Draws(jransac.sample_minimal_sets)
    draws.record_draw(key, valid, want)
    draws.arm()
    # through the port's module global, as its RANSACs and PnP call it
    patches = jax_lockstep.Patches()
    patches.set(transac, "sample_minimal_sets", draws.port_sample)
    patches.set(tpnp, "sample_minimal_sets", draws.port_sample)
    try:
        got = transac.sample_minimal_sets(torch.Generator(), torch.from_numpy(valid), num_sets, set_size)
    finally:
        patches.undo()
    assert transac.sample_minimal_sets is not draws.port_sample and tpnp.sample_minimal_sets is transac.sample_minimal_sets
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert valid[want].all()
    assert (draws.paired, draws.on_other_masks, draws.unpaired, draws.leftover()) == (1, 0, 0, 0)


def test_replay_stops_on_sets_that_are_not_the_jax_calls_and_flags_other_masks():
    rng = np.random.default_rng(8)
    valid = rng.random(128) < 0.5
    key = jax.random.PRNGKey(99)
    want = _jax_draw(key, valid, 100, 6)
    draws = jax_lockstep.Draws(jransac.sample_minimal_sets)
    tampered = want.copy()
    tampered[0, 0] = np.flatnonzero(valid & ~np.isin(np.arange(128), want[0]))[0]
    draws.record_draw(key, valid, tampered)
    draws.arm()
    with pytest.raises(jax_lockstep.DrawMismatch):
        draws.port_sample(None, torch.from_numpy(valid), 100, 6)
    # on another mask the port gets the same key's draw over its own mask
    other = valid.copy()
    other[np.flatnonzero(valid)[:5]] = False
    draws.record_draw(key, valid, want)
    draws.arm()
    draws.queue = draws.queue[-1:]
    got = draws.port_sample(None, torch.from_numpy(other), 100, 6).numpy()
    assert np.array_equal(got, _jax_draw(key, other, 100, 6)) and other[got].all()
    assert draws.on_other_masks == 1
    # a call no JAX call mirrors (another shape) is drawn from the spare key
    draws.arm()
    draws.queue = draws.queue[-1:]
    spare = draws.port_sample(None, torch.from_numpy(valid), 200, 8).numpy()
    assert spare.shape == (200, 8) and valid[spare].all() and draws.unpaired == 1 and draws.leftover() == 1


def _ba_stage(as_run_t, like_t, spread_t=1e-5):
    gap = lambda t: {"R": t / 10, "t": t, "X": t, "inlier_agreement": 1.0}  # noqa: E731
    return [{"as_run": gap(as_run_t), "bf16_summands": gap(like_t), "port_one_ulp_spread": gap(spread_t)}]


def _track_stage(within):
    return {"within": within, "gap": {"n": 1, "R": 0.0, "t": 0.0}, "spreads": {"port": {"n": 1, "R": 0.0, "t": 0.0}}}


@pytest.mark.parametrize("diff,stages,first_ok,later_ok,final_ok,want", [
    # identical step
    (set(), {}, True, True, True, ([], [])),
    # a first track that the two fused cores on identical inputs reproduce within their spreads
    ({"pnp_inliers"}, {"track": _track_stage(True)}, False, True, True, ([], ["track"])),
    ({"inliers"}, {"track": _track_stage(True)}, False, True, True, ([], ["track"])),
    # the first track differs and the cores do not account for it
    ({"inliers"}, {"track": _track_stage(False)}, False, True, True, (["track"], [])),
    # a window BA that differs only by the point-side summands' rounding choice
    ({"map_points"}, {"ba": _ba_stage(0.2, 1e-8)}, True, True, False, (["window BA point-side summands (C7)"], [])),
    # the track after a promotion follows that keyframe's BA
    (set(), {"track": _track_stage(True), "ba": _ba_stage(0.02, 1e-8)}, True, False, False,
     (["window BA point-side summands (C7)"], [])),
    # a window BA within its own one-ulp spread
    (set(), {"ba": _ba_stage(0.02, 0.02, spread_t=0.05)}, True, True, False, ([], ["window BA"])),
    # ... or within the JAX package's
    (set(), {"ba": [dict(_ba_stage(0.02, 0.02)[0], jax_one_ulp_spread={"R": 0.01, "t": 0.05})]}, True, True, False,
     ([], ["window BA"])),
    # a branch that differs with every count equal
    ({"branch", "keyframes"}, {"track": _track_stage(True)}, True, True, True, (["branch"], [])),
    ({"init"}, {}, True, True, True, (["init"], [])),
    # a first track that parts the branch (a promotion on one side): what
    # follows in the frame is downstream of it, whatever its BA reads
    ({"pnp_inliers", "inliers", "branch", "keyframes"}, {"track": _track_stage(True), "ba": _ba_stage(0.2, 0.2)},
     False, False, False, ([], ["track"])),
    ({"pnp_inliers", "inliers", "branch", "keyframes"}, {"track": _track_stage(False), "ba": _ba_stage(0.2, 0.2)},
     False, False, False, (["track"], [])),
])
def test_transplant_classes_name_what_differs(diff, stages, first_ok, later_ok, final_ok, want):
    assert jax_lockstep.Lockstep.classify(diff, stages, first_ok, later_ok, final_ok) == want


def test_split_by_names_the_stages_that_differ_on_identical_inputs_in_frame_order():
    track = {"within": True, "gap": {"n": 0, "R": 3e-6, "t": 0.0}}
    stages = {"extract": {"kpt_overlap": 0.97}, "match": {"jax": 20, "port": 20, "slot_agreement": 1.0},
              "track": track, "ba": _ba_stage(0.0, 0.0)}
    assert jax_lockstep.split_by(stages) == [{"stage": "extract", "kpt_overlap": 0.97},
                                             {"stage": "track core", "n": 0, "R": 3e-6, "t": 0.0}]
    assert jax_lockstep.split_by({"extract": {"kpt_overlap": 1.0}}) == []


def _engine_backend(setup):
    """The window BA's backend of the port's production engine for
    ``setup``, as ``cli.bench_accuracy`` builds it (an oracle extractor in
    place of the networks: the backend depends on the setup alone)."""
    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.cli import bench_accuracy as ba
    from ur_mvo_tpu_torch.config import SensorSetup
    from ur_mvo_tpu_torch.engine import UR_MVO
    from ur_mvo_tpu_torch.runtime.extractor import OracleExtractor

    bf = ba.FX * ba.BASELINE_M if setup == "stereo" else 0.0
    cam = make_pinhole(ba.W, ba.H, ba.FX, ba.FX, ba.W / 2, ba.H / 2, bf=bf)
    cfg = ba.production_cfg("sg" if setup == "mono" else "hybrid")
    oracle = OracleExtractor(np.zeros((4, 3), np.float32), cam, capacity=16, device="cpu")
    return UR_MVO(cfg, SensorSetup(setup), camera=cam, extractor=oracle, device="cpu").tracker.backend


def _window_gap(flat, a, b, dims):
    """Largest |a - b| over the valid frames' R_wc and t_wc of two packed
    window-BA results on the packed problem ``flat``."""
    F, P, _ = (int(x) for x in dims)
    fv = flat[: 14 * F].reshape(F, 14)[:, 12] > 0.5
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    R = np.abs(a[: 9 * F] - b[: 9 * F]).reshape(F, 9)[fv].max()
    t = np.abs(a[9 * F : 12 * F] - b[9 * F : 12 * F]).reshape(F, 3)[fv].max()
    return float(R), float(t)


def test_stereo_window_ba_is_the_jax_engines_on_a_captured_problem():
    """``stereo/decay`` seed 11, frame 12, the JAX engine's window BA (3
    keyframes, 798 points): the port's stereo engine, given that problem,
    gives the JAX package's window (whose route rounds the point side's
    summands to bf16) within the BA's limit, computed here by the JAX
    package's own backend. With exact float32 summands the stereo window
    had parted from it by 0.0321 in R and 0.1975 in t on this problem."""
    from tests.jax_matrix_reference import bench_accuracy as jax_bench_accuracy
    from ur_mvo_tpu.camera import make_pinhole as jax_pinhole
    from ur_mvo_tpu.runtime.backend import Backend as JaxBackend
    from ur_mvo_tpu_torch.cli import bench_accuracy as ba

    d = np.load(os.path.join(DATA, "lockstep_ba_stereo_decay_11_f12.npz"))
    flat = d["flat"]
    jcfg = jax_bench_accuracy()._production_cfg("hybrid")
    jcam = jax_pinhole(ba.W, ba.H, ba.FX, ba.FX, ba.W / 2, ba.H / 2, bf=ba.FX * ba.BASELINE_M)
    jb = JaxBackend(jcam, jcfg.backend, jcfg.backend_optimization, keypoints_per_frame=jcfg.superpoint.capacity)
    want = np.asarray(jb._ba(jnp.asarray(flat)))
    assert np.array_equal(want, d["jax"])  # the engine's result, reproduced
    backend = _engine_backend("stereo")
    assert tuple(backend._ba_dims) == tuple(jb._ba_dims) == tuple(d["dims"])
    with torch.no_grad():
        got = backend._ba(flat.copy()).numpy()
    R, t = _window_gap(flat, want, got, d["dims"])
    assert R <= jax_lockstep.BA_TOL and t <= jax_lockstep.BA_TOL, (R, t)


def test_c7_mono_window_ba_parts_from_jax_only_by_its_exact_point_side():
    """ROADMAP C7, open: ``mono/3d`` seed 13, frame 10, the JAX engine's
    window BA (3 keyframes, 269 points, one fixed: its scale is free). The
    port's mono engine keeps exact float32 point-side summands and lands
    0.33 in t from the JAX engine's window; the same BA with bf16 summands
    gives the JAX window within the BA's limit, so the two compute the same
    thing but for that rounding."""
    d = np.load(os.path.join(DATA, "lockstep_ba_mono_3d_13_f10.npz"))
    flat, want = d["flat"], d["jax"]
    backend = _engine_backend("mono")
    assert not backend._ba_cfg.bf16_point_side
    with torch.no_grad():
        exact = backend._ba(flat.copy()).numpy()
        bf16 = backend._ba(flat.copy(), backend._ba_cfg._replace(bf16_point_side=True)).numpy()
    R, t = _window_gap(flat, want, bf16, d["dims"])
    assert R <= jax_lockstep.BA_TOL and t <= jax_lockstep.BA_TOL, (R, t)
    assert _window_gap(flat, want, exact, d["dims"])[1] > 0.1
