"""The port's multi-sequence VO (``ur_mvo_tpu_torch.parallel.multi_seq``)
against the JAX package's ``MultiSequenceVO`` on the CPU, at a small size
(128x160, capacity 256, 200 keypoints, one GNN layer pair, S = 2, float32),
on random weights drawn with numpy and carried across with ``weights.py``:
the batched extraction, match and track, each batched lane against the
port's single-lane call, the oracle lanes' convergence, the neural
mechanics, the tracker's precomputed match and ``mesh=`` at one rank (two
ranks: ``tests/test_torch_parallel.py``).

Samplers differ (JAX's counter-based keys against a torch generator), so
every RANSAC gets the JAX package's own sets: ``sample_minimal_sets`` on
the keys its ``MultiSequenceVO`` splits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import make_landmarks, make_trajectory
from ur_mvo_tpu import config as jconfig
from ur_mvo_tpu.camera import make_pinhole as jax_pinhole
from ur_mvo_tpu.models import superglue as JG
from ur_mvo_tpu.models import superpoint as JS
from ur_mvo_tpu.ops.keypoints import FeatureBank as JBank
from ur_mvo_tpu.ops.matching import Matches as JMatches
from ur_mvo_tpu.ops.matching import decode_assignment as jax_decode
from ur_mvo_tpu.ops.matching import gather_match_points as jax_gather
from ur_mvo_tpu.ops.ransac import sample_minimal_sets
from ur_mvo_tpu.parallel.multi_seq import MultiSequenceVO as JaxMultiSequenceVO
from ur_mvo_tpu_torch import config as tconfig
from ur_mvo_tpu_torch.camera import make_pinhole
from ur_mvo_tpu_torch.parallel.multi_seq import MultiSequenceVO, lane, stack_lanes
from ur_mvo_tpu_torch.runtime import backend as backend_mod
from ur_mvo_tpu_torch.runtime import frontend as frontend_mod
from ur_mvo_tpu_torch.runtime.extractor import OracleExtractor
from ur_mvo_tpu_torch.runtime.frontend import Tracker, fused_track_core
from ur_mvo_tpu_torch.utils.metrics import ate_rmse
from ur_mvo_tpu_torch.utils.synthscene import render_sequence
from ur_mvo_tpu_torch.weights import feature_bank_from_numpy, matches_from_numpy, superglue_from_numpy, superpoint_from_numpy
from tests.torch_mesh_util import one_rank_mesh


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: PyTorch's
    intra-op thread pool costs several times what it gives there, most of
    all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H, W, FX = 128, 160, 100.0
S = 2


def _cfg(Configs):
    """Either package's configuration of the small neural lanes."""
    cfg = Configs()
    cfg.superpoint.capacity = 256
    cfg.superpoint.max_keypoints = 200
    cfg.superpoint.keypoint_threshold = 1e-4
    cfg.superglue.num_layers = 1
    cfg.superglue.matcher = "superglue"
    # random weights: a low decode threshold leaves enough matches for F-RANSAC
    cfg.superglue.matching_threshold = 0.02
    cfg.superglue.image_width, cfg.superglue.image_height = W, H
    # the JAX MultiSequenceVO computes in float32 whatever the configuration says
    cfg.runtime.compute_dtype = "float32"
    return cfg


def _numpy_weights(seed):
    """Random SuperPoint and SuperGlue (one layer pair) parameter trees,
    drawn with numpy in the JAX package's layout: He-normal kernels, small
    random biases, norms near identity, a live message MLP."""
    rng = np.random.default_rng(seed)
    sp = {name: {"w": rng.normal(0.0, np.sqrt(2.0 / (cin * k * k)), (k, k, cin, cout)).astype(np.float32),
                 "b": rng.normal(0.0, 0.01, cout).astype(np.float32)}
          for name, cin, cout, k in JS._ENCODER + JS._HEADS}

    def draw(node, name=""):
        if isinstance(node, dict):
            return {k: draw(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [draw(v) for v in node]
        a = np.zeros(node.shape, np.float32)
        if name == "w":
            return rng.normal(0.0, np.sqrt(2.0 / a.shape[0]), a.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.normal(0.0, 0.05, a.shape)).astype(np.float32)
        if name in ("b", "shift"):
            return rng.normal(0.0, 0.02, a.shape).astype(np.float32)
        return a + 1.0  # bin_score, 1.0 as JG.init_params gives it

    # the tree's layout alone: eval_shape traces init_params without running it
    sg = draw(jax.eval_shape(lambda: JG.init_params(jax.random.PRNGKey(0), num_layers=1)))
    return sp, sg


@pytest.fixture(scope="module")
def both_vo():
    """Both packages' MultiSequenceVO on the same numpy weights."""
    sp, sg = _numpy_weights(4)
    jm = JaxMultiSequenceVO(_cfg(jconfig.Configs), jax_pinhole(W, H, FX, FX, W / 2, H / 2), num_sequences=S)
    jm.sp_params = jax.tree.map(jnp.asarray, sp)
    jm.sg_params = jax.tree.map(jnp.asarray, sg)
    tm = MultiSequenceVO(_cfg(tconfig.Configs), make_pinhole(W, H, FX, FX, W / 2, H / 2), S, device="cpu")
    tm.superpoint.load_state_dict(superpoint_from_numpy(sp))
    tm.superglue.load_state_dict(superglue_from_numpy(sg))
    return jm, tm, sg


@pytest.fixture(scope="module")
def frames():
    """Frames 0 and 1 of two rendered scenes: lane i is scene 3 + i."""
    seqs = [render_sequence(2, H, W, FX, seed=3 + i)[0] for i in range(S)]
    return np.stack([s[0] for s in seqs]), np.stack([s[1] for s in seqs])


def _jbanks(jm, images):
    return jm._extract_batched(jnp.asarray(images))


def _tbank(jb):
    """A JAX bank with a lane axis as the port's."""
    return feature_bank_from_numpy(jax.tree.map(np.asarray, tuple(jb)))


def test_batched_extract_matches_jax_and_single_lanes(both_vo, frames):
    """Against ``_extract_batched`` at the extraction tolerances of
    ``test_torch_superpoint.py`` (float32): equal valid counts, the same
    keypoint in the same slot in >= 99% of the valid slots, scores and
    descriptors there within 1e-4. Each lane against the port's S = 1 call:
    equal valid counts, the same keypoint in the same slot in >= 99% of the
    valid slots, scores and descriptors everywhere within 1e-5 (the plain
    convolutions round by the ulp otherwise at another batch, which can
    swap two near-equal scores in the top-k order)."""
    jm, tm, _ = both_vo
    jb = _jbanks(jm, frames[0])
    tb = tm._extract_batched(frames[0])
    for i in range(S):
        vj, vt = np.asarray(jb.valid[i]), tb.valid[i].numpy()
        assert vj.sum() == vt.sum() > 100
        same = (np.asarray(jb.kpts[i]) == tb.kpts[i].numpy()).all(-1) & vj
        assert same.sum() / vj.sum() >= 0.99
        np.testing.assert_allclose(tb.desc[i].numpy()[same], np.asarray(jb.desc[i])[same], atol=1e-4)
        np.testing.assert_allclose(tb.scores[i].numpy()[same], np.asarray(jb.scores[i])[same], atol=1e-4)
        one = lane(tm._extract_batched(frames[0][i : i + 1]), 0)
        assert int(one.valid.sum()) == vt.sum()
        same1 = (one.kpts.numpy() == tb.kpts[i].numpy()).all(-1) & vt
        assert same1.sum() / vt.sum() >= 0.99
        np.testing.assert_allclose(one.scores.numpy(), tb.scores[i].numpy(), atol=1e-5)
        np.testing.assert_allclose(one.desc.numpy()[same1], tb.desc[i].numpy()[same1], atol=1e-5)
    # the extraction of the JAX MultiSequenceVO: /255 only where the maximum exceeds 1.5
    unit = tm._extract_batched(frames[0].astype(np.float32) / 255.0)
    assert torch.equal(unit.kpts, tb.kpts) and torch.equal(unit.valid, tb.valid)


def test_batched_match_matches_jax_and_single_lanes(both_vo, frames):
    """The same banks (the JAX package's) through both packages' batched
    match. Scores (the vmapped ``match_scores``, dustbins included) within
    1e-3; with the JAX sets on the keys its MultiSequenceVO splits, the matches and
    the F-RANSAC verdicts equal on >= 99% of the slots. Each lane bit for
    bit equal to the port's S = 1 call with the same sets."""
    jm, tm, sg = both_vo
    jb0, jb1 = _jbanks(jm, frames[0]), _jbanks(jm, frames[1])
    keys = jax.random.split(jm._next_key(), S)
    jmatch = jax.tree.map(np.asarray, jm._match_batched(keys, jb0, jb1))
    # the JAX MultiSequenceVO's scores and pre-RANSAC matches, for the sets it draws
    params = jax.tree.map(jnp.asarray, sg)
    Zj = np.asarray(jax.jit(jax.vmap(lambda b0, b1: JG.match_scores(params, b0, b1, W, H, 20, num_heads=4)))(jb0, jb1))
    tb0, tb1 = _tbank(jb0), _tbank(jb1)
    with torch.no_grad():
        Zt = tm.superglue.match_scores(tb0, tb1, W, H, 20, num_heads=4).numpy()
    np.testing.assert_allclose(Zt, Zj, atol=1e-3)
    sets = []
    for i in range(S):
        jbi0, jbi1 = (JBank(*(f[i] for f in b)) for b in (jb0, jb1))
        m = jax_decode(jnp.asarray(Zj[i]), jbi0.valid, jbi1.valid, tm.match_threshold)
        valid = jax_gather(m, jbi0.kpts, jbi1.kpts)[2]
        sets.append(torch.from_numpy(np.array(sample_minimal_sets(keys[i], valid, 200, 8))).to(torch.int64))
    tmatch = tm._match_batched(tb0, tb1, sets=sets)
    for i in range(S):
        assert jmatch.valid[i].sum() >= 8
        assert (tmatch.idx1[i].numpy() == jmatch.idx1[i]).mean() >= 0.99
        assert (tmatch.valid[i].numpy() == jmatch.valid[i]).mean() >= 0.99
        one = lane(tm._match_batched(stack_lanes([lane(tb0, i)]), stack_lanes([lane(tb1, i)]), sets=[sets[i]]), 0)
        assert all(torch.equal(a, b) for a, b in zip(one, lane(tmatch, i)))


# --- the batched track: two synthetic lanes, K = 64 ------------------------

KT = 64


def _track_lanes():
    """Per lane: map points seen by the reference keyframe (slot i's id
    100 + i), a matched current frame after a small motion (ref slot i ->
    current slot perm[i], ~15% unmatched) and the snapshot the tracker
    would give (ref pose at the origin)."""
    snaps, idx1, mvalid, kpts = [], [], [], []
    for s in range(S):
        rng = np.random.default_rng(40 + s)
        X = np.stack([rng.uniform(-2, 2, KT), rng.uniform(-1.5, 1.5, KT), rng.uniform(6, 10, KT)], 1).astype(np.float32)
        t_true = np.array([0.08 + 0.04 * s, -0.02, 0.01], np.float32)
        Xc = X - t_true
        uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + W / 2, FX * Xc[:, 1] / Xc[:, 2] + H / 2], 1)
        perm = rng.permutation(KT)
        v = rng.random(KT) > 0.15
        kp = np.zeros((KT, 2), np.float32)
        kp[perm] = uv + rng.normal(0, 0.05, (KT, 2))
        snap = np.zeros((KT, 6), np.float32)
        snap[:, 0:3] = X
        snap[:, 3] = np.where(np.arange(KT) % 7 == 0, 1.0, 2.0)  # every 7th id untriangulated
        snap[:, 4] = np.arange(KT) + 100
        snap[0:9, 5] = np.eye(3, dtype=np.float32).reshape(-1)
        snaps.append(snap)
        idx1.append(np.where(v, perm, -1).astype(np.int32))
        mvalid.append(v)
        kpts.append(kp)
    return np.stack(snaps), np.stack(idx1), np.stack(mvalid), np.stack(kpts)


def test_batched_track_matches_jax_and_single_lanes(both_vo):
    """``_track_batched`` of both packages on the same matches, banks and
    snapshots, the port given the JAX package's PnP sets: match and inlier
    counts equal, R within 2e-5, t within 2e-4, track ids equal on >= 99%,
    uvr bit for bit (``test_torch_track.py``'s tolerances). Each lane's row
    bit for bit equal to the single-lane ``fused_track_core`` with the same
    sets: its two pose problems are rows 2i, 2i + 1 of ONE batched call."""
    jm, tm, _ = both_vo
    snaps, idx1, mvalid, kpts = _track_lanes()
    jmatch = JMatches(idx1=jnp.asarray(idx1), score=jnp.asarray(mvalid.astype(np.float32)), valid=jnp.asarray(mvalid))
    jbank = JBank(scores=jnp.asarray(mvalid.astype(np.float32)), kpts=jnp.asarray(kpts),
                  desc=jnp.zeros((S, KT, 1), jnp.float32), valid=jnp.asarray(mvalid))
    keys = jax.random.split(jm._next_key(), S)
    ref = np.asarray(jm._track_batched(keys, jmatch, jbank, jnp.asarray(snaps)))
    iters = tm.cfg.runtime.pnp_ransac_iterations
    sets = []
    for i in range(S):
        src_ok = mvalid[i] & (snaps[i, :, 3] > 1.5)
        valid_cur = np.zeros(KT, bool)
        valid_cur[idx1[i][src_ok]] = True
        sets.append(torch.from_numpy(np.array(sample_minimal_sets(keys[i], jnp.asarray(valid_cur), iters, 6))).to(torch.int64))
    tmatch = matches_from_numpy((idx1, mvalid.astype(np.float32), mvalid))
    tbank = feature_bank_from_numpy((mvalid.astype(np.float32), kpts, np.zeros((S, KT, 1), np.float32), mvalid))
    out = tm._track_batched(tmatch, tbank, torch.from_numpy(snaps), pnp_sets=sets).numpy()
    assert out.shape == ref.shape == (S, 14 + 4 * KT)
    cam, topt, rt, kf = tm.camera, tm.cfg.tracking_optimization, tm.cfg.runtime, tm.cfg.keyframe
    for i in range(S):
        assert out[i, 0] == ref[i, 0] == mvalid[i].sum() and out[i, 1] == ref[i, 1] > 30
        np.testing.assert_allclose(out[i, 2:11], ref[i, 2:11], atol=2e-5)
        np.testing.assert_allclose(out[i, 11:14], ref[i, 11:14], atol=2e-4)
        assert (out[i, 14 : 14 + KT] == ref[i, 14 : 14 + KT]).mean() >= 0.99
        np.testing.assert_array_equal(out[i, 14 + KT :], ref[i, 14 + KT :])
        uvr = torch.cat([tbank.kpts[i], -torch.ones((KT, 1))], 1)
        one = fused_track_core(None, lane(tmatch, i), uvr, torch.from_numpy(snaps[i]), tm.K_mat,
                               cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, topt.mono_point, topt.stereo_point,
                               rt.pnp_ransac_iterations, rt.pnp_reprojection_threshold, kf.min_num_match,
                               4.0 * kf.max_distance, pnp_sets=sets[i])[0].numpy()
        np.testing.assert_array_equal(out[i], one)


# --- whole lanes -----------------------------------------------------------

def _oracle_cfg():
    """``tests/test_e2e_synthetic.small_config`` in the port's Configs."""
    cfg = tconfig.Configs()
    cfg.superpoint.capacity = 512
    cfg.superpoint.max_keypoints = 512
    cfg.backend.window_opt_frames = 8
    cfg.backend.window_fixed_frames = 6
    cfg.backend.ba_max_points = 512
    cfg.backend.ba_max_observations = 4096
    cfg.backend.ba_iterations_phase1 = 6
    cfg.backend.ba_iterations_phase2 = 3
    return cfg


def _oracle_lanes(n_lanes, n_frames):
    """``test_multi_seq.py``'s lanes: a landmark cloud and a trajectory
    offset each, oracles with 0.2 px noise."""
    cam = make_pinhole(640, 512, 400.0, 400.0, 320.0, 256.0)
    T_wc, ts = make_trajectory(n_frames, advance=0.05)
    extractors, gts = [], []
    for s in range(n_lanes):
        X = make_landmarks(400, along=2.0, seed=10 + s)
        extractors.append(OracleExtractor(X, cam, capacity=512, noise_px=0.2, seed=20 + s, device="cpu"))
        off = np.eye(4)
        off[:3, 3] = [0, 0, 0.1 * s]
        gts.append(np.einsum("ij,njk->nik", off, T_wc))
    return cam, extractors, gts, ts


def _lane_ates(msvo, gts, ts):
    out = []
    for s, (kts, _, kt) in enumerate(msvo.trajectories()):
        idx = np.clip(np.searchsorted(ts, kts), 0, len(ts) - 1)
        out.append((len(kts), ate_rmse(kt, gts[s][idx, :3, 3], align=True, correct_scale=True)))
    return out


@pytest.mark.parametrize("path", ["oracle", "batched"])
def test_multi_sequence_oracle_convergence(path, monkeypatch):
    """``test_multi_seq.py``'s: S = 3 oracle sequences, 35 frames, each
    >= 4 keyframes and keyframe ATE < 0.08. ``oracle``: each tracker
    extracts and matches on its own (``process_batch_with_oracle``).
    ``batched``: the oracles' banks through ``process_banks``, the batched
    match (mutual-NN: the oracle's descriptors name their landmark) and the
    batched track, whose rows the trackers adopt; every frame makes
    exactly one ``optimize_pose`` call for the batch where a lane tracks,
    plus the calls the lanes' own flows count (``last_frame``)."""
    S3, n = 3, 35
    cam, extractors, gts, ts = _oracle_lanes(S3, n)
    msvo = MultiSequenceVO(_oracle_cfg(), cam, S3, extractors=extractors if path == "oracle" else None, device="cpu")
    calls = []
    for mod in (frontend_mod, backend_mod):
        monkeypatch.setattr(mod, "optimize_pose", lambda *a, _f=mod.optimize_pose, **k: calls.append(1) or _f(*a, **k))
    adopted = 0
    for i in range(n):
        if path == "oracle":
            msvo.process_batch_with_oracle([g[i] for g in gts], [ts[i]] * S3)
        else:
            before = len(calls)
            msvo.process_banks(stack_lanes([e.extract_with_pose(g[i]) for e, g in zip(extractors, gts)]), [ts[i]] * S3)
            f = msvo.last_frame
            assert len(calls) - before == (f["track_lanes"] > 0) + f["lane_pose_calls"], (i, f)
            adopted += f["adopted"]
    for s, (n_kf, ate) in enumerate(_lane_ates(msvo, gts, ts)):
        assert n_kf >= 4, f"seq {s} produced {n_kf} keyframes"
        assert ate < 0.08, (s, ate)
    if path == "batched":
        assert msvo.matcher == "nn" and adopted >= S3 * (n - 10)


def test_process_batch_runs_neural():
    """``test_multi_seq.py``'s mechanics: the lock-step neural path runs and
    keeps per-sequence state independent (random weights won't
    initialize); every lane holds an init bank after the first frame."""
    cfg = _oracle_cfg()
    cfg.superpoint.capacity = 256
    cfg.superpoint.max_keypoints = 200
    cfg.superglue.num_layers = 1
    msvo = MultiSequenceVO(cfg, make_pinhole(W, H, FX, FX, W / 2, H / 2), num_sequences=2, device="cpu")
    rng = np.random.default_rng(0)
    imgs = rng.random((2, H, W)).astype(np.float32)
    for i in range(3):
        out = msvo.process_batch(imgs, [i * 0.033] * 2)
        assert len(out) == 2
    assert not msvo.trackers[0].initialized
    assert all(t._init_bank is not None for t in msvo.trackers)
    assert msvo.last_frame == {"track_lanes": 0, "adopted": 0, "lane_pose_calls": 0}


def test_precomputed_match_gives_the_same_keyframes():
    """``Tracker.process(precomputed_match=...)`` with the extractor's own
    matches (init bank or reference keyframe -> frame) gives the keyframe
    poses of the run without it, bit for bit."""
    cam, (oracle,), (gt,), ts = _oracle_lanes(1, 35)
    runs = []
    for precompute in (False, True):
        oracle.reset_state()
        tr = Tracker(_oracle_cfg(), cam, oracle, device="cpu")
        poses = []
        for i in range(len(ts)):
            bank = oracle.extract_with_pose(gt[i])
            partner = tr._ref_bank if tr.initialized else tr._init_bank
            m = oracle.match(partner, bank) if precompute and partner is not None else None
            out = tr.process(bank, ts[i], precomputed_match=m)
            if out is not None:
                poses.append((i, out))
        runs.append(poses)
    assert len(runs[0]) >= 4 and [i for i, _ in runs[0]] == [i for i, _ in runs[1]]
    for (_, a), (_, b) in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_mesh_raises_and_the_device_defaults_to_cuda(tmp_path):
    """``mesh=``: a mesh of one rank (this process, gloo) holds every lane;
    S that the mesh size does not divide raises before anything is built
    (a stand-in of two ranks); without a mesh the device defaults to
    ``cuda``. World 2: ``tests/test_torch_parallel.py``."""
    cfg = _cfg(tconfig.Configs)
    cam = make_pinhole(W, H, FX, FX, W / 2, H / 2)
    with one_rank_mesh(tmp_path) as mesh:
        vo = MultiSequenceVO(cfg, cam, 2, mesh=mesh, device="cpu")
        assert vo.lanes == [0, 1] and len(vo.trackers) == len(vo.generators) == 2

    class TwoRanks:
        def size(self):
            return 2

    with pytest.raises(ValueError, match="do not split over a mesh of 2"):
        MultiSequenceVO(cfg, cam, 3, mesh=TwoRanks(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MultiSequenceVO(cfg, cam, 2)
