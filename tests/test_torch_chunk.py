"""Chunked tracking on the CPU: ``Tracker.process_chunk`` and the chunked
``UR_MVO.process_sequence`` held to the per-frame path.

A consumed chunk row is the per-frame path's frame bit for bit (the carried
pose is checked where a row read it, and both samplers end where the
per-frame path leaves them), so the chunked runs are held to their
per-frame runs exactly: keyframe ids, frames lost, the map, the ATE and the
generators. The neural run uses the shipped weights; the oracle runs
(``tests/torch_chunk_util.py``) drive the mono, stereo and RGB-D chunks, a
short padded block and a weak row. The chunk's rows against the JAX
package's fused step are in ``tests/test_torch_track.py``, beside the
compiled JAX step they share.
"""

import os

import numpy as np
import pytest
import torch

from tests import torch_chunk_util as U
from ur_mvo_tpu_torch import components as tcomp
from ur_mvo_tpu_torch import config as tconfig
from ur_mvo_tpu_torch.camera import make_pinhole
from ur_mvo_tpu_torch.engine import UR_MVO
from ur_mvo_tpu_torch.models.superglue import checkpoint_operating_point
from ur_mvo_tpu_torch.runtime.extractor import OracleExtractor
from ur_mvo_tpu_torch.utils import synthscene
from ur_mvo_tpu_torch.utils.metrics import ate_rmse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = tconfig.SensorSetup


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny eager ops: PyTorch's
    intra-op thread pool costs several times what it gives there, most of
    all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _store_state(vo):
    st = vo.tracker.backend.store
    slots = st.keyframe_slots()
    return dict(kf_frame_id=st.kf_frame_id[slots], kf_R=st.kf_R[slots], kf_t=st.kf_t[slots],
                kf_kpts=st.kf_kpts[slots], kf_track=st.kf_track[slots], mp_pos=st.mp_pos, mp_good=st.mp_good,
                mp_bad=st.mp_bad)


def _assert_same_run(a, b):
    """Two engines' runs, bit for bit: keyframes, map, frames lost and both
    samplers."""
    sa, sb = _store_state(a), _store_state(b)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    assert a.tracker.frames_lost == b.tracker.frames_lost
    assert torch.equal(a.tracker._gen.get_state(), b.tracker._gen.get_state())
    assert torch.equal(a.extractor._gen.get_state(), b.extractor._gen.get_state())


# ---------------------------------------------------------------------------
# the neural path on the shipped weights
# ---------------------------------------------------------------------------

NH, NW, NFX, N_NEURAL = 160, 224, 180.0, 7


def _neural_cfg(chunk):
    """The production mono configuration with the keyframe policy's frame
    budget cut to 3 (a tracked keyframe falls inside the run) and the bank
    cut to 512 slots (the matcher's cost on the CPU)."""
    cfg = tconfig.Configs()
    sg_path = os.path.join(REPO, "weights", "superglue_v3scene.npz")
    cfg.superpoint.weights_path = os.path.join(REPO, "weights", "superpoint_scratch_v3.npz")
    cfg.superglue.weights_path = sg_path
    op = checkpoint_operating_point(sg_path) or {}
    cfg.superpoint.capacity = 512
    cfg.superpoint.max_keypoints = 512
    cfg.superpoint.keypoint_threshold = op.get("keypoint_threshold", 1e-4)
    cfg.initializer.min_matches = op.get("min_matches", 60)
    cfg.initializer.min_features_first = op.get("min_features_first", 100)
    cfg.superglue.nn_fallback_min_matches_init = 40
    cfg.keyframe.max_num_passed_frame = 3
    cfg.runtime.chunk_frames = chunk
    return cfg


@pytest.fixture(scope="module")
def neural_runs():
    images, T_wc, _ = synthscene.render_sequence(N_NEURAL, NH, NW, NFX, seed=0, n_planes=3, z_background=6.0)
    cam = make_pinhole(NW, NH, NFX, NFX, NW / 2, NH / 2)
    runs = {}
    for chunk in (0, 3):
        vo = UR_MVO(_neural_cfg(chunk), S.MONO, camera=cam, device="cpu")
        frames = [tcomp.Frame(image=tcomp.Image(images[i], i / 30.0)) for i in range(N_NEURAL)]
        runs[chunk] = (vo, vo.process_sequence(frames))
    return runs, T_wc


def _emitted_ate(outs, T_wc):
    """The emitted trajectory's ATE, scale-corrected: the poses a keyframe
    returns cover the frames since the last emission."""
    stamps, pos, pending = [], [], []
    for i, out in enumerate(outs):
        pending.append(i)
        if out:
            stamps.extend(pending[-len(out):])
            pos.extend(p.translation for p in out)
            pending.clear()
    return ate_rmse(np.stack(pos), T_wc[stamps][:, :3, 3], align=True, correct_scale=True)


def test_chunked_sequence_is_the_per_frame_run_on_the_shipped_weights(neural_runs):
    """``chunk_frames = 3`` against the per-frame run through
    ``UR_MVO(device="cpu")``: the same keyframes (two at init and a tracked
    one), frames lost, map and samplers, bit for bit, so the same emitted
    ATE, under the JAX package's own bound (0.35,
    ``tests/test_chunk_track.py``)."""
    (pf, outs_pf), (ch, outs_ch) = neural_runs[0][0], neural_runs[0][3]
    T_wc = neural_runs[1]
    assert pf.tracker.initialized and ch.tracker.initialized
    assert [i for i, o in enumerate(outs_ch) if o is not None] == [i for i, o in enumerate(outs_pf) if o is not None]
    assert pf.tracker.backend.store.num_keyframes() >= 3
    _assert_same_run(pf, ch)
    st = ch.tracker.backend.store
    assert int((st.mp_good & ~st.mp_bad).sum()) > 0
    ate_pf, ate_ch = _emitted_ate(outs_pf, T_wc), _emitted_ate(outs_ch, T_wc)
    assert ate_ch == ate_pf and ate_ch < 0.35, (ate_pf, ate_ch)
    stats = ch.tracker.chunk_stats
    assert stats["chunks"] >= 1 and stats["consumed"] >= 1, stats
    assert pf.tracker.chunk_stats["chunks"] == 0


# ---------------------------------------------------------------------------
# the oracle: mono, stereo and RGB-D chunks, a short block, a weak row
# ---------------------------------------------------------------------------

ORACLE_SETUPS = {
    # name: (setup, capacity, points, bf, fx, frames)
    "mono": (S.MONO, 64, 60, 0.0, U.FX, 12),
    "stereo": (S.STEREO, 256, 250, 40.0, 400.0, 8),
    "rgbd": (S.RGBD, 320, 300, 0.0, 400.0, 8),
}


@pytest.mark.parametrize("name", list(ORACLE_SETUPS))
def test_chunked_oracle_run_is_the_per_frame_run(name):
    """Blocks of 4 against the per-frame run, bit for bit; the keyframes
    that chunk rows inserted keep their stereo column (``u_right``) and
    seed new map points from it or from their own depth lookups."""
    setup, cap, n_points, bf, fx, n = ORACLE_SETUPS[name]
    runs = {}
    for chunk in (0, 4):
        vo, _ = U.engine(n, cap, n_points, chunk, setup, bf, fx)
        inserted = []
        process_chunk = vo.tracker.process_chunk

        def spy(*a, _pc=process_chunk, _vo=vo, **k):
            before = set(_vo.tracker.backend.store.kf_frame_id[_vo.tracker.backend.store.keyframe_slots()].tolist())
            out = _pc(*a, **k)
            st = _vo.tracker.backend.store
            inserted.extend(int(s) for s in st.keyframe_slots() if int(st.kf_frame_id[s]) not in before)
            return out

        vo.tracker.process_chunk = spy
        outs = vo.process_sequence([U.frame(i, setup == S.STEREO) for i in range(n)])
        runs[chunk] = (vo, outs, inserted)
    (pf, outs_pf, _), (ch, outs_ch, inserted) = runs[0], runs[4]
    assert [o is None for o in outs_ch] == [o is None for o in outs_pf]
    _assert_same_run(pf, ch)
    assert ch.tracker.frames_lost == 0 and ch.tracker.chunk_stats["consumed"] >= 4
    assert inserted, "no chunk row inserted a keyframe"
    st = ch.tracker.backend.store
    init_slot = st.keyframe_slots()[0]
    for slot in inserted:
        u_right = st.kf_kpts[slot, :, 2]
        if setup == S.STEREO:
            assert (u_right > 0).sum() >= 100
        else:
            assert (u_right <= 0).all()
    if setup != S.MONO:
        # points seeded after initialization, from disparity or depth
        assert int(st.mp_good.sum()) > int((st.kf_track[init_slot] >= 0).sum())


def test_a_short_block_pads_and_consumes_only_its_frames():
    """Two frames through C = 4: the block pads to 4, queues the 2 real
    frames only, and the counter advances by 2."""
    vo, _ = U.engine(12, 64, 60, chunk=4)
    vo.config.runtime.chunk_frames = 0
    vo.process_sequence([U.frame(i) for i in range(7)])
    assert vo.tracker.initialized
    vo.config.runtime.chunk_frames = 4
    counter = vo.tracker._frame_counter
    outs = vo.process_sequence([U.frame(i) for i in (7, 8)])
    assert len(outs) == 2
    assert vo.tracker._frame_counter == counter + 2
    assert vo.tracker.chunk_stats["chunks"] == 1 and vo.tracker.chunk_stats["rows"] == 2


def test_a_weak_row_is_handed_back_and_retried_on_the_same_draws():
    """A blank frame inside a chunk is not consumed: its bank (a fresh
    extraction's bit for bit) comes back, the samplers are set back to
    where that row started, and the per-frame retry draws what the row
    drew. The frame before it is consumed."""
    vo, _ = U.engine(12, 64, 60)
    vo.process_sequence([U.frame(i) for i in range(7)])
    tr, ext = vo.tracker, vo.extractor
    assert tr.chunk_available()
    starts = []
    fused = tr._fused_kernel

    def spy(*a, **k):
        starts.append((tr._gen.get_state(), ext._gen.get_state()))
        return fused(*a, **k)

    tr._fused_kernel = spy
    imgs = np.stack([U.frame(i).image.get_image() for i in (7, U.BLANK, 8)])
    results, consumed, weak_bank = tr.process_chunk(imgs, [7 / 30.0, 8 / 30.0, 9 / 30.0])
    assert consumed == 1 and results == [None] and len(starts) == 3
    fresh = ext.extract(imgs[1])
    assert weak_bank is not None and all(torch.equal(a, b) for a, b in zip(weak_bank, fresh))
    assert torch.equal(tr._gen.get_state(), starts[1][0]) and torch.equal(ext._gen.get_state(), starts[1][1])
    tr.process(weak_bank, 8 / 30.0)
    assert torch.equal(starts[3][0], starts[1][0]) and torch.equal(starts[3][1], starts[1][1])
    assert tr.chunk_stats["weak"] == 1


def test_chunk_available_follows_the_jax_conditions():
    """A neural (fused) extractor, an initialized tracker with a reference
    bank, no local-map tracking, no resolution buckets; a stereo chunk also
    needs a baseline. ``process_chunk`` raises where it is not available."""
    vo, _ = U.engine(12, 64, 60)
    tr = vo.tracker
    assert not tr.chunk_available()
    with pytest.raises(ValueError, match="not available"):
        tr.process_chunk(np.zeros((2, 2, 2), np.uint8), [0.0, 0.1])
    vo.process_sequence([U.frame(i) for i in range(7)])
    assert tr.chunk_available() and not tr.chunk_available(stereo=True)
    vo.config.local_map_tracking.enabled = True
    assert not tr.chunk_available()
    vo.config.local_map_tracking.enabled = False
    vo.extractor._buckets = [(256, 256)]
    assert not tr.chunk_available()
    oracle = OracleExtractor(U.landmarks(60), vo.camera, capacity=64, device="cpu")
    plain = UR_MVO(vo.config, S.MONO, camera=vo.camera, extractor=oracle, device="cpu")
    plain.tracker._initialized, plain.tracker._ref_bank = True, object()
    assert not plain.tracker.chunk_available()
