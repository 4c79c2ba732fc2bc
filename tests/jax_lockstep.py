"""The JAX engine and the port's engine in lock step on the CPU, frame by
frame, over the same rendered frames of a ``cli.bench_accuracy`` cell.

Both engines take the cell's production configuration and camera (those of
``tests/jax_matrix_reference.py`` and ``cli/bench_accuracy.py``); the port
runs on ``device="cpu"``, so through its kernels' plain versions. Both take
the same draws: every minimal set the port samples (match F-RANSAC, PnP,
the two-view F and H, place verification) is the JAX sampler's Gumbel
top-k on the key that the JAX engine used for the same call, replayed on
the port's validity mask. Where the two masks agree the replayed sets must
equal the sets the JAX call drew, or the harness stops with an error.

One JSON line a frame (``"frame"``): for each side (``"jax"``, ``"port"``)
the valid keypoints, the matches of each match-to-reference, the init
attempts (success, matches, triangulated), the PnP inliers, the pose-GN
inliers, the branch the frame took (``track``, ``promoted``,
``promote_refused``, ``kf_decision``, ``kf_promoted``, ``kf_refused``,
``lost``, ``relocalized``, ``reloc_failed``, ``init_held``,
``init_attempt``, ``init_wait``, ``initialised``), the keyframes, the live
map points and the poses emitted so far; beside them the two banks'
keypoint overlap, the pose difference (rotation degrees, translation), each
side's distance to the truth (metric setups), the draws paired and those
on different masks, and ``differs``, the counts and branches that differ.
A summary line (``"run"``) closes each seed: each side's ATE, poses,
keyframes and losses, the first frame where any count or branch differs
(``first_divergence``, with ``split_by``: the stages that already differ
there on identical inputs) and the first where the branches differ
(``first_branch_divergence``).

At each of those two frames (at every frame where a count or branch
differs, with ``--transplant all``) the harness transplants the step
(``"transplant"``): a third engine of the port is given the JAX engine's
state before the frame (the map through ``weights.map_store_from``, the
banks through ``weights.feature_bank_from_numpy``), the JAX bank of the
frame, the JAX engine's matches of that frame and its draws, and runs the
one frame. Its stages redo parts of it on identical inputs: the port's
extraction of the same image against the JAX bank (``extract``), the
port's matcher on the JAX banks and draw (``match``), both packages'
``fused_track_core`` on the JAX match, key and sets and the transplanted
snapshot (``track``), and each window BA of the step solved by both
packages on the captured packed problem, with bf16 and with exact
point-side summands (``ba``); beside each, both packages' spreads under
one-ulp moves of the stage's input. The class is ``rounding carried
forward`` where the step's counts, branch and poses agree within the
limits of the tests that cover each module (the fused step's R 2e-5, t
2e-4; the BA's 1e-3), or where what differs is accounted for by a stage
within those limits or within twice either package's spread. Anything
else is a ``logic difference``, named in ``"logic"``
(``Lockstep.classify``): a window BA that agrees only when both packages
round the point-side summands to bf16 is the port's exact-summand choice
(ROADMAP C7).

``--banks jax`` feeds the port the JAX engine's banks (one extraction for
both), ``--banks port`` feeds the JAX engine the port's: a run that then
follows the other side's path shows where the extraction's rounding leads.
``--reverse`` runs the JAX engine again from the port's state before the
first branch divergence to the end of the seed, on the port's banks, each
JAX call sampling with the key the port's call used (an ordered host
callback hands it in): one ``"reverse_frame"`` line a frame against the
port's record of it, then ``"reverse"`` with the first divergence and the
JAX side's ATE, poses and losses. ``--render jax`` draws the frames with
the JAX package's renderer (the two differ by one grey level at ~160 of a
sequence's 1.8M pixels).

Run from the root of the repository:

    JAX_PLATFORMS=cpu python -m tests.jax_lockstep mono/3d 11,12,13 --transplant all --reverse --out build/lockstep
    JAX_PLATFORMS=cpu python -m tests.jax_lockstep rgbd/3d 19 --banks jax

(~1-4 s a frame on one CPU thread after the JAX engine's ~90 s compile;
~20 s a frame with every frame transplanted.) Not a
test module: pytest collects nothing here. Only this file, among the
port's helpers, imports both packages.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_torch_track.py::test_fused_track_core_matches_jax, and the
# window BA's limit in tests/test_torch_ba.py (the "auto" assembly)
R_TOL, T_TOL, BA_TOL = 2e-5, 2e-4, 1e-3
COLLAPSED = 6  # reference keyframe candidates below which a loss counts as collapsed (ROADMAP C11)

TRACKER_FIELDS = (
    "_initialized", "_init_bank", "_init_time", "_init_frame_id", "_frame_counter", "_last_pose", "_last_bank",
    "_last_track", "_last_uvr", "_last_time", "_last_frame_id", "_last_track_well", "_num_since_last_keyframe",
    "_lost_count", "_reloc_next_attempt", "_ref_slot", "_ref_bank", "_ref_frame_id", "_last_keyframe_pose",
    "_last_keyframe_frame_id", "_last_keyframe_time",
)
BANK_FIELDS = ("_init_bank", "_last_bank", "_ref_bank")


class DrawMismatch(RuntimeError):
    """A port call on the JAX call's mask received other sets than it drew."""


# ---------------------------------------------------------------------------
# Draws: recorded in JAX, replayed for the port
# ---------------------------------------------------------------------------

def jax_sampler():
    """The JAX package's ``sample_minimal_sets`` as the module holds it."""
    from ur_mvo_tpu.ops import ransac

    return ransac.sample_minimal_sets


def replay_sets(sampler, key, valid, num_sets: int, set_size: int) -> np.ndarray:
    """The JAX sampler's ``num_sets`` x ``set_size`` draw of ``key`` over
    ``valid`` (a bool mask), as host indices."""
    import jax
    import jax.numpy as jnp

    fn = _REPLAY.get(sampler)
    if fn is None:
        fn = _REPLAY[sampler] = jax.jit(sampler, static_argnums=(2, 3))
    return np.asarray(fn(jnp.asarray(key), jnp.asarray(valid), num_sets, set_size))


_REPLAY: dict = {}


class Draws:
    """One frame's JAX calls, in call order (``log`` holds the minimal sets
    and the matches, as the JAX program produced them), and the port's
    replay of them: :meth:`port_sample` hands the port's ``i``-th call the
    JAX sampler's draw of the ``i``-th JAX call's key on the port's mask."""

    def __init__(self, sampler):
        import jax

        self.sampler = sampler
        self.log = []  # ("draw", key, valid, sets) / ("match", idx1, score, valid)
        self.queue = []
        self.spare = jax.random.PRNGKey(2**31 - 1)  # draws no JAX call mirrors
        self.paired = self.on_other_masks = self.unpaired = 0
        self.port_keys = []  # (key, num_sets, set_size) of each port call, in call order
        self.override = None  # keys the JAX calls take instead of their own (the reverse run)
        self.overridden = self.not_overridden = 0

    def start(self):
        self.log = []
        self.port_keys = []
        self.paired = self.on_other_masks = self.unpaired = 0

    def choose_key(self, key, num_sets, set_size):
        """The key a JAX call samples with: its own, or under ``override``
        the next recorded port call's key when that call had its shape."""
        if self.override is not None:
            if self.override and self.override[0][1:] == (num_sets, set_size):
                self.overridden += 1
                return np.asarray(self.override.pop(0)[0], np.uint32)
            self.not_overridden += 1
        return np.asarray(key, np.uint32)

    def record_draw(self, key, valid, sets):
        self.log.append(("draw", np.asarray(key), np.asarray(valid), np.asarray(sets)))

    def record_match(self, idx1, score, valid):
        self.log.append(("match", np.asarray(idx1), np.asarray(score), np.asarray(valid)))

    def draws(self):
        return [e for e in self.log if e[0] == "draw"]

    def matches(self):
        return [e for e in self.log if e[0] == "match"]

    def arm(self):
        """Queue this frame's JAX draws for the port's calls."""
        self.queue = list(self.draws())

    def leftover(self) -> int:
        return len(self.queue)

    def port_sample(self, generator, valid, num_sets, set_size):
        import jax
        import torch

        mask = valid.detach().cpu().numpy().astype(bool)
        if self.queue and self.queue[0][3].shape == (num_sets, set_size):
            _, key, jvalid, jsets = self.queue.pop(0)
            self.port_keys.append((np.asarray(key), num_sets, set_size))
            sets = replay_sets(self.sampler, key, mask, num_sets, set_size)
            if np.array_equal(mask, jvalid):
                if not np.array_equal(sets, jsets):
                    raise DrawMismatch(f"replayed sets differ from the JAX call's on the same mask ({num_sets}x{set_size})")
                self.paired += 1
            else:
                self.on_other_masks += 1
        else:
            # the branches parted: no JAX call mirrors this one
            self.spare, key = jax.random.split(self.spare)
            self.port_keys.append((np.asarray(key), num_sets, set_size))
            sets = replay_sets(self.sampler, np.asarray(key), mask, num_sets, set_size)
            self.unpaired += 1
        return torch.from_numpy(np.array(sets, np.int64)).to(valid.device)


class Patches:
    """The module patches of a lock-step run, undone by :meth:`undo`: the
    JAX sampler and PnP record their calls (ordered host callbacks), the
    port's samplers replay them, the port's PnP records its inliers."""

    def __init__(self):
        self._undo = []

    def set(self, mod, name, value):
        self._undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def undo(self):
        for mod, name, value in reversed(self._undo):
            setattr(mod, name, value)
        self._undo = []

    @contextlib.contextmanager
    def suspended(self):
        """The modules as they were, for tracing a program that must not
        record (the reference programs of the stages)."""
        now = [(mod, name, getattr(mod, name)) for mod, name, _ in self._undo]
        for mod, name, value in reversed(self._undo):
            setattr(mod, name, value)
        try:
            yield
        finally:
            for mod, name, value in now:
                setattr(mod, name, value)


def install(draws: Draws, pnp_log: dict) -> Patches:
    import jax
    from jax.experimental import io_callback

    from ur_mvo_tpu.ops import pnp as jpnp
    from ur_mvo_tpu.ops import ransac as jransac
    from ur_mvo_tpu.runtime import frontend as jfront
    from ur_mvo_tpu_torch.ops import pnp as ppnp
    from ur_mvo_tpu_torch.ops import ransac as pransac
    from ur_mvo_tpu_torch.runtime import frontend as pfront

    p = Patches()
    orig = draws.sampler

    def jax_sample(key, valid, num_sets, set_size):
        key = io_callback(lambda k: draws.choose_key(k, num_sets, set_size), jax.ShapeDtypeStruct(key.shape, key.dtype),
                          key, ordered=True)
        idx = orig(key, valid, num_sets, set_size)
        jax.debug.callback(draws.record_draw, key, valid, idx, ordered=True)
        return idx

    p.set(jransac, "sample_minimal_sets", jax_sample)
    p.set(jpnp, "sample_minimal_sets", jax_sample)
    jpnp_orig, ppnp_orig = jfront.ransac_pnp, pfront.ransac_pnp

    def jax_pnp(*a, **k):
        res = jpnp_orig(*a, **k)
        jax.debug.callback(lambda n: pnp_log["jax"].append(int(n)), res.n_inliers, ordered=True)
        return res

    def port_pnp(*a, **k):
        res = ppnp_orig(*a, **k)
        pnp_log["port"].append(int(res.n_inliers))
        return res

    p.set(jfront, "ransac_pnp", jax_pnp)
    p.set(pfront, "ransac_pnp", port_pnp)
    p.set(pransac, "sample_minimal_sets", draws.port_sample)
    p.set(ppnp, "sample_minimal_sets", draws.port_sample)
    return p


# ---------------------------------------------------------------------------
# Engines and what each frame did
# ---------------------------------------------------------------------------

class Side:
    """An engine and its tracker's events of the current frame."""

    def __init__(self, name, vo):
        self.name, self.vo, self.tr = name, vo, vo.tracker
        self.ctx = []
        self.reset()

    def reset(self):
        self.records, self.keys, self.banks_seq = [], [], []  # every frame's record, draw keys and banks
        self.lost, self.collapsed, self.relocs = 0, 0, 0
        self.ts_out, self.pos_out, self.pending = [], [], []
        self.init_at = None
        self.start()

    def start(self):
        self.branch, self.tracks, self.inits, self.track_poses, self.track_uvr = [], [], [], [], []
        self.bank = self.bank_right = None

    def record(self, pnp):
        st = self.tr.backend.store
        return {
            "kpts": None if self.bank is None else int(np.asarray(_np(self.bank.valid)).sum()),
            "matches": [t[0] for t in self.tracks], "inliers": [t[1] for t in self.tracks], "pnp_inliers": pnp,
            "init": self.inits, "branch": self.branch, "keyframes": int(st.num_keyframes()),
            "map_points": int((st.mp_alloc & st.mp_good & ~st.mp_bad).sum()), "poses": len(self.ts_out),
        }


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def reference_candidates(tr) -> int:
    """Triangulated live points of the tracker's reference keyframe (as
    ``tests/jax_matrix_reference.py`` counts them)."""
    if tr._ref_slot is None:
        return 0
    st = tr.backend.store
    ref = np.asarray(st.kf_track[tr._ref_slot])
    safe = np.maximum(ref, 0)
    live = (ref >= 0) & ~np.asarray(st.mp_bad)[safe]
    return int((live & np.asarray(st.mp_good)[safe]).sum())


def instrument(side: Side):
    """Wrap the tracker's state-machine methods (the same names in both
    packages) so that each frame's branch, track results and init attempts
    land in ``side``."""
    tr = side.tr

    def wrap(name, after, ctx=None, before=None):
        orig = getattr(tr, name)

        def f(*a, **k):
            pre = before() if before else None
            if ctx:
                side.ctx.append(ctx)
            try:
                out = orig(*a, **k)
            finally:
                if ctx:
                    side.ctx.pop()
            after(out, pre, *a, **k)
            return out

        setattr(tr, name, f)

    def track(out, _pre, *a, **k):
        num_match, n_inl, pose = int(out[0]), int(out[1]), np.asarray(out[2], np.float64)
        side.branch.append("track")
        side.tracks.append((num_match, n_inl))
        side.track_poses.append(pose)
        side.track_uvr.append(np.asarray(out[4], np.float32))

    def promote(out, _pre, *a, **k):
        side.branch.append("promoted" if out is not None else "promote_refused")

    def insert(out, _pre, *a, **k):
        where = side.ctx[-1] if side.ctx else "decision"
        if out is None:
            side.branch.append("kf_refused")
        elif where in ("decision", "promoted"):
            side.branch.append("kf_" + where)

    def lost(out, cand, *a, **k):
        if out is None:
            side.branch.append("lost")
            side.lost += 1
            side.collapsed += cand < COLLAPSED

    def reloc(out, _pre, *a, **k):
        side.branch.append("relocalized" if out is not None else "reloc_failed")
        side.relocs += out is not None

    def init(out, held, *a, **k):
        if tr._initialized:
            side.branch.append("initialised")
        elif tr._init_bank is not None and tr._init_bank is not held:
            side.branch.append("init_held")
        elif held is not None:
            side.branch.append("init_attempt")
        else:
            side.branch.append("init_wait")

    def fused_init(out, _pre, *a, **k):
        flat = _np(out)
        K = (len(flat) - 13) // 6
        side.inits.append({"success": bool(flat[0] > 0.5), "matches": int((flat[13 + K : 13 + 2 * K] > 0.5).sum()),
                           "triangulated": int((flat[13 + 2 * K : 13 + 3 * K] > 0.5).sum())})

    wrap("_track_frame_fused", track)
    wrap("_promote_last_frame", promote, ctx="promoted")
    wrap("_insert_keyframe", insert)
    wrap("_handle_lost", lost, before=lambda: reference_candidates(tr))
    wrap("_relocalize", reloc, ctx="relocalize")
    for name in ("_try_initialize", "_init_stereo"):
        wrap(name, init, ctx="init", before=lambda: tr._init_bank)
    if tr._fused_init is not None:
        wrap("_fused_init", fused_init)


def record_jax_matches(ext, draws: Draws):
    """The JAX extractor's traceable matcher, recording each match (ordered
    host callback) before the tracker compiles its fused programs."""
    import jax

    orig = ext.match_traceable

    def match(sg_params, key, b0, b1, outlier_rejection=True, floor=None):
        m = orig(sg_params, key, b0, b1, outlier_rejection, floor=floor)
        jax.debug.callback(draws.record_match, m.idx1, m.score, m.valid, ordered=True)
        return m

    ext.match_traceable = match


def engines(cell: str, draws: Draws):
    """(jax engine, port engine, port probe engine, protocol): the cell's
    production engines, built as the two accuracy scripts build them; the
    JAX extractor records its matches into ``draws``."""
    import jax

    from tests.jax_matrix_reference import bench_accuracy as jax_bench_accuracy
    from ur_mvo_tpu.camera import make_pinhole as jax_pinhole
    from ur_mvo_tpu.config import SensorSetup as JaxSetup
    from ur_mvo_tpu.engine import UR_MVO as JaxEngine
    from ur_mvo_tpu.runtime.extractor import NeuralExtractor as JaxExtractor
    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.cli import bench_accuracy as ba
    from ur_mvo_tpu_torch.config import SensorSetup
    from ur_mvo_tpu_torch.engine import UR_MVO

    jba = jax_bench_accuracy()
    setup, scene = cell.split("/")
    matcher = "sg" if setup == "mono" else "hybrid"
    bf = ba.FX * ba.BASELINE_M if setup == "stereo" else 0.0
    jcfg = jba._production_cfg(matcher)
    jcam = jax_pinhole(ba.W, ba.H, ba.FX, ba.FX, ba.W / 2, ba.H / 2, bf=bf)
    jcfg.superglue.image_width, jcfg.superglue.image_height = jcam.width, jcam.height
    jext = JaxExtractor(jcfg, jcam)
    record_jax_matches(jext, draws)
    jvo = JaxEngine(jcfg, JaxSetup(setup), camera=jcam, extractor=jext)
    cam = make_pinhole(ba.W, ba.H, ba.FX, ba.FX, ba.W / 2, ba.H / 2, bf=bf)
    pvo = UR_MVO(ba.production_cfg(matcher), SensorSetup(setup), camera=cam, device="cpu")
    probe = UR_MVO(ba.production_cfg(matcher), SensorSetup(setup), camera=cam, device="cpu")
    assert jax.default_backend() == "cpu"
    return jvo, pvo, probe, dict(setup=setup, scene=scene, matcher=matcher, ba=ba)


# ---------------------------------------------------------------------------
# State across the packages
# ---------------------------------------------------------------------------

def capture(tr) -> dict:
    """The tracker's per-sequence state: its fields, a copy of the map and
    the backend's loop cooldown (banks are immutable arrays, kept as
    they are)."""
    assert tr.backend._pending_ba is None, "an asynchronous BA is in flight"
    state = {f: (v if f in BANK_FIELDS else copy.deepcopy(v)) for f in TRACKER_FIELDS for v in [getattr(tr, f)]}
    state["store"] = copy.deepcopy(tr.backend.store)
    state["loop_cooldown"] = tr.backend._loop_cooldown
    return state


def jax_bank(bank):
    from ur_mvo_tpu.ops.keypoints import FeatureBank
    import jax.numpy as jnp

    return FeatureBank(*(jnp.asarray(_np(x)) for x in bank))


def port_bank(bank):
    import jax

    from ur_mvo_tpu_torch.weights import feature_bank_from_numpy

    return feature_bank_from_numpy(jax.tree.map(np.asarray, tuple(bank)))


def jax_store_from(src):
    """The port's ``MapStore`` as a JAX ``MapStore`` (``weights.map_store_from``
    the other way round)."""
    from ur_mvo_tpu.runtime.map_store import MapStore, StoreConfig

    c = src.cfg
    st = MapStore(StoreConfig(max_keyframes=c.max_keyframes, max_mappoints=c.max_mappoints,
                              keypoints_per_frame=c.keypoints_per_frame, store_descriptors=c.store_descriptors,
                              descriptor_dim=c.descriptor_dim))
    for name, value in vars(src).items():
        if name != "cfg":
            setattr(st, name, copy.deepcopy(value))
    return st


def load(tr, state: dict, to_port: bool):
    """Give tracker ``tr`` a captured state of the other package."""
    from ur_mvo_tpu_torch.weights import map_store_from

    conv = port_bank if to_port else jax_bank
    for f in TRACKER_FIELDS:
        v = state[f]
        setattr(tr, f, conv(v) if f in BANK_FIELDS and v is not None else copy.deepcopy(v))
    tr.backend.store = map_store_from(state["store"]) if to_port else jax_store_from(state["store"])
    tr.backend._loop_cooldown = state["loop_cooldown"]


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------

def pose_diff(A, B):
    """(rotation angle in degrees, translation distance) between two 4x4."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    c = np.clip((np.trace(A[:3, :3].T @ B[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c))), float(np.linalg.norm(A[:3, 3] - B[:3, 3]))


def differs(a: dict, b: dict):
    """The counts and the branch that differ between two frame records."""
    return [k for k in ("kpts", "matches", "init", "pnp_inliers", "inliers", "branch", "keyframes", "map_points",
                        "poses") if a[k] != b[k]]


def kpt_overlap(bj, bp) -> float:
    kj = _np(bj.kpts)[_np(bj.valid)]
    kp = _np(bp.kpts)[_np(bp.valid)]
    a = {tuple(r) for r in np.round(kj, 2).tolist()}
    b = {tuple(r) for r in np.round(kp, 2).tolist()}
    return len(a & b) / max(len(a), len(b), 1)


def slot_agreement(mj, mp) -> float:
    """Share of slots whose (valid, idx1) agree between two matches."""
    vj, vp = np.asarray(mj[3], bool), _np(mp.valid).astype(bool)
    ij, ip = np.where(vj, np.asarray(mj[1]), -1), np.where(vp, _np(mp.idx1), -1)
    return float((ij == ip).mean())


def poses_within(Tj, Tp, tol_R, tol_t) -> bool:
    """R_cw within ``tol_R`` and t_cw within ``tol_t`` (the fused step's
    outputs), elementwise."""
    def cw(T):
        R = np.asarray(T, np.float64)[:3, :3].T
        return R, -R @ np.asarray(T, np.float64)[:3, 3]

    (Rj, tj), (Rp, tp) = cw(Tj), cw(Tp)
    return bool(np.abs(Rj - Rp).max() <= tol_R and np.abs(tj - tp).max() <= tol_t)


def split_by(stages) -> list:
    """The stages of a transplant that already differ on identical inputs,
    in the order the frame runs them: where the two runs' rounding parts."""
    out = []
    e, m = stages.get("extract"), stages.get("match")
    if e and e["kpt_overlap"] < 1.0:
        out.append({"stage": "extract", "kpt_overlap": e["kpt_overlap"]})
    if m and (m["slot_agreement"] < 1.0 or m["jax"] != m["port"]):
        out.append({"stage": "match", "slot_agreement": m["slot_agreement"], "jax": m["jax"], "port": m["port"]})
    c = stages.get("track")
    if c and any(c["gap"].values()):
        out.append({"stage": "track core", **c["gap"]})
    for b in stages.get("ba") or []:
        if any(b["as_run"][k] > 0 for k in ("R", "t", "X")):
            out.append({"stage": "window BA", **b["as_run"]})
    return out


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

class Lockstep:
    def __init__(self, cell: str, banks: str = "own", out=None, render: str = "port", save_ba=None):
        import torch

        torch.set_num_threads(1)
        self.cell, self.banks_mode, self.render = cell, banks, render
        self.draws = Draws(jax_sampler())
        self.pnp = {"jax": [], "port": []}
        self.jvo, self.pvo, self.probe, self.proto = engines(cell, self.draws)
        self.patches = install(self.draws, self.pnp)
        self.J, self.P, self.Q = Side("jax", self.jvo), Side("port", self.pvo), Side("probe", self.probe)
        for s in (self.J, self.P, self.Q):
            instrument(s)
        self._hook_banks()
        self.ba_log = []
        backend, ba = self.jvo.tracker.backend, self.jvo.tracker.backend._ba
        self._jax_ba, self._jax_core = ba, None

        def jax_ba(flat):
            res = ba(flat)
            self.ba_log.append((np.array(flat), np.array(res)))
            return res

        backend._ba = jax_ba
        self.out, self.save_ba = out, save_ba

    def close(self):
        self.patches.undo()

    def emit(self, obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if self.out is not None:
            self.out.write(line + "\n")
            self.out.flush()

    def _hook_banks(self):
        """Each engine's ``_extract_banks`` records the frame's banks and,
        under ``--banks``, hands one side the other side's."""
        J, P = self.J, self.P
        jx, px = self.jvo._extract_banks, self.pvo._extract_banks

        def jax_extract(data):
            if self.banks_mode == "port":
                b, br = self._port_banks
                out = (jax_bank(b), None if br is None else jax_bank(br))
            else:
                out = jx(data)
            J.bank, J.bank_right = out
            return out

        def port_extract(data):
            if self.banks_mode == "jax":
                out = (port_bank(J.bank), None if J.bank_right is None else port_bank(J.bank_right))
            elif self.banks_mode == "port":
                out = self._port_banks
            else:
                out = px(data)
            P.bank, P.bank_right = out
            return out

        self.jvo._extract_banks, self.pvo._extract_banks = jax_extract, port_extract
        self._port_extract_own = px

    def frames(self, seed: int, n: int):
        """The cell's frames, rendered once by ``render``'s package (the two
        renderers differ by one grey level at ~160 of a sequence's 1.8M
        pixels), as each package's ``Frame``."""
        from ur_mvo_tpu import components as jc
        from ur_mvo_tpu_torch import components as pc

        if self.render == "jax":
            from ur_mvo_tpu.utils.synthscene import render_sequence
        else:
            from ur_mvo_tpu_torch.utils.synthscene import render_sequence

        ba = self.proto["ba"]
        setup = self.proto["setup"]
        baseline = ba.BASELINE_M if setup == "stereo" else 0.0
        out = render_sequence(n, ba.H, ba.W, ba.FX, seed=seed, baseline=baseline, **ba.SCENES[self.proto["scene"]])
        made = []
        for mod in (jc, pc):
            fs = []
            for i in range(n):
                f = mod.Frame(image=mod.Image(out[0][i], i / ba.FPS))
                if setup == "stereo":
                    f.right_image = mod.Image(out[3][i], i / ba.FPS)
                if setup == "rgbd":
                    f.depth_map = mod.DepthMap(out[2][i])
                fs.append(f)
            made.append(fs)
        return made[0], made[1], out[1]

    def _emit_poses(self, side, i, poses, fps):
        side.pending.append(i / fps)
        if poses:
            for t, p in zip(side.pending[-len(poses):], poses):
                side.ts_out.append(t)
                side.pos_out.append(p.translation)
            side.pending.clear()

    def gt_error(self, side, i, T_wc):
        """Metric setups: the distance from the side's pose of frame ``i``
        to the truth, both in the frame of the side's first keyframe (the
        camera it initialised at); None for mono (no scale)."""
        if self.proto["setup"] == "mono" or side.init_at is None:
            return None
        T0 = np.asarray(T_wc[side.init_at], np.float64)
        rel = np.linalg.inv(T0) @ np.asarray(T_wc[i], np.float64)
        return float(np.linalg.norm(np.asarray(side.tr._last_pose, np.float64)[:3, 3] - rel[:3, 3]))

    def run(self, seed: int, n: int = 24, transplant: str = "first", reverse: bool = False):
        import jax

        fps = self.proto["ba"].FPS
        jframes, pframes, T_wc = self.frames(seed, n)
        self.jvo.reset()
        self.pvo.reset()
        J, P = self.J, self.P
        for s in (J, P):
            s.reset()
        first = first_branch = None
        port_state_at = {}
        transplants = {"logic difference": [], "rounding carried forward": []}
        for i in range(n):
            self.draws.start()
            for v in self.pnp.values():
                v.clear()
            self.ba_log.clear()
            J.start()
            P.start()
            jstate = capture(self.jvo.tracker) if transplant != "none" else None
            pstate = capture(self.pvo.tracker) if reverse else None
            pengine = (self.pvo.last_pose, self.pvo.accumulated_samples, list(P.ts_out), list(P.pos_out),
                       list(P.pending), (P.lost, P.collapsed, P.relocs))
            if self.banks_mode == "port":
                self._port_banks = self._port_extract_own(pframes[i])
            jposes = self.jvo.process(jframes[i])
            jax.effects_barrier()
            jlog, jpnp, jba = list(self.draws.log), list(self.pnp["jax"]), list(self.ba_log)
            if self.save_ba:
                self.write_ba(seed, i, jba)
            self.draws.arm()
            pposes = self.pvo.process(pframes[i])
            unused = self.draws.leftover()
            P.keys.append(list(self.draws.port_keys))
            P.banks_seq.append((P.bank, P.bank_right))
            self._emit_poses(J, i, jposes, fps)
            self._emit_poses(P, i, pposes, fps)
            for s in (J, P):
                if s.init_at is None and s.tr._initialized:
                    s.init_at = i
            rj, rp = J.record(jpnp), P.record(list(self.pnp["port"]))
            P.records.append(rp)
            dR, dt = pose_diff(self.jvo.tracker._last_pose, self.pvo.tracker._last_pose)
            diff = differs(rj, rp)
            self.emit({"frame": i, "seed": seed, "jax": rj, "port": rp, "differs": diff,
                       "kpt_overlap": None if J.bank is None or P.bank is None else kpt_overlap(J.bank, P.bank),
                       "pose_dR_deg": dR, "pose_dt": dt,
                       "gt_error": {"jax": self.gt_error(J, i, T_wc), "port": self.gt_error(P, i, T_wc)},
                       "draws": {"paired": self.draws.paired, "on_other_masks": self.draws.on_other_masks,
                                 "unpaired": self.draws.unpaired, "jax_unused": unused}})
            new_first = first is None and bool(diff)
            new_branch = first_branch is None and "branch" in diff
            if new_first:
                first = {"frame": i, "differs": {k: [rj[k], rp[k]] for k in diff}}
            if new_branch:
                first_branch = {"frame": i, "jax": rj["branch"], "port": rp["branch"]}
                port_state_at = {"frame": i, "state": pstate, "engine": pengine}
            if (transplant == "all" and diff) or (transplant == "first" and (new_first or new_branch)):
                t = self.transplant(i, jstate, jlog, jba, rj, jposes is not None, pframes[i], seed)
                if new_first:
                    first["split_by"] = split_by(t["stages"])
                transplants[t["class"]].append(i)
                if t["logic"]:
                    transplants.setdefault("logic", {})[i] = t["logic"]
                self.emit(t)
        summary = {"run": self.cell, "seed": seed, "banks": self.banks_mode, "render": self.render,
                   "first_divergence": first, "first_branch_divergence": first_branch,
                   "transplanted_frames": transplants}
        for s in (J, P):
            summary[s.name] = self.health(s, n, T_wc)
        self.emit(summary)
        if reverse and port_state_at:
            self.reverse(seed, n, port_state_at, jframes, T_wc)
        return summary

    def write_ba(self, seed, i, jba):
        """``--save-ba DIR``: each window BA of the JAX engine's frame, its
        packed problem (``Backend._ba``'s input) and the JAX result, as
        ``CELL_SEED_fFRAME_bK.npz`` (``flat``, ``jax``, ``dims`` (F, P, O))."""
        os.makedirs(self.save_ba, exist_ok=True)
        for k, (flat, res) in enumerate(jba):
            name = f"{self.cell.replace('/', '_')}_{seed}_f{i}_b{k}.npz"
            np.savez_compressed(os.path.join(self.save_ba, name), flat=flat, jax=res,
                                dims=np.asarray(self.jvo.tracker.backend._ba_dims))

    def health(self, side, n, T_wc):
        from ur_mvo_tpu_torch.utils.metrics import ate_rmse

        fps = self.proto["ba"].FPS
        ate = None
        if len(side.ts_out) >= 5:
            idx = np.clip((np.asarray(side.ts_out) * fps).round().astype(int), 0, n - 1)
            ate = float(ate_rmse(np.asarray(side.pos_out), T_wc[idx][:, :3, 3], align=True,
                                 correct_scale=self.proto["setup"] == "mono"))
        return {"ate": ate, "poses": len(side.ts_out), "keyframes": int(side.tr.backend.store.num_keyframes()),
                "frames_lost": side.lost, "frames_lost_collapsed": side.collapsed, "relocalizations": side.relocs,
                "initialised_at_frame": side.init_at}

    def jax_exact_ba(self):
        """The JAX backend's window BA program on the ``"scatter"`` assembly
        (exact float32 summands; its ``"auto"`` route rounds the point
        side's summands to bf16), same packed I/O and schedule."""
        if getattr(self, "_jax_exact_ba", None) is None:
            import jax
            import jax.numpy as jnp

            from ur_mvo_tpu.ops.ba import BAConfig, BAProblem, bundle_adjust

            cfg, cam = self.jvo.config, self.jvo.tracker.camera
            bc, oc = cfg.backend, cfg.backend_optimization
            ba_cfg = BAConfig(chi2_mono=oc.mono_point, chi2_stereo=oc.stereo_point, iters_phase1=bc.ba_iterations_phase1,
                              iters_phase2=bc.ba_iterations_phase2, tol=bc.ba_tol, assembly="scatter",
                              max_free_frames=((min(bc.window_opt_frames, bc.fix_older_than) + 1 + 7) // 8) * 8)
            F, P_, O = self.jvo.tracker.backend._ba_dims

            @jax.jit
            def ba(flat):
                fp, pp = flat[: 14 * F].reshape(F, 14), flat[14 * F : 14 * F + 4 * P_].reshape(P_, 4)
                op = flat[14 * F + 4 * P_ :].reshape(O, 6)
                prob = BAProblem(R_wc=fp[:, 0:9].reshape(-1, 3, 3), t_wc=fp[:, 9:12], frame_valid=fp[:, 12] > 0.5,
                                 frame_fixed=fp[:, 13] > 0.5, X=pp[:, 0:3], point_valid=pp[:, 3] > 0.5,
                                 obs_frame=op[:, 0].astype(jnp.int32), obs_point=op[:, 1].astype(jnp.int32),
                                 obs_uv=op[:, 2:5], obs_valid=op[:, 5] > 0.5)
                res = bundle_adjust(prob, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, ba_cfg)
                return jnp.concatenate([res.R_wc.reshape(-1), res.t_wc.reshape(-1), res.X.reshape(-1),
                                        res.obs_inlier.astype(jnp.float32)])

            self._jax_exact_ba = ba
        return self._jax_exact_ba

    def ba_stage(self, jba):
        """Each window BA of the JAX step, solved again on the identical
        packed problem: the JAX package's as run (``"auto"``: bf16
        point-side summands) and exact (``"scatter"``), the port's with
        bf16 point-side summands and with exact ones (its backend takes
        bf16 for RGB-D only, ROADMAP C6/C7). The pairs of like numerics
        show whether the two BAs compute the same thing; ``as_run`` is
        what the two engines' BAs gave."""
        import jax.numpy as jnp

        b = self.probe.tracker.backend
        F, P_, O = b._ba_dims
        out = []
        for flat, jres in jba:
            fv = flat[: 14 * F].reshape(F, 14)[:, 12] > 0.5
            pv = flat[14 * F : 14 * F + 4 * P_].reshape(P_, 4)[:, 3] > 0.5
            ov = flat[14 * F + 4 * P_ :].reshape(O, 6)[:, 5] > 0.5

            def parts(r):
                r = np.asarray(r, np.float64)
                return (r[: 9 * F].reshape(F, 9)[fv], r[9 * F : 12 * F].reshape(F, 3)[fv],
                        r[12 * F : 12 * F + 3 * P_].reshape(P_, 3)[pv], r[12 * F + 3 * P_ :][ov] > 0.5)

            def gap(a, c):
                (Ra, ta, Xa, ia), (Rc, tc, Xc, ic) = parts(a), parts(c)
                return {"R": float(np.abs(Ra - Rc).max()), "t": float(np.abs(ta - tc).max()),
                        "X": float(np.abs(Xa - Xc).max()), "inlier_agreement": float((ia == ic).mean())}

            port = {bf: _np(b._ba(flat.copy(), b._ba_cfg._replace(bf16_point_side=bf))) for bf in (True, False)}
            jexact = np.asarray(self.jax_exact_ba()(jnp.asarray(flat)))
            # each package's own BA under one-ulp moves of its starting
            # poses and points (up and down): how far the window carries
            # rounding
            spread = {"R": 0.0, "t": 0.0, "X": 0.0}
            jspread = dict(spread)
            for cols, part, to in (((9, 12), "frames", np.inf), ((9, 12), "frames", -np.inf),
                                   ((0, 3), "points", np.inf), ((0, 3), "points", -np.inf)):
                nudged = flat.copy()
                if part == "frames":
                    v = nudged[: 14 * F].reshape(F, 14)
                    v[fv, cols[0]:cols[1]] = np.nextafter(v[fv, cols[0]:cols[1]], np.float32(to))
                else:
                    v = nudged[14 * F : 14 * F + 4 * P_].reshape(P_, 4)
                    v[pv, cols[0]:cols[1]] = np.nextafter(v[pv, cols[0]:cols[1]], np.float32(to))
                g = gap(port[b._ba_cfg.bf16_point_side], _np(b._ba(nudged)))
                spread = {k: max(spread[k], g[k]) for k in spread}
                g = gap(jres, np.asarray(self._jax_ba(jnp.asarray(nudged))))
                jspread = {k: max(jspread[k], g[k]) for k in jspread}
            out.append({"frames": int(fv.sum()), "points": int(pv.sum()), "observations": int(ov.sum()),
                        "as_run": gap(jres, port[b._ba_cfg.bf16_point_side]),
                        "bf16_summands": gap(jres, port[True]), "exact_summands": gap(jexact, port[False]),
                        "jax_bf16_vs_exact": gap(jres, jexact), "port_one_ulp_spread": spread,
                        "jax_one_ulp_spread": jspread})
        return out

    def track_stage(self, tr, jlog, rj):
        """The fused track core of both packages (``fused_track_core``:
        candidate scatter, PnP, pose GN, the jump guard's rescue) on
        identical inputs: the match and the PnP key of the JAX engine's
        first track of the frame (the port taking that call's minimal
        sets), the snapshot of the transplanted state. Beside the gap, each
        package's spread under one-ulp moves of the snapshot's points and
        of its last pose (up and down), and the gap between the JAX core
        run alone and the same core inside the engine's program (one code,
        two compilations). Within where the inlier counts differ by at most
        twice the largest count spread and, where both sides keep their
        pose (enough inliers), the poses by at most the fused step's limits
        or twice the largest pose spread."""
        import jax
        import jax.numpy as jnp
        import torch

        from ur_mvo_tpu.ops.matching import Matches as JaxMatches
        from ur_mvo_tpu.runtime import frontend as jfront
        from ur_mvo_tpu_torch.runtime import frontend as pfront
        from ur_mvo_tpu_torch.weights import matches_from_numpy

        k_pnp = next(k for k, e in enumerate(jlog) if e[0] == "draw" and e[3].shape[1] == 6)
        k_match = max(k for k in range(k_pnp) if jlog[k][0] == "match")
        key, sets = jlog[k_pnp][1], torch.from_numpy(np.array(jlog[k_pnp][3], np.int64))
        idx1, score, mvalid = jlog[k_match][1:]
        cfg, cam, jt = self.probe.config, tr.camera, self.jvo.tracker
        rt, kf, topt = cfg.runtime, cfg.keyframe, cfg.tracking_optimization
        min_match = kf.min_num_match
        consts = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, topt.mono_point, topt.stereo_point,
                  rt.pnp_ransac_iterations, rt.pnp_reprojection_threshold, min_match, 4.0 * kf.max_distance)
        if self._jax_core is None:
            self._jax_core = jax.jit(lambda key, i, sc, v, uvr, snap: jfront.fused_track_core(
                key, JaxMatches(idx1=i, score=sc, valid=v), uvr, snap, jt.K_mat, *consts))
        uvr = np.array(self.J.track_uvr[0], np.float32)
        snap = tr.fused_snapshot()
        m = matches_from_numpy((idx1, score, mvalid))

        def jax_row(sn):
            with self.patches.suspended():  # traced without the recording callbacks
                return np.asarray(self._jax_core(*(jnp.asarray(x) for x in (key, idx1, score, mvalid, uvr, sn))))

        def port_row(sn):
            with torch.no_grad():
                row, _ = pfront.fused_track_core(None, m, torch.from_numpy(uvr), torch.from_numpy(sn), tr.K_mat,
                                                 *consts, pnp_sets=sets, plain=True)
            return _np(row)

        def parts(row):
            return int(row[1]), np.asarray(row[2:11], np.float64), np.asarray(row[11:14], np.float64)

        def gap(a, b):
            (na, Ra, ta), (nb, Rb, tb) = parts(a), parts(b)
            if min(na, nb) < min_match:  # a side drops its pose: the counts tell
                return {"n": abs(na - nb), "R": 0.0, "t": 0.0}
            return {"n": abs(na - nb), "R": float(np.abs(Ra - Rb).max()), "t": float(np.abs(ta - tb).max())}

        def nudged(rows, cols, to):
            sn = snap.copy()
            sn[rows, cols] = np.nextafter(sn[rows, cols], np.float32(to))
            return sn

        pts = snap[:, 3] > 1.5
        moves = [nudged(pts, slice(0, 3), to) for to in (np.inf, -np.inf)] + \
                [nudged(slice(0, 12), 5, to) for to in (np.inf, -np.inf)]
        jr, pr = jax_row(snap), port_row(snap)
        spreads = {}
        for name, fn, base in (("port", port_row, pr), ("jax", jax_row, jr)):
            gs = [gap(base, fn(sn)) for sn in moves]
            spreads[name] = {k: max(g[k] for g in gs) for k in ("n", "R", "t")}
        # the JAX engine's own row of this track, as its tracker read it
        Tj = np.asarray(self.J.track_poses[0], np.float64)
        Rj = Tj[:3, :3].T
        engine = np.concatenate([[0.0, rj["inliers"][0]], Rj.reshape(-1), -Rj @ Tj[:3, 3]])
        spreads["jax_alone_vs_engine"] = gap(engine, jr)
        g = gap(jr, pr)
        top = {k: max(sp[k] for sp in spreads.values()) for k in ("n", "R", "t")}
        within = g["n"] <= 2 * top["n"] and g["R"] <= max(R_TOL, 2 * top["R"]) and g["t"] <= max(T_TOL, 2 * top["t"])
        return {"jax": parts(jr)[0], "port": parts(pr)[0], "gap": g, "spreads": spreads, "within": bool(within)}

    @staticmethod
    def classify(diff, stages, first_track_ok, later_tracks_ok, final_ok):
        """(logic, rounding): what differs on identical inputs that no
        stage accounts for, and what the stages account for as rounding.

        - The frame's first track (its counts or pose): rounding where the
          two packages' fused track cores on identical inputs lie within
          their limits or spreads (``track_stage``). A branch that parts at
          a first track that differs follows it: what comes after it in the
          frame is not classed again.
        - A later track of the frame, the live map points or the final pose
          beyond the BA test's limit: these follow the step's window BA (a
          later track runs against the keyframe the promotion just
          adjusted). Rounding where each BA, solved by both packages on the
          identical problem as each engine runs it, lies within that limit
          or within twice either package's one-ulp spread; where only the
          like-numerics pair (bf16 point-side summands on both sides) does,
          the port's exact summands are what differs (ROADMAP C7). Without
          a BA, a final pose follows the first track.
        - The branch, keyframes or the emitted pose: downstream of the
          above where one of them differs, else a logic difference; so is
          an init attempt that differs."""
        logic, rounding = [], []
        track_rounding = bool(stages.get("track")) and stages["track"]["within"]
        if not first_track_ok:
            (rounding if track_rounding else logic).append("track")
        parted = not first_track_ok and bool(diff & {"branch", "keyframes", "emitted"})
        bas = stages.get("ba") or []

        def within(pair):
            return bool(bas) and all(b[pair][k] <= max(BA_TOL, 2 * b["port_one_ulp_spread"][k],
                                                       2 * b.get("jax_one_ulp_spread", {}).get(k, 0.0))
                                     for b in bas for k in ("R", "t"))

        if not parted and (not later_tracks_ok or "map_points" in diff or not final_ok):
            if within("as_run"):
                rounding.append("window BA")
            elif within("bf16_summands"):
                logic.append("window BA point-side summands (C7)")
            elif bas:
                logic.append("window BA")
            elif later_tracks_ok and (first_track_ok or track_rounding):
                (rounding if not first_track_ok else logic).append("track" if not first_track_ok else "final pose")
            else:
                logic.append("track")
        if "init" in diff:
            logic.append("init")
        if diff & {"branch", "keyframes", "emitted"} and not (logic or rounding):
            logic.append("branch")
        return sorted(set(logic)), sorted(set(rounding))

    def transplant(self, i, jstate, jlog, jba, rj, jemitted, pframe, seed):
        """The port's step given the JAX engine's inputs of frame ``i``."""
        import torch

        Q, tr = self.Q, self.probe.tracker
        self.probe.reset()
        Q.reset()
        load(tr, jstate, to_port=True)
        jb, jbr = self.J.bank, self.J.bank_right
        bank, bank_right = port_bank(jb), None if jbr is None else port_bank(jbr)
        stages = {}
        # the port's own extraction of the same image against the JAX bank
        own = self._port_extract_own(pframe)[0]
        stages["extract"] = {"kpt_overlap": kpt_overlap(jb, own), "jax_kpts": int(_np(jb.valid).sum()),
                             "port_kpts": int(_np(own.valid).sum())}
        # the port's matcher on the JAX banks and the JAX draw of the
        # frame's first match, against that match
        first = next((k for k, e in enumerate(jlog) if e[0] == "match"), None)
        anchor = jstate["_ref_bank"] if jstate["_initialized"] else jstate["_init_bank"]
        if first is not None and first > 0 and jlog[first - 1][0] == "draw" and anchor is not None \
                and not (self.proto["setup"] == "stereo" and jstate["_initialized"]):
            floor = None if jstate["_initialized"] else (self.probe.config.superglue.nn_fallback_min_matches_init or None)
            self.draws.queue = [jlog[first - 1]]
            self.draws.paired = self.draws.on_other_masks = self.draws.unpaired = 0
            m = self.probe.extractor.match(port_bank(anchor), bank, True, floor=floor)
            jm = jlog[first]
            stages["match"] = {"jax": int(np.asarray(jm[3]).sum()), "port": int(_np(m.valid).sum()),
                               "slot_agreement": slot_agreement(jm, m), "same_mask_draw": self.draws.paired == 1}
        if jba:
            stages["ba"] = self.ba_stage(jba)
        if self.J.tracks:
            stages["track"] = self.track_stage(tr, jlog, rj)
        # the step itself: JAX state, bank, matches and draws; an injected
        # match takes its F-RANSAC draw (the entry before it) off the queue
        jmatches = [(jlog[k - 1] if k and jlog[k - 1][0] == "draw" else None, e)
                    for k, e in enumerate(jlog) if e[0] == "match"]
        ext = self.probe.extractor
        real_match = ext.match

        def injected(b0, b1, outlier_rejection=True, floor=None):
            from ur_mvo_tpu_torch.weights import matches_from_numpy

            if not jmatches:
                return real_match(b0, b1, outlier_rejection, floor=floor)
            d, e = jmatches.pop(0)
            q = self.draws.queue
            drop = [j for j, x in enumerate(q) if x is d]
            if drop:
                del q[drop[0]]
            return matches_from_numpy((e[1], e[2], e[3]))

        self.draws.queue = [e for e in jlog if e[0] == "draw"]
        self.draws.paired = self.draws.on_other_masks = self.draws.unpaired = 0
        self.pnp["port"].clear()
        ext.match = injected
        Q.start()
        Q.bank = bank
        try:
            with torch.no_grad():
                out = tr.process(bank, i / self.proto["ba"].FPS, self.probe._make_depth_lookup(pframe),
                                 bank_right=bank_right)
        finally:
            ext.match = real_match
        rq = Q.record(list(self.pnp["port"]))
        rq["poses"] = rj["poses"]  # the engine's count, not the step's
        rq["emitted"], rj = out is not None, dict(rj, emitted=jemitted)
        diff = [k for k in differs(rj, rq) + ["emitted"] if rj[k] != rq[k]]
        sp = list((stages.get("track") or {}).get("spreads", {}).values()) or [{"R": 0.0, "t": 0.0}]
        tol_R, tol_t = max(R_TOL, 2 * max(x["R"] for x in sp)), max(T_TOL, 2 * max(x["t"] for x in sp))
        same = [a == b and poses_within(pa, pb, tol_R, tol_t)
                for a, b, pa, pb in zip(self.J.tracks, Q.tracks, self.J.track_poses, Q.track_poses)]
        first_ok = bool(same) and same[0] and rj["pnp_inliers"][:1] == rq["pnp_inliers"][:1]
        later_ok = len(self.J.tracks) == len(Q.tracks) and all(same[1:]) and rj["pnp_inliers"][1:] == rq["pnp_inliers"][1:]
        track_ok = (first_ok or not self.J.tracks) and later_ok
        # without a BA the final pose is the track's: the track's limits hold
        final_ok = poses_within(self.jvo.tracker._last_pose, tr._last_pose, max(BA_TOL, tol_R), max(BA_TOL, tol_t))
        logic, rounding = self.classify(set(diff), stages, first_ok or not self.J.tracks, later_ok, final_ok)
        dR, dt = pose_diff(self.jvo.tracker._last_pose, tr._last_pose)
        return {"transplant": i, "seed": seed, "class": "logic difference" if logic else "rounding carried forward",
                "logic": logic, "rounding": rounding,
                "differs": {k: [rj[k], rq[k]] for k in diff}, "track_pose_within": track_ok,
                "final_pose_within": final_ok, "final_dR_deg": dR, "final_dt": dt,
                "draws": {"paired": self.draws.paired, "on_other_masks": self.draws.on_other_masks,
                          "unpaired": self.draws.unpaired, "jax_unused": self.draws.leftover()},
                "matches_unused": len(jmatches), "stages": stages}

    def reverse(self, seed, n, at, jframes, T_wc):
        """The JAX engine in lock step with the port's recorded run, from
        the port's state before the first branch divergence to the end of
        the seed: the port's tracker state, map, engine pose and pending
        frames, the port's banks, and each JAX call sampling with the key
        the port's call used. One ``"reverse_frame"`` line a frame (the JAX
        side against the port's record), then a ``"reverse"`` line with the
        first divergence and the JAX side's health."""
        import jax

        from ur_mvo_tpu.components import Pose

        fps = self.proto["ba"].FPS
        i0 = at["frame"]
        jvo, J, P = self.jvo, self.J, self.P
        jvo.reset()
        J.reset()
        load(jvo.tracker, at["state"], to_port=False)
        last, jvo.accumulated_samples, ts_out, pos_out, pending, (J.lost, J.collapsed, J.relocs) = at["engine"]
        jvo.last_pose = None if last is None else Pose(last.rotation, last.translation)
        J.ts_out, J.pos_out, J.pending = list(ts_out), list(pos_out), list(pending)
        J.init_at = P.init_at if P.init_at is not None and P.init_at < i0 else None
        mode, self.banks_mode = self.banks_mode, "port"
        first = None
        try:
            for i in range(i0, n):
                J.start()
                self.draws.start()
                for v in self.pnp.values():
                    v.clear()
                self.draws.override = list(P.keys[i])
                self.draws.overridden = self.draws.not_overridden = 0
                self._port_banks = P.banks_seq[i]
                self._emit_poses(J, i, jvo.process(jframes[i]), fps)
                jax.effects_barrier()
                if J.init_at is None and J.tr._initialized:
                    J.init_at = i
                rj = J.record(list(self.pnp["jax"]))
                diff = differs(rj, P.records[i])
                self.emit({"reverse_frame": i, "seed": seed, "jax": rj, "port": P.records[i], "differs": diff,
                           "keys": {"port_calls": len(P.keys[i]), "taken": self.draws.overridden,
                                    "own": self.draws.not_overridden, "left": len(self.draws.override)}})
                if first is None and diff:
                    first = {"frame": i, "differs": {k: [rj[k], P.records[i][k]] for k in diff}}
        finally:
            self.banks_mode = mode
            self.draws.override = None
        self.emit({"reverse": self.cell, "seed": seed, "from_frame": i0, "first_divergence": first,
                   "jax_from_port_state": self.health(J, n, T_wc), "port": self.health(P, n, T_wc)})


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m tests.jax_lockstep")
    ap.add_argument("cell", help="setup/scene of cli.bench_accuracy, e.g. mono/3d")
    ap.add_argument("seeds", help="comma list, e.g. 11,12,13")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--banks", choices=("own", "jax", "port"), default="own",
                    help="own: each engine extracts; jax / port: both take that side's banks")
    ap.add_argument("--transplant", choices=("first", "all", "none"), default="first")
    ap.add_argument("--reverse", action="store_true",
                    help="run the JAX engine from the port's state at the first branch divergence")
    ap.add_argument("--render", choices=("port", "jax"), default="port",
                    help="whose renderer draws the frames (cli.bench_accuracy's is the port's)")
    ap.add_argument("--out", default=None, help="directory for CELL_BANKS_SEED.jsonl copies of the lines")
    ap.add_argument("--save-ba", default=None, help="directory for each JAX window BA's problem and result (npz)")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    ls = Lockstep(args.cell, args.banks, render=args.render, save_ba=args.save_ba)
    try:
        for seed in [int(s) for s in args.seeds.split(",")]:
            f = None
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                name = f"{args.cell.replace('/', '_')}_{args.banks}{'_jaxrender' if args.render == 'jax' else ''}_{seed}"
                f = open(os.path.join(args.out, name + ".jsonl"), "w")
            ls.out = f
            t0 = time.time()
            ls.run(seed, args.frames, args.transplant, args.reverse)
            print(f"# seed {seed}: {time.time() - t0:.0f} s", file=sys.stderr, flush=True)
            if f:
                f.close()
    finally:
        ls.close()


if __name__ == "__main__":
    main()
