"""The JAX package on a cell of ``scripts/bench_accuracy.py``'s short
matrix, scene seed by scene seed, on the CPU: the reference that
``chip_smoke.py`` phase 18's per-run health is read against.

For each seed, one JSON line: the ATE of the emitted trajectory
(scale-corrected for mono only; None below 5 poses, a failed run), the
keyframes, the poses emitted, and the frames lost and relocalizations
counted as the port's tracker counts them (a frame that ``_handle_lost``
could not re-anchor is lost, one that ``_relocalize`` re-anchored is a
relocalization), with the lost frames whose reference keyframe held fewer
than 6 triangulated points counted apart (``frames_lost_collapsed``). The cell's production matcher (mono ``sg``, stereo and
RGB-D ``hybrid``) and configuration (``_production_cfg``); one engine,
``reset`` between seeds, as the script runs it.

Run from the root of the repository:

    JAX_PLATFORMS=cpu python -m tests.jax_matrix_reference mono/plane 11,12,13

(~1 min a seed on one CPU core after the first seed's compile). Not a
test module: pytest collects nothing here.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_accuracy():
    """``scripts/bench_accuracy.py`` as a module (it imports no JAX at
    module level)."""
    spec = importlib.util.spec_from_file_location("jax_bench_accuracy",
                                                  os.path.join(REPO, "scripts", "bench_accuracy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_candidates(tr):
    """The triangulated points of the tracker's reference keyframe, as the
    port's ``fused_snapshot`` flags them (live, good, not bad)."""
    import numpy as np

    st = tr.backend.store
    ref = np.asarray(st.kf_track[tr._ref_slot])
    safe = np.maximum(ref, 0)
    live = (ref >= 0) & ~np.asarray(st.mp_bad)[safe]
    return int((live & np.asarray(st.mp_good)[safe]).sum())


def counting(vo):
    """``vo`` with ``vo.count`` = {"lost", "reloc", "collapsed"} kept as
    the port's tracker keeps its ``frames_lost`` and ``relocalizations``;
    ``collapsed`` counts the lost frames whose reference keyframe held
    fewer than 6 triangulated points (a collapsed map, ROADMAP C11)."""
    tr, count = vo.tracker, {"lost": 0, "reloc": 0, "collapsed": 0}
    handle_lost, relocalize = tr._handle_lost, tr._relocalize

    def lost(*a, **k):
        cand = reference_candidates(tr)
        out = handle_lost(*a, **k)
        count["lost"] += out is None
        count["collapsed"] += out is None and cand < 6
        return out

    def reloc(*a, **k):
        out = relocalize(*a, **k)
        count["reloc"] += out is not None
        return out

    tr._handle_lost, tr._relocalize, vo.count = lost, reloc, count
    return vo


def reference_runs(cell, seeds, frames=24):
    """One JSON line a seed of ``cell`` (``setup/scene``) in the JAX package."""
    import numpy as np

    from ur_mvo_tpu.camera import make_pinhole
    from ur_mvo_tpu.config import SensorSetup
    from ur_mvo_tpu.engine import UR_MVO
    from ur_mvo_tpu.utils.metrics import ate_rmse
    from ur_mvo_tpu.utils.synthscene import render_sequence

    ba = bench_accuracy()
    setup, scene = cell.split("/")
    baseline = ba.BASELINE_M if setup == "stereo" else 0.0
    cfg = ba._production_cfg("sg" if setup == "mono" else "hybrid")
    vo = counting(UR_MVO(cfg, SensorSetup(setup),
                         camera=make_pinhole(ba.W, ba.H, ba.FX, ba.FX, ba.W / 2, ba.H / 2, bf=ba.FX * baseline)))
    for seed in seeds:
        out = render_sequence(frames, ba.H, ba.W, ba.FX, seed=seed, baseline=baseline, **ba.SCENES[scene])
        vo.reset()
        vo.count.update(lost=0, reloc=0, collapsed=0)
        ts, pos = ba._run_sequence(vo, out[0], out[3] if setup == "stereo" else None, out[2], setup)
        row = {"cell": cell, "seed": seed, "ate": None}
        if len(ts) >= 5:
            idx = np.clip((ts * ba.FPS).round().astype(int), 0, frames - 1)
            row["ate"] = float(ate_rmse(pos, out[1][idx][:, :3, 3], align=True, correct_scale=setup == "mono"))
        row.update(keyframes=vo.tracker.backend.store.num_keyframes(), frames_lost=vo.count["lost"],
                   frames_lost_collapsed=vo.count["collapsed"], relocalizations=vo.count["reloc"],
                   poses_emitted=len(ts))
        print(json.dumps(row), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit("usage: python -m tests.jax_matrix_reference CELL SEEDS  (e.g. mono/plane 11,12,13)")
    import jax

    jax.config.update("jax_platforms", "cpu")
    reference_runs(argv[0], [int(s) for s in argv[1].split(",")])


if __name__ == "__main__":
    main()
