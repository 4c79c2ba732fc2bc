"""Standing multi-seed accuracy benchmark over the synthetic scene matrix
(the port of ``scripts/bench_accuracy.py``).

The matrix is {plane, 3d, decay} x {mono, stereo, rgbd} x N seeds with the
production configuration: a 24-frame run swings with the PnP samplers'
draws alone, so every number is a seed mean with its spread. ``--long``
runs the loop-bearing protocol: 120 frames of an out-and-back path at
480x640 with culling, loop closure and relocalization on, and scores the
keyframe trajectory after ``global_optimize()`` too.

ATE protocol: mono is Umeyama-aligned with scale correction (the
reference's ``evo_ape --align --correct_scale``); stereo and RGB-D are
aligned without it, since they observe metric scale. A run that emits
fewer than 5 poses has failed and is scored at the ground truth's extent
in ``mean``. ``pgo_mean`` (``--long``) is the mean over the runs that did
not fail: a failed run skips ``global_optimize``, as in the JAX script.

On a CUDA device the run takes PyTorch's deterministic algorithms (the
window BA's ``index_add_`` adds with atomics otherwise, and two runs would
not share their bits); the caller's setting is restored on return.

Writes ``ACCURACY_TORCH.json`` at the repository root unless ``--out``
names another file, merging into it (a partial run updates only its
cells; runs that share the file take it in turn). The scenes are rendered
ahead of the runs in a worker thread, each once for all the matchers and
setups that run it.

Usage:
  python -m ur_mvo_tpu_torch.cli.bench_accuracy                        # the whole matrix on the card
  python -m ur_mvo_tpu_torch.cli.bench_accuracy --cells mono/plane,rgbd/3d --seeds 2
  python -m ur_mvo_tpu_torch.cli.bench_accuracy --long --cells mono/long --matchers sg
  python -m ur_mvo_tpu_torch.cli.bench_accuracy --device cpu --cells mono/plane --matchers nn --seeds 1 --frames 16

``--device`` defaults to ``cuda`` and raises without it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "ACCURACY_TORCH.json")

H, W, FX = 240, 320, 260.0
LONG_H, LONG_W, LONG_FX = 480, 640, 520.0
LONG_FRAMES = 120
BASELINE_M = 0.12
FPS = 30.0

# scene family per cell: (n_planes, z_background, brightness_decay). The
# plane cells exist only for mono: a constant-depth plane is yaw and
# x-translation degenerate for metric VO, so stereo and RGB-D run the 3d
# families only.
SCENES = {
    "plane": dict(n_planes=0, z_background=4.0, brightness_decay=0.0),
    "3d": dict(n_planes=3, z_background=6.0, brightness_decay=0.0),
    "decay": dict(n_planes=3, z_background=6.0, brightness_decay=0.04),
}
SETUP_SCENES = {
    "mono": ("plane", "3d", "decay"),
    "stereo": ("3d", "decay"),
    "rgbd": ("3d", "decay"),
}
# the long protocol's cells and scene family
LONG_SCENES = {"long": dict(n_planes=3, z_background=6.0, brightness_decay=0.0)}
LONG_SETUP_SCENES = {"mono": ("long",), "rgbd": ("long",)}


def production_cfg(matcher: str, sg_path: Optional[str] = None, margin: Optional[float] = None,
                   nn_floor: Optional[int] = None, W: int = W, H: int = H, long_run: bool = False):
    """The default command line's configuration: the v3 detector at the
    shipped SuperGlue checkpoint's embedded operating point (``cli.run_vo``
    discovery), with that matcher (``"sg"``, ``"hybrid"``) or mutual-NN
    (``"nn"``). ``sg_path`` evaluates another checkpoint; ``margin`` and
    ``nn_floor`` override the decode ambiguity gate and the tracking-time
    NN floor (None: the production defaults). ``long_run``: the long
    protocol's map maintenance and recovery."""
    from ur_mvo_tpu_torch.config import Configs
    from ur_mvo_tpu_torch.models.superglue import checkpoint_operating_point

    cfg = Configs()
    cfg.superpoint.weights_path = os.path.join(REPO, "weights", "superpoint_scratch_v3.npz")
    cfg.superglue.image_width = W
    cfg.superglue.image_height = H
    sg_path = sg_path or os.path.join(REPO, "weights", "superglue_v3scene.npz")
    op = checkpoint_operating_point(sg_path) or {}
    cfg.superpoint.capacity = op.get("capacity", 1024)
    cfg.superpoint.max_keypoints = op.get("max_keypoints", 1000)
    cfg.superpoint.keypoint_threshold = op.get("keypoint_threshold", 1e-4)
    cfg.initializer.min_matches = op.get("min_matches", 60)
    cfg.initializer.min_features_first = op.get("min_features_first", 100)
    if matcher in ("sg", "hybrid"):
        cfg.superglue.weights_path = sg_path
        if matcher == "hybrid":
            cfg.superglue.matcher = "hybrid"
        if margin is not None:
            cfg.superglue.match_margin = margin
        # the init-only NN floor and relocalization: the recovery ladder
        # that keeps a weak stretch from failing a sequence
        cfg.superglue.nn_fallback_min_matches_init = 40
        if nn_floor is not None:
            cfg.superglue.nn_fallback_min_matches = nn_floor
        cfg.backend.relocalization = True
    else:
        cfg.superglue.matcher = "nn"
    if long_run:
        # culling keeps the store bounded over 100+ frames; loop closure and
        # relocalization are what the out-and-back path exists to exercise
        cfg.backend.enable_culling = True
        cfg.backend.loop_closure = True
        cfg.backend.relocalization = True
        if matcher in ("sg", "hybrid"):
            # 480x640 is beyond the validated 240x320 envelope: the
            # tracking-time NN floor engages, as run_vo's resolution guard
            cfg.superglue.nn_fallback_min_matches = 40
    return cfg


def run_sequence(vo, images, images_r, depths, setup: str, fps: float = FPS):
    """Feed a rendered sequence through the engine (the next frame
    prefetched) with ``cli.run_vo``'s pose/timestamp pairing: the poses
    returned at a keyframe cover the frames since the last emission, so
    the last ``len(poses)`` pending timestamps are theirs. Returns the
    emitted timestamps and positions, each frame's host ms, the frame that
    initialised (None if none did) and the frames the tracker lost."""
    import numpy as np

    from ur_mvo_tpu_torch.components import DepthMap, Frame, Image

    n = len(images)
    frames = []
    for i in range(n):
        f = Frame(image=Image(images[i], i / fps))
        if setup == "stereo":
            f.right_image = Image(images_r[i], i / fps)
        if setup == "rgbd":
            f.depth_map = DepthMap(depths[i])
        frames.append(f)
    ts_out, pos_out, pending, host_ms, init_at, lost_at = [], [], [], [], None, []
    for i in range(n):
        pending.append(i / fps)
        lost = vo.tracker.frames_lost
        t0 = time.perf_counter()
        poses = vo.process(frames[i], next_data=frames[i + 1] if i + 1 < n else None)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        if vo.tracker.frames_lost > lost:
            lost_at.append(i)
        if poses:
            assert len(poses) <= len(pending)
            for t, p in zip(pending[-len(poses):], poses):
                ts_out.append(t)
                pos_out.append(p.translation)
            pending.clear()
        if init_at is None and vo.tracker.initialized:
            init_at = i
    return np.asarray(ts_out), np.asarray(pos_out), host_ms, init_at, lost_at


def score_row(ates: Sequence[float], penalties: Sequence[float], ates_pgo: Sequence[float] = ()) -> dict:
    """One matcher's row of a cell, the JAX script's arithmetic: ``runs``
    (None for a failed run), ``mean`` with failed runs scored at their
    penalty (the ground truth's extent), ``mean_finite`` over the runs that
    did not fail, ``spread`` of the scored runs, ``failed``; and where the
    long protocol scored runs after ``global_optimize``, ``pgo_runs`` and
    ``pgo_mean`` over them alone (failed runs skip it)."""
    import numpy as np

    arr = np.asarray(ates, dtype=np.float64)
    ok = np.isfinite(arr)
    scored = np.where(ok, arr, np.asarray(penalties))
    row = {
        "runs": [round(a, 4) if np.isfinite(a) else None for a in ates],
        "mean": round(float(scored.mean()), 4),
        "mean_finite": round(float(arr[ok].mean()), 4) if ok.any() else None,
        "spread": round(float(scored.max() - scored.min()), 4),
        "failed": int((~ok).sum()),
    }
    if ates_pgo:
        row["pgo_runs"] = [round(a, 4) for a in ates_pgo]
        row["pgo_mean"] = round(float(np.mean(ates_pgo)), 4)
    return row


def merge_rows(path: str, results: dict, protocol_key: str, protocol: dict) -> dict:
    """Merge one run's rows (cell -> matcher -> row) and its protocol block
    into the JSON file at ``path`` (created if absent; an unreadable file
    starts afresh), as the JAX script merges, and return the document
    written."""
    doc = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                doc = json.load(f)
        except ValueError:
            doc = {}
    doc.setdefault("cells", {})
    for cell, row in results.items():
        doc["cells"].setdefault(cell, {}).update(row)
    doc[protocol_key] = protocol
    doc["generated_unix"] = int(time.time())
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc


def _launches_since(before: dict) -> dict:
    from ur_mvo_tpu_torch.ops import cuda_ext

    return {k: v - before.get(k, 0) for k, v in cuda_ext.LAUNCHES.items() if v - before.get(k, 0)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the command line ``argv``. Returns the written document
    (``doc``), its path (``out``), each cell and matcher's seconds and
    kernel launches (``cells``: a list in run order) and each run's health
    (``runs``: the seed, whether and where it initialised, keyframes,
    frames lost, poses emitted, the ATE, median host ms a frame)."""
    ap = argparse.ArgumentParser(prog="python -m ur_mvo_tpu_torch.cli.bench_accuracy")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--matchers", default="nn,sg")
    ap.add_argument("--sg-path", default=None,
                    help="evaluate a candidate SuperGlue checkpoint instead of the shipped one")
    ap.add_argument("--cells", default=None, help="comma list like mono/plane,stereo/3d (default: all)")
    ap.add_argument("--margin", type=float, default=None,
                    help="override superglue.match_margin (decode ambiguity gate)")
    ap.add_argument("--nn-floor", type=int, default=None, help="override superglue.nn_fallback_min_matches")
    ap.add_argument("--long", action="store_true",
                    help="long-sequence protocol: 120-frame out-and-back (loop-bearing) mono and rgbd cells "
                         "at 480x640 with culling, loop closure and relocalization on; merges into --out")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ur_mvo_tpu_torch.camera import make_pinhole
    from ur_mvo_tpu_torch.config import SensorSetup
    from ur_mvo_tpu_torch.device import deterministic_on, resolve_device
    from ur_mvo_tpu_torch.engine import UR_MVO
    from ur_mvo_tpu_torch.ops import cuda_ext
    from ur_mvo_tpu_torch.utils.metrics import ate_rmse
    from ur_mvo_tpu_torch.utils.synthscene import out_and_back_trajectory, render_sequence

    device = resolve_device(args.device)
    h, w, fx, frames = H, W, FX, args.frames
    scenes, setup_scenes, poses_long = SCENES, SETUP_SCENES, None
    if args.long:
        h, w, fx = LONG_H, LONG_W, LONG_FX
        if frames == 24:
            frames = LONG_FRAMES
        scenes, setup_scenes = LONG_SCENES, LONG_SETUP_SCENES
        poses_long = out_and_back_trajectory(frames)
    matchers = args.matchers.split(",")
    wanted = set(args.cells.split(",")) if args.cells else None
    setups = {"mono": SensorSetup.MONO, "stereo": SensorSetup.STEREO, "rgbd": SensorSetup.RGBD}

    todo = [(setup, scene) for setup in setup_scenes for scene in setup_scenes[setup]
            if not wanted or f"{setup}/{scene}" in wanted]

    def scene_key(setup, scene, seed):
        return scene, seed, BASELINE_M if setup == "stereo" else 0.0

    def render(key):
        scene, seed, baseline = key
        return render_sequence(frames, h, w, fx, seed=seed, baseline=baseline, poses=poses_long, **scenes[scene])

    results, cells, runs, engines = {}, [], [], {}
    t_start = time.time()
    # the scenes are rendered ahead of the runs by one worker thread (numpy
    # leaves the interpreter lock while it renders), each once for every
    # matcher and setup that runs it
    pool, rendered = ThreadPoolExecutor(max_workers=1), {}
    for setup, scene in todo:
        for seed in range(11, 11 + args.seeds):
            key = scene_key(setup, scene, seed)
            if key not in rendered:
                rendered[key] = pool.submit(render, key)
    try:
        with deterministic_on(device):
            for setup, scene in todo:
                cam = make_pinhole(w, h, fx, fx, w / 2, h / 2, bf=fx * BASELINE_M if setup == "stereo" else 0.0)
                cell = f"{setup}/{scene}"
                for m in matchers:
                    if (setup, m) not in engines:
                        engines[setup, m] = UR_MVO(
                            production_cfg(m, args.sg_path, args.margin, args.nn_floor, W=w, H=h, long_run=args.long),
                            setups[setup], camera=cam, device=device)
                    vo = engines[setup, m]
                    before, t_cell = dict(cuda_ext.LAUNCHES), time.perf_counter()
                    ates, penalties, ates_pgo = [], [], []
                    for seed in range(11, 11 + args.seeds):
                        out = rendered[scene_key(setup, scene, seed)].result()
                        T_wc = out[1]
                        # a failed run scores as the ground truth's extent, the
                        # worst-case aligned error: a matcher that fails a run
                        # must not look better than one that finishes it
                        penalties.append(float(np.linalg.norm(T_wc[:, :3, 3].max(0) - T_wc[:, :3, 3].min(0))))
                        vo.reset()
                        ts, pos, host_ms, init_at, lost_at = run_sequence(
                            vo, out[0], out[3] if setup == "stereo" else None, out[2], setup)
                        run = {"cell": cell, "matcher": m, "seed": seed, "initialised_at_frame": init_at,
                               "keyframes": vo.tracker.backend.store.num_keyframes(),
                               "frames_lost": vo.tracker.frames_lost, "lost_at": lost_at,
                               "relocalizations": vo.tracker.relocalizations, "poses_emitted": len(ts),
                               "host_ms_a_frame": statistics.median(host_ms), "ate": None}
                        runs.append(run)
                        print(f"  {cell} [{m}] seed {seed}: initialised at {init_at}, {run['keyframes']} keyframes, "
                              f"{run['frames_lost']} frames lost {lost_at}, {len(ts)} poses, "
                              f"{run['host_ms_a_frame']:.1f} host ms a frame", flush=True)
                        if len(ts) < 5:
                            ates.append(float("nan"))
                            continue
                        idx = np.clip((ts * FPS).round().astype(int), 0, frames - 1)
                        scale_ok = setup == "mono"  # metric setups are scored without scale
                        ates.append(float(ate_rmse(pos, T_wc[idx][:, :3, 3], align=True, correct_scale=scale_ok)))
                        run["ate"] = ates[-1]
                        if args.long:
                            # consume the loop edges (Sim3 scale, pose graph, full
                            # BA) and score the final keyframe trajectory too
                            vo.tracker.backend.global_optimize()
                            kts, kpos, _ = vo.keyframe_trajectory()
                            kidx = np.clip((np.asarray(kts) * FPS).round().astype(int), 0, frames - 1)
                            ates_pgo.append(float(ate_rmse(np.asarray(kpos), T_wc[kidx][:, :3, 3], align=True,
                                                           correct_scale=scale_ok)))
                            run["pgo_ate"] = ates_pgo[-1]
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    row = score_row(ates, penalties, ates_pgo)
                    results.setdefault(cell, {})[m] = row
                    cells.append({"cell": cell, "matcher": m, "seconds": time.perf_counter() - t_cell,
                                  "launches": _launches_since(before)})
                    print(f"{cell} [{m}]: mean {row['mean']} spread {row['spread']} failed {row['failed']} "
                          f"runs {row['runs']} ({time.time() - t_start:.0f}s)", flush=True)
            for vo in engines.values():
                vo.shutdown()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    protocol = {
        "frames": frames, "seeds": args.seeds, "H": h, "W": w, "fx": fx, "baseline_m": BASELINE_M,
        "ate": "umeyama-aligned; scale-corrected for mono only; failed runs scored at GT-extent penalty in mean",
        "config": "production (v3 detector at the shipped SG operating point)",
    }
    if args.long:
        protocol["trajectory"] = "out-and-back (loop-bearing)"
        protocol["config"] += " + culling/loop-closure/relocalization"
    # partial runs (--cells, --long) update only their cells
    doc = merge_rows(args.out, results, "protocol_long" if args.long else "protocol", protocol)
    print(f"wrote {args.out}")
    return {"out": args.out, "doc": doc, "cells": cells, "runs": runs}


if __name__ == "__main__":
    main()
