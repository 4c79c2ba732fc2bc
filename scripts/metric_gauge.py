#!/usr/bin/env python
"""The ``rgbd/long`` protocol's windowed BA in the PyTorch port and in the
JAX package, on the CPU, and the JAX package's ATE over many scene seeds.

An RGB-D keyframe stores its features as mono rows (``u_right = -1``): the
depth seeds new map points and enters no residual. A window BA whose only
fixed keyframe is the first (``frame id <= 2``) then has a free scale, and
an LM step moves along it by what rounding leaves in the gradient there,
over the damping alone. The JAX package sums the point side of bf16
summands (its one-hot matmul); the port's RGB-D and stereo BAs do the
same (``BAConfig.bf16_point_side``), its monocular BAs sum exact float32
summands.

Run from the root of the repository (JAX on the CPU, the port's plain
versions on the CPU):

    JAX_PLATFORMS=cpu python scripts/metric_gauge.py --ba 11 16
    JAX_PLATFORMS=cpu python scripts/metric_gauge.py --reference rgbd/long 11,12,13

``--ba SEED FRAME`` drives the port's ``rgbd/long`` engine with exact
float32 point-side summands over scene SEED up to keyframe FRAME (its first
frames; about a minute, one CPU thread), captures the window
BA that FRAME's insertion runs, and solves that one problem with the port's
BA in float32 (exact point-side summands, and bf16 ones as the RGB-D setup
takes them), in float64, and with the JAX package's (float32),
printing each keyframe's position, whether it is fixed, and the truth; and
the largest relative error of each normal term at the given state, the
port's exact float32 assembly and the JAX package's, against the port's
float64. ``--reference CELL SEEDS`` runs ``scripts/bench_accuracy.py``'s
protocol for ``rgbd/3d`` or ``rgbd/long`` (matcher ``hybrid``) in the JAX
package per scene seed: the ATE without scale correction (for
``rgbd/long`` online and after ``global_optimize``) and the keyframes, one
JSON line a seed (``rgbd/long``: ~7 min a seed; the port's own sweep is
``chip_smoke.py --metric-seeds`` on the card). ``--reference
mono/3d+local_map SEEDS`` and ``--reference snapshot SEEDS`` run
``chip_smoke.py`` phase 13's local-map and snapshot protocols in the JAX
package (production mono configuration, matcher ``sg``); ``--reference
multi_seq SEEDS [--runtime-seed N]`` runs phase 14's, the JAX package's
``MultiSequenceVO`` with one lane a seed (``N``: another key for its
samplers).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
FPS = 30.0


def port_engine():
    import chip_smoke

    # the exact float32 point side, the numerics whose windows ran off
    return chip_smoke, chip_smoke.metric_engine("rgbd/long", kernels=False, device="cpu", float32_point_side=True)


def jax_engine(cell):
    import bench_accuracy as ba
    from ur_mvo_tpu.camera import make_pinhole
    from ur_mvo_tpu.config import SensorSetup
    from ur_mvo_tpu.engine import UR_MVO

    W, H, FX = (640, 480, 520.0) if cell == "rgbd/long" else (ba.W, ba.H, ba.FX)
    return UR_MVO(ba._production_cfg("hybrid", W=W, H=H, long_run=cell == "rgbd/long"), SensorSetup.RGBD,
                  camera=make_pinhole(W, H, FX, FX, W / 2, H / 2))


def ba_at(seed, frame):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from ur_mvo_tpu import camera as jcamera
    from ur_mvo_tpu import config as jconfig
    from ur_mvo_tpu.ops import ba as jba
    from ur_mvo_tpu.runtime.backend import Backend as JaxBackend
    from ur_mvo_tpu_torch.ops import ba as tba

    cs, vo = port_engine()
    frames, T_wc = cs.metric_scene("rgbd/long", seed)
    backend = vo.tracker.backend
    F, P, O = backend._ba_dims
    captured = []
    solve = backend._ba

    def capture(flat, cfg=None):
        fp = flat[: 14 * F].reshape(F, 14)
        n = int(fp[:, 12].sum())
        st = backend.store
        slots = st.keyframe_slots()
        # the window's keyframes by their pre-BA poses
        d = np.abs(st.kf_t[slots][None] - fp[:n, None, 9:12]).sum(-1) + np.abs(
            st.kf_R[slots].reshape(-1, 9)[None] - fp[:n, None, 0:9]).sum(-1)
        fids = st.kf_frame_id[slots[d.argmin(1)]].tolist()
        captured.append((np.array(flat), fids, fp[:n, 13] > 0.5))
        return solve(flat, cfg)

    backend._ba = capture
    vo.reset()
    for f in frames[: frame + 1]:
        vo.process(f)
    flat, fids, fixed = captured[-1]
    if fids[-1] != frame:
        raise SystemExit(f"frame {frame} inserted no keyframe (last window BA: keyframe {fids[-1]})")
    n = len(fids)

    def unpack_t(arr):
        return np.asarray(arr, np.float64)[9 * F : 12 * F].reshape(F, 3)[:n]

    def problem(mod, x, index):
        fp, pp, op = x[: 14 * F].reshape(F, 14), x[14 * F : 14 * F + 4 * P].reshape(P, 4), x[14 * F + 4 * P :].reshape(O, 6)
        return mod.BAProblem(R_wc=fp[:, 0:9].reshape(-1, 3, 3), t_wc=fp[:, 9:12], frame_valid=fp[:, 12] > 0.5,
                             frame_fixed=fp[:, 13] > 0.5, X=pp[:, 0:3], point_valid=pp[:, 3] > 0.5,
                             obs_frame=index(op[:, 0]), obs_point=index(op[:, 1]), obs_uv=op[:, 2:5],
                             obs_valid=op[:, 5] > 0.5)

    def port_problem(dtype):
        return problem(tba, torch.from_numpy(flat).to(dtype), lambda a: a.to(torch.int64))

    def jax_problem():
        return problem(jba, jnp.asarray(flat), lambda a: a.astype(jnp.int32))

    cfg, cam = vo.config, vo.camera
    exact_cfg = backend._ba_cfg._replace(bf16_point_side=False)

    def port_solve(dtype, bf16_point_side=False):
        return tba.bundle_adjust(port_problem(dtype), cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                                 exact_cfg._replace(bf16_point_side=bf16_point_side), plain=True).t_wc[:n]

    jb = JaxBackend(jcamera.make_pinhole(cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy),
                    jconfig.BackendConfig(**dataclasses.asdict(cfg.backend)),
                    jconfig.OptimizationConfig(**dataclasses.asdict(cfg.backend_optimization)),
                    keypoints_per_frame=cfg.superpoint.capacity)
    # the normal terms at the given state: float32 against float64
    terms = {}
    for dtype in (torch.float32, torch.float64):
        prob = port_problem(dtype)
        R_cw, t_cw = tba._invert_poses(prob.R_wc, prob.t_wc)
        slot = tba._free_rank(prob, backend._ba_cfg.max_free_frames)[prob.obs_frame]
        terms[dtype] = [x.double().numpy() for x in tba.build_normal_terms(
            prob, R_cw, t_cw, prob.X, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, exact_cfg, prob.obs_valid.to(dtype),
            True, obs_slot=slot)[:5]]
    jp = jax_problem()
    jR, jt = jba._invert_poses(jp.R_wc, jp.t_wc)
    jcfg = jba.BAConfig(**{k: v for k, v in exact_cfg._asdict().items() if k != "bf16_point_side"})
    jterms = [np.asarray(x, np.float64) for x in jax.jit(
        lambda p, R, t: jba.build_normal_terms_matmul(p, R, t, p.X, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, jcfg,
                                                     p.obs_valid.astype(jnp.float32), True))(jp, jR, jt)[:5]]
    ref = terms[torch.float64]
    rel = {name: {"port_float32": float(np.abs(terms[torch.float32][i] - ref[i]).max() / np.abs(ref[i]).max()),
                  "jax_float32": float(np.abs(jterms[i] - ref[i]).max() / np.abs(ref[i]).max())}
           for i, name in enumerate(("H_cc", "b_c", "H_pp", "b_p", "U"))}
    rows = {"keyframe": fids, "fixed": fixed.tolist(), "truth": T_wc[fids][:, :3, 3].tolist(),
            "before": flat[: 14 * F].reshape(F, 14)[:n, 9:12].tolist(),
            "port_float32": port_solve(torch.float32).double().numpy().tolist(),
            "port_float64": port_solve(torch.float64).numpy().tolist(),
            # the point side's summands rounded to bf16, as the JAX package's
            # window assembly rounds them (its one-hot matmul)
            "port_float32_bf16_point_side": port_solve(torch.float32, True).double().numpy().tolist(),
            "jax_float32": unpack_t(jb._ba(jnp.asarray(flat))).tolist()}
    print(json.dumps({"seed": seed, "frame": frame, **rows, "normal_terms_relative_error": rel}))


def reference_runs(cell, seeds):
    import bench_accuracy as ba
    import numpy as np

    from ur_mvo_tpu.utils.metrics import ate_rmse
    from ur_mvo_tpu.utils.synthscene import out_and_back_trajectory, render_sequence

    long_run = cell == "rgbd/long"
    W, H, FX, N = (640, 480, 520.0, 120) if long_run else (ba.W, ba.H, ba.FX, 24)
    vo = jax_engine(cell)
    for seed in seeds:
        images, T_wc, depths = render_sequence(N, H, W, FX, seed=seed, poses=out_and_back_trajectory(N) if long_run
                                               else None, **ba.SCENES["3d"])[:3]
        vo.reset()
        ts, pos = ba._run_sequence(vo, images, None, depths, "rgbd")
        row = {"cell": cell, "seed": seed, "ate": None}
        if len(ts) >= 5:
            idx = np.clip((ts * FPS).round().astype(int), 0, N - 1)
            row["ate"] = float(ate_rmse(pos, T_wc[idx][:, :3, 3], align=True, correct_scale=False))
        row["keyframes"] = vo.tracker.backend.store.num_keyframes()
        if long_run:
            vo.tracker.backend.global_optimize()
            kts, kpos, _ = vo.keyframe_trajectory()
            kidx = np.clip((np.asarray(kts) * FPS).round().astype(int), 0, N - 1)
            row["pgo_ate"] = float(ate_rmse(np.asarray(kpos), T_wc[kidx][:, :3, 3], align=True, correct_scale=False))
        print(json.dumps(row), flush=True)


def extras_reference(cell, seeds):
    """``chip_smoke.py`` phase 13's ``mono/3d+local_map`` and ``snapshot``
    in the JAX package: the production mono configuration
    (``bench_accuracy.py``'s matcher ``sg``) at 240x320 over the ``mono/3d``
    scenes, one JSON line a seed. ``mono/3d+local_map``: local-map tracking
    on over 24 frames, the scale-corrected ATE of the emitted trajectory
    (None below 5 poses: a failed run of the protocol) and of the keyframe
    trajectory, keyframes, frames lost, relocalizations. ``snapshot``: session A over
    frames 0-15, ``save_map_snapshot``; session B a fresh engine,
    ``load_map_snapshot``, frames 16-23; the scale-corrected keyframe ATE
    over both sessions, B's keyframes added, relocalizations and frames
    lost (the JAX tracker counts lost frames only as its consecutive
    ``_lost_count``, read at the end)."""
    import tempfile

    import bench_accuracy as ba
    import numpy as np

    from ur_mvo_tpu.camera import make_pinhole
    from ur_mvo_tpu.components import Frame, Image
    from ur_mvo_tpu.config import SensorSetup
    from ur_mvo_tpu.engine import UR_MVO
    from ur_mvo_tpu.utils.metrics import ate_rmse
    from ur_mvo_tpu.utils.synthscene import render_sequence

    N, SPLIT = 24, 16

    def engine(local_map=False):
        """The JAX engine, its tracker counting as the port's does: a frame
        that ``_handle_lost`` could not re-anchor is lost, one that
        ``_relocalize`` re-anchored is a relocalization."""
        cfg = ba._production_cfg("sg")
        cfg.local_map_tracking.enabled = local_map
        vo = UR_MVO(cfg, SensorSetup.MONO, camera=make_pinhole(ba.W, ba.H, ba.FX, ba.FX, ba.W / 2, ba.H / 2))
        tr, count = vo.tracker, {"lost": 0, "reloc": 0}
        handle_lost, relocalize = tr._handle_lost, tr._relocalize

        def lost(*a, **k):
            out = handle_lost(*a, **k)
            count["lost"] += out is None
            return out

        def reloc(*a, **k):
            out = relocalize(*a, **k)
            count["reloc"] += out is not None
            return out

        tr._handle_lost, tr._relocalize, vo.count = lost, reloc, count
        return vo

    vo = engine(local_map=cell == "mono/3d+local_map")
    for seed in seeds:
        images, T_wc, _ = render_sequence(N, ba.H, ba.W, ba.FX, seed=seed, **ba.SCENES["3d"])
        row = {"cell": cell, "seed": seed}
        vo.reset()
        vo.count.update(lost=0, reloc=0)
        if cell == "mono/3d+local_map":
            ts, pos = ba._run_sequence(vo, images, None, None, "mono")
            row.update(ate=None, poses_emitted=len(ts))
            if len(ts) >= 5:
                idx = np.clip((ts * FPS).round().astype(int), 0, N - 1)
                row["ate"] = float(ate_rmse(pos, T_wc[idx][:, :3, 3], align=True, correct_scale=True))
            kts, kpos, _ = vo.keyframe_trajectory()
            kidx = np.clip((np.asarray(kts) * FPS).round().astype(int), 0, N - 1)
            row.update(keyframe_ate=float(ate_rmse(np.asarray(kpos), T_wc[kidx][:, :3, 3], align=True,
                                                   correct_scale=True)) if len(kts) >= 3 else None,
                       keyframes=len(kts), keyframe_frame_ids=kidx.tolist(), frames_lost=vo.count["lost"],
                       relocalizations=vo.count["reloc"])
        else:
            ba._run_sequence(vo, images[:SPLIT], None, None, "mono")
            row["keyframes_a"] = vo.tracker.backend.store.num_keyframes()
            with tempfile.TemporaryDirectory() as tmp:
                vo.save_map_snapshot(os.path.join(tmp, "map.npz"))
                vo_b = engine()
                vo_b.load_map_snapshot(os.path.join(tmp, "map.npz"))
            initialised = vo_b.tracker.initialized
            for i in range(SPLIT, N):
                vo_b.process(Frame(image=Image(images[i], i / FPS)))
            kts, kpos, _ = vo_b.keyframe_trajectory()
            idx = np.clip((np.asarray(kts) * FPS).round().astype(int), 0, N - 1)
            row.update(initialised_on_load=initialised, keyframes_after_b=vo_b.tracker.backend.store.num_keyframes(),
                       keyframe_ate_both_sessions=float(ate_rmse(np.asarray(kpos), T_wc[idx][:, :3, 3], align=True,
                                                                 correct_scale=True)),
                       frames_lost_b=vo_b.count["lost"], relocalizations_b=vo_b.count["reloc"])
        print(json.dumps(row), flush=True)


def multi_seq_reference(seeds, runtime_seed=None):
    """``chip_smoke.py`` phase 14's protocol in the JAX package: its
    ``MultiSequenceVO`` with the production mono configuration
    (``bench_accuracy.py``'s matcher ``sg``) at 240x320, one lane a
    ``mono/3d`` scene seed, 24 frames stepped lock-step. One JSON line a
    lane: the scale-corrected keyframe ATE, keyframes, keyframe poses
    returned, the frame that initialised, frames lost (a frame that
    ``_handle_lost`` could not re-anchor) and relocalizations; then the
    lanes' mean keyframe ATE. Each lane's line carries its per-frame trace,
    the fields of ``chip_smoke.multi_seq_trace`` that the JAX package's
    tracker exposes."""
    import bench_accuracy as ba
    import numpy as np

    from ur_mvo_tpu.camera import make_pinhole
    from ur_mvo_tpu.parallel.multi_seq import MultiSequenceVO
    from ur_mvo_tpu.utils.metrics import ate_rmse
    from ur_mvo_tpu.utils.synthscene import render_sequence

    N = 24
    scenes = [render_sequence(N, ba.H, ba.W, ba.FX, seed=s, **ba.SCENES["3d"])[:2] for s in seeds]
    cfg = ba._production_cfg("sg")
    if runtime_seed is not None:
        cfg.runtime.seed = runtime_seed  # the driver's and the trackers' keys
    vo = MultiSequenceVO(cfg, make_pinhole(ba.W, ba.H, ba.FX, ba.FX, ba.W / 2, ba.H / 2), len(seeds))
    counts = []
    for tr in vo.trackers:
        count = {"lost": 0, "reloc": 0}
        handle_lost, relocalize = tr._handle_lost, tr._relocalize

        def lost(*a, _f=handle_lost, _c=count, **k):
            out = _f(*a, **k)
            _c["lost"] += out is None
            return out

        def reloc(*a, _f=relocalize, _c=count, **k):
            out = _f(*a, **k)
            _c["reloc"] += out is not None
            return out

        tr._handle_lost, tr._relocalize = lost, reloc
        counts.append(count)
        trace = count["trace"] = []

        def process(bank, ts, _t=tr, _f=tr.process, _log=trace, _c=count, **k):
            # the frame as chip_smoke.multi_seq_trace logs it: the state it
            # began in, the precomputed match's count, the batched row's
            # match and inlier counts, lost, a keyframe inserted
            e = {"s": "t" if _t.initialized else "i"}
            m, pt = k.get("precomputed_match"), k.get("precomputed_track")
            if m is not None:
                e["m"] = int(m.num_valid())
            if pt is not None:
                e["row"] = [int(pt[0]), int(pt[1])]
            lost = _c["lost"]
            out = _f(bank, ts, **k)
            e.update(lost=int(_c["lost"] > lost), kf=int(out is not None))
            _log.append(e)
            return out

        tr.process = process
    returned, init_at = [0] * len(seeds), [None] * len(seeds)
    for i in range(N):
        out = vo.process_batch(np.stack([sc[0][i] for sc in scenes]), [i / FPS] * len(seeds))
        for s, pose in enumerate(out):
            returned[s] += pose is not None
            if init_at[s] is None and vo.trackers[s].initialized:
                init_at[s] = i
    ates = []
    for s, (seed, (kts, _, kt)) in enumerate(zip(seeds, vo.trajectories())):
        T_wc = scenes[s][1]
        idx = np.clip((np.asarray(kts) * FPS).round().astype(int), 0, N - 1)
        ate = float(ate_rmse(np.asarray(kt), T_wc[idx][:, :3, 3], align=True, correct_scale=True)) if len(kts) >= 3 else None
        ates.append(ate)
        print(json.dumps({"cell": "multi_seq", "seed": seed, "runtime_seed": cfg.runtime.seed,
                          "keyframe_ate": ate, "keyframes": len(kts),
                          "keyframe_frame_ids": idx.tolist(), "keyframe_poses_returned": returned[s],
                          "initialised_at_frame": init_at[s], "frames_lost": counts[s]["lost"],
                          "relocalizations": counts[s]["reloc"], "trace": counts[s]["trace"]}), flush=True)
    if all(a is not None for a in ates):
        print(json.dumps({"cell": "multi_seq", "seeds": list(seeds), "mean_keyframe_ate": float(np.mean(ates))}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ba", nargs=2, type=int, metavar=("SEED", "FRAME"))
    ap.add_argument("--reference", nargs=2, metavar=("CELL", "SEEDS"),
                    help="rgbd/3d, rgbd/long, mono/3d+local_map, snapshot or multi_seq; a comma list of seeds")
    ap.add_argument("--runtime-seed", type=int, default=None,
                    help="multi_seq: runtime.seed, the keys of the driver's and the trackers' samplers")
    args = ap.parse_args()
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.set_num_threads(1)  # the summation order of the CPU reductions
    if args.ba:
        ba_at(*args.ba)
    if args.reference:
        cell, seeds = args.reference[0], [int(s) for s in args.reference[1].split(",")]
        if cell == "multi_seq":
            multi_seq_reference(seeds, args.runtime_seed)
        else:
            (extras_reference if cell in ("mono/3d+local_map", "snapshot") else reference_runs)(cell, seeds)


if __name__ == "__main__":
    main()
