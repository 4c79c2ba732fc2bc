"""Multi-sequence concurrent VO from the command line (the port of
``scripts/run_vo_multi.py``).

Runs S independent monocular sequences lock-step on one device with the
device work batched across them (``parallel/multi_seq.MultiSequenceVO``:
SuperPoint on the S images, SuperGlue on the S pairs, one pose-GN launch
for all lanes a frame). Each sequence keeps its own map and trajectory;
per-sequence TUM keyframe files and, with ``--gt``, one JSON line a
sequence with its ATE are written.

  python -m ur_mvo_tpu_torch.cli.run_vo_multi --images seqA seqB [seqC ...] \
      --results out/ [--gt gtA gtB ...] [--weights w.npz] [--device cuda|cpu]

All sequences must share image size and calibration (the first
sequence's ``camera.yaml`` is used). Processing runs to the shortest
sequence's length (lock-step batching). ``--device`` defaults to ``cuda``
and raises without it; on CUDA the run takes PyTorch's deterministic
algorithms, the caller's setting restored on return.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m ur_mvo_tpu_torch.cli.run_vo_multi")
    ap.add_argument("--images", nargs="+", required=True, help="sequence dirs (EuRoC layout)")
    ap.add_argument("--gt", nargs="*", default=None, help="per-sequence TUM ground truth")
    ap.add_argument("--results", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--matcher", default=None, choices=["auto", "superglue", "nn"])
    ap.add_argument("--sg-weights", default=None)
    ap.add_argument("--kpt-threshold", type=float, default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    ap.add_argument("--stride", type=int, default=5)
    args = ap.parse_args(argv)

    from ur_mvo_tpu_torch.device import deterministic_on, resolve_device

    # on CUDA the run takes deterministic algorithms, which the gated card
    # runs read; the caller's setting comes back on return
    with deterministic_on(resolve_device(args.device)):
        return _run(args)


def _run(args) -> None:
    import numpy as np
    import torch

    from ur_mvo_tpu_torch.camera import Camera
    from ur_mvo_tpu_torch.components import Setup
    from ur_mvo_tpu_torch.config import Configs
    from ur_mvo_tpu_torch.dataset import Dataset
    from ur_mvo_tpu_torch.ops.lie import rotmat_to_quat
    from ur_mvo_tpu_torch.parallel.multi_seq import MultiSequenceVO
    from ur_mvo_tpu_torch.utils.metrics import ate_rmse
    from ur_mvo_tpu_torch.utils.tum_io import associate, read_tum, write_tum

    cfg = Configs.from_yaml(args.config, Setup.MONO) if args.config else Configs()
    if args.weights:
        cfg.superpoint.weights_path = args.weights
    if args.matcher:
        cfg.superglue.matcher = args.matcher
    if args.sg_weights:
        cfg.superglue.weights_path = args.sg_weights
    if args.kpt_threshold is not None:
        cfg.superpoint.keypoint_threshold = args.kpt_threshold
    # no shipped-matcher discovery here (unlike cli.run_vo), as in the JAX
    # package's script: pass --sg-weights weights/superglue_v3scene.npz to
    # opt in
    seq_cam = os.path.join(args.images[0], "camera.yaml")
    if cfg.camera_config_path is None and os.path.exists(seq_cam):
        cfg.camera_config_path = seq_cam
    if cfg.camera_config_path is None:
        raise SystemExit("no calibration: pass --config or put camera.yaml in the first sequence dir")
    camera = Camera.from_yaml(cfg.camera_config_path)
    # the matcher normalises keypoints by these, as UR_MVO keeps them (the
    # JAX package's script leaves the config's 640x512 in place)
    cfg.superglue.image_width, cfg.superglue.image_height = camera.width, camera.height

    datasets = [Dataset(d) for d in args.images]
    S = len(datasets)
    n = min(len(d) for d in datasets)
    msvo = MultiSequenceVO(cfg, camera, num_sequences=S, device=args.device)
    os.makedirs(args.results, exist_ok=True)

    t0 = time.perf_counter()
    for f in range(n):
        frames = [d.get(f) for d in datasets]
        images = np.stack([fr.image for fr in frames])
        msvo.process_batch(images, [fr.time for fr in frames])
    if msvo.device.type == "cuda":
        torch.cuda.synchronize(msvo.device)
    elapsed = time.perf_counter() - t0
    print(
        f"processed {S} sequences x {n} frames in {elapsed:.1f}s "
        f"({S * n / max(elapsed, 1e-9):.1f} frames/s aggregate)",
        file=sys.stderr,
    )

    for i, (ts, R, t) in enumerate(msvo.trajectories()):
        name = os.path.basename(os.path.normpath(args.images[i])) or f"seq{i}"
        path = os.path.join(args.results, f"keyframes_{i}_{name}.txt")
        q = rotmat_to_quat(torch.from_numpy(np.asarray(R, np.float32))).numpy() if len(ts) else np.zeros((0, 4))
        write_tum(path, list(ts), np.asarray(t, np.float64), q)
        rec = {"seq": name, "n_keyframes": len(ts)}
        if args.gt and i < len(args.gt):
            gt_ts, gt_pos, _ = read_tum(args.gt[i])
            ia, ib = associate(np.asarray(ts), gt_ts)
            if len(ia) >= 3:
                rec["ate_rmse_m"] = round(
                    float(ate_rmse(np.asarray(t)[ia], gt_pos[ib], align=True, correct_scale=True)), 5
                )
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
