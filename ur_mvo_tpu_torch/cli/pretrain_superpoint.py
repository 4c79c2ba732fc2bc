"""SuperPoint from-scratch pretraining on synthetic shapes (port of
``scripts/pretrain_superpoint.py``).

Produces a detector + descriptor checkpoint with no external weights, in
the JAX package's ``.npz`` layout (either package loads it):

  python -m ur_mvo_tpu_torch.cli.pretrain_superpoint --out superpoint_scratch.npz
      [--steps 5000] [--batch 16] [--size 128 128] [--lr 1e-3] [--device cuda|cpu]

Chain with ``cli.train_superpoint`` for domain adaptation, then point
``superpoint.weights_path`` at the .npz. ``--device`` defaults to ``cuda``
and raises without it.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from ur_mvo_tpu_torch.models import superpoint
from ur_mvo_tpu_torch.models.pretrain_superpoint import pretrain


def main(argv: Optional[Sequence[str]] = None):
    """Run the command line ``argv``; returns the trained ``SuperPoint``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="superpoint_scratch.npz")
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, nargs=2, default=(128, 128), metavar=("H", "W"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lambda-desc", type=float, default=0.001)
    ap.add_argument("--init", default=None, help="warm-start from an existing .npz checkpoint")
    ap.add_argument("--flat-desc", action="store_true", help="descriptor pairs from flat shapes (no texture)")
    ap.add_argument("--desc-objective", default="nce", choices=["nce", "hinge"])
    ap.add_argument("--detector-only", action="store_true",
                    help="train only the detector head; keep the random backbone/descriptors")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    model = pretrain(
        torch.Generator().manual_seed(args.seed),
        steps=args.steps,
        batch=args.batch,
        H=args.size[0],
        W=args.size[1],
        lr=args.lr,
        seed=args.seed,
        log_every=max(1, args.steps // 50),
        lambda_desc=args.lambda_desc,
        init_params=superpoint.load_torch_weights(args.init) if args.init else None,
        textured_desc=not args.flat_desc,
        desc_objective=args.desc_objective,
        detector_only=args.detector_only,
        device=args.device,
    )
    superpoint.save_npz(model, args.out)
    print(f"saved {args.out}")
    return model


if __name__ == "__main__":
    main()
