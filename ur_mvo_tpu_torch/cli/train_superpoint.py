"""SuperPoint descriptor fine-tuning (domain adaptation; port of
``scripts/train_superpoint.py``).

Loads a base checkpoint (``.npz`` in the MagicLeap key layout, or a torch
``superpoint_v1.pth`` through the same loader; the repo ships only
``.npz``), builds Siamese homography-warped pairs with photometric
augmentation from random crops of a directory of grayscale images, trains
ONLY the descriptor head (convDa/convDb) with the dense hinge-contrastive
loss, and saves an ``.npz`` checkpoint (the JAX package's layout) after
every epoch:

  python -m ur_mvo_tpu_torch.cli.train_superpoint --images <dir> [--weights base.npz]
      [--out model_ft.npz] [--epochs 100] [--batch 8] [--crop 256 320]
      [--lr 1e-3] [--steps-per-epoch 50] [--device cuda|cpu]

One process trains on one device; ``parallel.train_step.make_dp_train_step``
is the data-parallel step for a world of ranks. ``--device`` defaults to
``cuda`` and raises without it.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ur_mvo_tpu_torch.dataset import load_gray
from ur_mvo_tpu_torch.device import resolve_device
from ur_mvo_tpu_torch.models import superpoint
from ur_mvo_tpu_torch.models.superpoint import SuperPoint
from ur_mvo_tpu_torch.models.train_superpoint import make_batch, make_optimizer, make_train_step

IMAGE_SUFFIXES = ("png", "jpg", "jpeg", "pgm", "npy")


def main(argv: Optional[Sequence[str]] = None) -> SuperPoint:
    """Run the command line ``argv``; returns the fine-tuned ``SuperPoint``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", required=True, help="directory of grayscale images (png/pgm/npy)")
    ap.add_argument("--weights", default=None, help="base checkpoint (.npz/.pth); random init if omitted")
    ap.add_argument("--out", default="superpoint_ft.npz")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--crop", type=int, nargs=2, default=(256, 320), metavar=("H", "W"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps-per-epoch", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    names = sorted(f for f in os.listdir(args.images) if f.split(".")[-1].lower() in IMAGE_SUFFIXES)
    if not names:
        raise SystemExit(f"no images in {args.images}")
    H, W = args.crop
    rng = np.random.default_rng(0)

    def sample_crops(n):
        out = np.empty((n, H, W), np.float32)
        for i in range(n):
            img = load_gray(os.path.join(args.images, names[rng.integers(len(names))]))
            img = img.astype(np.float32) / 255.0
            if img.shape[0] < H or img.shape[1] < W:
                pad = np.zeros((max(H, img.shape[0]), max(W, img.shape[1])), np.float32)
                pad[: img.shape[0], : img.shape[1]] = img
                img = pad
            r = rng.integers(0, img.shape[0] - H + 1)
            c = rng.integers(0, img.shape[1] - W + 1)
            out[i] = img[r : r + H, c : c + W]
        return out

    model = SuperPoint()
    if args.weights:
        model.load_state_dict(superpoint.load_torch_weights(args.weights))
    else:
        model.init_random(torch.Generator().manual_seed(0))
    model = model.to(dev)
    step = make_train_step(make_optimizer(model, args.lr))
    print(f"training on {dev}, {len(names)} images", file=sys.stderr)

    gen = torch.Generator(device=dev).manual_seed(1)
    for epoch in range(args.epochs):
        losses = []
        for _ in range(args.steps_per_epoch):
            batch = make_batch(gen, torch.from_numpy(sample_crops(args.batch)).to(dev))
            losses.append(step(model, batch))
        print(f"epoch {epoch + 1}/{args.epochs}  loss {float(torch.stack(losses).mean()):.4f}", file=sys.stderr)
        superpoint.save_npz(model, args.out)
    print(f"saved {args.out}")
    return model


if __name__ == "__main__":
    main()
