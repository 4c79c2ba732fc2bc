"""Train the port's SuperGlue from scratch on synthetic warped
correspondences (``models/train_superglue.py``; port of
``scripts/train_superglue.py``):

  python -m ur_mvo_tpu_torch.cli.train_superglue --out sg.npz [--steps 2000] [--batch 8]
      [--capacity 256] [--layers 9] [--heads 4] [--lr 1e-4] [--on-device] [--device cuda|cpu]

The result is a native flat-key ``.npz`` (the JAX package's layout), which
``superglue.weights_path`` loads in either package. ``--device`` defaults
to ``cuda`` and raises without it.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ur_mvo_tpu_torch.models import superglue, train_superglue
from ur_mvo_tpu_torch.models.superglue import SuperGlue


def main(argv: Optional[Sequence[str]] = None) -> SuperGlue:
    """Run the command line ``argv``; returns the trained ``SuperGlue``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--size", type=int, nargs=2, default=(512, 640), metavar=("H", "W"))
    ap.add_argument("--layers", type=int, default=9)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--sinkhorn", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init", default=None, help="warm-start checkpoint (.npz)")
    ap.add_argument("--on-device", action="store_true",
                    help="batches drawn on the device, one host read a chunk")
    ap.add_argument("--chunk", type=int, default=100, help="steps a chunk with --on-device")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    params = superglue.load_weights(args.init, args.layers, args.heads) if args.init else None
    H, W = args.size
    train_fn = train_superglue.train_on_device if args.on_device else train_superglue.train
    kwargs = {"chunk": args.chunk} if args.on_device else {}
    model = train_fn(
        steps=args.steps,
        batch=args.batch,
        capacity=args.capacity,
        width=W,
        height=H,
        num_layers=args.layers,
        num_heads=args.heads,
        sinkhorn_iterations=args.sinkhorn,
        lr=args.lr,
        seed=args.seed,
        params=params,
        device=args.device,
        **kwargs,
    )
    superglue.save_npz(args.out, model)
    print(f"saved {args.out}")
    return model


if __name__ == "__main__":
    main()
