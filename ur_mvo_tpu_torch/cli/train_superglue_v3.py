"""Train SuperGlue against the shipped v3 SuperPoint on rendered scenes
(port of ``scripts/train_superglue_v3.py``).

1. ``data``: render textured single-plane and 3D multi-plane scenes
   (``utils/synthscene.py``), extract feature banks with the shipped
   ``weights/superpoint_scratch_v3.npz`` detector, and label ground-truth
   partial assignments by exact depth transfer with occlusion checks.
2. ``train``: train SuperGlue (``models/superglue.py``, ``kernels=False``)
   on those banks with the assignment NLL
   (``models/train_superglue.batch_loss``), the dataset resident on the
   device and the minibatches gathered there, one host read a chunk.
   Mirror augmentation (x/y flips), optional gap balancing, AdamW with a
   warmup-cosine schedule after a global-norm clip of 1.
3. ``eval``: held-out scenes, decoded-match precision/recall against the
   ground truth, beside the mutual-NN baseline.

Usage:
  python -m ur_mvo_tpu_torch.cli.train_superglue_v3 data  --out build/sg_data.npz
  python -m ur_mvo_tpu_torch.cli.train_superglue_v3 train --data build/sg_data.npz \\
      --steps 3000 --out weights/superglue_v3scene.npz
  python -m ur_mvo_tpu_torch.cli.train_superglue_v3 eval  --weights weights/superglue_v3scene.npz

Every subcommand takes ``--device`` (default ``cuda``; it raises without
it, ``cpu`` runs the plain versions). The checkpoint is the JAX package's
native ``.npz`` with the same ``__meta_*__`` keys.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ur_mvo_tpu_torch.camera import make_pinhole
from ur_mvo_tpu_torch.config import Configs
from ur_mvo_tpu_torch.device import resolve_device
from ur_mvo_tpu_torch.models import superglue
from ur_mvo_tpu_torch.models.superglue import SuperGlue
from ur_mvo_tpu_torch.models.train_superglue import CLIP_NORM, batch_loss
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank
from ur_mvo_tpu_torch.runtime.extractor import NeuralExtractor
from ur_mvo_tpu_torch.utils.synthscene import gt_assignment, render_sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SP_V3 = os.path.join(REPO, "weights", "superpoint_scratch_v3.npz")

H, W, FX = 240, 320, 260.0
CAP = 512


def _make_extractor(device, cap=CAP, max_kpts=400, H=H, W=W, fx=FX, sg_weights=None, threshold=0.5):
    """The v3 detector at its training operating point, matcher ``nn`` or,
    with ``sg_weights``, SuperGlue; float32."""
    cfg = Configs()
    cfg.superpoint.capacity = cap
    cfg.superpoint.max_keypoints = max_kpts
    cfg.superpoint.keypoint_threshold = 1e-4
    cfg.superpoint.weights_path = SP_V3
    cfg.superglue.matcher = "superglue" if sg_weights else "nn"
    if sg_weights:
        cfg.superglue.weights_path = sg_weights
        cfg.superglue.matching_threshold = threshold
    cfg.superglue.image_width = W
    cfg.superglue.image_height = H
    cfg.runtime.compute_dtype = "float32"
    return NeuralExtractor(cfg, make_pinhole(W, H, fx, fx, W / 2, H / 2), device=device)


def _render_scene(seed: int, frames: int, rng, H=H, W=W, fx=FX, baseline=0.0):
    """One scene: plane-only (a third of the time) or 3D multi-plane with a
    random brightness decay and scene depth; with ``baseline`` also the
    right views and their depths (stereo supervision)."""
    n_planes = 0 if seed % 3 == 0 else int(rng.integers(2, 5))
    decay = float(rng.uniform(0.0, 0.03))
    # scene depth randomized: a matcher trained at one depth collapsed at
    # another
    z_bg = float(rng.uniform(4.0, 8.0))
    return render_sequence(frames, H, W, fx, seed=seed, n_planes=n_planes, brightness_decay=decay,
                           z_background=z_bg, baseline=baseline, with_right_depth=baseline > 0)


def _rectify_roundtrip(img: np.ndarray, k1: float, fx: float) -> np.ndarray:
    """The resampling footprint of right-camera rectification: a radial
    warp and its inverse (two bilinear resamples), whose geometry round-trips
    to O(k1^2) (< 0.2 px at |k1| <= 0.06), so the labels stay valid."""
    Hh, Ww = img.shape
    cx, cy = Ww / 2.0, Hh / 2.0
    yy, xx = np.mgrid[0:Hh, 0:Ww].astype(np.float64)
    x = (xx - cx) / fx
    y = (yy - cy) / fx
    r2 = x * x + y * y

    def sample(im, u, v):
        u0 = np.clip(np.floor(u).astype(int), 0, Ww - 2)
        v0 = np.clip(np.floor(v).astype(int), 0, Hh - 2)
        du = np.clip(u - u0, 0, 1)
        dv = np.clip(v - v0, 0, 1)
        return (im[v0, u0] * (1 - du) * (1 - dv) + im[v0, u0 + 1] * du * (1 - dv)
                + im[v0 + 1, u0] * (1 - du) * dv + im[v0 + 1, u0 + 1] * du * dv)

    f = 1.0 + k1 * r2
    im1 = sample(img.astype(np.float64), x * f * fx + cx, y * f * fx + cy)
    g = 1.0 - k1 * r2
    out = sample(im1, x * g * fx + cx, y * g * fx + cy)
    return np.clip(out, 0, 255).astype(np.uint8)


def gen_data(args):
    """Banks of rendered scenes and their labelled pairs, to ``args.out``."""
    # multi-resolution scene family; keypoints stored rescaled into the
    # 240x320 reference frame so the trainer's position normalization holds
    res_family = [(120, 160), (240, 320), (360, 480), (480, 640)] if args.multires else [(H, W)]
    exts = {}
    rng = np.random.default_rng(args.seed)
    scores, kpts, desc, valid = [], [], [], []
    pair_fi, pair_fj, tgt0s, tgt1s = [], [], [], []
    n_frames_total = 0
    t0 = time.time()

    def add_pair(i, j, *gt_args, **gt_kw):
        t_0, t_1 = gt_assignment(*gt_args, **gt_kw)
        if (t_0 < args.capacity).sum() < 30:
            return
        pair_fi.append(i)
        pair_fj.append(j)
        tgt0s.append(t_0)
        tgt1s.append(t_1)

    for s in range(args.scenes):
        seed = args.seed + 1000 + s
        Hs, Ws = res_family[s % len(res_family)]
        fxs = FX * (Ws / W)
        if (Hs, Ws) not in exts:
            exts[(Hs, Ws)] = _make_extractor(args.device, cap=args.capacity, max_kpts=args.max_kpts, H=Hs, W=Ws,
                                             fx=fxs)
        ext = exts[(Hs, Ws)]
        baseline = float(rng.uniform(0.05, 0.2)) if args.stereo else 0.0
        out_r = _render_scene(seed, args.frames, rng, H=Hs, W=Ws, fx=fxs, baseline=baseline)
        imgs, T, depths = out_r[0], out_r[1], out_r[2]
        base = n_frames_total
        kpts_scene = []  # scene-resolution coords, for the ground truth

        def add_bank(img):
            b = ext.extract(img)
            k_scene = b.kpts.cpu().numpy().astype(np.float32)
            kpts_scene.append(k_scene)
            scores.append(b.scores.cpu().numpy().astype(np.float32))
            kpts.append(k_scene * np.array([W / Ws, H / Hs], np.float32))
            desc.append(b.desc.cpu().numpy().astype(np.float16))
            valid.append(b.valid.cpu().numpy())

        for i in range(args.frames):
            add_bank(imgs[i])
        n_frames_total += args.frames
        tol = args.tol_px * (Ws / W)
        if args.stereo:
            # right banks after the left ones, half through the
            # rectification-resampling blur; left-right pairs at one time
            imgs_r, depths_r = out_r[3], out_r[4]
            base_r = n_frames_total
            T_r = T.copy()
            for i in range(args.frames):
                T_r[i, :3, 3] = T[i, :3, 3] + T[i, :3, :3] @ np.array([baseline, 0.0, 0.0])
                img_r = imgs_r[i]
                if s % 2 == 0:
                    img_r = _rectify_roundtrip(img_r, float(rng.uniform(-0.06, 0.06)), fxs)
                add_bank(img_r)
            n_frames_total += args.frames
            for i in range(args.frames):
                add_pair(base + i, base_r + i, kpts_scene[i], valid[base + i], kpts_scene[args.frames + i],
                         valid[base_r + i], depths[i], T[i], T_r[i], fxs, Ws / 2, Hs / 2, depth1=depths_r[i],
                         tol_px=tol)
        for i in range(args.frames):
            # VO matches the current frame against a keyframe up to ~10
            # frames back: supervise those gaps, not adjacent pairs alone
            for gap in (1, 2, 3, 5, 7, 9):
                j = i + gap
                if j < args.frames:
                    add_pair(base + i, base + j, kpts_scene[i], valid[base + i], kpts_scene[j], valid[base + j],
                             depths[i], T[i], T[j], fxs, Ws / 2, Hs / 2, depth1=depths[j], tol_px=tol)
        print(f"scene {s + 1}/{args.scenes} ({Hs}x{Ws}): {len(pair_fi)} pairs so far ({time.time() - t0:.0f}s)",
              flush=True)
    np.savez_compressed(
        args.out, scores=np.stack(scores), kpts=np.stack(kpts), desc=np.stack(desc), valid=np.stack(valid),
        pair_fi=np.asarray(pair_fi, np.int32), pair_fj=np.asarray(pair_fj, np.int32),
        tgt0=np.stack(tgt0s), tgt1=np.stack(tgt1s), width=W, height=H,
    )
    gt_counts = (np.stack(tgt0s) < args.capacity).sum(1)
    print(f"wrote {args.out}: {len(pair_fi)} pairs over {n_frames_total} frames, "
          f"GT matches/pair median {np.median(gt_counts):.0f}")


def warmup_cosine(lr: float, warmup: int, decay_steps: int, end: float):
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps, end)``
    as a function of the update count."""

    def at(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        t = min(count - warmup, decay_steps - warmup) / (decay_steps - warmup)
        return (lr - end) * 0.5 * (1.0 + math.cos(math.pi * t)) + end

    return at


def augment(g: torch.Generator, b0: FeatureBank, b1: FeatureBank, aug: str):
    """Correspondence-preserving augmentation of a batch of pairs: mirror
    flips shared by a pair's banks, sub-pixel keypoint jitter, small
    descriptor noise; ``strong`` adds a small similarity warp a bank,
    ``vo-hard`` a global shift of bank 1 (which breaks the "nearest
    position" shortcut) with half the descriptor noise."""
    B = b0.kpts.shape[0]
    dev = g.device
    flip_x = torch.rand((B, 1), generator=g, device=dev) < 0.5
    flip_y = torch.rand((B, 1), generator=g, device=dev) < 0.5
    c = torch.tensor([W / 2.0, H / 2.0], device=dev)
    shift = -40.0 + 80.0 * torch.rand((B, 1, 2), generator=g, device=dev)
    d_noise = 0.02 if aug == "vo-hard" else 0.05

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    def warp(b, extra_shift=None):
        x = torch.where(flip_x, W - 1.0 - b.kpts[..., 0], b.kpts[..., 0])
        y = torch.where(flip_y, H - 1.0 - b.kpts[..., 1], b.kpts[..., 1])
        p = torch.stack([x, y], dim=-1)
        if aug == "strong":
            th, sc = uniform((B,), -0.25, 0.25), uniform((B,), 0.9, 1.1)
            t = uniform((B, 1, 2), -15.0, 15.0)
            ct, st = torch.cos(th), torch.sin(th)
            R = torch.stack([torch.stack([ct, -st], -1), torch.stack([st, ct], -1)], -2)
            p = (p - c) @ (sc[:, None, None] * R).transpose(-1, -2) + c + t
        if extra_shift is not None:
            p = p + extra_shift
        p = p + 0.3 * torch.randn(p.shape, generator=g, device=dev)
        d = b.desc + d_noise * torch.randn(b.desc.shape, generator=g, device=dev)
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-6)
        m = b.valid[..., None]
        return b._replace(kpts=p * m, desc=d * m)

    return warp(b0), warp(b1, shift if aug == "vo-hard" else None)


def train(args):
    """Train on ``args.data``; writes ``args.out`` with its ``__meta_*__``
    operating point (every 5,000 steps and at the end)."""
    dev = resolve_device(args.device)
    data = np.load(args.data)
    S = len(data["pair_fi"])
    print(f"{S} pairs, {len(data['scores'])} frames; device: {dev}")
    # the dataset resident on the device; descriptors stay float16 until gathered
    dset = {k: torch.from_numpy(data[k]).to(dev) for k in ("scores", "kpts", "desc", "valid", "tgt0", "tgt1")}
    dset["fi"] = torch.from_numpy(data["pair_fi"]).to(dev).long()
    dset["fj"] = torch.from_numpy(data["pair_fj"]).to(dev).long()

    # gap balancing: each temporal-gap class (and the stereo left-right
    # class) gets equal sampling mass; uniform sampling is dominated by
    # small-flow pairs and teaches a positional shortcut
    pair_w = None
    if args.balance_gaps:
        gaps = (data["pair_fj"] - data["pair_fi"]).astype(np.int64)
        classes, counts = np.unique(gaps, return_counts=True)
        w = np.zeros(S, np.float64)
        for cl, cnt in zip(classes, counts):
            w[gaps == cl] = 1.0 / (len(classes) * cnt)
        pair_w = torch.from_numpy((w / w.sum()).astype(np.float32)).to(dev)
        print(f"gap balance: classes {dict(zip(classes.tolist(), counts.tolist()))}")

    state = SuperGlue(args.layers).init_random(torch.Generator().manual_seed(args.seed)).state_dict()
    if args.init_from:
        state = superglue.load_weights(args.init_from, args.layers, args.heads)
    if "desc_center" not in state:
        # learned descriptor re-centering, initialized at the dataset mean
        state["desc_center"] = torch.from_numpy(data["desc"][data["valid"]].astype(np.float32).mean(0))
    model = SuperGlue.from_state_dict(state, kernels=False).to(dev)
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-5)
    schedule = warmup_cosine(args.lr, 200, max(args.steps, 201), args.lr * 0.05)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda count: schedule(count) / args.lr)

    def gather(idx):
        def bank(f):
            return FeatureBank(scores=dset["scores"][f], kpts=dset["kpts"][f], desc=dset["desc"][f].float(),
                               valid=dset["valid"][f])

        return bank(dset["fi"][idx]), bank(dset["fj"][idx]), dset["tgt0"][idx], dset["tgt1"][idx]

    def one_step(g):
        if pair_w is not None:
            idx = torch.multinomial(pair_w, args.batch, replacement=True, generator=g)
        else:
            idx = torch.randint(0, S, (args.batch,), generator=g, device=dev)
        b0, b1, t0, t1 = gather(idx)
        b0, b1 = augment(g, b0, b1, args.aug)
        optimizer.zero_grad(set_to_none=True)
        loss = batch_loss(model, b0, b1, t0, t1, W, H, args.sinkhorn_iters, args.heads)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(), CLIP_NORM)
        optimizer.step()
        scheduler.step()
        return loss.detach()

    def save():
        superglue.save_npz(args.out, model)
        state = dict(np.load(args.out))
        state["__meta_num_layers__"] = np.asarray(args.layers)
        state["__meta_num_heads__"] = np.asarray(args.heads)
        state["__meta_matching_threshold__"] = np.asarray(args.rec_threshold)
        # the validated operating point the training banks were made at
        state["__meta_op_capacity__"] = np.asarray(args.op_capacity)
        state["__meta_op_max_keypoints__"] = np.asarray(args.op_max_keypoints)
        state["__meta_op_keypoint_threshold__"] = np.asarray(args.op_keypoint_threshold)
        state["__meta_op_min_matches__"] = np.asarray(args.op_min_matches)
        state["__meta_op_min_features_first__"] = np.asarray(args.op_min_features_first)
        np.savez(args.out, **state)

    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    done, last_save = 0, 0
    t0 = time.time()
    while done < args.steps:
        losses = torch.stack([one_step(g) for _ in range(args.chunk)])
        done += args.chunk
        print(f"step {done}/{args.steps}: loss {float(losses.mean()):.4f} ({time.time() - t0:.0f}s)", flush=True)
        if done - last_save >= 5000:
            save()
            last_save = done
    save()
    print(f"saved {args.out}")
    return model


def evaluate(args):
    """Held-out scenes: decoded-match precision and recall against the
    ground truth, mutual-NN (``nn``) beside SuperGlue (``sg``)."""
    ext = _make_extractor(args.device)
    sg_ext = _make_extractor(args.device, sg_weights=args.weights, threshold=args.threshold) if args.weights else None
    rng = np.random.default_rng(args.seed + 7777)
    stats = {"nn": [0, 0, 0], "sg": [0, 0, 0]}  # matches, correct, gt
    for s in range(args.scenes):
        seed = args.seed + 9000 + s  # disjoint from the training seeds
        imgs, T, depths = _render_scene(seed, args.frames, rng)
        banks = [ext.extract(imgs[i]) for i in range(args.frames)]
        for i in range(args.frames):
            for gap in (1, 2, 5, 8):  # keyframe-scale gaps included
                j = i + gap
                if j >= args.frames:
                    continue
                k0, v0 = banks[i].kpts.cpu().numpy(), banks[i].valid.cpu().numpy()
                k1, v1 = banks[j].kpts.cpu().numpy(), banks[j].valid.cpu().numpy()
                t_0, _ = gt_assignment(k0, v0, k1, v1, depths[i], T[i], T[j], FX, W / 2, H / 2, depth1=depths[j])
                n_gt = int((t_0 < CAP).sum())
                for name, e in (("nn", ext), ("sg", sg_ext)):
                    if e is None:
                        continue
                    m = e.match(banks[i], banks[j], outlier_rejection=False)
                    idx1, mv = m.idx1.cpu().numpy(), m.valid.cpu().numpy()
                    pred = np.where(mv, idx1, -1)
                    stats[name][0] += int(mv.sum())
                    stats[name][1] += int(((pred == t_0) & (t_0 < CAP) & mv).sum())
                    stats[name][2] += n_gt
    for name, (n, c, g) in stats.items():
        if n:
            print(f"{name}: matches {n}, precision {c / max(n, 1):.3f}, recall {c / max(g, 1):.3f}")
    return stats


def main(argv: Optional[Sequence[str]] = None):
    """Run the command line ``argv``; returns the subcommand's result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("data")
    d.add_argument("--out", default="sg_data.npz")
    d.add_argument("--scenes", type=int, default=200)
    d.add_argument("--frames", type=int, default=10)  # gaps up to 9 need them
    d.add_argument("--tol-px", type=float, default=3.0)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--capacity", type=int, default=CAP,
                   help="feature-bank capacity of the generated banks (the matcher's native K)")
    d.add_argument("--max-kpts", type=int, default=400)
    d.add_argument("--multires", action="store_true",
                   help="cycle scenes through 120x160..480x640 (kpts stored rescaled to 240x320)")
    d.add_argument("--stereo", action="store_true",
                   help="also render right views and label left-right pairs")

    t = sub.add_parser("train")
    t.add_argument("--data", default="sg_data.npz")
    t.add_argument("--out", default=os.path.join(REPO, "weights", "superglue_v3scene.npz"))
    t.add_argument("--steps", type=int, default=3000)
    t.add_argument("--batch", type=int, default=8)
    t.add_argument("--chunk", type=int, default=50)
    t.add_argument("--layers", type=int, default=9)
    t.add_argument("--heads", type=int, default=4)
    t.add_argument("--sinkhorn-iters", type=int, default=20)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--init-from", default=None)
    t.add_argument("--aug", default="mild", choices=["mild", "strong", "vo-hard"])
    t.add_argument("--balance-gaps", action="store_true",
                   help="equal sampling mass for each temporal-gap / left-right pair class")
    t.add_argument("--rec-threshold", type=float, default=0.5,
                   help="recommended decode threshold embedded in the checkpoint")
    t.add_argument("--op-capacity", type=int, default=512)
    t.add_argument("--op-max-keypoints", type=int, default=400)
    t.add_argument("--op-keypoint-threshold", type=float, default=1e-4)
    t.add_argument("--op-min-matches", type=int, default=60)
    t.add_argument("--op-min-features-first", type=int, default=100)

    e = sub.add_parser("eval")
    e.add_argument("--weights", default=None)
    e.add_argument("--scenes", type=int, default=4)
    e.add_argument("--frames", type=int, default=5)
    e.add_argument("--threshold", type=float, default=0.5)
    e.add_argument("--seed", type=int, default=0)

    for p in (d, t, e):
        p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    return {"data": gen_data, "train": train, "eval": evaluate}[args.cmd](args)


if __name__ == "__main__":
    main()
