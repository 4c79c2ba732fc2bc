"""Write an on-disk synthetic VO dataset (EuRoC layout + TUM ground truth).

Renders views of a textured plane (or, with ``--scene 3d``, the multi-plane
scene of ``utils/synthscene``) under a smooth camera trajectory and writes
the frames with nanosecond timestamps, the TUM ground truth and the true
calibration (``camera.yaml``, which ``cli.run_vo`` picks up): a stand-in
for an Aqualoc sequence, so that the whole command-line workflow runs
without external data. The port of ``scripts/make_synthetic_dataset.py``;
rendering is numpy and the port's ``ops.lie``, so there is no device to
choose.

  python -m ur_mvo_tpu_torch.cli.make_synthetic_dataset --out seq_dir
      [--frames 60] [--size 240 320] [--gt gt.txt] [--seed 0]
      [--setup mono|stereo|rgbd] [--scene plane|3d] [--masks]
      [--image-format png|npy]

``--image-format npy`` writes the frames as uint8 ``.npy``, which the
native prefetcher reads (``Dataset.reader == "native"``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ur_mvo_tpu_torch.camera import undistort_radtan
from ur_mvo_tpu_torch.ops.lie import rotmat_to_quat, so3_exp
from ur_mvo_tpu_torch.utils.tum_io import write_tum


def render_plane_sequence(n_frames, H, W, fx, seed=0, baseline=0.0, with_depth=False,
                          d_right=None):
    """Textured-plane renderer (the JAX package's script's, bit for bit in
    its draws; rotations through the port's ``ops.lie``).

    ``baseline`` > 0 also renders a right camera displaced by
    ``R @ [baseline, 0, 0]``; ``with_depth`` returns per-pixel metric
    camera-frame depth of the left view. ``d_right`` (radtan k1,k2,p1,p2)
    renders the right view through a DISTORTED lens — exercising the
    separate right-camera rectify map (``camera.cc:61-75,117-127``).
    Returns ``(images, T_wc[, images_right][, depths])``."""
    rng = np.random.default_rng(seed)
    tex_coarse = rng.random((200, 260))
    texture = (np.kron(tex_coarse, np.ones((4, 4))) * 255).astype(np.float32)
    TH, TW = texture.shape
    Z0 = 4.0
    scale_px = 90.0
    cx, cy = W / 2.0, H / 2.0
    images = np.zeros((n_frames, H, W), np.uint8)
    images_r = np.zeros((n_frames, H, W), np.uint8) if baseline > 0 else None
    depths = np.zeros((n_frames, H, W), np.float32) if with_depth else None
    poses = np.zeros((n_frames, 4, 4))
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([(xx - cx) / fx, (yy - cy) / fx, np.ones_like(xx)], -1)
    if d_right is not None:
        # right-lens ray field: pixel (u,v) sees the ray whose forward
        # distortion lands back on (u,v)
        xy = undistort_radtan(rays[..., :2].copy(), np.asarray(d_right, np.float64))
        rays_right = np.concatenate([xy, np.ones_like(xy[..., :1])], -1)
    else:
        rays_right = rays

    def render(R, t, rays=rays):
        rays_w = rays @ R.T
        lam = (Z0 - t[2]) / rays_w[..., 2]
        pw = t + rays_w * lam[..., None]
        u = pw[..., 0] * scale_px + TW / 2
        v = pw[..., 1] * scale_px + TH / 2
        u0 = np.clip(np.floor(u).astype(int), 0, TW - 2)
        v0 = np.clip(np.floor(v).astype(int), 0, TH - 2)
        du = np.clip(u - u0, 0, 1)
        dv = np.clip(v - v0, 0, 1)
        img = (
            texture[v0, u0] * (1 - du) * (1 - dv)
            + texture[v0, u0 + 1] * du * (1 - dv)
            + texture[v0 + 1, u0] * (1 - du) * dv
            + texture[v0 + 1, u0 + 1] * du * dv
        )
        # camera-frame depth: pc = lam * ray_cam, ray_cam_z = 1
        return np.clip(img, 0, 255).astype(np.uint8), lam.astype(np.float32)

    for i in range(n_frames):
        yaw = 0.03 * np.sin(0.3 * i)
        R = so3_exp(torch.tensor([0.0, yaw, 0.015 * np.sin(0.2 * i)], dtype=torch.float32)).numpy()
        t = np.array([0.08 * i, 0.04 * np.sin(0.3 * i), 0.02 * np.sin(0.17 * i)])
        poses[i, :3, :3] = R
        poses[i, :3, 3] = t
        poses[i, 3, 3] = 1.0
        images[i], lam = render(R, t)
        if with_depth:
            depths[i] = lam
        if baseline > 0:
            images_r[i], _ = render(R, t + R @ np.array([baseline, 0.0, 0.0]), rays=rays_right)
    out = [images, poses]
    if baseline > 0:
        out.append(images_r)
    if with_depth:
        out.append(depths)
    return tuple(out)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m ur_mvo_tpu_torch.cli.make_synthetic_dataset")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", type=int, nargs=2, default=(240, 320), metavar=("H", "W"))
    ap.add_argument("--fx", type=float, default=260.0)
    ap.add_argument("--gt", default=None, help="TUM ground-truth output path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--setup", default="mono", choices=["mono", "stereo", "rgbd"],
                    help="also write cam1/ (stereo, baseline 0.1 m) or depth0/ (rgbd, metric .npy)")
    ap.add_argument("--baseline", type=float, default=0.1, help="stereo baseline in meters")
    ap.add_argument("--distort-right", type=float, nargs=4, default=None,
                    metavar=("K1", "K2", "P1", "P2"),
                    help="render the right view through a radtan-distorted lens and "
                         "write a RIGHT_K/D/R/P calib block (stereo only)")
    ap.add_argument("--masks", action="store_true",
                    help="also write semantic masks (mask0/data): a moving blanked "
                         "band simulating a dynamic object to exclude from features")
    ap.add_argument("--brightness-decay", type=float, default=0.0,
                    help="3d-scene per-frame brightness decay (frame i is "
                         "dimmed by (1-d)^i; photometric degradation is the "
                         "domain where the learned matcher beats mutual-NN)")
    ap.add_argument("--z-background", type=float, default=6.0,
                    help="3d-scene background depth (6.0 = the benchmark "
                         "family the shipped matcher is trained/gated on)")
    ap.add_argument("--scene", default="plane", choices=["plane", "3d"],
                    help="'plane': single fronto-parallel textured plane; '3d': "
                         "multi-plane scene with depth discontinuity + occlusion "
                         "(ur_mvo_tpu_torch.utils.synthscene). A constant-depth plane is "
                         "DEGENERATE for RGB-D/stereo VO (yaw and x-translation "
                         "produce identical image motion) — use '3d' for those.")
    ap.add_argument("--image-format", default="png", choices=["png", "npy"],
                    help="write cam0/cam1 frames (and masks) as PNG or as uint8 .npy (read by the "
                         "native prefetcher)")
    args = ap.parse_args(argv)

    if args.image_format == "png":
        from PIL import Image as PILImage

        def save(path, img):
            PILImage.fromarray(img).save(path + ".png")
    else:
        def save(path, img):
            np.save(path + ".npy", img)

    H, W = args.size
    baseline = args.baseline if args.setup == "stereo" else 0.0
    d_right = args.distort_right if args.setup == "stereo" else None
    if args.scene == "3d":
        if d_right is not None:
            raise SystemExit("--distort-right is only implemented for --scene plane")
        from ur_mvo_tpu_torch.utils.synthscene import render_sequence

        out3 = render_sequence(args.frames, H, W, args.fx, seed=args.seed,
                               n_planes=3, baseline=baseline,
                               z_background=args.z_background,
                               brightness_decay=args.brightness_decay)
        images, T_wc, depths = out3[0], out3[1], out3[2]
        images_r = out3[3] if args.setup == "stereo" else None
        if args.setup != "rgbd":
            depths = None
    else:
        out = render_plane_sequence(
            args.frames, H, W, args.fx, args.seed,
            baseline=baseline, with_depth=args.setup == "rgbd",
            d_right=d_right,
        )
        images, T_wc = out[0], out[1]
        images_r = out[2] if args.setup == "stereo" else None
        depths = out[2] if args.setup == "rgbd" else None
    data_dir = os.path.join(args.out, "cam0", "data")
    os.makedirs(data_dir, exist_ok=True)
    right_dir = os.path.join(args.out, "cam1", "data")
    depth_dir = os.path.join(args.out, "depth0", "data")
    if images_r is not None:
        os.makedirs(right_dir, exist_ok=True)
    if depths is not None:
        os.makedirs(depth_dir, exist_ok=True)
    mask_dir = os.path.join(args.out, "mask0", "data")
    if args.masks:
        os.makedirs(mask_dir, exist_ok=True)
    ts0 = 1400000000000000000
    dt = int(1e9 / args.fps)
    ts = []
    for i in range(args.frames):
        t = ts0 + i * dt
        save(os.path.join(data_dir, str(t)), images[i])
        if images_r is not None:
            save(os.path.join(right_dir, str(t)), images_r[i])
        if depths is not None:
            np.save(os.path.join(depth_dir, f"{t}.npy"), depths[i])
        if args.masks:
            m = np.full((H, W), 255, np.uint8)
            x0 = int((0.1 + 0.02 * i) * W) % W  # drifting "dynamic object"
            m[:, x0 : min(x0 + W // 6, W)] = 0
            save(os.path.join(mask_dir, str(t)), m)
        ts.append(t * 1e-9)
    gt_path = args.gt or os.path.join(args.out, "gt.txt")
    q = rotmat_to_quat(torch.from_numpy(T_wc[:, :3, :3].astype(np.float32))).numpy()
    write_tum(gt_path, ts, T_wc[:, :3, 3], q)

    # true calibration in the reference's OpenCV-YAML format, picked up
    # automatically by cli.run_vo (and loadable via
    # input.camera_config_path in a config YAML)
    cam_path = os.path.join(args.out, "camera.yaml")
    fx = args.fx
    cx, cy = W / 2.0, H / 2.0
    with open(cam_path, "w") as f:
        f.write(
            "%YAML:1.0\n---\n"
            f"image_width: {W}\n"
            f"image_height: {H}\n"
            "distortion_type: 0\n"
            "LEFT_K: !!opencv-matrix\n"
            "   rows: 3\n   cols: 3\n   dt: d\n"
            f"   data: [{fx}, 0., {cx}, 0., {fx}, {cy}, 0., 0., 1.]\n"
            "LEFT_D: !!opencv-matrix\n"
            "   rows: 1\n   cols: 4\n   dt: d\n"
            "   data: [0., 0., 0., 0.]\n"
        )
        if args.setup == "stereo":
            f.write(f"bf: {fx * args.baseline}\n")
            if d_right is not None:
                k1, k2, p1, p2 = d_right
                f.write(
                    "RIGHT_K: !!opencv-matrix\n"
                    "   rows: 3\n   cols: 3\n   dt: d\n"
                    f"   data: [{fx}, 0., {cx}, 0., {fx}, {cy}, 0., 0., 1.]\n"
                    "RIGHT_D: !!opencv-matrix\n"
                    "   rows: 1\n   cols: 4\n   dt: d\n"
                    f"   data: [{k1}, {k2}, {p1}, {p2}]\n"
                    # explicit identity rectifying rotation: the reference
                    # requires ALL of RIGHT_K/D/R/P (camera.cc:53-59), so
                    # generated calibs must be loadable by it too
                    "RIGHT_R: !!opencv-matrix\n"
                    "   rows: 3\n   cols: 3\n   dt: d\n"
                    "   data: [1., 0., 0., 0., 1., 0., 0., 0., 1.]\n"
                    "RIGHT_P: !!opencv-matrix\n"
                    "   rows: 3\n   cols: 4\n   dt: d\n"
                    f"   data: [{fx}, 0., {cx}, {-fx * args.baseline}, 0., {fx}, {cy}, 0., 0., 0., 1., 0.]\n"
                )
    print(f"wrote {args.frames} frames to {data_dir}, GT to {gt_path}, calib to {cam_path}")


if __name__ == "__main__":
    main()
