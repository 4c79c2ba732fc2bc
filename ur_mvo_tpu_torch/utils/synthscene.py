"""Synthetic 3D multi-plane scene renderer and ground-truth correspondence
(the port's own copy of ``ur_mvo_tpu.utils.synthscene``).

Several finite textured planes at different depths plus an infinite
background, so views contain depth discontinuities and occlusion, with
optional per-frame brightness decay. Every render also returns per-pixel
metric depth, which gives exact, occlusion-checked pixel transfer between
views (:func:`gt_assignment`, the SuperGlue trainer's supervision).
Everything is vectorized host-side numpy: rendering makes test, training
and smoke-run inputs, it is not a device workload. Rotations come
from a numpy Rodrigues (:func:`so3_exp`), so nothing here needs JAX.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class MultiPlaneScene:
    """Fronto-parallel textured planes z = z_k (world), nearest-hit wins.

    The last plane is the background: infinite extent so every ray hits.
    ``origins`` are the world (x, y) of each texture's center and
    ``scales`` its resolution in texture pixels per world meter.
    """

    zs: List[float]
    extents: List[Tuple[float, float, float, float]]  # x0, x1, y0, y1 (world)
    textures: List[np.ndarray]
    scales: List[float]
    origins: List[Tuple[float, float]]


def _band_limited_texture(rng: np.random.Generator, h: int, w: int, up: int = 4) -> np.ndarray:
    """Smooth random texture in [0, 255]: coarse noise, kron-upsampled so
    bilinear sampling stays well-behaved under warps."""
    coarse = rng.random((h, w))
    return (np.kron(coarse, np.ones((up, up))) * 255.0).astype(np.float32)


def make_scene(
    seed: int = 0,
    n_planes: int = 3,
    z_range: Tuple[float, float] = (2.2, 4.5),
    z_background: float = 6.0,
    span_x: Tuple[float, float] = (-1.0, 3.0),
) -> MultiPlaneScene:
    """Random scene: ``n_planes`` finite foreground planes at distinct
    depths in ``z_range`` plus an infinite background plane at
    ``z_background``. Foreground centers spread across ``span_x`` so a
    camera translating along +x keeps structure in view."""
    rng = np.random.default_rng(seed)
    zs, extents, textures, scales, origins = [], [], [], [], []
    depth_slots = np.linspace(z_range[0], z_range[1], max(n_planes, 1))
    for i in range(n_planes):
        z = float(depth_slots[i] + rng.uniform(-0.15, 0.15))
        cx = float(rng.uniform(span_x[0], span_x[1]))
        cy = float(rng.uniform(-0.8, 0.8))
        half_w = float(rng.uniform(0.5, 1.3))
        half_h = float(rng.uniform(0.4, 1.0))
        zs.append(z)
        extents.append((cx - half_w, cx + half_w, cy - half_h, cy + half_h))
        textures.append(_band_limited_texture(rng, 140, 180))
        scales.append(float(rng.uniform(70.0, 110.0)))
        origins.append((cx, cy))
    # background: infinite, coarser texture (farther away)
    zs.append(float(z_background))
    extents.append((-np.inf, np.inf, -np.inf, np.inf))
    textures.append(_band_limited_texture(rng, 260, 340))
    scales.append(60.0)
    origins.append((1.0, 0.0))
    return MultiPlaneScene(zs, extents, textures, scales, origins)


def render_view(
    scene: MultiPlaneScene,
    T_wc: np.ndarray,
    fx: float,
    H: int,
    W: int,
    brightness: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render one view. Returns (image u8 (H, W), depth f32 (H, W)) where
    depth is camera-frame z of the nearest surface (exact GT)."""
    cx, cy = W / 2.0, H / 2.0
    R = np.asarray(T_wc[:3, :3], np.float64)
    t = np.asarray(T_wc[:3, 3], np.float64)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([(xx - cx) / fx, (yy - cy) / fx, np.ones_like(xx)], -1)
    rays_w = rays @ R.T  # world-frame directions; |z component| scales depth

    img = np.zeros((H, W), np.float64)
    depth = np.full((H, W), np.inf, np.float64)
    for z, (x0, x1, y0, y1), tex, sc, (ox, oy) in zip(
        scene.zs, scene.extents, scene.textures, scene.scales, scene.origins
    ):
        denom = rays_w[..., 2]
        lam = (z - t[2]) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        px = t[0] + rays_w[..., 0] * lam
        py = t[1] + rays_w[..., 1] * lam
        hit = (lam > 0.05) & (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
        # camera-frame depth of the hit (ray_cam z == 1 => depth == lam)
        nearer = hit & (lam < depth)
        TH, TW = tex.shape
        u = (px - ox) * sc + TW / 2.0
        v = (py - oy) * sc + TH / 2.0
        u0 = np.clip(np.floor(u).astype(int), 0, TW - 2)
        v0 = np.clip(np.floor(v).astype(int), 0, TH - 2)
        du = np.clip(u - u0, 0, 1)
        dv = np.clip(v - v0, 0, 1)
        val = (
            tex[v0, u0] * (1 - du) * (1 - dv)
            + tex[v0, u0 + 1] * du * (1 - dv)
            + tex[v0 + 1, u0] * (1 - du) * dv
            + tex[v0 + 1, u0 + 1] * du * dv
        )
        img = np.where(nearer, val, img)
        depth = np.where(nearer, lam, depth)
    img = np.clip(img * brightness, 0, 255).astype(np.uint8)
    return img, depth.astype(np.float32)


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues' formula: axis-angle (3,) -> rotation matrix (3, 3)."""
    w = np.asarray(w, np.float64)
    theta = float(np.linalg.norm(w))
    Wx = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if theta < 1e-12:
        return np.eye(3) + Wx
    return (
        np.eye(3)
        + np.sin(theta) / theta * Wx
        + (1.0 - np.cos(theta)) / (theta * theta) * (Wx @ Wx)
    )


def default_trajectory(n_frames: int, advance: float = 0.08) -> np.ndarray:
    """Gentle forward-lateral sweep with yaw/pitch, same family as the
    round-1 plane benchmark (T_wc (N, 4, 4))."""
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        yaw = 0.03 * np.sin(0.3 * i)
        R = so3_exp(np.array([0.0, yaw, 0.015 * np.sin(0.2 * i)]))
        t = np.array([advance * i, 0.04 * np.sin(0.3 * i), 0.02 * np.sin(0.17 * i)])
        poses[i, :3, :3] = R
        poses[i, :3, 3] = t
        poses[i, 3, 3] = 1.0
    return poses


def out_and_back_trajectory(n_frames: int, advance: float = 0.08) -> np.ndarray:
    """Loop-bearing path: forward leg, smooth turnaround, return to the
    start viewpoint at the same heading — the long-sequence proxy of the
    accuracy protocol (``T_wc`` (N, 4, 4)). The sin() position profile keeps
    per-frame motion <= ``advance`` while the end frame re-observes the
    start frame's view, so loop closure and relocalization have a genuine
    revisit to fire on."""
    x_max = advance * (n_frames - 1) / np.pi
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        s = np.pi * i / (n_frames - 1)
        yaw = 0.03 * np.sin(0.3 * i)
        R = so3_exp(np.array([0.0, yaw, 0.015 * np.sin(0.2 * i)]))
        t = np.array([x_max * np.sin(s), 0.04 * np.sin(0.3 * i), 0.02 * np.sin(0.17 * i)])
        poses[i, :3, :3] = R
        poses[i, :3, 3] = t
        poses[i, 3, 3] = 1.0
    return poses


def render_sequence(
    n_frames: int,
    H: int = 240,
    W: int = 320,
    fx: float = 260.0,
    seed: int = 0,
    n_planes: int = 3,
    brightness_decay: float = 0.0,
    poses: Optional[np.ndarray] = None,
    baseline: float = 0.0,
    z_background: float = 6.0,
    with_right_depth: bool = False,
) -> tuple:
    """Render a 3D-scene sequence.

    Returns ``(images, T_wc, depths)`` or, with ``baseline`` > 0,
    ``(images, T_wc, depths, images_right)`` (plus ``depths_right`` when
    ``with_right_depth`` — needed to occlusion-check left-right GT
    correspondence for stereo matcher supervision). ``brightness_decay``
    d dims frame i by ``(1 - d)^i`` (photometric degradation)."""
    scene = make_scene(seed, n_planes=n_planes, z_background=z_background)
    if poses is None:
        poses = default_trajectory(n_frames)
    images = np.zeros((n_frames, H, W), np.uint8)
    depths = np.zeros((n_frames, H, W), np.float32)
    images_r = np.zeros((n_frames, H, W), np.uint8) if baseline > 0 else None
    depths_r = np.zeros((n_frames, H, W), np.float32) if (baseline > 0 and with_right_depth) else None
    for i in range(n_frames):
        b = (1.0 - brightness_decay) ** i
        images[i], depths[i] = render_view(scene, poses[i], fx, H, W, brightness=b)
        if baseline > 0:
            T_r = poses[i].copy()
            T_r[:3, 3] = T_r[:3, 3] + T_r[:3, :3] @ np.array([baseline, 0.0, 0.0])
            images_r[i], d_r = render_view(scene, T_r, fx, H, W, brightness=b)
            if depths_r is not None:
                depths_r[i] = d_r
    if baseline > 0:
        if with_right_depth:
            return images, poses, depths, images_r, depths_r
        return images, poses, depths, images_r
    return images, poses, depths


# ---------------------------------------------------------------------------
# Exact ground-truth correspondence between two rendered views
# ---------------------------------------------------------------------------

def transfer_points(
    kpts: np.ndarray,
    depth_map: np.ndarray,
    T_i: np.ndarray,
    T_j: np.ndarray,
    fx: float,
    cx: float,
    cy: float,
    depth_map_j: Optional[np.ndarray] = None,
    occlusion_tol: float = 0.03,
) -> Tuple[np.ndarray, np.ndarray]:
    """Transfer pixels from view i to view j via rendered depth.

    ``kpts`` (N, 2) pixels in view i; returns ``(uv_j (N, 2), visible (N,))``
    where visibility requires positive depth in j, in-image bounds, and —
    when ``depth_map_j`` is given — an occlusion test: the transferred
    point's camera-z must match view j's depth buffer within
    ``occlusion_tol`` (relative)."""
    H, W = depth_map.shape
    ui = np.clip(np.round(kpts[:, 0]).astype(int), 0, W - 1)
    vi = np.clip(np.round(kpts[:, 1]).astype(int), 0, H - 1)
    d = depth_map[vi, ui].astype(np.float64)
    rays = np.stack([(kpts[:, 0] - cx) / fx, (kpts[:, 1] - cy) / fx, np.ones(len(kpts))], 1)
    pc_i = rays * d[:, None]
    Ri, ti = T_i[:3, :3], T_i[:3, 3]
    Rj, tj = T_j[:3, :3], T_j[:3, 3]
    pw = pc_i @ Ri.T + ti
    pc_j = (pw - tj) @ Rj
    zj = pc_j[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uj = fx * pc_j[:, 0] / zj + cx
        vj = fx * pc_j[:, 1] / zj + cy
    visible = np.isfinite(d) & (d > 0) & (zj > 0.05)
    visible &= (uj >= 0) & (uj <= W - 1) & (vj >= 0) & (vj <= H - 1)
    if depth_map_j is not None:
        uc = np.clip(np.round(np.nan_to_num(uj)).astype(int), 0, W - 1)
        vc = np.clip(np.round(np.nan_to_num(vj)).astype(int), 0, H - 1)
        zbuf = depth_map_j[vc, uc].astype(np.float64)
        visible &= np.abs(zbuf - zj) < occlusion_tol * np.maximum(zj, 1e-6) + 0.02
    uv_j = np.stack([np.nan_to_num(uj), np.nan_to_num(vj)], 1).astype(np.float32)
    return uv_j, visible


def gt_assignment(
    kpts0: np.ndarray,
    valid0: np.ndarray,
    kpts1: np.ndarray,
    valid1: np.ndarray,
    depth0: np.ndarray,
    T0: np.ndarray,
    T1: np.ndarray,
    fx: float,
    cx: float,
    cy: float,
    depth1: Optional[np.ndarray] = None,
    tol_px: float = 3.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ground-truth partial assignment between two extracted keypoint sets.

    Returns ``(tgt0 (K,), tgt1 (K,))`` in the convention of
    ``models/train_superglue.py``: ``tgt0[i]`` is the bank-1 column matched
    to row i (K = dustbin/unmatched), ``tgt1[j]`` the bank-0 row for column
    j. A pair matches when the depth-transferred bank-0 point lands within
    ``tol_px`` of a bank-1 keypoint, one-to-one by greedy nearest distance.
    """
    K = kpts0.shape[0]
    tgt0 = np.full((K,), K, np.int32)
    tgt1 = np.full((K,), K, np.int32)
    uv_j, vis = transfer_points(kpts0, depth0, T0, T1, fx, cx, cy, depth_map_j=depth1)
    rows = np.nonzero(valid0 & vis)[0]
    cols = np.nonzero(valid1)[0]
    if len(rows) == 0 or len(cols) == 0:
        return tgt0, tgt1
    d2 = ((uv_j[rows, None, :] - kpts1[None, cols, :]) ** 2).sum(-1)
    # greedy one-to-one by ascending distance
    order = np.argsort(d2, axis=None)
    tol2 = tol_px * tol_px
    used_r = np.zeros(len(rows), bool)
    used_c = np.zeros(len(cols), bool)
    for flat in order:
        r, c = divmod(int(flat), len(cols))
        if d2[r, c] > tol2:
            break
        if used_r[r] or used_c[c]:
            continue
        used_r[r] = used_c[c] = True
        tgt0[rows[r]] = cols[c]
        tgt1[cols[c]] = rows[r]
    return tgt0, tgt1
