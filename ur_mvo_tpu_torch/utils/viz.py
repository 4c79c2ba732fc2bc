"""Debug visualization: feature, match and reprojection overlays, and the
map cloud as PLY (the port's own copy of ``ur_mvo_tpu.utils.viz``).

File-output replacement for the reference's rviz / ROS2 image topics and
its debug disk dumps: pure-numpy drawing (circles, lines, side-by-side
match canvases) saved as PNG when PIL is available, ``.npy`` otherwise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _to_rgb(gray: np.ndarray) -> np.ndarray:
    g = np.asarray(gray)
    if g.dtype != np.uint8:
        g = np.clip(g * (255.0 if g.max() <= 1.5 else 1.0), 0, 255).astype(np.uint8)
    if g.ndim == 2:
        return np.stack([g, g, g], axis=-1)
    return g.copy()


def _color(idx: int) -> np.ndarray:
    """Deterministic per-track color (parity with GenerateColor)."""
    rng = np.random.default_rng(idx * 2654435761 % (2**32))
    return rng.integers(64, 255, 3).astype(np.uint8)


def draw_circle(img: np.ndarray, x: float, y: float, radius: int, color) -> None:
    H, W = img.shape[:2]
    xi, yi = int(round(x)), int(round(y))
    yy, xx = np.mgrid[max(0, yi - radius): min(H, yi + radius + 1), max(0, xi - radius): min(W, xi + radius + 1)]
    d2 = (yy - yi) ** 2 + (xx - xi) ** 2
    ring = (d2 <= radius**2) & (d2 >= (radius - 1.5) ** 2)
    img[yy[ring], xx[ring]] = color


def draw_dot(img: np.ndarray, x: float, y: float, radius: int, color) -> None:
    H, W = img.shape[:2]
    xi, yi = int(round(x)), int(round(y))
    yy, xx = np.mgrid[max(0, yi - radius): min(H, yi + radius + 1), max(0, xi - radius): min(W, xi + radius + 1)]
    disk = (yy - yi) ** 2 + (xx - xi) ** 2 <= radius**2
    img[yy[disk], xx[disk]] = color


def draw_line(img: np.ndarray, x0, y0, x1, y1, color) -> None:
    H, W = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.clip(np.linspace(x0, x1, n + 1).round().astype(int), 0, W - 1)
    ys = np.clip(np.linspace(y0, y1, n + 1).round().astype(int), 0, H - 1)
    img[ys, xs] = color


def draw_features(image: np.ndarray, kpts: np.ndarray, valid: Optional[np.ndarray] = None,
                  track_ids: Optional[np.ndarray] = None) -> np.ndarray:
    """Keypoint overlay; colors keyed by track id when given."""
    canvas = _to_rgb(image)
    kpts = np.asarray(kpts)
    n = kpts.shape[0]
    for i in range(n):
        if valid is not None and not valid[i]:
            continue
        c = _color(int(track_ids[i])) if track_ids is not None and track_ids[i] >= 0 else np.array([0, 255, 0], np.uint8)
        draw_circle(canvas, kpts[i, 0], kpts[i, 1], 3, c)
    return canvas


def draw_matches(image0: np.ndarray, kpts0: np.ndarray, image1: np.ndarray, kpts1: np.ndarray,
                 idx1: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Side-by-side match visualization (debug.h:17-46 equivalent)."""
    c0 = _to_rgb(image0)
    c1 = _to_rgb(image1)
    H = max(c0.shape[0], c1.shape[0])
    W0 = c0.shape[1]
    canvas = np.zeros((H, W0 + c1.shape[1], 3), np.uint8)
    canvas[: c0.shape[0], :W0] = c0
    canvas[: c1.shape[0], W0:] = c1
    for i in np.nonzero(np.asarray(valid))[0]:
        j = int(idx1[i])
        if j < 0:
            continue
        c = _color(i)
        x0, y0 = float(kpts0[i, 0]), float(kpts0[i, 1])
        x1, y1 = float(kpts1[j, 0]) + W0, float(kpts1[j, 1])
        draw_dot(canvas, x0, y0, 2, c)
        draw_dot(canvas, x1, y1, 2, c)
        draw_line(canvas, x0, y0, x1, y1, c)
    return canvas


def draw_reprojections(image: np.ndarray, observed: np.ndarray, projected: np.ndarray,
                       valid: np.ndarray) -> np.ndarray:
    """Observed (green circles) vs projected (red dots) with error lines —
    the reference's per-frame debug topic (tracking.cc:732-767)."""
    canvas = _to_rgb(image)
    green = np.array([0, 255, 0], np.uint8)
    red = np.array([255, 0, 0], np.uint8)
    for i in np.nonzero(np.asarray(valid))[0]:
        ox, oy = float(observed[i, 0]), float(observed[i, 1])
        px, py = float(projected[i, 0]), float(projected[i, 1])
        draw_circle(canvas, ox, oy, 4, green)
        draw_dot(canvas, px, py, 2, red)
        draw_line(canvas, px, py, ox, oy, red)
    return canvas


def save_map_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """Write the map cloud as ASCII PLY (viewable in MeshLab/CloudCompare/
    Open3D) — the file-based stand-in for the reference's rviz map-cloud
    topic (``ros2_publisher.cc:132-164``). ``points``: (N, 3) float;
    ``colors``: optional (N, 3) uint8."""
    points = np.asarray(points, np.float32)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in points:
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
        else:
            for p, c in zip(points, np.asarray(colors, np.uint8)):
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {c[0]} {c[1]} {c[2]}\n")


def save_image(path: str, image: np.ndarray) -> None:
    try:
        from PIL import Image as PILImage

        PILImage.fromarray(image).save(path)
    except ImportError:
        np.save(path + ".npy", image)
