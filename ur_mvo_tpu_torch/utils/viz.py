"""Map-cloud export (the port's own copy of ``save_map_ply`` from
``ur_mvo_tpu.utils.viz``; the drawing helpers there are not copied)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def save_map_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """Write the map cloud as ASCII PLY (viewable in MeshLab, CloudCompare,
    Open3D). ``points``: (N, 3) float; ``colors``: optional (N, 3) uint8."""
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
