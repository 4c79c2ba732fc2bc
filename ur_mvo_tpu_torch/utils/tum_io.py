"""TUM-format trajectory I/O.

Own copy of ``ur_mvo_tpu.utils.tum_io``, parity with the reference's
trajectory writers: each line is
``timestamp tx ty tz qx qy qz qw``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def write_tum(path: str, timestamps: Sequence[float], positions: np.ndarray, quaternions_wxyz: np.ndarray) -> None:
    """Write a TUM trajectory. ``quaternions_wxyz`` is (N, 4) in (w,x,y,z);
    the file stores (qx qy qz qw) per the TUM convention."""
    positions = np.asarray(positions, dtype=np.float64)
    q = np.asarray(quaternions_wxyz, dtype=np.float64)
    with open(path, "w") as f:
        for i, ts in enumerate(timestamps):
            t = positions[i]
            f.write(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[i,1]:.6f} {q[i,2]:.6f} {q[i,3]:.6f} {q[i,0]:.6f}\n"
            )


def read_tum(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a TUM trajectory -> (timestamps (N,), positions (N,3),
    quaternions (N,4) in (w,x,y,z))."""
    ts, pos, quat = [], [], []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            if len(vals) < 8:
                continue
            ts.append(vals[0])
            pos.append(vals[1:4])
            qx, qy, qz, qw = vals[4:8]
            quat.append([qw, qx, qy, qz])
    return (
        np.asarray(ts, dtype=np.float64),
        np.asarray(pos, dtype=np.float64),
        np.asarray(quat, dtype=np.float64),
    )


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_diff: float = 0.02) -> tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association between two trajectories
    (the role evo's association plays in ``scripts/vo.py:73-75``)."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, t))
        best, best_d = -1, max_diff
        for cand in (j - 1, j):
            if 0 <= cand < len(ts_b):
                d = abs(ts_b[cand] - t)
                if d <= best_d:
                    best, best_d = cand, d
        if best >= 0:
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, dtype=np.int64), np.asarray(ib, dtype=np.int64)
