"""Dataset reading: EuRoC-style image directories and ground truth (the
port's own copy of ``ur_mvo_tpu.dataset``).

The reference's ``cam0/data`` layout with 19-character nanosecond
timestamps parsed from the file names, a flat folder of images, and colmap
``images.txt`` ground truth. Images decode with PIL, or as raw ``.npy`` /
PGM; where every frame is PGM or uint8 ``.npy``, the native prefetcher
(``ur_mvo_tpu_torch.native``) reads ahead on threads of its own.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass
class InputData:
    """One input sample."""

    index: int
    time: float
    image: np.ndarray
    image_right: Optional[np.ndarray] = None
    depth: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None


def _read_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"P5", b"P2"):
            raise ValueError(f"not a PGM: {path}")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = [int(x) for x in line.split()]
        maxval = int(f.readline())
        if magic == b"P5":
            dtype = np.uint8 if maxval < 256 else ">u2"
            return np.frombuffer(f.read(), dtype=dtype).reshape(h, w).astype(np.uint8)
        data = np.array(f.read().split(), dtype=np.int32).reshape(h, w)
        return (data * 255 // max(maxval, 1)).astype(np.uint8)


def load_gray(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".pgm"):
        return _read_pgm(path)
    from PIL import Image as PILImage

    return np.asarray(PILImage.open(path).convert("L"))


def parse_timestamp(filename: str) -> Optional[float]:
    """19-digit ns timestamps, else float stems."""
    stem = Path(filename).stem
    if re.fullmatch(r"\d{16,19}", stem):
        return int(stem) * 1e-9
    try:
        return float(stem)
    except ValueError:
        return None


class Dataset:
    """EuRoC-layout sequence: ``<root>/cam0/data/*.png`` (+cam1, +depth0,
    +mask0 when asked for), or a flat folder of images.

    ``reader`` says how the left images are read: ``"native"`` (the C++
    prefetcher, taken where every file is PGM or uint8 ``.npy`` and a
    compiler exists; a failing build raises) or ``"python"``."""

    IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".pgm", ".npy", ".bmp")

    def __init__(self, root: str, use_right: bool = False, use_depth: bool = False, use_mask: bool = False,
                 prefetch: bool = True):
        self.root = Path(root)
        self.left_dir = self.root / "cam0" / "data"
        if not self.left_dir.is_dir():
            # flat layout (e.g. raw Aqualoc: a folder of frameXXXXXX.png)
            if not any(n.lower().endswith(self.IMAGE_EXTS) for n in os.listdir(self.root)):
                raise FileNotFoundError(f"{self.left_dir} missing and {self.root} has no images")
            self.left_dir = self.root
        self.names = sorted(n for n in os.listdir(self.left_dir) if n.lower().endswith(self.IMAGE_EXTS))
        self.right_dir = self.root / "cam1" / "data" if use_right else None
        self.depth_dir = self.root / "depth0" / "data" if use_depth else None
        self.mask_dir = self.root / "mask0" / "data" if use_mask else None
        self._prefetcher = None
        self._next = 0  # the frame the prefetcher serves next
        self.reader = "python"
        if prefetch and self.names and all(n.endswith((".pgm", ".npy")) for n in self.names):
            from ur_mvo_tpu_torch import native

            if native.available():
                self._prefetcher = native.ImagePrefetcher(
                    [str(self.left_dir / n) for n in self.names], n_workers=4, window=16
                )
                self.reader = "native"

    def __len__(self) -> int:
        return len(self.names)

    def get(self, idx: int) -> InputData:
        name = self.names[idx]
        ts = parse_timestamp(name)
        image = None
        if self._prefetcher is not None and idx == self._next:
            # the prefetcher serves each frame once, in order, within its
            # window, and would wait for ever on any other read: a frame
            # read out of order or again comes from its file
            image = self._prefetcher.get(idx)
            self._next += 1
        if image is None:
            image = load_gray(str(self.left_dir / name))
        data = InputData(
            index=idx,
            time=ts if ts is not None else float(idx),
            image=image,
        )
        if self.right_dir is not None:
            data.image_right = load_gray(str(self.right_dir / name))
        if self.depth_dir is not None:
            # metric float depth ships as .npy next to the PNG name
            p = self.depth_dir / name
            npy = p.with_suffix(".npy")
            data.depth = load_gray(str(npy if npy.exists() else p))
        if self.mask_dir is not None:
            data.mask = load_gray(str(self.mask_dir / name))
        return data

    def __iter__(self):
        for i in range(len(self)):
            yield self.get(i)


def load_colmap_images_txt(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Colmap ``images.txt`` ground truth: (timestamps-or-indices, positions
    (N, 3) of camera centres, quaternions (N, 4) wxyz of world-from-camera)."""
    from ur_mvo_tpu_torch.ops.lie import quat_to_rotmat, rotmat_to_quat

    ids, pos, quat = [], [], []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 10 or not parts[0].isdigit():
                continue  # skip POINTS2D lines
            qw, qx, qy, qz = [float(x) for x in parts[1:5]]
            tx, ty, tz = [float(x) for x in parts[5:8]]
            name = parts[9]
            # colmap stores world->camera; camera centre = -R^T t
            R_cw = quat_to_rotmat(torch.tensor([qw, qx, qy, qz], dtype=torch.float32)).numpy()
            c = -R_cw.T @ np.array([tx, ty, tz])
            ts = parse_timestamp(name)
            ids.append(ts if ts is not None else float(parts[0]))
            pos.append(c)
            # world-from-camera rotation quaternion
            quat.append(rotmat_to_quat(torch.from_numpy(np.ascontiguousarray(R_cw.T))).numpy())
    order = np.argsort(ids)
    return (
        np.asarray(ids)[order],
        np.asarray(pos)[order],
        np.asarray(quat)[order],
    )
