"""Camera model: pinhole intrinsics + radial-tangential / equidistant
(fisheye) distortion, with precomputed undistort-rectify maps applied on
the device (the port's copy of ``ur_mvo_tpu.camera``).

Calibration parsing and map construction are host-side numpy, as in the
JAX package; the per-frame remap is a bilinear gather on the device.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# OpenCV-YAML calibration parsing (reference format: configs/camera_settings)
# ---------------------------------------------------------------------------

def _parse_opencv_yaml(path: str) -> dict:
    """Parse the subset of OpenCV-YAML used by the calibration files.

    Handles the ``%YAML:1.0`` header and ``!!opencv-matrix`` nodes without
    requiring OpenCV (parity with ``camera.cc:8-60`` which uses
    ``cv::FileStorage``).
    """
    with open(path, "r") as f:
        text = f.read()
    text = re.sub(r"^%YAML:[\d.]+\s*\n(---\s*\n)?", "", text)
    out: dict = {}
    lines = text.split("\n")
    i = 0
    while i < len(lines):
        line = lines[i].split("#")[0].rstrip()
        i += 1
        if not line.strip():
            continue
        m = re.match(r"^(\w+):\s*(.*)$", line)
        if not m or line.startswith(" "):
            continue
        key, val = m.group(1), m.group(2).strip()
        if val == "!!opencv-matrix" or val == "":
            # Collect the indented block (rows/cols/dt/data).
            block: dict = {}
            data_txt = ""
            in_data = False
            while i < len(lines):
                sub = lines[i].split("#")[0].rstrip()
                if sub and not sub.startswith(" "):
                    break
                i += 1
                s = sub.strip()
                if not s:
                    continue
                if in_data:
                    data_txt += " " + s
                    if "]" in s:
                        in_data = False
                    continue
                sm = re.match(r"^(\w+):\s*(.*)$", s)
                if sm:
                    k2, v2 = sm.group(1), sm.group(2).strip()
                    if k2 == "data":
                        data_txt = v2
                        if "[" in v2 and "]" not in v2:
                            in_data = True
                    else:
                        block[k2] = v2
            if data_txt:
                nums = [float(x) for x in re.findall(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", data_txt)]
                rows = int(block.get("rows", 1))
                cols = int(block.get("cols", len(nums) // max(1, rows)))
                out[key] = np.array(nums, dtype=np.float64).reshape(rows, cols)
            else:
                out[key] = block
        else:
            try:
                out[key] = float(val) if ("." in val or "e" in val.lower()) else int(val)
            except ValueError:
                out[key] = val
    return out


# ---------------------------------------------------------------------------
# Distortion models
# ---------------------------------------------------------------------------

def distort_radtan(xy: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Radial-tangential (plumb-bob) distortion of normalized coords."""
    k1, k2, p1, p2 = d[0], d[1], d[2], d[3]
    k3 = d[4] if len(d) > 4 else 0.0
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_radtan(xyd: np.ndarray, d: np.ndarray, iters: int = 10) -> np.ndarray:
    """Invert ``distort_radtan`` by fixed-point iteration (the same
    scheme as ``cv::undistortPoints``). Used by the synthetic-dataset
    generator to render through a distorted lens and by tests; accuracy
    ~1e-9 for mild distortion after 10 iterations."""
    k1, k2, p1, p2 = d[0], d[1], d[2], d[3]
    k3 = d[4] if len(d) > 4 else 0.0
    x = xyd.copy()
    for _ in range(iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        tx = 2 * p1 * xx * yy + p2 * (r2 + 2 * xx * xx)
        ty = p1 * (r2 + 2 * yy * yy) + 2 * p2 * xx * yy
        x = (xyd - np.stack([tx, ty], axis=-1)) / radial[..., None]
    return x


def distort_equidistant(xy: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Kannala-Brandt equidistant (fisheye) distortion (cv::fisheye model)."""
    k1, k2, k3, k4 = d[0], d[1], d[2], d[3]
    x, y = xy[..., 0], xy[..., 1]
    r = np.sqrt(np.maximum(x * x + y * y, 1e-12))
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = theta_d / r
    return np.stack([x * scale, y * scale], axis=-1)


@dataclasses.dataclass
class Camera:
    """Rectified pinhole camera + precomputed undistortion maps.

    Attributes mirror the reference's ``Camera`` surface: ``fx/fy/cx/cy``
    come from the rectified projection matrix P, ``bf`` is the stereo
    baseline*focal product, and depth/disparity gates match
    ``camera_settings/aqua.yaml``.
    """

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float = 0.0
    depth_lower_thr: float = 0.1
    depth_upper_thr: float = 10.0
    max_y_diff: float = 2.0
    # (H, W, 2) float32 source-pixel coordinates for rectification, or None
    # when the input is already rectified.
    undistort_map: Optional[np.ndarray] = None
    # Separate right-camera rectification map (stereo rigs have distinct
    # right intrinsics/distortion/rectifying rotation — the reference
    # builds _mapr1/_mapr2 from RIGHT_K/D/R/P, ``camera.cc:61-75``, and
    # remaps the right image with them, ``camera.cc:117-127``). None for
    # mono or when the calib has no RIGHT_* block.
    undistort_map_right: Optional[np.ndarray] = None

    # -- construction -------------------------------------------------------

    @classmethod
    def from_yaml(cls, path: str) -> "Camera":
        """Load an OpenCV-YAML calibration file (reference format)."""
        cfg = _parse_opencv_yaml(path)
        width = int(cfg["image_width"])
        height = int(cfg["image_height"])
        K = cfg["LEFT_K"]
        D = np.asarray(cfg["LEFT_D"]).reshape(-1)
        R = cfg.get("LEFT_R", np.eye(3))
        P = cfg.get("LEFT_P")
        if P is None:
            P = np.hstack([K, np.zeros((3, 1))])
        fx, fy = float(P[0, 0]), float(P[1, 1])
        cx, cy = float(P[0, 2]), float(P[1, 2])
        dist_type = int(cfg.get("distortion_type", 0))
        cam = cls(
            width=width,
            height=height,
            fx=fx,
            fy=fy,
            cx=cx,
            cy=cy,
            bf=float(cfg.get("bf", 0.0)),
            depth_lower_thr=float(cfg.get("depth_lower_thr", 0.1)),
            depth_upper_thr=float(cfg.get("depth_upper_thr", 10.0)),
            max_y_diff=float(cfg.get("max_y_diff", 2.0)),
        )
        cam.undistort_map = cam._build_undistort_map(np.asarray(K), D, np.asarray(R), dist_type)
        # Right camera: the reference requires ALL of RIGHT_K/D/R/P for a
        # stereo rig (camera.cc:46-59) and builds a second rectify map
        # with the RIGHT projection matrix P_r (camera.cc:61-75). The
        # rectified right intrinsics (P_r) usually equal the left P up to
        # the -bf column, but the distortion/rotation legs differ.
        if "RIGHT_K" in cfg and "RIGHT_D" in cfg:
            # A partial RIGHT_* block is almost always a calib-file bug:
            # the reference hard-exits unless ALL of RIGHT_K/D/R/P are
            # present (camera.cc:53-59). We default RIGHT_R=I /
            # RIGHT_P=left P to stay usable with identity-rectified
            # synthetic rigs, but warn loudly — a real rig with a
            # missing/typo'd RIGHT_R would otherwise silently rectify
            # the right image with the wrong rotation.
            missing = [k for k in ("RIGHT_R", "RIGHT_P") if k not in cfg]
            if missing:
                import warnings

                warnings.warn(
                    f"{path}: stereo calib has RIGHT_K/RIGHT_D but is missing "
                    f"{'/'.join(missing)}; assuming identity rectification "
                    "rotation / left projection. The reference rejects such "
                    "files (camera.cc:53-59) — add explicit RIGHT_R/RIGHT_P.",
                    stacklevel=2,
                )
            K_r = np.asarray(cfg["RIGHT_K"])
            D_r = np.asarray(cfg["RIGHT_D"]).reshape(-1)
            R_r = np.asarray(cfg.get("RIGHT_R", np.eye(3)))
            P_r = cfg.get("RIGHT_P")
            if P_r is None:
                P_r = P
            P_r = np.asarray(P_r)
            cam.undistort_map_right = cam._build_undistort_map(
                K_r, D_r, R_r, dist_type,
                fx=float(P_r[0, 0]), fy=float(P_r[1, 1]),
                cx=float(P_r[0, 2]), cy=float(P_r[1, 2]),
            )
        return cam

    def _build_undistort_map(
        self,
        K: np.ndarray,
        D: np.ndarray,
        R: np.ndarray,
        dist_type: int,
        fx: Optional[float] = None,
        fy: Optional[float] = None,
        cx: Optional[float] = None,
        cy: Optional[float] = None,
    ) -> np.ndarray:
        """For each rectified pixel, the source pixel to sample.

        Same math as ``cv::initUndistortRectifyMap`` /
        ``cv::fisheye::initUndistortRectifyMap`` (``camera.cc:61-86``):
        rectified pixel -> normalized ray via P^-1 -> rotate by R^-1 ->
        distort -> source pixel via K. Computed once on host in f64,
        applied per frame on device as a bilinear gather.

        ``fx/fy/cx/cy`` override the rectified projection used for the
        destination grid (the right camera rectifies onto RIGHT_P, not
        the left P — ``camera.cc:66-68``); default to this camera's.
        """
        fx = self.fx if fx is None else fx
        fy = self.fy if fy is None else fy
        cx = self.cx if cx is None else cx
        cy = self.cy if cy is None else cy
        v, u = np.mgrid[0:self.height, 0:self.width].astype(np.float64)
        x = (u - cx) / fx
        y = (v - cy) / fy
        rays = np.stack([x, y, np.ones_like(x)], axis=-1) @ np.linalg.inv(R).T
        xy = rays[..., :2] / rays[..., 2:3]
        if dist_type == 1:
            xyd = distort_equidistant(xy, D)
        else:
            xyd = distort_radtan(xy, D)
        map_x = K[0, 0] * xyd[..., 0] + K[0, 1] * xyd[..., 1] + K[0, 2]
        map_y = K[1, 1] * xyd[..., 1] + K[1, 2]
        return np.stack([map_x, map_y], axis=-1).astype(np.float32)

    # -- projections (jit-safe; used inside device kernels) ------------------

    def intrinsic_matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    def project(self, pc: torch.Tensor) -> torch.Tensor:
        """Camera-frame points (..., 3) -> pixels (..., 2)."""
        z = pc[..., 2]
        u = self.fx * pc[..., 0] / z + self.cx
        v = self.fy * pc[..., 1] / z + self.cy
        return torch.stack([u, v], axis=-1)

    def in_image(self, uv: torch.Tensor) -> torch.Tensor:
        """Bounds check, parity with ``camera.h:48-96``."""
        return (
            (uv[..., 0] >= 0)
            & (uv[..., 0] <= self.width - 1)
            & (uv[..., 1] >= 0)
            & (uv[..., 1] <= self.height - 1)
        )

    def back_project(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) -> unit-depth camera rays (..., 3)
        (``BackProjectMono``, ``camera.cc:168-173``)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], axis=-1)

    def back_project_stereo(self, uv: torch.Tensor, right_u: torch.Tensor) -> torch.Tensor:
        """Left pixel + right x-coordinate -> camera point via disparity
        (``BackProjectStereo``, ``camera.cc:175-182``)."""
        disparity = uv[..., 0] - right_u
        depth = self.bf / torch.clamp(disparity, min=1e-6)
        return self.back_project(uv) * depth[..., None]

    def stereo_project(self, pc: torch.Tensor) -> torch.Tensor:
        """Camera point -> (u, v, u_right)."""
        uv = self.project(pc)
        ur = uv[..., 0] - self.bf / pc[..., 2]
        return torch.cat([uv, ur[..., None]], axis=-1)


def make_pinhole(width: int, height: int, fx: float, fy: float, cx: float, cy: float, bf: float = 0.0) -> Camera:
    """Distortion-free camera for synthetic tests."""
    return Camera(width=width, height=height, fx=fx, fy=fy, cx=cx, cy=cy, bf=bf)


def remap_bilinear(image: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """Device-side equivalent of ``cv::remap`` with bilinear interpolation.

    ``image``: (H, W) float; ``src_map``: (H, W, 2) source (x, y) pixels.
    Out-of-range samples produce 0 (BORDER_CONSTANT).
    """
    H, W = image.shape
    x = src_map[..., 0]
    y = src_map[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xi_c = torch.clamp(xi, 0, W - 1)
        yi_c = torch.clamp(yi, 0, H - 1)
        return torch.where(valid, image[yi_c, xi_c], torch.zeros((), dtype=image.dtype, device=image.device))

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    return (
        v00 * (1 - dx) * (1 - dy)
        + v01 * dx * (1 - dy)
        + v10 * (1 - dx) * dy
        + v11 * dx * dy
    )
