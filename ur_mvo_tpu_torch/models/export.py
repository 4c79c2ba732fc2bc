"""Ahead-of-time export of the fused frame step (port of
``ur_mvo_tpu.models.export``).

The deployable artifact is a ``torch.export`` program of the frame step
(SuperPoint extract of two images, SuperGlue match), saved with
``torch.export.save``; ``load_frame_step`` reloads and runs it without the
model code. The stage kernel is the ``torch.library`` op
``ur_mvo_tpu_torch::stage_conv`` (``ops/cuda_conv.py``), so a program
exported on the card holds its nodes and launches the kernel when it runs
(its packed weights are buffers of the program); on the CPU the same nodes
run the plain version. SuperGlue runs with its kernels off, as the JAX
frame step calls ``match_scores`` with its Pallas attention and Sinkhorn
off. The numeric check (export, reload, compare) is the reference's
``assert_allclose(rtol=1e-3, atol=1e-5)``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ur_mvo_tpu_torch.device import DeviceLike, resolve_device
from ur_mvo_tpu_torch.models.superglue import SuperGlue
from ur_mvo_tpu_torch.models.superpoint import SuperPoint
from ur_mvo_tpu_torch.ops.cuda_conv import PackedStage
from ur_mvo_tpu_torch.ops.keypoints import select_keypoints
from ur_mvo_tpu_torch.ops.matching import decode_assignment

_PACKED = ("wa", "ba", "wb", "bb")


class FrameStep(nn.Module):
    """The fused extract + match step as a module of two (H, W) float32
    images -> (kpts0 (K, 2), kpts1 (K, 2), idx1 (K,), score (K,))."""

    def __init__(self, sp_state: Dict[str, torch.Tensor], sg_state: Dict[str, torch.Tensor], height: int,
                 width: int, capacity: int = 1024, max_keypoints: int = 1000, threshold: float = 5e-4,
                 sinkhorn_iterations: int = 20, match_threshold: float = 0.5, num_heads: int = 4,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        sp = SuperPoint()
        sp.load_state_dict(sp_state)
        self.superpoint = sp.to(dev).eval().requires_grad_(False)
        self.superglue = SuperGlue.from_state_dict(sg_state, kernels=False).to(dev).eval().requires_grad_(False)
        self.height, self.width = height, width
        self.capacity, self.max_keypoints, self.threshold = capacity, max_keypoints, threshold
        self.sinkhorn_iterations, self.match_threshold, self.num_heads = sinkhorn_iterations, match_threshold, num_heads
        # the stage kernel's packed weights as buffers, so that an exported
        # program carries them (packing reads raw storage, which export's
        # tracing does not have)
        self._packed_meta = []
        if dev.type == "cuda":
            for i, p in enumerate(self.superpoint._packed_stages()):
                self._packed_meta.append((p.dtype, p.cin))
                for f in _PACKED:
                    self.register_buffer(f"packed{i}_{f}", getattr(p, f))

    def _packed(self):
        if not self._packed_meta:
            return None
        return [PackedStage(dt, cin, *(getattr(self, f"packed{i}_{f}") for f in _PACKED))
                for i, (dt, cin) in enumerate(self._packed_meta)]

    def forward(self, image0: torch.Tensor, image1: torch.Tensor):
        packed = self._packed()

        def ext(img):
            scores, desc = self.superpoint(img[None, :, :, None], packed=packed)
            return select_keypoints(scores[0], desc[0], capacity=self.capacity, threshold=self.threshold,
                                    max_keypoints=self.max_keypoints)

        b0, b1 = ext(image0), ext(image1)
        Z = self.superglue.match_scores(b0, b1, self.width, self.height, self.sinkhorn_iterations,
                                        num_heads=self.num_heads)
        m = decode_assignment(Z, b0.valid, b1.valid, self.match_threshold)
        return b0.kpts, b1.kpts, m.idx1, m.score


def build_frame_step(sp_state, sg_state, height: int, width: int, **kw) -> FrameStep:
    """The fused frame step on ``device`` (keyword), of the two models'
    state dicts."""
    return FrameStep(sp_state, sg_state, height, width, **kw)


def export_frame_step(path: str, sp_state, sg_state, height: int = 512, width: int = 640, **kw):
    """Export the frame step at static (height, width) float32 inputs and
    save it to ``path``; returns the ``ExportedProgram``."""
    fn = build_frame_step(sp_state, sg_state, height, width, **kw)
    dev = fn.superglue.bin_score.device
    # two tensors: one passed twice would be traced as one input
    specs = tuple(torch.zeros((height, width), dtype=torch.float32, device=dev) for _ in range(2))
    exported = torch.export.export(fn, specs)
    torch.export.save(exported, path)
    return exported


def load_frame_step(path: str):
    """Reload a saved frame step; returns a callable(image0, image1)."""
    from ur_mvo_tpu_torch.ops import cuda_conv  # noqa: F401  (registers ur_mvo_tpu_torch::stage_conv)

    return torch.export.load(path).module()


def verify_roundtrip(path: str, sp_state, sg_state, height: int = 64, width: int = 80, **kw) -> float:
    """Export -> reload -> numeric comparison on a random image pair (the
    reference's ``assert_allclose(rtol=1e-3, atol=1e-5)``, which raises on a
    miss); returns the largest absolute difference."""
    fn = build_frame_step(sp_state, sg_state, height, width, **kw)
    dev = fn.superglue.bin_score.device
    img0 = torch.rand((height, width), generator=torch.Generator().manual_seed(0)).to(dev)
    img1 = img0 + 0.01
    with torch.no_grad():
        ref = fn(img0, img1)
        got = load_frame_step(path)(img0, img1)
    err = 0.0
    for a, b in zip(ref, got):
        a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-5)
        err = max(err, float(np.max(np.abs(a - b))))
    return err
