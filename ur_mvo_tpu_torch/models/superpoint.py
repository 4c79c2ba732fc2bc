"""SuperPoint keypoint detector + descriptor network as a PyTorch module
(port of ``ur_mvo_tpu.models.superpoint``).

A VGG-style shared encoder (64-64-128-128 channels, three 2x2 max-pools),
a 65-channel detector head (8x8 cells + dustbin, softmax ->
depth-to-space -> NMS) and a 256-channel descriptor head. Encoder stages
1-3 run as the fused stage kernel (``ops/cuda_conv.py``); stage 4 and the
heads are plain convolutions, as the JAX package computes them outside
any Pallas kernel. Activations stay NHWC at the public functions, as in
the JAX package; parameters use the ``nn.Conv2d`` (OIHW) layout, whose
state-dict keys are the MagicLeap ``superpoint_v1.pth`` keys.

The module's parameter dtype is the compute dtype: ``.to(torch.bfloat16)``
gives the bf16 path of ``RuntimeConfig.compute_dtype = "bfloat16"``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ur_mvo_tpu_torch.ops.cuda_conv import PackedStage, pack_stage, stage_conv
from ur_mvo_tpu_torch.ops.nms import simple_nms

# (name, in_ch, out_ch, kernel) in forward order; pools after the 'b' conv
# of stages 1-3.
_ENCODER = [
    ("conv1a", 1, 64, 3),
    ("conv1b", 64, 64, 3),
    ("conv2a", 64, 64, 3),
    ("conv2b", 64, 64, 3),
    ("conv3a", 64, 128, 3),
    ("conv3b", 128, 128, 3),
    ("conv4a", 128, 128, 3),
    ("conv4b", 128, 128, 3),
]
_HEADS = [
    ("convPa", 128, 256, 3),
    ("convPb", 256, 65, 1),
    ("convDa", 128, 256, 3),
    ("convDb", 256, 256, 1),
]
_STAGES = (("conv1a", "conv1b"), ("conv2a", "conv2b"), ("conv3a", "conv3b"))


def _cell_softmax_to_scores(logits: torch.Tensor) -> torch.Tensor:
    """(B, Hc, Wc, 65) detector logits -> dense (B, H, W) score map: 65-way
    softmax (64 positions + dustbin), drop the dustbin, depth-to-space with
    cell channel c = 8*dy + dx."""
    probs = torch.softmax(logits, dim=-1)[..., :64]
    B, Hc, Wc = probs.shape[:3]
    scores = probs.reshape(B, Hc, Wc, 8, 8)
    return scores.permute(0, 1, 3, 2, 4).reshape(B, Hc * 8, Wc * 8)


def _l2_normalize(d: torch.Tensor) -> torch.Tensor:
    """sqrt(sum+eps), not max(norm, eps): an exactly-zero descriptor keeps
    finite gradients."""
    return d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-12)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class SuperPoint(nn.Module):
    """``kernels=False`` runs the stage kernel's plain version on any
    device (the on-card comparison); the main path keeps the default."""

    def __init__(self, kernels: bool = True):
        super().__init__()
        self.kernels = kernels
        for name, cin, cout, k in _ENCODER + _HEADS:
            setattr(self, name, nn.Conv2d(cin, cout, k, padding=k // 2))
        self._packed: tuple = (None, [], [])

    def _packed_stages(self) -> list[PackedStage]:
        """Stages 1-3's weights in the stage kernel's layout, packed once and
        reused while every stage parameter keeps its storage and version
        (``.to()``, ``load_state_dict`` and in-place updates repack). The
        cache keeps the parameters' storages alive, so an address in its key
        cannot come back as another tensor's."""
        params = [t for pair in _STAGES for n in pair for t in (getattr(self, n).weight, getattr(self, n).bias)]
        key = [(t.data_ptr(), t.dtype, t.device, t._version) for t in params]
        if self._packed[0] != key:
            convs = [(getattr(self, na), getattr(self, nb)) for na, nb in _STAGES]
            packed = [pack_stage(ca.weight, ca.bias, cb.weight, cb.bias, self.dtype) for ca, cb in convs]
            self._packed = (key, [t.detach() for t in params], packed)
        return self._packed[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.conv1a.weight.dtype

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "SuperPoint":
        """He-normal kernels, zero biases (``superpoint.init_params``)."""
        for name, cin, _, k in _ENCODER + _HEADS:
            conv = getattr(self, name)
            w = torch.randn(conv.weight.shape, generator=generator) * math.sqrt(2.0 / (cin * k * k))
            conv.weight.copy_(w)
            conv.bias.zero_()
        return self

    def backbone(self, image: torch.Tensor, packed: Optional[list[PackedStage]] = None) -> torch.Tensor:
        """Shared encoder: (B, H, W, 1) -> (B, H/8, W/8, 128), NHWC.
        ``packed``: stages 1-3's weights in the kernel's layout, where the
        caller holds them (an exported program's buffers); by default the
        cache of :meth:`_packed_stages`."""
        x = image
        if packed is None:
            packed = self._packed_stages() if self.kernels and x.is_cuda else [None] * len(_STAGES)
        for (na, nb), p in zip(_STAGES, packed):
            ca, cb = getattr(self, na), getattr(self, nb)
            x = stage_conv(x, ca.weight, ca.bias, cb.weight, cb.bias, plain=not self.kernels, packed=p)
        x = _nchw(x)
        x = F.relu(self.conv4a(x))
        x = F.relu(self.conv4b(x))
        return _nhwc(x)

    def detector_head(self, feat: torch.Tensor) -> torch.Tensor:
        """(B, Hc, Wc, 128) -> dense keypoint score map (B, H, W)."""
        x = F.relu(self.convPa(_nchw(feat)))
        return _cell_softmax_to_scores(_nhwc(self.convPb(x)))

    def descriptor_head(self, feat: torch.Tensor) -> torch.Tensor:
        """(B, Hc, Wc, 128) -> L2-normalized coarse descriptors (B, Hc, Wc, 256)."""
        x = F.relu(self.convDa(_nchw(feat)))
        return _l2_normalize(_nhwc(self.convDb(x)))

    def forward(self, image: torch.Tensor, nms_radius: int = 4, return_raw_scores: bool = False,
                packed: Optional[list[PackedStage]] = None) -> tuple:
        """(B, H, W, 1) image in [0, 1] -> (scores (B, H, W) float32 after
        NMS, descriptors (B, Hc, Wc, 256) float32). The network runs in the
        parameter dtype; scores are cast to float32 before NMS. With
        ``return_raw_scores`` the pre-NMS score map is a third output: NMS
        zeroes the 3x3 neighbourhoods that sub-pixel refinement needs
        (``ops.keypoints.select_keypoints(raw_scores=...)``)."""
        x = image.to(self.dtype)
        feat = self.backbone(x, packed)
        scores = self.detector_head(feat).float()
        desc = self.descriptor_head(feat).float()
        if return_raw_scores:
            return simple_nms(scores, radius=nms_radius), desc, scores
        return simple_nms(scores, radius=nms_radius), desc


def load_torch_weights(path: str) -> Dict[str, torch.Tensor]:
    """State dict (OIHW kernels, MagicLeap key layout) from a
    ``superpoint_v1.pth``-style checkpoint or an ``.npz`` export with the
    same keys."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            state = {k: torch.from_numpy(np.asarray(f[k], np.float32)) for k in f.files}
    else:
        state = {k: v.float().cpu() for k, v in torch.load(path, map_location="cpu", weights_only=True).items()}
    keys = [f"{name}.{p}" for name, _, _, _ in _ENCODER + _HEADS for p in ("weight", "bias")]
    return {k: state[k] for k in keys}


def save_npz(state: Union[nn.Module, Dict[str, torch.Tensor]], path: str) -> None:
    """A ``SuperPoint`` (or its state dict) as the JAX package's ``.npz``
    (``superpoint.save_npz``: OIHW ``{name}.weight`` / ``{name}.bias``, the
    MagicLeap keys, float32), which both packages' ``load_torch_weights``
    read."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    keys = [f"{name}.{p}" for name, _, _, _ in _ENCODER + _HEADS for p in ("weight", "bias")]
    np.savez(path, **{k: state[k].detach().float().cpu().numpy() for k in keys})
