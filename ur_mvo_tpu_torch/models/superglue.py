"""SuperGlue attentional feature matcher as a PyTorch module (port of
``ur_mvo_tpu.models.superglue``).

Keypoint-encoder MLP (3 -> 32 -> 64 -> 128 -> 256), alternating
self/cross multi-head attention layers with message MLPs
(512 -> 512 -> 256), final projection, and masked log-Sinkhorn with a
learnable dustbin score, over fixed-capacity padded feature banks.
BatchNorms are folded to per-channel scale/shift.

Parameters keep the JAX pytree's layout and names: linear weights are
(in, out) and applied as ``x @ w + b``, so the state-dict keys are the
flat keys of the native ``.npz`` checkpoints (``layers.3.q.w``,
``kenc.0.scale``, ``bin_score``, ``desc_center``). The attention core
runs as the attention kernel and the transport as the Sinkhorn kernel
(``ops/cuda_kernels.py``); the q/k/v/merge projections and MLPs are
plain matmuls, as the JAX package leaves them to XLA.

The module's parameter dtype is the compute dtype. As in the JAX package
(which casts the parameter tree, then lets float32 inputs promote), the
keypoint encoder runs in float32 on the dtype-rounded parameters and the
GNN runs in the compute dtype.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ur_mvo_tpu_torch.ops.cuda_kernels import attention, log_optimal_transport_kernel
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank, normalize_keypoints_for_matching

D = 256
_KENC_DIMS = (3, 32, 64, 128, 256)
_MLP_DIMS = (2 * D, 2 * D, D)
_NATIVE_MARKER = "__urmvo_superglue__"


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` (in, out), optionally followed by a folded
    BatchNorm ``* scale + shift``."""

    def __init__(self, cin: int, cout: int, norm: bool = False):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cin, cout))
        self.b = nn.Parameter(torch.zeros(cout))
        if norm:
            self.scale = nn.Parameter(torch.ones(cout))
            self.shift = nn.Parameter(torch.zeros(cout))
        else:
            self.scale = self.shift = None

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        def p(t):
            return t if dtype is None else t.to(dtype)

        x = x @ p(self.w) + p(self.b)
        if self.scale is not None:
            x = x * p(self.scale) + p(self.shift)
        return x


def _mlp(layers: List[Linear], x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = layer(x, dtype)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _make_mlp(dims) -> nn.ModuleList:
    return nn.ModuleList(Linear(dims[i], dims[i + 1], norm=i < len(dims) - 2) for i in range(len(dims) - 1))


class GNNLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.q = Linear(D, D)
        self.k = Linear(D, D)
        self.v = Linear(D, D)
        self.merge = Linear(D, D)
        self.mlp = _make_mlp(_MLP_DIMS)


class SuperGlue(nn.Module):
    """``kernels=False`` runs the attention and Sinkhorn kernels' plain
    versions on any device (the on-card comparison)."""

    def __init__(self, num_layers: int = 9, desc_center: bool = False, kernels: bool = True):
        super().__init__()
        self.kernels = kernels
        self.kenc = _make_mlp(_KENC_DIMS)
        self.layers = nn.ModuleList(GNNLayer() for _ in range(2 * num_layers))
        self.final_proj = Linear(D, D)
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        self.desc_center = nn.Parameter(torch.zeros(D)) if desc_center else None

    @classmethod
    def from_state_dict(cls, state: Dict[str, torch.Tensor], kernels: bool = True) -> "SuperGlue":
        """Module shaped by ``state`` (layer count, ``desc_center``), loaded."""
        n = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("layers."))
        model = cls(num_layers=n // 2, desc_center="desc_center" in state, kernels=kernels)
        model.load_state_dict(state)
        return model

    @property
    def dtype(self) -> torch.dtype:
        return self.bin_score.dtype

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "SuperGlue":
        """He-normal linears, zero biases, identity norms, zero-initialized
        message-MLP outputs (``superglue.init_params``)."""
        for module in self.modules():
            if isinstance(module, Linear):
                module.w.copy_(torch.randn(module.w.shape, generator=generator) * math.sqrt(2.0 / module.w.shape[0]))
        for layer in self.layers:
            layer.mlp[-1].w.zero_()
        self.bin_score.fill_(1.0)
        return self

    def encode(self, bank: FeatureBank, width: int, height: int) -> torch.Tensor:
        """Descriptor + positional encoding: desc + MLP(x, y, score), in
        float32 on the dtype-rounded parameters. With ``desc_center``,
        descriptors are re-centered and re-normalized first. A bank with a
        leading lane axis encodes every lane."""
        desc = bank.desc
        if self.desc_center is not None:
            c = desc - self.desc_center.float()
            c = c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=1e-6)
            desc = c * bank.valid[..., None]
        kpts_n = normalize_keypoints_for_matching(bank.kpts, width, height)
        inputs = torch.cat([kpts_n, bank.scores[..., None]], dim=-1)
        return desc + _mlp(self.kenc, inputs, torch.float32)

    def _attention(self, layer: GNNLayer, x_q: torch.Tensor, x_kv: torch.Tensor, kv_valid: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
        """Multi-head attention over the pair batched on a leading axis of 2:
        (B, K, D) queries against (B, K, D) keys/values."""
        B, K, _ = x_q.shape
        hd = D // num_heads
        q = layer.q(x_q.reshape(B * K, D)).reshape(B, K, num_heads, hd)
        k = layer.k(x_kv.reshape(B * K, D)).reshape(B, K, num_heads, hd)
        v = layer.v(x_kv.reshape(B * K, D)).reshape(B, K, num_heads, hd)
        msg = attention(q, k, v, kv_valid, plain=not self.kernels).reshape(B * K, D)
        return layer.merge(msg).reshape(B, K, D)

    def gnn(self, x0: torch.Tensor, x1: torch.Tensor, valid0: torch.Tensor, valid1: torch.Tensor,
            num_heads: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
        """Alternating self/cross attentional message passing; cross layers
        attend to the other bank with the other bank's validity. One pair
        ((K, D) banks) or S pairs ((S, K, D)): the pairs' 2S banks are one
        batch, so each layer is ONE attention call at B = 2S, lane i's
        banks at rows 2i and 2i + 1."""
        x = torch.stack([x0, x1], dim=-3)  # (2, K, D) or (S, 2, K, D)
        valid = torch.stack([valid0, valid1], dim=-2)
        lanes, K = x.shape[:-3], x.shape[-2]
        B = 2 * math.prod(lanes)
        valid_b = valid.reshape(B, K)
        valid_flip = valid.flip(-2).reshape(B, K)
        for i, layer in enumerate(self.layers):
            xb = x.reshape(B, K, D)
            if i % 2 == 0:
                m = self._attention(layer, xb, xb, valid_b, num_heads)
            else:
                m = self._attention(layer, xb, x.flip(-3).reshape(B, K, D), valid_flip, num_heads)
            x = x + _mlp(layer.mlp, torch.cat([xb, m], dim=-1).reshape(B * K, 2 * D)).reshape(lanes + (2, K, D))
        return x[..., 0, :, :], x[..., 1, :, :]

    def match_scores(self, bank0: FeatureBank, bank1: FeatureBank, width: int, height: int,
                     sinkhorn_iterations: int = 20, num_heads: int = 4) -> torch.Tensor:
        """Two feature banks -> (K0+1, K1+1) log-assignment matrix
        (dustbins included), masked for invalid slots. Banks with a leading
        lane axis S match S pairs -> (S, K0+1, K1+1): encoder and GNN on
        the stacked banks, the score product and the transport a lane at a
        time (:func:`log_optimal_transport_kernel`)."""
        dt = self.dtype
        x0 = self.encode(bank0, width, height).to(dt)
        x1 = self.encode(bank1, width, height).to(dt)
        x0, x1 = self.gnn(x0, x1, bank0.valid, bank1.valid, num_heads)
        d0 = self.final_proj(x0)
        d1 = self.final_proj(x1)
        # float32 product of the dtype-valued projections (exact products)
        if d0.dim() == 3:
            scores = torch.stack([torch.matmul(a.float(), b.float().T) for a, b in zip(d0, d1)]) / (D**0.25)
        else:
            scores = torch.matmul(d0.float(), d1.float().T) / (D**0.25)
        return log_optimal_transport_kernel(
            scores, bank0.valid, bank1.valid, self.bin_score.float(), sinkhorn_iterations, plain=not self.kernels
        )


# ---------------------------------------------------------------------------
# Checkpoints: native flat-key .npz and the MagicLeap torch layout
# ---------------------------------------------------------------------------

def checkpoint_meta(path: str):
    """(num_layers, num_heads) embedded in a native .npz checkpoint, or None."""
    if not path.endswith(".npz"):
        return None
    with np.load(path) as state:
        if "__meta_num_layers__" in state.files:
            heads = int(state["__meta_num_heads__"]) if "__meta_num_heads__" in state.files else 4
            return int(state["__meta_num_layers__"]), heads
    return None


def checkpoint_threshold(path) -> "float | None":
    """Calibrated decode threshold embedded in a native .npz checkpoint
    (``__meta_matching_threshold__``), or None."""
    if not (path and str(path).endswith(".npz")):
        return None
    with np.load(path) as state:
        if "__meta_matching_threshold__" in state.files:
            return float(state["__meta_matching_threshold__"])
    return None


def checkpoint_operating_point(path) -> "dict | None":
    """Validated operating point embedded in a native .npz checkpoint
    (``__meta_op_*__`` keys): bank capacity, keypoint budget/threshold and
    init gates the matcher was trained and gate-tested with."""
    if not (path and str(path).endswith(".npz")):
        return None
    keys = {
        "capacity": "__meta_op_capacity__",
        "max_keypoints": "__meta_op_max_keypoints__",
        "keypoint_threshold": "__meta_op_keypoint_threshold__",
        "min_matches": "__meta_op_min_matches__",
        "min_features_first": "__meta_op_min_features_first__",
    }
    with np.load(path) as state:
        if keys["capacity"] not in state.files:
            return None
        out = {}
        for name, k in keys.items():
            if k in state.files:
                v = state[k]
                out[name] = float(v) if name == "keypoint_threshold" else int(v)
    return out


def resolve_matching_threshold(sg_cfg) -> float:
    """Effective decode threshold: explicit config value > checkpoint
    calibration > 0.5 (reference default)."""
    if sg_cfg.matching_threshold is not None:
        return float(sg_cfg.matching_threshold)
    thr = checkpoint_threshold(sg_cfg.weights_path)
    return 0.5 if thr is None else thr


def save_npz(path: str, state: "nn.Module | Dict[str, torch.Tensor]") -> None:
    """A ``SuperGlue`` (or its state dict) as the JAX package's native
    ``.npz`` (``superglue.save_npz``: the flat keys, float32, with the
    native marker), which both packages' ``load_weights`` read."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    flat = {k: v.detach().float().cpu().numpy() for k, v in state.items()}
    flat[_NATIVE_MARKER] = np.asarray(1)
    np.savez(path, **flat)


def load_npz(path: str, num_layers: int = 9, num_heads: int = 4) -> Dict[str, torch.Tensor]:
    """State dict of a native .npz checkpoint. Shipped checkpoints store
    float16; values are upcast to float32 at load. The embedded
    architecture, when present, wins over the arguments."""
    meta = checkpoint_meta(path)
    if meta is not None:
        num_layers, num_heads = meta
    with np.load(path) as f:
        state = {
            k: torch.from_numpy(np.asarray(f[k], np.float32))
            for k in f.files
            if not k.startswith("__") and (not k.startswith("layers.") or int(k.split(".")[1]) < 2 * num_layers)
        }
    return state


def load_torch_weights(path: str, num_layers: int = 9, num_heads: int = 4) -> Dict[str, torch.Tensor]:
    """State dict from a torch SuperGlue checkpoint in the public layout
    (``kenc.encoder.*`` Conv1d + BatchNorm1d, ``gnn.layers.{i}.attn.proj.{0,1,2}``,
    ``gnn.layers.{i}.attn.merge``, ``gnn.layers.{i}.mlp.*``, ``final_proj``,
    ``bin_score``), BatchNorms folded into scale/shift."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            src = {k: np.asarray(f[k]) for k in f.files}
    else:
        src = {k: v.cpu().numpy() for k, v in torch.load(path, map_location="cpu", weights_only=True).items()}
    out: Dict[str, np.ndarray] = {}

    def conv1d(prefix, dst):
        w = src[f"{prefix}.weight"]  # (cout, cin, 1)
        b = src.get(f"{prefix}.bias")
        out[f"{dst}.w"] = w[:, :, 0].T
        out[f"{dst}.b"] = b if b is not None else np.zeros((w.shape[0],), np.float32)

    def mlp_from(prefix, dst, n_linear):
        # torch MLP(Sequential): Conv1d, BN, ReLU, ..., Conv1d
        idx = 0
        for i in range(n_linear):
            conv1d(f"{prefix}.{idx}", f"{dst}.{i}")
            idx += 1
            if i < n_linear - 1:
                bn = f"{prefix}.{idx}"
                scale = src[f"{bn}.weight"] / np.sqrt(src[f"{bn}.running_var"] + 1e-5)
                out[f"{dst}.{i}.scale"] = scale
                out[f"{dst}.{i}.shift"] = src[f"{bn}.bias"] - src[f"{bn}.running_mean"] * scale
                idx += 2  # BN, ReLU

    mlp_from("kenc.encoder", "kenc", len(_KENC_DIMS) - 1)
    for i in range(2 * num_layers):
        g = f"gnn.layers.{i}"
        for j, name in enumerate(("q", "k", "v")):
            conv1d(f"{g}.attn.proj.{j}", f"layers.{i}.{name}")
        conv1d(f"{g}.attn.merge", f"layers.{i}.merge")
        mlp_from(f"{g}.mlp", f"layers.{i}.mlp", len(_MLP_DIMS) - 1)
    conv1d("final_proj", "final_proj")
    out["bin_score"] = np.asarray(float(src["bin_score"]), np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in out.items()}


def load_weights(path: str, num_layers: int = 9, num_heads: int = 4) -> Dict[str, torch.Tensor]:
    """State dict from a native .npz checkpoint or a torch-layout one."""
    if path.endswith(".npz"):
        with np.load(path) as state:
            native = _NATIVE_MARKER in state.files
        if native:
            return load_npz(path, num_layers, num_heads)
    return load_torch_weights(path, num_layers, num_heads)
