"""Parameters carried across from the JAX package.

Each function takes a JAX parameter pytree as numpy arrays
(``jax.tree.map(np.asarray, params)``: nested dicts and lists of arrays)
and returns the state dict of the port's module, so both packages can run
on the same weights. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def superpoint_from_numpy(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``superpoint`` pytree ({name: {"w": HWIO, "b"}}) -> ``SuperPoint``
    state dict (OIHW kernels)."""
    state = {}
    for name, p in params.items():
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(p["b"], np.float32).copy())
    return state


def _flatten(node, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    if isinstance(node, dict):
        for k, v in node.items():
            flat.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            flat.update(_flatten(v, f"{prefix}{i}."))
    else:
        flat[prefix[:-1]] = np.asarray(node)
    return flat


def superglue_from_numpy(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``superglue`` pytree (``kenc``, ``layers`` with ``q/k/v/merge/mlp``,
    folded ``scale``/``shift``, ``final_proj``, ``bin_score``, optional
    ``desc_center``) -> ``SuperGlue`` state dict. The pytree's flat keys
    are the module's keys; weights stay (in, out)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in _flatten(params).items()}
