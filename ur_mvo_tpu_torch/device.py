"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    A CUDA device without CUDA raises: the port never moves quietly to
    the CPU. Callers that want the CPU (the tests) ask for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ur_mvo_tpu_torch: CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """``RuntimeConfig.compute_dtype`` string -> torch dtype."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32
