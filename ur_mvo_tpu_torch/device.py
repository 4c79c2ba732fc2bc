"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def deterministic_on(device: torch.device):
    """PyTorch's deterministic algorithms (``warn_only``) for the span of a
    command-line run on a CUDA ``device``; the caller's setting comes back
    on exit, also on an exception. On CUDA the window BA's ``index_add_``
    adds with atomics, and two runs would not share their bits without it;
    the card's gated runs read this setting. Any other device is left as
    it is. The library API sets no process-wide state: only the CLIs take
    this."""
    if torch.device(device).type != "cuda":
        yield
        return
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)
