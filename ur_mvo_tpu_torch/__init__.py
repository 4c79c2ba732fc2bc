"""PyTorch/CUDA port of ``ur_mvo_tpu`` for NVIDIA Hopper (H100).

The package mirrors the layout of ``ur_mvo_tpu`` module by module and
imports nothing of it (nor JAX). Plain tensor code is PyTorch; every
kernel that the JAX package wrote in Pallas for the TPU is a CUDA C++
kernel under ``csrc/``, compiled for ``sm_90a`` at first use.

Entry points take an explicit ``device`` and default to ``cuda``. The
device decides the path: on a CUDA tensor a kernel wrapper launches its
kernel (or raises), on a CPU tensor it runs the kernel's plain PyTorch
version. Nothing falls back from one to the other.
"""

from ur_mvo_tpu_torch.config import Configs, SensorSetup  # noqa: F401
from ur_mvo_tpu_torch.device import resolve_device  # noqa: F401
