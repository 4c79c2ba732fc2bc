"""Build, load and count the port's CUDA kernels.

The kernels (``csrc/stage_conv.cu``, ``attention.cu``, ``sinkhorn.cu``,
``pose_gn.cu``, ``point_reduce.cu``, each exporting a plain C launcher) and their binding
(``csrc/bindings.cpp``, the only source that includes PyTorch's headers)
are one extension, compiled
for ``sm_90a`` by ``torch.utils.cpp_extension.load`` at first use into
``build/ur_mvo_tpu_torch_ext/`` beside the package. ``load`` compiles the
sources in parallel (ninja), rebuilds what an edit changed and reuses an
unchanged build.

Nothing here runs when the module is imported, and nothing here is
reached on the CPU: the CPU path runs the kernels' plain versions.

Only the stage kernel has a gradient (``cuda_conv.stage_conv_op``); the
other wrappers call :func:`refuse_grad` before they launch, so that a
CUDA input on an autograd path raises instead of coming back detached.

``LAUNCHES`` counts, per kernel name, the wrapper calls that launched a
kernel in this process; a run resets it to show which kernels its main
path went through.
"""

from __future__ import annotations

import collections
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ur_mvo_tpu_torch_ext"
SOURCES = ("bindings.cpp", "stage_conv.cu", "attention.cu", "sinkhorn.cu", "pose_gn.cu", "point_reduce.cu")
# The -gencode flag replaces load's own target flags. The -U flags undo
# load's -D__CUDA_NO_*__ defaults, so the .cu sources compile as plain nvcc
# would compile them.
CUDA_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-U__CUDA_NO_HALF_OPERATORS__",
    "-U__CUDA_NO_HALF_CONVERSIONS__",
    "-U__CUDA_NO_BFLOAT16_CONVERSIONS__",
    "-U__CUDA_NO_HALF2_OPERATORS__",
)

LAUNCHES: "collections.Counter[str]" = collections.Counter()

_ext = None
_lock = threading.Lock()


def extension(verbose: bool = False):
    """The extension module, built and loaded at first use; raises if the
    build fails. ``verbose`` shows the build's commands and what ``ptxas``
    reports per kernel (registers, shared memory, spills)."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _ext = load(
                name="ur_mvo_tpu_torch_ext",
                sources=[str(CSRC / s) for s in SOURCES],
                build_directory=str(BUILD_DIR),
                extra_cflags=["-O3"],
                extra_cuda_cflags=list(CUDA_FLAGS) + (["-Xptxas=-v"] if verbose else []),
                verbose=verbose,
            )
        return _ext


def count(name: str) -> None:
    LAUNCHES[name] += 1


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need the gradient of kernel ``what``: grad
    mode is on and one of ``tensors`` requires grad. These kernels have none
    (no TPU kernel had a VJP); their output would come back detached."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no gradient and an input requires grad; run it under "
            "torch.no_grad(), or take the plain version (plain=True, or the model's kernels=False)"
        )
