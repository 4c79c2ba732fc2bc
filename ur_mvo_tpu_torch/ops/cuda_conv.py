"""Fused SuperPoint encoder stage: the CUDA kernel and its plain version
(counterpart of ``ur_mvo_tpu.ops.pallas_conv``).

One stage is conv_a 3x3 + bias + ReLU -> rounded to the compute dtype ->
conv_b 3x3 + bias + ReLU -> 2x2 max-pool, on NHWC activations. The kernel
(``csrc/stage_conv.cu``) serves the TPU's ``_stage1_kernel`` (Cin = 1) and
``_stage2_kernel`` (Cin = 64, stages 2 and 3) and covers any even H x W,
240x320 included, where the TPU kernels needed H % 32 == 0 and
W % 128 == 0.

:func:`stage_conv` takes the weights in the ``nn.Conv2d`` layout (OIHW)
and the biases in any float dtype; they are rounded to the activation
dtype, as the TPU kernel rounds them to bf16, and packed into the kernel's
layout by :func:`pack_stage`.

The kernel is the ``torch.library`` op ``ur_mvo_tpu_torch::stage_conv``
(:func:`stage_conv_op`): its CUDA implementation launches the kernel on the
packed weights, its CPU implementation is the plain version, a fake
implementation gives ``torch.export`` the output's shape, and its gradient
is the JAX package's (``_stage123_bwd``): the plain version recomputed from
the saved input and raw weights, and its VJP. There is no backward kernel,
as the TPU has none.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ur_mvo_tpu_torch.ops import cuda_ext

# (Cin, Cmid, Cout) the kernel is instantiated for: stages 1, 2, 3
SUPPORTED = ((1, 64, 64), (64, 64, 64), (64, 128, 128))


def stage_conv_plain(x: torch.Tensor, wa: torch.Tensor, ba: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused stage: (B, H, W, Cin) ->
    (B, H/2, W/2, Cout) in ``x.dtype``, float32 accumulation, conv_a's
    output rounded to ``x.dtype``. The zero padding conv_b sees outside
    the image is literal zeros (padding of conv_a's output)."""
    dt = x.dtype

    def r(t):
        return t.to(dt).float()

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        xf = x.float().permute(0, 3, 1, 2)
        a = r(F.relu(F.conv2d(xf, r(wa), r(ba), padding=1)))
        b = F.relu(F.conv2d(a, r(wb), r(bb), padding=1))
    return F.max_pool2d(b, 2).to(dt).permute(0, 2, 3, 1).contiguous()


def _kernel_weights(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """OIHW -> float [tap][ci][co], holding the ``dt``-rounded values (the
    CUDA-core loops)."""
    return w.to(dt).float().permute(2, 3, 1, 0).contiguous()


@functools.lru_cache(maxsize=None)
def _fragment_index(ci: int, co: int, device: torch.device) -> torch.Tensor:
    """Flat [ci][co] positions in mma.m16n8k16 B-fragment order: for k-step
    ks, n-tile nt, lane 4g + c, register r and half h, the element
    (k = 16 ks + 8 r + 2 c + h, n = 8 nt + g)."""
    ks, nt, g, c, r, h = (torch.arange(n) for n in (ci // 16, co // 8, 8, 4, 2, 2))
    k = 16 * ks[:, None, None, None, None, None] + 8 * r[:, None] + 2 * c[:, None, None] + h
    n = 8 * nt[None, :, None, None, None, None] + g[:, None, None, None]
    return (k * co + n).reshape(-1).to(device)


def _mma_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW -> the tensor-core kernel's packing: bf16 pairs as int32,
    [tap][ci/16][co/8][lane][2 registers]."""
    co, ci = w.shape[0], w.shape[1]
    flat = w.to(torch.bfloat16).permute(2, 3, 1, 0).reshape(9, ci * co)
    packed = flat[:, _fragment_index(ci, co, w.device)].contiguous()
    return packed.view(torch.int32).reshape(9, ci // 16, co // 8, 32, 2)


class PackedStage(NamedTuple):
    """One stage's weights in the kernel's layout, for activations of
    ``dtype`` with ``cin`` channels (see :func:`pack_stage`)."""

    dtype: torch.dtype
    cin: int
    wa: torch.Tensor
    ba: torch.Tensor
    wb: torch.Tensor
    bb: torch.Tensor


@torch.no_grad()
def pack_stage(wa: torch.Tensor, ba: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor, dtype: torch.dtype) -> PackedStage:
    """OIHW weights and biases -> the kernel's layout for ``dtype``
    activations: bfloat16 packs the 64-channel convs in mma-fragment order
    (conv_a with Cin = 1 stays a float 9-tap filter), float32 reorders to
    [tap][ci][co]; biases become float32 holding ``dtype``-rounded values.
    It depends only on the weights: ``SuperPoint`` packs once and reuses it."""
    if dtype == torch.bfloat16:
        wa_k = _kernel_weights(wa, dtype) if wa.shape[1] == 1 else _mma_weights(wa)
        wb_k = _mma_weights(wb)
    else:
        wa_k, wb_k = _kernel_weights(wa, dtype), _kernel_weights(wb, dtype)
    return PackedStage(dtype, wa.shape[1], wa_k, ba.to(dtype).float().contiguous(), wb_k, bb.to(dtype).float().contiguous())


@torch.library.custom_op("ur_mvo_tpu_torch::stage_conv", mutates_args=())
def stage_conv_op(x: torch.Tensor, wa: torch.Tensor, ba: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor,
                  packed: List[torch.Tensor]) -> torch.Tensor:
    """One fused stage as a ``torch.library`` op. ``packed`` holds
    :class:`PackedStage`'s four tensors for a CUDA ``x`` and is empty for
    a CPU one. This body is the CPU implementation: the plain version."""
    return stage_conv_plain(x, wa, ba, wb, bb)


@stage_conv_op.register_kernel("cuda")
def _stage_conv_cuda(x, wa, ba, wb, bb, packed):
    out = cuda_ext.extension().stage_conv(x.contiguous(), *packed)
    cuda_ext.count("stage1_conv" if x.shape[-1] == 1 else "stage_conv")
    return out


@stage_conv_op.register_fake
def _stage_conv_fake(x, wa, ba, wb, bb, packed):
    B, H, W, _ = x.shape
    return x.new_empty((B, H // 2, W // 2, wb.shape[0]))


def _stage_conv_setup(ctx, inputs, output):
    x, wa, ba, wb, bb, packed = inputs
    ctx.save_for_backward(x, wa, ba, wb, bb)
    ctx.n_packed = len(packed)


def _stage_conv_backward(ctx, grad):
    """``_stage123_bwd``: the plain version's VJP at the saved inputs, the
    incoming gradient cast to the output's dtype; its convolutions in
    float32 as the forward's are (no TF32)."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[:5]
    with torch.enable_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        args = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        out = stage_conv_plain(*args)
        wanted = [a for a in args if a.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad.to(out.dtype)) if wanted else ())
    return (*(next(grads) if n else None for n in need), [None] * ctx.n_packed)


stage_conv_op.register_autograd(_stage_conv_backward, setup_context=_stage_conv_setup)


def stage_conv(x: torch.Tensor, wa: torch.Tensor, ba: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor,
               plain: bool = False, packed: Optional[PackedStage] = None) -> torch.Tensor:
    """One fused encoder stage through :func:`stage_conv_op`. A CPU tensor
    runs :func:`stage_conv_plain`; a CUDA tensor launches the kernel or
    raises, with the weights from ``packed`` when given (else packed for
    this call). ``plain=True`` asks for the plain version on any device (the
    on-card comparison)."""
    if plain:
        return stage_conv_plain(x, wa, ba, wb, bb)
    if x.device.type == "cpu":
        return stage_conv_op(x, wa, ba, wb, bb, [])
    if x.device.type != "cuda":
        raise ValueError(f"stage_conv: unsupported device {x.device}")
    B, H, W, Cin = x.shape
    Cmid, Cout = wa.shape[0], wb.shape[0]
    if (Cin, Cmid, Cout) not in SUPPORTED or wa.shape[1] != Cin or wb.shape[1] != Cmid:
        raise ValueError(f"stage_conv: channels {(Cin, Cmid, Cout)} not in {SUPPORTED}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stage_conv: dtype {x.dtype} not supported")
    if H % 2 or W % 2:
        raise ValueError(f"stage_conv: H and W must be even, got {H}x{W}")
    if packed is None:
        packed = pack_stage(wa, ba, wb, bb, x.dtype)
    elif packed.dtype != x.dtype or packed.cin != Cin:
        raise ValueError(f"stage_conv: weights packed for {packed.dtype}, Cin={packed.cin}; got {x.dtype}, Cin={Cin}")
    return stage_conv_op(x, wa, ba, wb, bb, [packed.wa, packed.ba, packed.wb, packed.bb])
