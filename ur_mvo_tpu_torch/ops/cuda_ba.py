"""Bundle adjustment's point-side segment sums: the two CUDA kernels of
``csrc/point_reduce.cu`` beside their plain versions (counterpart of
``ur_mvo_tpu.ops.pallas_ba``).

For value rows ``A`` (O, 18) and ``Vp`` (O, 12), point ids and free-frame
slots in [0, FF), both compute the (P, FF*18 + 12) float32

    out[p, f*18 + v] = sum over o with pt = p, slot = f of bf16(A[o, v])
    out[p, FF*18 + v] = sum over o with pt = p of bf16(Vp[o, v])

(summands rounded to bf16, float32 accumulation: the numerics of the JAX
package's one-hot matmul and Pallas routes). :func:`point_reduce_sorted`
takes rows sorted by point with a CSR ``seg_start`` and sums each point's
rows in order, without atomics (bit for bit repeatable);
:func:`point_reduce` takes rows in any order and adds with atomics.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
(counted as ``point_reduce_sorted`` / ``point_reduce``) or raises, also
where an input requires grad under grad mode (no gradient).
``plain=True`` asks for the plain version on any device.
"""

from __future__ import annotations

import torch

from ur_mvo_tpu_torch.ops import cuda_ext


def point_reduce_plain(A: torch.Tensor, Vp: torch.Tensor, pt: torch.Tensor, slot: torch.Tensor,
                       P: int, FF: int) -> torch.Tensor:
    """``index_add_`` of the bf16-rounded rows into a float32
    (P, FF*18 + 12); ids clipped as the kernels clip them."""
    pt = torch.clamp(pt.to(torch.int64), 0, P - 1)
    slot = torch.clamp(slot.to(torch.int64), 0, FF - 1)
    f32 = torch.float32
    A_b = A.to(torch.bfloat16).to(f32)
    Vp_b = Vp.to(torch.bfloat16).to(f32)
    U = torch.zeros((P * FF, 18), dtype=f32, device=A.device).index_add_(0, pt * FF + slot, A_b)
    H = torch.zeros((P, 12), dtype=f32, device=A.device).index_add_(0, pt, Vp_b)
    return torch.cat([U.reshape(P, FF * 18), H], dim=1)


def _check(A, Vp, ids, what):
    if A.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {A.device}")
    O = A.shape[0]
    if A.shape != (O, 18) or Vp.shape != (O, 12) or any(t.shape != (O,) for t in ids):
        raise ValueError(f"{what}: shapes A{tuple(A.shape)} Vp{tuple(Vp.shape)} ids {[tuple(t.shape) for t in ids]}")
    cuda_ext.refuse_grad(what, A, Vp)


def point_reduce_sorted(A: torch.Tensor, Vp: torch.Tensor, pt: torch.Tensor, slot: torch.Tensor,
                        seg_start: torch.Tensor, FF: int, plain: bool = False) -> torch.Tensor:
    """Point-sorted rows: ``seg_start`` (P + 1,) with rows
    ``seg_start[p]:seg_start[p+1]`` belonging to point p (``pt`` equal to p
    there) -> (P, FF*18 + 12). Rows after ``seg_start[P]`` belong to no
    point and must be zero (BA's padding). Points without rows are exact
    zeros."""
    P = seg_start.shape[0] - 1
    if plain or A.device.type == "cpu":
        return point_reduce_plain(A, Vp, pt, slot, P, FF)
    _check(A, Vp, (pt, slot), "point_reduce_sorted")
    i32 = torch.int32
    out = cuda_ext.extension().point_reduce_sorted(
        A.to(torch.float32).contiguous(), Vp.to(torch.float32).contiguous(), slot.to(i32).contiguous(),
        seg_start.to(i32).contiguous(), int(FF),
    )
    cuda_ext.count("point_reduce_sorted")
    return out


def point_reduce(A: torch.Tensor, Vp: torch.Tensor, pt: torch.Tensor, slot: torch.Tensor, P: int, FF: int,
                 plain: bool = False) -> torch.Tensor:
    """Rows in any order -> (P, FF*18 + 12), by float atomics on the card
    (repeatable only to float32 summation order)."""
    if plain or A.device.type == "cpu":
        return point_reduce_plain(A, Vp, pt, slot, P, FF)
    _check(A, Vp, (pt, slot), "point_reduce")
    i32 = torch.int32
    out = cuda_ext.extension().point_reduce(
        A.to(torch.float32).contiguous(), Vp.to(torch.float32).contiguous(), pt.to(i32).contiguous(),
        slot.to(i32).contiguous(), int(P), int(FF),
    )
    cuda_ext.count("point_reduce")
    return out
