"""Data-parallel SuperPoint fine-tuning over a mesh (port of
``ur_mvo_tpu.parallel.train_step``).

The JAX step is one jitted program with the batch sharded over the mesh
and the parameters and optimizer state replicated: XLA inserts the
gradient ``psum``, and the step computes the whole batch's loss. Here each
rank is a process (``parallel/mesh``): it takes its block of the batch
(``shard_batch``), computes the descriptor loss's sum on it, and divides by
the whole batch's normalization (one ``all_reduce`` of the ranks' valid-cell
counts before the backward); the gradients are then summed over the ranks
(one ``all_reduce`` of all of them in one buffer), so every rank applies the
whole batch's gradient to its replica and the replicas stay equal. The hinge
loss is a ratio of sums over the batch, not a mean of per-item losses, so
this is the JAX step's loss exactly, where a mean of the ranks' own losses
would weight each rank by its share of valid cells. The loss returned is the
whole batch's.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ur_mvo_tpu_torch.models.train_superpoint import loss_terms
from ur_mvo_tpu_torch.parallel.mesh import AXIS, all_sum, shard_batch


def make_dp_train_step(optimizer: torch.optim.Optimizer, mesh: DeviceMesh, axis: str = AXIS):
    """``step(model, batch) -> loss``: ``batch`` is the whole batch (every
    rank passes the same), of which each rank computes its block; the model
    is replicated and ``optimizer`` holds its trainable parameters."""
    if mesh.mesh_dim_names != (axis,):
        raise ValueError(f"make_dp_train_step: a 1-D mesh over {axis!r}, got {mesh.mesh_dim_names}")

    def step(model, batch):
        local = {k: shard_batch(v, mesh) for k, v in batch.items()}
        optimizer.zero_grad(set_to_none=True)
        total, norm = loss_terms(model, local)
        (norm_all,) = all_sum([norm.detach().reshape(1)], mesh)
        loss = total / torch.clamp(norm_all[0], min=1.0)
        loss.backward()
        params = [p for group in optimizer.param_groups for p in group["params"] if p.grad is not None]
        for p, g in zip(params, all_sum([p.grad for p in params], mesh)):
            p.grad.copy_(g)
        optimizer.step()
        (loss_all,) = all_sum([loss.detach().reshape(1)], mesh)
        return loss_all[0]

    return step
