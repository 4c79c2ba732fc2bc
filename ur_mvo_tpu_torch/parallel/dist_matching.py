"""Batched pair matching sharded over the ranks of a mesh (port of
``ur_mvo_tpu.parallel.dist_matching``).

Each pair is independent, so every rank matches its block of the pairs
with the batched ``SuperGlue.match_scores`` (on the card: one attention
launch a GNN layer at 2 B / n banks, one Sinkhorn launch a pair), decodes
its assignments, and the ``Matches`` are gathered to every rank: the only
collective. This serves multi-sequence VO and offline map building.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ur_mvo_tpu_torch.models.superglue import SuperGlue
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank
from ur_mvo_tpu_torch.ops.matching import Matches, decode_assignment
from ur_mvo_tpu_torch.parallel.mesh import gather_batch, shard_batch
from ur_mvo_tpu_torch.parallel.multi_seq import stack_lanes


def make_batched_matcher(superglue: SuperGlue, mesh: DeviceMesh, width: int, height: int,
                         sinkhorn_iterations: int = 20, threshold: float = 0.5, num_heads: int = 4):
    """Returns ``fn(banks0, banks1) -> Matches`` over a leading batch axis
    that the mesh size divides. Every rank passes all B pairs and gets all
    B match tables back; it computes only its own ``B / n``."""

    @torch.no_grad()
    def fn(banks0: FeatureBank, banks1: FeatureBank) -> Matches:
        b0, b1 = shard_batch(banks0, mesh), shard_batch(banks1, mesh)
        Z = superglue.match_scores(b0, b1, width, height, sinkhorn_iterations, num_heads)
        local = stack_lanes([decode_assignment(Z[i], b0.valid[i], b1.valid[i], threshold)
                             for i in range(Z.shape[0])])
        return gather_batch(local, mesh)

    return fn
