"""Process groups and the 1-D device mesh (port of ``ur_mvo_tpu.parallel.mesh``).

The JAX package rides one ``jax.sharding.Mesh`` driven by a single
controller. Here every rank is a process: :func:`init_distributed` joins
the ranks into a ``torch.distributed`` world, :func:`make_mesh` lays a 1-D
``DeviceMesh`` named ``"data"`` over it, and sharding over the leading axis
(``P("data")``) becomes rank ``r`` owning the contiguous block
``[r*B/n, (r+1)*B/n)`` (:func:`shard_batch`). A ``psum`` becomes an
``all_reduce``; a gather of the full leading axis (:func:`gather_batch`)
is an ``all_reduce`` of a zero-filled buffer in which each rank fills its
block, summed on the integer view of the bits: gloo offers only
``all_reduce`` and ``broadcast`` on CUDA tensors, and a float sum would
turn ``-0.0 + 0.0`` into ``+0.0``.

Backends: a CUDA mesh runs NCCL unless the caller names ``"gloo"`` (two
ranks on one card: NCCL refuses a GPU shared by two ranks); a CPU mesh runs
gloo. Without NCCL a CUDA mesh raises rather than move to gloo or the CPU.
"""

from __future__ import annotations

import collections
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ur_mvo_tpu_torch.device import DeviceLike, resolve_device

AXIS = "data"
# a rank that dies leaves the others blocked in a collective: every group
# gives up after this long
DEFAULT_TIMEOUT_S = 60.0

# the device init_distributed chose, with the world it chose it for: a
# world joined otherwise (torchrun and init_process_group) has none
_joined: Optional[tuple] = None

# what :func:`all_sum` sent through ``all_reduce`` in this process:
# ``"calls"`` and ``"bytes"`` (the packed buffer's), counted as
# ``ops/cuda_ext.LAUNCHES`` counts kernel launches; ``cli.bench_scaling``
# reads them a LM step
ALL_SUM: "collections.Counter[str]" = collections.Counter()


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``device`` if given, else ``cuda:{LOCAL_RANK}``
    (raises without CUDA, as every entry point does)."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return resolve_device(device)


def _joined_device() -> Optional[torch.device]:
    """The device :func:`init_distributed` chose for the current world."""
    if _joined is not None and dist.is_initialized() and _joined[0] is dist.group.WORLD:
        return _joined[1]
    return None


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None, device: DeviceLike = None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join this process to the world (``torch.distributed.init_process_group``)
    and return its device (:func:`rank_device`). ``backend`` None picks NCCL
    for a CUDA device and gloo for the CPU; ``init_method`` is a ``file://``
    or ``tcp://`` rendezvous, or None for the ``MASTER_ADDR`` environment."""
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("init_distributed: NCCL reduces CUDA tensors only; a CPU mesh runs gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("init_distributed: this PyTorch has no NCCL; name backend='gloo' to run over gloo")
    elif backend != "gloo":
        raise ValueError(f"init_distributed: backend {backend!r} (nccl or gloo)")
    if dev.type == "cuda":
        # a device chosen before the mesh: DeviceMesh keeps it rather than
        # guess one from the rank
        torch.cuda.set_device(dev)
        torch.zeros((), device=dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    global _joined
    _joined = (dist.group.WORLD, dev)
    return dev


def make_mesh(n: Optional[int] = None, axis: str = AXIS) -> DeviceMesh:
    """A 1-D mesh named ``axis`` over the whole world (``n``, if given, must
    be the world size), of the device type :func:`init_distributed` chose.
    A world joined otherwise gets :func:`rank_device`'s CUDA device,
    whatever its backend (gloo reduces CUDA tensors too): only
    ``init_distributed(device="cpu")`` makes a CPU mesh."""
    world = dist.get_world_size()
    if n not in (None, world):
        raise ValueError(f"make_mesh: a mesh of {n} over a world of {world} ranks")
    dev = _joined_device() or rank_device()
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis,))


def mesh_rank_device(mesh: DeviceMesh, device: DeviceLike = None) -> torch.device:
    """An entry point's device on a mesh: ``device`` if given, else the
    device :func:`init_distributed` chose for this rank, else
    :func:`rank_device`'s CUDA device (which raises without CUDA). The CPU
    only where one of the two asked for it."""
    if device is not None:
        return resolve_device(device)
    return _joined_device() or rank_device()


def _map(fn, x):
    """``fn`` on a tensor, or on each field of a NamedTuple of tensors."""
    if isinstance(x, tuple):
        return type(x)(*(fn(f) for f in x))
    return fn(x)


def _block(n: int, rank: int, length: int) -> slice:
    if length % n:
        raise ValueError(f"a leading axis of {length} does not split over {n} ranks")
    b = length // n
    return slice(rank * b, (rank + 1) * b)


def shard_batch(x, mesh: DeviceMesh):
    """This rank's block of the leading axis of a tensor (or of every field
    of a NamedTuple of tensors)."""
    return _map(lambda t: t[_block(mesh.size(), mesh.get_local_rank(), t.shape[0])], x)


def _to_bits(t: torch.Tensor) -> torch.Tensor:
    """The bits of ``t`` as 32- or 64-bit integers (bool as int32)."""
    if t.dtype == torch.bool:
        return t.to(torch.int32)
    if t.element_size() in (4, 8):
        return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int64)
    raise TypeError(f"no exact collective for {t.dtype}")


def _from_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return bits != 0 if dtype == torch.bool else bits.view(dtype)


def _all_reduce_bits(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    bits = _to_bits(t)
    dist.all_reduce(bits, group=mesh.get_group())
    return _from_bits(bits, t.dtype)


def gather_batch(x_local, mesh: DeviceMesh):
    """The full leading axis on every rank from each rank's block: an
    ``all_reduce`` of the bits of a zero-filled buffer holding this rank's
    block (exact: each element has one non-zero summand)."""

    def gather(t):
        n, r = mesh.size(), mesh.get_local_rank()
        full = torch.zeros((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        full[_block(n, r, full.shape[0])] = t
        return _all_reduce_bits(full, mesh)

    return _map(gather, x_local)


def replicate(x, mesh: DeviceMesh):
    """Rank 0's tensor (or NamedTuple of tensors) on every rank: a
    ``broadcast`` of its bits. Every rank passes a tensor of the same shape
    and dtype."""

    def bcast(t):
        bits = _to_bits(t)
        dist.broadcast(bits, src=dist.get_global_rank(mesh.get_group(), 0), group=mesh.get_group())
        return _from_bits(bits, t.dtype)

    return _map(bcast, x)


def all_sum(tensors, mesh: DeviceMesh):
    """The ``psum`` of several float tensors in ONE ``all_reduce``: packed
    into one buffer, summed, split back to their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.get_group())
    ALL_SUM["calls"] += 1
    ALL_SUM["bytes"] += flat.numel() * flat.element_size()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i : i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def gather_objects(obj, mesh: DeviceMesh) -> list:
    """Each rank's picklable host object, in rank order, on every rank
    (``all_gather_object``: gloo moves it through host tensors, NCCL
    through the rank's CUDA device)."""
    out = [None] * mesh.size()
    dist.all_gather_object(out, obj, group=mesh.get_group())
    return out


def replicate_object(obj, mesh: DeviceMesh):
    """Rank 0's picklable host object on every rank (``broadcast_object_list``)."""
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(mesh.get_group(), 0), group=mesh.get_group())
    return box[0]
