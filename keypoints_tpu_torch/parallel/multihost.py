"""Process-group bootstrap and host sharding — port of ``keypoints_tpu/parallel/multihost.py``.

The port runs one process per card, launched by ``torchrun`` (``python -m
torch.distributed.run``), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.
:func:`initialize` joins the process group those describe; every other
helper answers as a single process (rank 0 of 1) when there is no group, so
the same CLI runs alone or under ``torchrun``.

Not ported: JAX's ``TPU_WORKER_HOSTNAMES`` rule, a workaround for a TPU
plugin that names a single worker.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def initialize(backend: Optional[str] = None) -> None:
    """Join the process group of ``torchrun``'s environment; a no-op when
    ``WORLD_SIZE`` is unset or 1, or when a group already exists.

    The rank's card (``LOCAL_RANK`` modulo the visible cards) is made
    current *before* ``init_process_group``: NCCL builds its communicator on
    the current card, and without this every rank's lands on card 0. The
    backend is ``nccl`` when the local ranks map one to one onto cards, and
    ``gloo`` when ranks share a card or there is none (``backend`` forces
    one: the CLIs pass ``gloo`` for ``--device cpu``).
    """
    world = _env_int("WORLD_SIZE", 1)
    if world <= 1 or dist.is_initialized():
        return
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards:
        torch.cuda.set_device(rank_device())
    if backend is None:
        local_world = _env_int("LOCAL_WORLD_SIZE", world)
        backend = "nccl" if 0 < local_world <= cards else "gloo"
    # NCCL's barrier and communicators on this rank's card, bound up front
    dist.init_process_group(
        backend, device_id=rank_device() if backend == "nccl" else None)
    if dist.get_rank() == 0:
        print(f"process group: {backend}, {dist.get_world_size()} ranks",
              flush=True)


def host_shard() -> tuple[int, int]:
    """→ (rank, world size) for this process's data loader: pass them to
    ``data.records.single_stream``/``pair_stream`` as ``shard_index`` and
    ``shard_count`` so each rank reads a disjoint slice of the store. (0, 1)
    without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_batch_size(global_batch: int) -> int:
    """This rank's share of ``global_batch``; raises when it does not
    divide by the world size."""
    _, world = host_shard()
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{world} processes")
    return global_batch // world


def is_primary() -> bool:
    """True on rank 0 (and without a process group): the one rank that
    writes checkpoints, ``best.json``, logs, results and generated stores.
    Every writer of the package asks here."""
    return host_shard()[0] == 0


def barrier() -> None:
    """Wait for every rank; a no-op without a process group."""
    if dist.is_initialized():
        dist.barrier()


def min_max(value: int) -> tuple[int, int]:
    """→ (least, greatest) of ``value`` over the ranks, in one all-reduce;
    (value, value) without a process group. What decides a rank's
    collectives is agreed or checked through it, so no rank takes a branch
    the others do not."""
    if not dist.is_initialized():
        return value, value
    device = (torch.cuda.current_device() if dist.get_backend() == "nccl"
              else "cpu")
    both = torch.tensor([-value, value], dtype=torch.int64, device=device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    return -int(both[0]), int(both[1])


def rank_device() -> torch.device:
    """This rank's card: ``cuda:{LOCAL_RANK % device_count}``."""
    return torch.device("cuda", _env_int("LOCAL_RANK", 0)
                        % torch.cuda.device_count())
