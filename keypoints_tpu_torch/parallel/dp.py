"""Data parallelism on ``torch.distributed`` — port of ``keypoints_tpu/parallel/dp.py``.

The one parallelism strategy this model family needs (no attention, so no
tensor, pipeline, sequence or expert parallelism): every rank holds the
whole model, takes ``batch / world`` rows of each global batch, and the
only collective of a step is the mean of the gradients and the loss, one
all-reduce over a flat float32 bucket (:func:`all_reduce_mean`). One
process per card, launched by ``torchrun`` (``multihost.initialize``);
NCCL between cards, gloo on the CPU or where ranks share a card.

* Draws. A rank's warp draws and in-step batch rows come from
  :func:`shard_generator`, seeded from (seed, step, rank): distinct ranks
  draw distinct warps (JAX folds the data-axis index into its key), and a
  one-rank group draws exactly what a single process draws, so it trains
  bit for bit as the single-card step.
* Parameters stay equal on every rank: they start equal
  (:func:`replicate` broadcasts rank 0's, after a resume too), and every
  rank applies the same averaged gradients.
* In-step sampling (JAX's ``make_dp_fused_chunk``): rank r draws its
  ``batch / world`` rows of batch i from ``shard_generator(seed + salt, i,
  r, world)``'s seed (``train.InStepBatches.sample_at``). The DP step is
  dispatched eagerly, one aten op and kernel launch at a time: the
  single-process step's CUDA graph (``training.make_graphed_train_step``)
  is not ported to it yet, since :func:`all_reduce_mean` rebinds the
  gradients as views of its bucket and a gloo all-reduce cannot be
  captured. The scan's chunking (``capped_chunk``) is not ported: a graph
  replays one step.
* Serving (:func:`make_dp_extract`) is row-parallel with no collective: one
  process, a frozen replica per device, each device given an equal slab of
  the padded request.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from keypoints_tpu_torch.configs import Config
from keypoints_tpu_torch.export import BucketedExtract, bundle_meta
from keypoints_tpu_torch.training import (build_model, freeze_for_inference,
                                          make_extract_fn, make_train_step,
                                          step_seed)


def shard_generator(seed: int, step: int, rank: int, world: int,
                    device: torch.device | str) -> torch.Generator:
    """The generator of ``rank``'s draws at ``step``: exactly
    ``training.step_generator(seed, step)`` in a one-rank group, else
    seeded from ``SeedSequence([seed, step, rank])``, distinct per rank
    (``training.step_seed``)."""
    return torch.Generator(device=device).manual_seed(
        step_seed(seed, step, rank, world))


def _broadcast_(tensor: torch.Tensor, group) -> None:
    """Broadcast rank 0's ``tensor`` into everyone's, in place. NCCL takes
    card tensors only, so a host tensor (Adam's step counts) goes through
    the rank's card."""
    if tensor.device.type == "cpu" and dist.get_backend(group) == "nccl":
        staged = tensor.to(torch.cuda.current_device())
        dist.broadcast(staged, 0, group=group)
        tensor.copy_(staged)
    else:
        dist.broadcast(tensor, 0, group=group)


def replicate(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
              group=None) -> None:
    """Make every rank's parameters, buffers and optimizer state rank 0's,
    in place. Each rank must hold the same optimizer state layout (all
    fresh, or all restored from one checkpoint)."""
    for tensor in model.state_dict().values():
        _broadcast_(tensor, group)
    for param in model.parameters():
        state = optimizer.state.get(param, {})
        for key in sorted(state):
            if isinstance(state[key], torch.Tensor):
                _broadcast_(state[key], group)


def shard_batch(batch, rank: int, world: int):
    """``rank``'s rows of a global batch (a tensor, or a (source, target)
    tuple): rows ``[rank * b / world, (rank + 1) * b / world)``. A batch
    that is already this rank's own (what a rank's stream yields) is not
    passed through here."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(x, rank, world) for x in batch)
    n = batch.shape[0]
    if n % world:
        raise ValueError(f"batch {n} not divisible by {world} ranks")
    return batch[rank * n // world:(rank + 1) * n // world]


def all_reduce_mean(params: Sequence[torch.Tensor], loss: torch.Tensor,
                    group) -> torch.Tensor:
    """Average the parameters' gradients and ``loss`` over ``group`` in one
    all-reduce; → the averaged loss.

    The gradients and the loss go into one flat float32 bucket on the
    current stream (the stream the collective orders itself after), are
    summed and divided by the world size (gloo has no average), and each
    ``.grad`` becomes its slice of the bucket. A parameter without a
    gradient goes in as zeros, so every rank reduces the same layout, and
    keeps ``None``: one graph gives every rank the same set.
    """
    params = list(params)
    bucket = torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
        for p in params] + [loss.detach().reshape(1).float()])
    dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=group)
    bucket.div_(dist.get_world_size(group))
    offset = 0
    for p in params:
        if p.grad is not None:
            p.grad = bucket[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return bucket[-1]


def make_dp_train_step(cfg: Config, group,
                       loss: Optional[Callable] = None) -> Callable:
    """→ step(state, batch, draws=None) -> (state, metrics) over ``group``:
    ``training.make_train_step`` with the gradients and the loss averaged
    across the group between the backward and the optimizer. ``batch`` is
    this rank's rows; the metrics are the group's means."""
    return make_train_step(cfg, loss, group=group)


def broadcast_rows(batch, rows: int, group=None):
    """Rank 0's first ``rows`` rows of ``batch`` (a tensor or a tuple) on
    every rank: rows from which every rank must reach the same decision
    (the spread check, the scoring loss)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(broadcast_rows(x, rows, group) for x in batch)
    out = batch[:rows].clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, 0, group=group)
    return out


def make_dp_extract(cfg: Config, state_dict: dict | None,
                    batches: Sequence[int],
                    devices: Sequence[torch.device | str],
                    input_dtype: str = "float32") -> BucketedExtract:
    """Data-parallel serving over ``devices``: → a ``BucketedExtract``.

    One model per device (``state_dict`` as ``checkpoint.load_model_state``
    takes it; None keeps the seeded random init), frozen for inference. A
    bucket is split into one equal slab per device; each slab is uploaded,
    rescaled from uint8 on its device when ``input_dtype`` is uint8, and
    run through Ψ and the soft-argmax on that device's current stream, all
    slabs queued before the first result is read back; the rows come back
    in order. Every bucket must divide by the device count (each device
    gets a fixed slab).
    """
    from keypoints_tpu_torch.checkpoint import load_model_state

    devices = [torch.device(d) for d in devices]
    n_dev = len(devices)
    sizes = sorted({int(b) for b in batches})
    if not sizes or sizes[0] < 1 or not n_dev:
        raise ValueError(f"invalid bucket list {batches!r} or device list "
                         f"{devices!r}")
    bad = [b for b in sizes if b % n_dev]
    if bad:
        raise ValueError(f"bucket sizes {bad} not divisible by the {n_dev} "
                         f"devices (each device needs a fixed slab)")
    if input_dtype not in ("float32", "uint8"):
        raise ValueError(f"input_dtype must be float32|uint8, "
                         f"got {input_dtype!r}")
    replicas = []
    for device in devices:
        model = build_model(cfg, device)
        if state_dict is not None:
            load_model_state(model, state_dict)
        replicas.append((device, make_extract_fn(freeze_for_inference(model))))

    def fn(images: np.ndarray) -> np.ndarray:
        outs = []
        for (device, extract), slab in zip(replicas,
                                           np.split(images, n_dev)):
            x = torch.from_numpy(slab).to(device)
            if x.dtype == torch.uint8:
                x = x.float() / 255.0
            outs.append(extract(x))
        return np.concatenate([kp.cpu().numpy() for kp in outs])

    meta = {**bundle_meta(cfg, sizes, input_dtype),
            "data_parallel_devices": n_dev}
    return BucketedExtract({b: fn for b in sizes}, meta)


# --- a multi-process dry run (``__graft_entry__.dryrun_multichip``) ----------

def _dryrun_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of :func:`dryrun`: a DP step on its shard of a seeded
    batch, then two steps on rows it samples itself; writes its losses and
    parameters to ``{out}/{rank}.pt``."""
    from keypoints_tpu_torch.configs import get_config
    from keypoints_tpu_torch.train import SyntheticBatches
    from keypoints_tpu_torch.training import init_state

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        cfg = get_config("celeba128").override(**{
            "model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
            "model.decoder_filters": (16, 8),
            "model.decoder_upsample": (True, True), "model.groups": 4,
            "data.image_size": 32, "train.batch_size": 2 * world,
            "train.compute_dtype": "float32"})
        state = init_state(cfg, "cpu")
        replicate(state.model, state.optimizer)
        step = make_dp_train_step(cfg, dist.group.WORLD)
        images = torch.from_numpy(np.random.RandomState(0).rand(
            2 * world, 3, 32, 32).astype(np.float32))
        state, metrics = step(state, shard_batch(images, rank, world))
        losses = [float(metrics["loss"])]
        source = SyntheticBatches(
            lambda gen, n: torch.rand((n, 3, 32, 32), generator=gen),
            cfg.train.batch_size // world, cfg.train.seed, 0, "cpu",
            rank=rank, world=world)
        for i in (1, 2):
            state, metrics = step(state, source.sample_at(i))
            losses.append(float(metrics["loss"]))
        torch.save({"losses": losses, "params": state.model.state_dict()},
                   os.path.join(out, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dryrun(n_processes: int) -> list[float]:
    """Spawn ``n_processes`` gloo ranks on the CPU; each takes one DP step
    of narrow celeba128 widths on its shard of a seeded batch, then two
    steps on rows it samples itself (warp mode, per-rank draws). Raises
    unless every loss is finite and every rank ends with rank 0's
    parameters bit for bit; → the losses."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_dryrun_rank, nprocs=n_processes,
                 args=(n_processes, os.path.join(tmp, "store"), tmp))
        results = [torch.load(os.path.join(tmp, f"{r}.pt"),
                              weights_only=True)
                   for r in range(n_processes)]
    losses = results[0]["losses"]
    if not all(np.isfinite(losses)):
        raise FloatingPointError(f"dry run losses {losses}")
    for rank, result in enumerate(results[1:], 1):
        if result["losses"] != losses:
            raise AssertionError(f"rank {rank} losses {result['losses']} != "
                                 f"rank 0's {losses}")
        for key, value in result["params"].items():
            if not torch.equal(value, results[0]["params"][key]):
                raise AssertionError(f"rank {rank} parameter {key} differs "
                                     f"from rank 0's")
    return losses
