"""Data parallelism on ``torch.distributed`` — port of ``keypoints_tpu/parallel/dp.py``.

The one parallelism strategy this model family needs (no attention, so no
tensor, pipeline, sequence or expert parallelism): every rank holds the
whole model, takes ``batch / world`` rows of each global batch, and the
only collective of a step is the mean of the gradients and the loss, one
all-reduce over a persistent flat float32 bucket (:class:`GradBucket`). One
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
* One dispatch a step, as JAX's jitted ``make_dp_train_step`` and its
  ``make_dp_fused_chunk``: on CUDA the train loop replays the DP step from
  CUDA graphs (``training.make_graphed_train_step(..., group=...)``), an
  in-step source's sampling inside (rank r draws its ``batch / world``
  rows of batch i from ``shard_generator(seed + salt, i, r, world)``'s
  seed, ``train.InStepBatches.sample_at``). The step is two graphs
  around one eager all-reduce, under NCCL and gloo alike (gloo's cannot
  be captured; NCCL's stays outside the graph until a multi-card run
  shows it reduces there and gains). The graphs read the
  gradients in place, which is why the bucket is persistent: the
  gradients are bound to it once and never rebound. The scan's chunking
  (``capped_chunk``) is not ported: a graph replays one step.
* Serving (:func:`make_dp_extract`) is row-parallel with no collective: one
  process, a frozen replica per device, each device given an equal slab of
  the padded request, each (device, bucket) replayed from one CUDA graph
  (``export.GraphedBucket``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from keypoints_tpu_torch.configs import Config
from keypoints_tpu_torch.export import (BucketedExtract, GraphedBucket,
                                        bundle_meta, read_back)
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


class GradBucket:
    """The gradients of a model's parameters and the step's loss, in one
    flat float32 buffer that lives as long as the model: DDP's
    ``gradient_as_bucket_view``, written out.

    Made from the gradients of a first backward: the parameters that got a
    gradient are the bucket's, in parameter order, their values copied in
    and each ``.grad`` rebound once as its view of the buffer; the last
    slot holds the loss. Every later backward accumulates into the views in
    place (autograd adds into an existing ``.grad``), so no tensor is
    rebound again and a CUDA graph may read and write them. A parameter
    that got no gradient keeps ``.grad = None``. Every rank takes the same
    set, since one model's graph gives every rank the same one.

    :meth:`reduce_mean` is :meth:`put_loss`, :meth:`all_reduce` and
    :meth:`mean`: the graphed step runs the three apart, the middle one
    eagerly between two CUDA graphs.
    """

    def __init__(self, params: Sequence[torch.Tensor]):
        self.params = [p for p in params if p.grad is not None]
        if not self.params:
            raise ValueError("no parameter has a gradient: run a backward "
                             "before making the bucket")
        bad = [p.grad.dtype for p in self.params
               if p.grad.dtype != torch.float32]
        if bad:
            raise ValueError(f"the bucket holds float32 gradients, got {bad}")
        loss = torch.zeros(1, device=self.params[0].grad.device)
        self.flat = torch.cat([p.grad.reshape(-1) for p in self.params]
                              + [loss])
        offset = 0
        for p in self.params:
            p.grad = self.flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()

    def zero_(self) -> None:
        """Zero every gradient and the loss: one fill of the buffer."""
        self.flat.zero_()

    def put_loss(self, loss: torch.Tensor) -> None:
        """Copy this rank's ``loss`` into the last slot."""
        self.flat[-1:].copy_(loss.detach().reshape(1))

    def all_reduce(self, group) -> None:
        """Sum the buffer over ``group``, in place, on the current stream."""
        dist.all_reduce(self.flat, op=dist.ReduceOp.SUM, group=group)

    def mean(self, group) -> torch.Tensor:
        """Divide the summed buffer by the world size (gloo has no
        average); → the averaged loss, a tensor of its own (the buffer is
        zeroed by the next step)."""
        self.flat.div_(dist.get_world_size(group))
        return self.flat[-1].clone()

    def reduce_mean(self, loss: torch.Tensor, group) -> torch.Tensor:
        """Average the gradients and ``loss`` over ``group`` in one
        all-reduce; → the averaged loss."""
        self.put_loss(loss)
        self.all_reduce(group)
        return self.mean(group)


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
    bucket is split into one equal slab per device; each slab runs Ψ and
    the soft-argmax on its device (rescaled from uint8 there first when
    ``input_dtype`` is uint8), all slabs queued before the first result is
    read back; the rows come back in order. On a CUDA device each (device,
    bucket) is one ``export.GraphedBucket``: the slab is copied from the
    array straight into the graph's static input and one CUDA graph
    replayed, as JAX compiles one program
    a bucket; the device's buckets share one memory pool. On the CPU the
    slab runs eagerly. Every bucket must divide by the device count (each
    device gets a fixed slab).
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
    d = cfg.data
    item = (d.channels, d.image_size, d.image_size)
    pools: dict = {}
    enqueues: dict[int, list[Callable]] = {b: [] for b in sizes}
    for device in devices:
        model = build_model(cfg, device)
        if state_dict is not None:
            load_model_state(model, state_dict)
        extract = make_extract_fn(freeze_for_inference(model))

        def run(x: torch.Tensor, extract=extract) -> torch.Tensor:
            if x.dtype == torch.uint8:
                x = x.float() / 255.0
            return extract(x)

        for b in sizes:
            if device.type == "cuda":
                enqueues[b].append(GraphedBucket(
                    run, b // n_dev, item, input_dtype, device,
                    pools).enqueue)
            else:
                enqueues[b].append(
                    lambda slab, run=run: run(torch.from_numpy(slab)))

    def bucket_fn(slab_fns: list[Callable]) -> Callable:
        def fn(images: np.ndarray) -> np.ndarray:
            return read_back([enqueue(slab) for enqueue, slab in
                              zip(slab_fns, np.split(images, n_dev))])
        return fn

    meta = {**bundle_meta(cfg, sizes, input_dtype),
            "data_parallel_devices": n_dev}
    return BucketedExtract({b: bucket_fn(fns) for b, fns in enqueues.items()},
                           meta)

