"""Training entry point — port of ``keypoints_tpu/train.py``.

``python -m keypoints_tpu_torch.train --preset transporter_atari``: build
the config → a batch source → the train step
(``training.make_train_step``) → logging every ``log_every`` steps, the
keypoint-spread check, logged images and best-checkpoint scoring every
``eval_every``, a checkpoint every ``checkpoint_every``, and automatic
resume from the newest checkpoint.

* Batch sources (:func:`make_batch_iterator`): the synthetic generators and
  stores that fit the card are sampled on the device, batch ``i`` a pure
  function of ``(seed + salt, i)`` (``training.step_generator``; salt 1 for
  the generators, 3 for resident stores, as JAX folds its keys); bigger
  stores stream from the host (``data.records``), batch ``i`` a pure
  function of ``(seed, i)`` too. The train step's own draws are a function
  of ``(seed, step)``, so a resumed run continues the uninterrupted run's
  trajectory bit for bit.
* The step counter lives on the host, and the metrics are read (a device
  sync) only at ``log_every``. Eager PyTorch dispatches one step a loop
  iteration.
* On CUDA, :func:`train` sets ``torch.backends.cudnn.deterministic`` (and
  ``benchmark`` off) for the run and restores both after it: resume is
  bit-exact only with deterministic convolution algorithms. The
  hand-written kernels use no float atomics.
* Ctrl-C saves at the interrupted step when that step is newer than the
  newest checkpoint and no step was in flight (a step interrupted inside
  the optimizer update would leave half-updated parameters).
* Data parallelism (``parallel.dp``): under ``torchrun --nproc_per_node N
  -m keypoints_tpu_torch.train``, one process a card, each rank takes
  ``batch / N`` rows of every batch (its own stream shard, or its own
  in-step draws) and the step averages the gradients across the ranks.
  Rank 0 alone writes checkpoints, ``best.json``, logs and images; every
  rank restores the newest checkpoint, then takes rank 0's parameters and
  optimizer state. What decides control flow (the divergence check, the
  spread check, best-checkpoint scoring, the stop) is computed on every
  rank from equal parameters and equal rows, so no rank leaves the loop
  while the others wait in an all-reduce.
* The supervisors (``--supervise``, ``--reroll-on-plateau``) wrap one
  process. Under ``torchrun`` each rank's supervisor relaunches its own
  child: a crashed rank leaves the others waiting in the next all-reduce
  until the process group's timeout, so restart a group with torchrun's
  own ``--max-restarts``, which relaunches every rank (each resumes from
  the newest checkpoint). A discovery failure stops every rank at the same
  step; rank 0 alone quarantines the checkpoints, and every rank's reroll
  supervisor relaunches with the same next seed.

Not ported:

* ``capped_chunk`` / ``MAX_CHUNK_STEPS``: the length of a ``lax.scan``
  dispatch, capped for a TPU worker's execution deadline; there is no scan.
* ``preflight_hbm``, ``_tree_bytes``, ``PREFLIGHT_MARGIN_BYTES``: XLA's
  buffer assignment asked for a program's peak, on the TPU only.
* ``_state_saveable``: JAX's donated buffers, which torch does not have.
* ``utils/compile_cache``: the XLA compilation cache (the kernels' library
  is cached by ``kernels._build``).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import sys
import time
from typing import Callable, Iterator, Optional

import torch
import torch.distributed as dist

from keypoints_tpu_torch import checkpoint as ckpt
from keypoints_tpu_torch.configs import Config, apply_overrides, get_config
from keypoints_tpu_torch.data.augment import make_pair
from keypoints_tpu_torch.data.device import (DeviceDataset, fits_in_memory,
                                             sample_frames,
                                             sample_pair_frames)
from keypoints_tpu_torch.data.records import (FrameStore, pair_stream,
                                              prefetch, single_stream,
                                              store_path_for,
                                              tail_pair_frames)
from keypoints_tpu_torch.data.synthetic import (moving_dots_pair,
                                                scripted_pong_pair)
from keypoints_tpu_torch.eval import keypoint_metrics
from keypoints_tpu_torch.losses import l2_loss, make_perceptual_loss
from keypoints_tpu_torch.models.vgg import make_feature_fn
from keypoints_tpu_torch.parallel import dp as dp_mod
from keypoints_tpu_torch.parallel import multihost
from keypoints_tpu_torch.training import (TrainState, init_state,
                                          make_extract_fn, make_train_step,
                                          require_device, step_generator,
                                          warp_config)
from keypoints_tpu_torch.viz import (Logger, image_grid, overlay_keypoints,
                                     side_by_side, to_hwc)

SYNTHETIC_DATASETS = ("synthetic_dots", "synthetic_pong")


def make_batch_iterator(cfg: Config, start_step: int = 0,
                        device: torch.device | str = "cuda") -> Iterator:
    """→ a source of raw-image batches (warp mode) or (src, tgt) pairs on
    ``device``, starting at batch ``start_step``: this rank's
    ``batch / world`` rows of each batch under a process group
    (``multihost.host_shard``), the whole batch without one.

    A missing store is generated first, by rank 0 under a process group
    (pose: articulated figures; celeba: procedural faces; atari:
    scripted-Pong rollouts, or real ALE where gym has it). Every rank takes
    the same source: resident only where the store fits every rank's
    card. A store's tail (:func:`scoring_holdout`) is held out of
    training in both the resident and the stream paths.
    """
    d = cfg.data
    rank, world = multihost.host_shard()
    b = multihost.local_batch_size(cfg.train.batch_size)
    warp_mode = d.pair_mode == "warp"
    if d.dataset == "synthetic_dots":
        def mk(gen, n):
            pair = moving_dots_pair(gen, n, d.image_size,
                                    num_dots=cfg.model.num_keypoints,
                                    channels=d.channels, max_shift=0.8)[:2]
            return pair[0] if warp_mode else pair
        return SyntheticBatches(mk, b, cfg.train.seed, start_step, device,
                                rank, world)
    if d.dataset == "synthetic_pong":
        def mk(gen, n):
            pair = scripted_pong_pair(gen, n, d.image_size)[:2]
            return pair[0] if warp_mode else pair
        return SyntheticBatches(mk, b, cfg.train.seed, start_step, device,
                                rank, world)
    store_path = store_path_for(d)
    # rank 0 alone generates a missing store (the group shares one
    # filesystem), and no rank opens it before it is whole
    try:
        if multihost.is_primary() and not os.path.exists(store_path):
            _generate_store(cfg, store_path, device)
    finally:
        multihost.barrier()
    store = FrameStore(store_path)
    n_items = (len(store.pairs) if d.pair_mode == "temporal"
               and store.pairs is not None else len(store.frames))
    holdout = scoring_holdout(cfg, n_items)
    limit = n_items - holdout if holdout else None
    # resident or streamed on every rank alike: a stream's first step
    # broadcasts its scoring rows, a resident source's does not
    if multihost.min_max(int(fits_in_memory(store, device=device)))[0]:
        return DeviceResidentBatches(DeviceDataset(store, device=device), b,
                                     d.pair_mode, cfg.train.seed, start_step,
                                     limit=limit, rank=rank, world=world)
    # bigger than the card: host streams, this rank's shard of the items
    stream = pair_stream if d.pair_mode == "temporal" else single_stream
    return prefetch(stream(store, b, cfg.train.seed, shard_index=rank,
                           shard_count=world, start_batch=start_step,
                           workers=d.loader_workers, limit=limit,
                           device=device))


def _generate_store(cfg: Config, store_path: str,
                    device: torch.device | str) -> None:
    """Write the preset's missing store at ``store_path``: pose figures,
    procedural faces, or Atari rollouts; raises for any other dataset."""
    d = cfg.data
    if d.dataset == "pose":
        from keypoints_tpu_torch.data.pose import generate_pose_store
        print(f"generating synthetic pose store at {store_path}",
              flush=True)
        generate_pose_store(store_path, size=d.image_size,
                            seed=cfg.train.seed, device=device)
    elif d.dataset == "celeba":
        from keypoints_tpu_torch.data.faces import generate_face_store
        print(f"generating synthetic face store at {store_path}",
              flush=True)
        generate_face_store(store_path, size=d.image_size,
                            seed=cfg.train.seed)
    elif d.dataset == "atari":
        from keypoints_tpu_torch.data.collect import collect
        print(f"collecting rollouts into {store_path}", flush=True)
        collect(store_path, size=d.image_size, seed=cfg.train.seed,
                device=device)
    else:
        raise FileNotFoundError(
            f"{store_path} not found; convert real frames with "
            f"data.records.image_folder_to_store or point data.data_dir "
            f"at an existing store")


class InStepBatches:
    """A batch source sampled on the device: rank ``rank`` of ``world``
    draws its ``batch`` rows of batch ``i`` as
    ``sample(parallel.dp.shard_generator(seed + _key_salt, i, rank, world),
    batch)``, a pure function of ``(seed + _key_salt, i, rank)`` (of
    ``(seed + _key_salt, i)`` alone in a one-rank world). The loop draws
    batch ``state.step`` each step; the eval cadence draws its rows from
    :meth:`generator`, the same on every rank. Also iterable, from
    ``start_step``."""

    batch: int = 0
    seed: int = 0
    start_step: int = 0
    device: torch.device | str = "cuda"
    rank: int = 0
    world: int = 1
    #: separates this source's draws from the train step's (seed, step)
    _key_salt: int = 1

    def sample(self, generator: torch.Generator, n: int):
        """Draw an ``n``-example batch on ``generator`` (on the device)."""
        raise NotImplementedError

    def generator(self, step: int) -> torch.Generator:
        """The generator of step ``step``, the same on every rank."""
        return step_generator(self.seed + self._key_salt, step, self.device)

    def sample_at(self, step: int):
        return self.sample(dp_mod.shard_generator(
            self.seed + self._key_salt, step, self.rank, self.world,
            self.device), self.batch)

    def __iter__(self):
        for i in itertools.count(self.start_step):
            yield self.sample_at(i)


class SyntheticBatches(InStepBatches):
    """A synthetic generator ``make(generator, n)`` drawn on the device."""

    def __init__(self, make: Callable, batch: int, seed: int,
                 start_step: int, device: torch.device | str = "cuda",
                 rank: int = 0, world: int = 1):
        self.make = make            # (generator, n) -> batch or (src, tgt)
        self.batch = batch
        self.seed = seed
        self.start_step = start_step
        self.device = device
        self.rank, self.world = rank, world

    def sample(self, generator, n):
        return self.make(generator, n)


class DeviceResidentBatches(InStepBatches):
    """The whole store on the device (``data.device.DeviceDataset``);
    ``limit`` restricts sampling to the first ``limit`` frames or pairs,
    the tail being the held-out scoring slice (:func:`scoring_holdout`)."""

    _key_salt = 3

    def __init__(self, ds: DeviceDataset, batch: int, pair_mode: str,
                 seed: int, start_step: int, limit: Optional[int] = None,
                 rank: int = 0, world: int = 1):
        self.ds = ds
        self.batch = batch
        self.pair_mode = pair_mode
        self.seed = seed
        self.start_step = start_step
        self.limit = limit
        self.device = ds.frames.device
        self.rank, self.world = rank, world

    def sample(self, generator, n):
        if self.pair_mode == "temporal":
            return sample_pair_frames(self.ds.frames, self.ds.pairs,
                                      generator, n, limit=self.limit)
        return sample_frames(self.ds.frames, generator, n, limit=self.limit)


def scoring_rows(cfg: Config) -> int:
    """Rows in the fixed best-checkpoint scoring pair."""
    return min(8, cfg.train.batch_size)


def scoring_holdout(cfg: Config, n_items: int) -> int:
    """How many tail items (frames in warp mode, pairs in temporal mode) a
    store reserves as held-out data: the best-checkpoint scoring pair is
    data training never sees, and store-backed eval scores the same tail,
    so the reserve is sized for an eval batch (up to 64 rows, at most a
    quarter of the store). Synthetic generators need none (a fresh draw is
    unseen data); a store whose reserve would be under the scoring rows
    reserves nothing, and scoring then falls back to trained rows."""
    reserve = min(64, n_items // 4)
    return reserve if reserve >= scoring_rows(cfg) else 0


def heldout_scoring_pair(cfg: Config, device: torch.device | str = "cuda"):
    """→ the fixed (src, tgt) scoring pair from the store's held-out tail on
    ``device``, or None (synthetic datasets, no store, or a store too small
    to reserve a tail).

    The last :func:`scoring_rows` items of the tail: temporal mode scores
    stored pairs; warp mode makes one pair of the tail frames with a
    generator seeded from ``train.seed + 9``.
    """
    d = cfg.data
    if d.dataset in SYNTHETIC_DATASETS:
        return None
    sp = store_path_for(d)
    if not os.path.exists(sp):
        return None
    store = FrameStore(sp)
    temporal = d.pair_mode == "temporal" and store.pairs is not None
    n_items = len(store.pairs) if temporal else len(store.frames)
    if not scoring_holdout(cfg, n_items):
        return None
    a, b, _ = tail_pair_frames(store, d.pair_mode, scoring_rows(cfg), device)
    if temporal:
        return a, b
    gen = torch.Generator(device=device).manual_seed(cfg.train.seed + 9)
    return make_pair(gen, a, warp_config(cfg))


#: exit code a trainer child uses to signal "init never discovered all
#: objects — reroll the seed" to the --reroll-on-plateau supervisor
#: (distinct from crash codes so a real crash is never retried as a reroll)
EXIT_DISCOVERY_FAILURE = 23


class DiscoveryFailure(RuntimeError):
    """Raised at eval cadence when keypoint_spread stays below the preset's
    pinned threshold past spread_check_step and train.abort_on_plateau is
    set."""

    def __init__(self, step: int, spread: float, threshold: float):
        super().__init__(
            f"discovery failure at step {step}: keypoint_spread "
            f"{spread:.3f} < {threshold} (quality.json: failed inits sit "
            f"at ~0.46 vs 0.88+ healthy)")
        self.step, self.spread = step, spread


class BestTracker:
    """Best-by-eval-loss checkpoint beside the latest ones, in its own
    one-slot manager, saved only when ``eval_loss`` improves.

    ``best.json`` is replaced atomically before the checkpoint is written
    and carries the previous entry, so a crash between the two reconciles
    at restart: the step the manager retained is matched against the
    current or the previous entry, and a later, worse value can never evict
    a strictly better checkpoint. Saves are synchronous. Under a process
    group every rank keeps the best, and rank 0 alone writes.
    """

    def __init__(self, directory: str, preset: str = ""):
        self.dir = directory
        self.preset = preset
        self._mgr = None
        self.best, self.step = float("inf"), None
        meta = os.path.join(directory, "best.json")
        if os.path.exists(meta):
            with open(meta) as f:
                m = json.load(f)
            self._mgr = ckpt.make_manager(directory, max_to_keep=1)
            saved = self._mgr.latest_step()
            for entry in (m, m.get("previous")):
                if entry is not None and entry["step"] == saved:
                    self.best = float(entry["eval_loss"])
                    self.step = int(entry["step"])
                    break

    def update(self, step: int, eval_loss: float, state: TrainState,
               extra: Optional[dict] = None) -> bool:
        if not eval_loss < self.best:       # NaN also fails: never "best"
            return False
        prev = ({"step": self.step, "eval_loss": self.best}
                if self.step is not None else None)
        self.best, self.step = eval_loss, step
        if not multihost.is_primary():
            return True
        if self._mgr is None:               # lazy: only runs that improve pay
            self._mgr = ckpt.make_manager(self.dir, max_to_keep=1)
        # ``extra`` carries the scoring pair's provenance: held_out=False
        # marks the fallback to trained rows
        meta = {"step": step, "eval_loss": eval_loss, "previous": prev,
                **(extra or {})}
        tmp = os.path.join(self.dir, "best.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self.dir, "best.json"))
        ckpt.save(self._mgr, step, state, self.preset)
        return True

    def finish(self) -> None:
        """Wait for any pending save (none: saves are synchronous)."""
        if self._mgr is not None:
            self._mgr.wait_until_finished()


def _crash_hint(step: int, last_saved, cfg: Config) -> str:
    """Operator-facing recovery message when the device runtime dies."""
    t = cfg.train
    where = (f"Latest checkpoint is step {last_saved} in "
             f"{t.checkpoint_dir}/{cfg.name} — relaunch the same command "
             f"to resume from it." if last_saved is not None
             else f"No checkpoint has been written yet (first save at step "
                  f"{t.checkpoint_every}) — a relaunch restarts from step 0.")
    return f"device runtime failed near step {step}. {where}"


def _is_device_fault(e: RuntimeError) -> bool:
    """A CUDA runtime error (torch's ``CUDA error`` text) or a failed launch
    of one of the package's kernels (``kernels._build.launch``)."""
    msg = str(e)
    return "CUDA error" in msg or "kernel launch failed" in msg


def make_loss(cfg: Config, device: torch.device | str = "cuda"
              ) -> Optional[Callable]:
    """The reconstruction loss of ``cfg`` for ``make_train_step(cfg,
    loss=...)``: the VGG perceptual loss on ``train.perceptual_layers`` when
    ``train.loss`` is "perceptual", with the trunk on ``device`` computing
    in bf16 when ``train.compute_dtype`` is bfloat16 (the taps and the sum
    stay float32); ``None`` (the L2 default) otherwise.

    The trunk's weights come from ``train.vgg_ckpt``, else from
    ``{data.data_dir}/vgg16.pth`` when that file exists (a torchvision
    ``vgg16`` state dict saved with ``torch.save``), else from the fixed
    seeded init (``models.vgg``).
    """
    if cfg.train.loss != "perceptual":
        return None
    dtype = (torch.bfloat16 if cfg.train.compute_dtype == "bfloat16"
             else None)
    ckpt_path = cfg.train.vgg_ckpt or None
    if ckpt_path is None:
        default = os.path.join(cfg.data.data_dir, "vgg16.pth")
        if os.path.exists(default):
            ckpt_path = default
    if ckpt_path:
        print(f"perceptual loss: VGG weights from {ckpt_path}", flush=True)
    layers = tuple(cfg.train.perceptual_layers)
    return make_perceptual_loss(
        make_feature_fn(layers, ckpt_path, dtype, device), layers)


def train(cfg: Config, logdir: str | None = None, dry_run: bool = False,
          device: torch.device | str = "cuda") -> TrainState:
    """Run the training loop on ``device``; → the final TrainState.

    ``dry_run`` stops after setup (config resolved, data source built) and
    prints what the run would do; it writes no checkpoint and no log.
    Ctrl-C saves a checkpoint at the interrupted step before re-raising,
    so relaunching the same command resumes the exact trajectory.
    """
    device = require_device(device, "train")
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    if device.type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    try:
        return _train(cfg, logdir, dry_run, device)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def _train(cfg: Config, logdir: str | None, dry_run: bool,
           device: torch.device) -> TrainState:
    t = cfg.train
    rank, world = multihost.host_shard()
    dp = world > 1
    if dp:
        if not t.data_parallel:
            raise ValueError(f"{world} ranks with train.data_parallel off: "
                             f"each would train alone into the same "
                             f"checkpoints; launch one process")
        if t.batch_size % world:
            raise ValueError(f"data_parallel off: batch {t.batch_size} not "
                             f"divisible by {world} processes")
        if device.type == "cuda" and device.index is None:
            device = multihost.rank_device()
    primary = multihost.is_primary()
    tag = f"[rank {rank}/{world}] " if dp else ""
    loss = make_loss(cfg, device)
    state = init_state(cfg, device)
    model = state.model

    extract = make_extract_fn(model)
    # a dry run must not touch disk: no tracker or manager directories
    best = (BestTracker(f"{t.checkpoint_dir}/{cfg.name}_best", cfg.name)
            if t.save_best and not dry_run else None)
    recon_loss = loss or l2_loss

    def eval_loss_fn(src, tgt):
        with torch.no_grad():
            return recon_loss(model(src, tgt)[0], tgt)

    start, mgr = None, None
    if not dry_run:
        mgr = ckpt.make_manager(f"{t.checkpoint_dir}/{cfg.name}",
                                t.max_to_keep)
        start, state = ckpt.restore_latest(mgr, state)
    if dp:
        # ``replicate`` needs one optimizer-state layout on every rank, and
        # the batch sources one start: every rank resumes the same step
        lo, hi = multihost.min_max(-1 if start is None else start)
        if lo != hi:
            raise RuntimeError(
                f"rank {rank} restored step {start}; the ranks restored "
                f"steps {lo} to {hi} (-1: none): every rank must read the "
                f"same train.checkpoint_dir")
    if start is not None and primary:
        print(f"resumed from step {start}", flush=True)

    log = Logger(logdir if primary and not dry_run else None)
    batches = make_batch_iterator(cfg, start_step=state.step, device=device)
    in_step = isinstance(batches, InStepBatches)
    step_fn = (make_train_step(cfg, loss=loss, group=dist.group.WORLD)
               if dp else make_train_step(cfg, loss=loss))

    if dry_run:
        print(f"{tag}dry run: preset {cfg.name!r}, {t.steps} steps of batch "
              f"{t.batch_size}, source {type(batches).__name__}"
              f"{' (in-step sampling)' if in_step else ''}, one step a "
              f"dispatch, dp={dp} ({world} rank(s)), on {device}",
              flush=True)
        if primary:
            print(json.dumps(dataclasses.asdict(cfg), default=str,
                             indent=2), flush=True)
        log.close()
        return state
    if dp:
        dp_mod.replicate(state.model, state.optimizer)

    batch_iter = None if in_step else iter(batches)
    eval_batch = None
    eval_pair, eval_pair_info = None, None
    step = state.step
    last_t, last_step = time.time(), step
    last_saved = start                      # step of the newest checkpoint
    mid_step = False                        # a step is being taken

    def _train_loop():
        nonlocal state, step, last_t, last_step, last_saved, mid_step
        nonlocal eval_batch, eval_pair, eval_pair_info
        while step < t.steps:
            mid_step = True
            try:
                batch = (batches.sample_at(step) if in_step
                         else next(batch_iter))
                if eval_batch is None and not in_step:
                    # every rank scores the same rows: rank 0's
                    eval_batch = (dp_mod.broadcast_rows(batch, 8) if dp
                                  else batch)
                state, metrics = step_fn(state, batch)
            except RuntimeError as e:
                if _is_device_fault(e):
                    raise RuntimeError(
                        _crash_hint(step, last_saved, cfg)) from e
                raise
            step = state.step
            mid_step = False
            _maybe_inject_fault(step)

            if step % t.log_every == 0:
                lv = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                now = time.time()
                fps = (step - last_step) * t.batch_size / max(now - last_t,
                                                              1e-9)
                last_t, last_step = now, step
                if not (math.isfinite(lv) and math.isfinite(gn)):
                    raise FloatingPointError(
                        f"training diverged at step {step}: loss={lv} "
                        f"grad={gn}; restart from the last checkpoint with a "
                        f"lower lr")
                print(f"{tag}step {step:6d} loss {lv:.5f} grad {gn:.3f} "
                      f"frames/s {fps:.0f}", flush=True)
                log.scalars(step, loss=lv, grad_norm=gn, frames_per_sec=fps)

            if step % t.eval_every == 0:
                if in_step and eval_batch is None:
                    # only the viz rows, drawn once
                    eval_batch = batches.sample(batches.generator(step),
                                                min(8, t.batch_size))
                imgs = (eval_batch[1] if isinstance(eval_batch, tuple)
                        else eval_batch)[:8]
                kp_np = extract(imgs).float().cpu().numpy()
                # eval.keypoint_metrics' spread: the min_spread thresholds
                # were calibrated against it
                spread = keypoint_metrics(kp_np)["keypoint_spread"]
                log.scalars(step, keypoint_spread=spread)
                if (t.min_spread and step >= t.spread_check_step
                        and spread < t.min_spread):
                    print(f"{tag}step {step:6d} DISCOVERY FAILURE SUSPECTED: "
                          f"keypoint_spread {spread:.3f} < {t.min_spread} "
                          f"past step {t.spread_check_step} — some objects "
                          f"were likely never discovered; rerolling the "
                          f"init seed is the measured fix (python -m "
                          f"keypoints_tpu_torch.train --reroll-on-plateau N "
                          f"automates it)", flush=True)
                    log.scalars(step, discovery_failure=1.0)
                    if t.abort_on_plateau:
                        raise DiscoveryFailure(step, spread, t.min_spread)
                if log.active:
                    imgs_np = imgs.float().cpu().numpy()
                    log.images(step, "keypoints",
                               image_grid(overlay_keypoints(imgs_np, kp_np)))
                    # target | reconstruction, side by side
                    src = (eval_batch[0][:8] if isinstance(eval_batch, tuple)
                           else imgs)
                    with torch.no_grad():
                        recon, _ = model(src, imgs)
                    log.images(step, "recon", image_grid(side_by_side(
                        to_hwc(imgs_np), to_hwc(recon.float().cpu().numpy()))))
                if best is not None:
                    if eval_pair is None:
                        # a fixed pair of data training never sees: the
                        # store's held-out tail, or a synthetic draw on its
                        # own seed; only a store too small to reserve a
                        # tail falls back to trained rows
                        eval_pair = heldout_scoring_pair(cfg, device)
                        if eval_pair is not None:
                            eval_pair_info = {"held_out": True,
                                              "scoring": "store_tail"}
                    if eval_pair is None:
                        synth_src = (cfg.data.dataset in SYNTHETIC_DATASETS
                                     or not os.path.exists(
                                         store_path_for(cfg.data)))
                        eval_pair_info = (
                            {"held_out": True, "scoring": "synthetic_draw"}
                            if in_step and synth_src else
                            {"held_out": False,
                             "scoring": ("store_insample" if in_step
                                         else "seen_batch")})
                        held = (batches.sample(
                                    torch.Generator(device=device)
                                    .manual_seed(t.seed + 101),
                                    min(8, t.batch_size))
                                if in_step else eval_batch)
                        if isinstance(held, tuple):
                            eval_pair = (held[0][:8], held[1][:8])
                        elif cfg.data.pair_mode == "warp":
                            eval_pair = make_pair(
                                torch.Generator(device=device)
                                .manual_seed(t.seed + 9),
                                held[:8], warp_config(cfg))
                        else:
                            eval_pair = (held[:8], held[:8])
                    el = float(eval_loss_fn(*eval_pair))
                    log.scalars(step, eval_loss=el)
                    if best.update(step, el, state,
                                   extra={**eval_pair_info,
                                          "rows": int(eval_pair[0].shape[0])}):
                        if primary:
                            print(f"step {step:6d} new best eval_loss "
                                  f"{el:.5f} -> {best.dir}", flush=True)

            if step % t.checkpoint_every == 0:
                ckpt.save(mgr, step, state, cfg.name)   # rank 0 writes
                multihost.barrier()
                last_saved = step

    try:
        _train_loop()
    except KeyboardInterrupt:
        # save at the interrupted step so relaunching resumes the exact
        # trajectory; not when a step was in flight (its update may be
        # half applied), and not a step already saved (the interrupt may
        # land between a save and the rebinding of last_saved)
        newest = max(last_saved or 0, mgr.latest_step() or 0)
        if not mid_step and step > newest:
            ckpt.save(mgr, step, state, cfg.name)
            if primary:
                print(f"\ninterrupted at step {step}: checkpoint saved to "
                      f"{t.checkpoint_dir}/{cfg.name}; rerun the same "
                      f"command to resume", flush=True)
        raise
    finally:
        # one shutdown path for normal exit, Ctrl-C and crashes
        mgr.wait_until_finished()
        if best is not None:
            best.finish()
        log.close()
    return state


def _supervise(child_argv: list[str], max_restarts: int) -> int:
    """Run the trainer in a subprocess and relaunch it on a crash (non-zero
    exit), each relaunch resuming from the newest checkpoint: a process
    whose CUDA context died cannot recover in place.

    → the final exit code (0 on success). A KeyboardInterrupt is forwarded
    to the child so it writes its interrupt checkpoint, and is not a crash;
    a discovery failure is passed through, not retried."""
    import signal
    import subprocess

    cmd = [sys.executable, "-m", "keypoints_tpu_torch.train", *child_argv]
    restarts = 0
    while True:
        # new session: a terminal Ctrl-C hits only the supervisor, which
        # forwards it once
        proc = subprocess.Popen(cmd, start_new_session=True)
        try:
            code = proc.wait()
        except KeyboardInterrupt:
            proc.send_signal(signal.SIGINT)
            return proc.wait()
        if code == 0:
            return 0
        if code == EXIT_DISCOVERY_FAILURE:
            # the child quarantined its checkpoints: resuming would re-train
            # the same seed to the same plateau
            print("supervisor: discovery failure (not a crash) — not "
                  "restarting; use --reroll-on-plateau to retry with a new "
                  "seed", flush=True)
            return code
        if restarts >= max_restarts:
            print(f"supervisor: giving up after {restarts} restart(s) "
                  f"(exit code {code})", flush=True)
            return code
        restarts += 1
        print(f"supervisor: trainer exited with code {code}; restart "
              f"{restarts}/{max_restarts} resumes from the latest "
              f"checkpoint", flush=True)


def _reroll_supervise(child_argv: list[str], max_rerolls: int,
                      base_offset: int = 0) -> int:
    """Run the trainer in a child with discovery-failure abort on; when it
    exits with EXIT_DISCOVERY_FAILURE, relaunch it with the next seed
    (``--seed-offset``), up to ``max_rerolls`` times. Any other exit code
    passes through. Attempts run at ``base_offset``, ``base_offset + 1``,
    ... (the user's own ``--seed-offset``, stripped from ``child_argv`` by
    the caller)."""
    import signal
    import subprocess

    for attempt in range(max_rerolls + 1):
        cmd = [sys.executable, "-m", "keypoints_tpu_torch.train",
               *child_argv, "--abort-on-plateau",
               "--seed-offset", str(base_offset + attempt)]
        proc = subprocess.Popen(cmd, start_new_session=True)
        try:
            code = proc.wait()
        except KeyboardInterrupt:
            proc.send_signal(signal.SIGINT)
            return proc.wait()
        if code != EXIT_DISCOVERY_FAILURE:
            return code
        if attempt < max_rerolls:
            print(f"reroll supervisor: discovery failure — retrying with "
                  f"seed offset {base_offset + attempt + 1} "
                  f"({attempt + 1}/{max_rerolls})", flush=True)
    print(f"reroll supervisor: still failing after {max_rerolls} "
          f"reroll(s)", flush=True)
    return EXIT_DISCOVERY_FAILURE


def _strip_flag(argv: list[str], flag: str) -> list[str]:
    """Remove ``flag value`` / ``flag=value`` pairs from an argv list."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == flag:
            skip = True
        elif not a.startswith(flag + "="):
            out.append(a)
    return out


#: env hook for fault-injection tests: ``"STEP:MARKER_PATH"`` raises a
#: RuntimeError the first time the loop passes STEP, creating MARKER_PATH
#: so the fault fires exactly once
FAULT_ENV = "KEYPOINTS_TPU_TORCH_FAULT"


def _maybe_inject_fault(step: int) -> None:
    spec = os.environ.get(FAULT_ENV)
    if not spec:
        return
    at, _, marker = spec.partition(":")
    if marker and step >= int(at) and not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError(
            f"injected fault at step {step} ({FAULT_ENV}={spec})")


def main(argv=None):
    # allow_abbrev=False: an abbreviated `--super 2` would parse as
    # --supervise but survive _strip_flag in the child argv, and every
    # child would become another supervisor
    p = argparse.ArgumentParser(
        description="keypoints trainer (the PyTorch port)", allow_abbrev=False)
    p.add_argument("--preset", default="pong64")
    p.add_argument("--override", nargs="*", default=[],
                   help="dotted overrides, e.g. train.lr=3e-4")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--logdir", default=None)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="train the first 20 steps under torch.profiler and "
                        "write DIR/trace.json")
    p.add_argument("--dry-run", action="store_true",
                   help="resolve the config, build the data source, print, "
                        "and exit — no training")
    p.add_argument("--supervise", type=int, default=None, metavar="N",
                   help="run the trainer in a supervised subprocess; on a "
                        "crash, relaunch up to N times, each resuming from "
                        "the latest checkpoint")
    p.add_argument("--reroll-on-plateau", type=int, default=None,
                   metavar="N",
                   help="run the trainer in a subprocess with discovery-"
                        "failure abort enabled (train.min_spread must be "
                        "set — pong64 pins it); on a detected failure, "
                        "retry with the next seed up to N times")
    p.add_argument("--abort-on-plateau", action="store_true",
                   help="exit with the reroll code when discovery failure "
                        "is detected (sets train.abort_on_plateau; the "
                        "--reroll-on-plateau supervisor passes this)")
    p.add_argument("--seed-offset", type=int, default=0,
                   help="add this to train.seed after overrides (reroll "
                        "attempts use 1, 2, ...)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on; only an explicit "
                        "--device cpu trains on the CPU")
    args = p.parse_args(argv)
    if args.dry_run and args.profile:
        p.error("--dry-run and --profile are mutually exclusive "
                "(a dry run takes no step a trace would record)")
    if args.supervise is not None:
        if args.dry_run or args.profile or args.reroll_on_plateau is not None:
            p.error("--supervise cannot be combined with "
                    "--dry-run/--profile/--reroll-on-plateau")
        raw = list(argv) if argv is not None else list(sys.argv[1:])
        raise SystemExit(_supervise(_strip_flag(raw, "--supervise"),
                                    args.supervise))
    if args.reroll_on_plateau is not None:
        if args.dry_run or args.profile:
            p.error("--reroll-on-plateau cannot be combined with "
                    "--dry-run/--profile")
        raw = list(argv) if argv is not None else list(sys.argv[1:])
        raise SystemExit(_reroll_supervise(
            _strip_flag(_strip_flag(raw, "--reroll-on-plateau"),
                        "--seed-offset"),
            args.reroll_on_plateau, base_offset=args.seed_offset))
    # join torchrun's process group, if any, before the first card access
    multihost.initialize("gloo" if torch.device(args.device).type == "cpu"
                         else None)

    cfg = apply_overrides(get_config(args.preset), args.override)
    if args.steps is not None:
        cfg = cfg.override(**{"train.steps": args.steps})
    if args.seed_offset:
        cfg = cfg.override(**{"train.seed": cfg.train.seed + args.seed_offset})
    if args.abort_on_plateau:
        if not cfg.train.min_spread:
            p.error("--abort-on-plateau needs train.min_spread (preset-"
                    "pinned on pong64; pass --override train.min_spread=X "
                    "elsewhere — thresholds do NOT transfer across presets)")
        cfg = cfg.override(**{"train.abort_on_plateau": True})
    if args.dry_run:
        train(cfg, args.logdir, dry_run=True, device=args.device)
    elif args.profile:
        from torch.profiler import ProfilerActivity, profile
        device = require_device(args.device, "train")
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            train(cfg.override(**{"train.steps": min(cfg.train.steps, 20)}),
                  args.logdir, device=device)
        if multihost.is_primary():
            os.makedirs(args.profile, exist_ok=True)
            out = os.path.join(args.profile, "trace.json")
            prof.export_chrome_trace(out)
            print(f"profile of the first 20 steps written to {out}",
                  flush=True)
    else:
        try:
            train(cfg, args.logdir, device=args.device)
        except DiscoveryFailure as e:
            # quarantine this attempt's checkpoints (non-destructively) so
            # the next seed starts fresh instead of resuming the plateaued
            # parameters, then signal the reroll supervisor
            for d in (f"{cfg.train.checkpoint_dir}/{cfg.name}",
                      f"{cfg.train.checkpoint_dir}/{cfg.name}_best"):
                if multihost.is_primary() and os.path.isdir(d):
                    dst, i = f"{d}_failed_seed{cfg.train.seed}", 1
                    while os.path.exists(dst):
                        dst = f"{d}_failed_seed{cfg.train.seed}.{i}"
                        i += 1
                    os.rename(d, dst)
            print(f"aborting: {e}", flush=True)
            raise SystemExit(EXIT_DISCOVERY_FAILURE)


if __name__ == "__main__":
    main()
