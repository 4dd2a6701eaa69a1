"""Training core and the extraction path — port of ``keypoints_tpu/training.py``.

``build_model`` (``training.py:41``), ``make_optimizer`` (``:56``) with the
warmup-cosine schedule, ``init_state`` (``:66``), ``warp_config`` (``:77``),
``make_loss_fn`` (``:84``), ``make_train_step`` (``:131``) and
``make_extract_fn`` (``:218``).

Parameters are float32; ``cfg.train.compute_dtype`` is the dtype the convs
compute in (bf16 on the hot path: GroupNorm statistics stay float32, the
heatmaps reach the soft-argmax as float32, the reconstruction comes back as
float32), as flax's ``dtype=`` does. :func:`freeze_for_inference` casts the
conv weights to the compute dtype once, for serving.

PyTorch is eager, so the train step is a Python function: augmentation (in
warp mode) → Φ/Ψ → soft-argmax → raster → decoder → L2 → backward → Adam,
each on the device of the batch. The step's metrics stay on the device; the
step never waits for it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from keypoints_tpu_torch.configs import Config
from keypoints_tpu_torch.data.augment import (PairDraws, WarpConfig,
                                              draw_pair, pair_from_draws)
from keypoints_tpu_torch.losses import l2_loss
from keypoints_tpu_torch.models import KeypointAutoencoder
from keypoints_tpu_torch.models.nets import Conv2d, init_flax_defaults

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(cfg: Config, device: torch.device | str = "cuda",
                seed: int = 0) -> KeypointAutoencoder:
    """The autoencoder of ``cfg`` (Φ, Ψ and the decoder) on ``device``, with
    float32 parameters drawn from ``seed`` and convs computing in
    ``cfg.train.compute_dtype``."""
    if cfg.train.model_kind != "autoencoder":
        raise NotImplementedError(
            f"model_kind {cfg.train.model_kind!r} is not ported yet")
    m = cfg.model
    with torch.device("meta"):
        model = KeypointAutoencoder(
            num_keypoints=m.num_keypoints, in_channels=cfg.data.channels,
            out_channels=m.out_channels, sigma=m.sigma,
            temperature=m.temperature, softmax_variant=m.softmax_variant,
            encoder_filters=m.encoder_filters,
            encoder_strides=m.encoder_strides,
            decoder_filters=m.decoder_filters,
            decoder_upsample=m.decoder_upsample, groups=m.groups,
            dtype=COMPUTE_DTYPES[cfg.train.compute_dtype])
    model.to_empty(device="cpu")
    init_flax_defaults(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def freeze_for_inference(model: nn.Module) -> nn.Module:
    """Serving: cast every conv's parameters to its compute dtype once (the
    per-call casts then launch nothing), stop gradients, eval mode."""
    for mod in model.modules():
        if isinstance(mod, Conv2d):
            mod.to(mod.compute_dtype)
    return model.eval().requires_grad_(False)


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` as a plain function of the
    update count: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine down to ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)
    return schedule


def make_schedule(cfg: Config) -> Callable[[int], float]:
    """The learning rate of each update, as a function of the count of
    updates before it (so the first update's rate is 0)."""
    t = cfg.train
    return warmup_cosine_decay(0.0, t.lr, t.warmup_steps,
                               max(t.steps, t.warmup_steps + 1), t.lr * 0.1)


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """``optax.adam`` (``adamw`` when ``train.weight_decay > 0``): b1 0.9,
    b2 0.999, eps 1e-8. The train step sets the rate before each update
    from :func:`make_schedule`."""
    t = cfg.train
    if t.weight_decay > 0:
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=t.weight_decay)
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)


@dataclass
class TrainState:
    """The model (float32 parameters), its optimizer and the count of
    updates taken. The step's random draws are a function of
    ``cfg.train.seed`` and this count (:func:`step_generator`), as JAX folds
    the step into its key."""
    model: KeypointAutoencoder
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_state(cfg: Config, device: torch.device | str = "cuda"
               ) -> TrainState:
    model = build_model(cfg, device, seed=cfg.train.seed)
    return TrainState(model, make_optimizer(cfg, model.parameters()))


def warp_config(cfg: Config) -> WarpConfig:
    d = cfg.data
    return WarpConfig(tps_scale=d.tps_scale, rotate=d.rotate, scale=d.scale,
                      translate=d.translate, brightness=d.brightness,
                      contrast=d.contrast, saturation=d.saturation)


def step_generator(seed: int, step: int,
                   device: torch.device | str) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step) alone."""
    words = np.random.SeedSequence([seed, step]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        (int(words[0]) << 31) ^ int(words[1]))


def make_loss_fn(cfg: Config, loss: Optional[Callable] = None) -> Callable:
    """→ fn(model, src, tgt, lam_scale=1.0) -> (loss, aux dict); L2 by default.

    ``train.keypoint_diversity`` > 0 adds the opt-in separation term of the
    JAX package: a squared hinge on per-example pairwise keypoint distances,
    mean(relu(margin - d_ij)^2) over the K(K-1)/2 pairs, scaled by
    ``lam_scale`` (the anneal).
    """
    recon_loss = loss or l2_loss
    lam = cfg.train.keypoint_diversity
    margin = cfg.train.diversity_margin

    def loss_fn(model, src, tgt, lam_scale=1.0):
        recon, kp = model(src, tgt)
        value = recon_loss(recon, tgt)
        aux = {"loss": value, "keypoints": kp, "recon": recon}
        if lam > 0.0:
            d = torch.linalg.vector_norm(kp[:, :, None] - kp[:, None] + 1e-12,
                                         dim=-1)
            k = kp.shape[1]
            mask = torch.triu(torch.ones((k, k), dtype=torch.bool,
                                         device=kp.device), 1)
            hinge = torch.relu(margin - d) ** 2
            div = (torch.where(mask, hinge, torch.zeros_like(hinge)).sum()
                   / (d.shape[0] * (k * (k - 1) // 2)))
            aux["diversity"] = div
            value = value + (lam * lam_scale) * div
            aux["loss"] = value
        return value, aux
    return loss_fn


def make_train_step(cfg: Config, loss: Optional[Callable] = None) -> Callable:
    """→ step(state, batch, draws=None) -> (state, metrics).

    ``batch`` is a raw image batch (warp mode: the (src, tgt) pair is made
    on the batch's device inside the step, after the bf16 cast when the
    compute dtype is bf16) or a (src, tgt) tuple (temporal mode). In warp
    mode the draws come from :func:`step_generator` unless ``draws`` (a
    ``PairDraws``) are given. With ``train.grad_accum`` > 1 the batch is
    split into micro-batches whose gradients sum and divide, which equals
    the full-batch gradient of the mean loss. The gradients stay in the
    parameters' ``.grad`` after the step. ``metrics`` holds ``loss`` and
    ``grad_norm`` (the global L2 norm of the gradients) as device tensors.
    """
    loss_fn = make_loss_fn(cfg, loss)
    schedule = make_schedule(cfg)
    warp_mode = cfg.data.pair_mode == "warp"
    wcfg = warp_config(cfg)
    bf16_aug = cfg.train.compute_dtype == "bfloat16"
    accum = cfg.train.grad_accum
    if accum < 1:
        raise ValueError(f"train.grad_accum must be >= 1, got {accum}")
    if accum > 1 and cfg.train.batch_size % accum != 0:
        raise ValueError(
            f"train.batch_size {cfg.train.batch_size} is not divisible by "
            f"train.grad_accum {accum}")
    div_anneal = (cfg.train.keypoint_diversity > 0.0
                  and cfg.train.diversity_steps > 0)

    def step(state: TrainState, batch, draws: Optional[PairDraws] = None):
        model, opt = state.model, state.optimizer
        lam_scale = 1.0
        if div_anneal:
            lam_scale = min(max(1.0 - state.step / cfg.train.diversity_steps,
                                0.0), 1.0)
        if warp_mode:
            if bf16_aug:
                batch = batch.to(torch.bfloat16)
            if draws is None:
                gen = step_generator(cfg.train.seed, state.step, batch.device)
                draws = draw_pair(gen, tuple(batch.shape), wcfg, batch.dtype)
            src, tgt = pair_from_draws(batch, draws, wcfg)
        else:
            src, tgt = batch
        opt.zero_grad(set_to_none=True)
        if accum > 1:
            if src.shape[0] % accum != 0:
                raise ValueError(f"per-step batch {src.shape[0]} is not "
                                 f"divisible by train.grad_accum {accum}")
            value = torch.zeros((), device=src.device)
            for s, t in zip(src.chunk(accum), tgt.chunk(accum)):
                v, _ = loss_fn(model, s, t, lam_scale)
                v.backward()
                value = value + v.detach()
            value = value / accum
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
        else:
            value, _ = loss_fn(model, src, tgt, lam_scale)
            value.backward()
            value = value.detach()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grad_norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        for group in opt.param_groups:
            group["lr"] = schedule(state.step)
        opt.step()
        state.step += 1
        return state, {"loss": value, "grad_norm": grad_norm}

    return step


def make_extract_fn(model: KeypointAutoencoder) -> Callable:
    """Keypoint extraction: NCHW images in [0, 1] → (B, K, 2)."""
    def extract(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model.extract_keypoints(images)
    return extract
