"""Typed experiment configs — one frozen dataclass, five shipped presets.

A copy of ``keypoints_tpu/configs.py``: that module imports no jax, but it can
only be reached through ``keypoints_tpu/__init__``, which does. The presets
are held equal to the JAX ones field by field (tests/test_torch_checkpoint.py).
CLI overrides: ``--preset name --override field=value``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    num_keypoints: int = 10
    out_channels: int = 3
    sigma: float = 0.1
    temperature: float = 1.0
    softmax_variant: str = "marginal"
    encoder_filters: Tuple[int, ...] = (32, 32, 64, 64, 128)
    encoder_strides: Tuple[int, ...] = (1, 2, 1, 2, 1)
    decoder_filters: Tuple[int, ...] = (128, 64, 32)
    decoder_upsample: Tuple[bool, ...] = (True, True, False)
    groups: int = 8


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic_dots"   # synthetic_dots | synthetic_pong | celeba | atari | pose
    image_size: int = 128
    channels: int = 3
    pair_mode: str = "warp"           # warp (TPS-synthesized) | temporal (stored pairs)
    data_dir: str = "data"
    loader_workers: int = 8           # host threads for bigger-than-HBM stores
    # augmentation (device-side)
    tps_scale: float = 0.05
    rotate: float = 0.1
    scale: float = 0.1
    translate: float = 0.1
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2


@dataclass(frozen=True)
class TrainConfig:
    model_kind: str = "autoencoder"   # autoencoder | transporter
    loss: str = "l2"                  # l2 | perceptual
    # bare taps are VGG-16's; "vgg19/relu3_2" and the like VGG-19's
    perceptual_layers: Tuple[str, ...] = ("relu1_2", "relu2_2", "relu3_3")
    # torch state dict (torchvision layout) of the taps' trunk; "" falls back
    # to {data.data_dir}/vgg16.pth (vgg19.pth for VGG-19 taps) when that file
    # exists, else fixed random init (offline-runnable). See models/vgg.py.
    vgg_ckpt: str = ""
    batch_size: int = 32
    # split each step's batch into this many sequential micro-batches and
    # average their gradients (exact for mean losses): trains an
    # HBM-limited config at a large effective batch for ~1/grad_accum the
    # activation memory. 1 = off.
    grad_accum: int = 1
    steps: int = 10_000
    lr: float = 1e-3
    warmup_steps: int = 100
    weight_decay: float = 0.0
    seed: int = 0
    compute_dtype: str = "bfloat16"   # hot path; parity/eval force float32
    log_every: int = 50
    eval_every: int = 500
    checkpoint_every: int = 1000
    checkpoint_dir: str = "checkpoints"
    max_to_keep: int = 3
    # also keep a best-by-eval-loss checkpoint in {checkpoint_dir}/{name}_best
    # (the reference's best/latest run-dir layout)
    save_best: bool = True
    data_parallel: bool = True        # shard batch over all visible devices
    # OPT-IN keypoint spatial-separation loss (0.0 = off, exact parity with
    # the published recipes). Squared hinge below diversity_margin on
    # per-example pairwise keypoint distances — targets the measured
    # partial-discovery failure mode (training.make_loss_fn docstring,
    # BASELINE.md round-4 multi-seed study).
    keypoint_diversity: float = 0.0
    # margin measured on the pong64 failing init (BASELINE.md r4 A/B):
    # 0.2 only mitigates (0.56→0.38); 0.5 fixes it (0.098) at unchanged
    # eval loss; 0.8 also works but drags pck. 0.5 is the shipped default.
    diversity_margin: float = 0.5
    # anneal the diversity term linearly to zero at this step (0 = constant).
    # A constant separation force displaces otherwise-locked keypoints
    # (measured, BASELINE.md r4 A/B); full strength early destabilizes
    # collapsed basins, zero late restores the pure published objective.
    diversity_steps: int = 0
    # Discovery-failure detection (VERDICT r4 #4). The r4 3-seed study
    # (benchmarks/quality.json) found a ~1-in-3 pong64 init that never
    # discovers all objects: its keypoint_spread is 0.46 vs 0.88-0.95 on
    # healthy siblings, a gap that opens long before locking converges.
    # At eval cadence past spread_check_step, spread < min_spread logs a
    # discovery-failure warning (stdout + metrics.jsonl); with
    # abort_on_plateau the run exits with the reroll code so the
    # `--reroll-on-plateau` supervisor retries with the next seed.
    # 0.0 = detection off. The threshold MUST be preset-pinned: pose256's
    # healthy runs lock fine at spread 0.37 (quality.json pose256_s1) —
    # a global threshold would false-positive there.
    min_spread: float = 0.0
    spread_check_step: int = 2000
    abort_on_plateau: bool = False


def _coerce(val, current):
    """Cast an override value to the field's current type, safely.

    Strings targeting tuple fields go through ``ast.literal_eval`` — a bare
    ``tuple("(1,2)")`` would silently yield a tuple of characters.
    """
    cur_t = type(current)
    if current is None or isinstance(val, cur_t):
        return val
    if cur_t is tuple:
        if isinstance(val, str):
            import ast
            val = ast.literal_eval(val)
        if not isinstance(val, (tuple, list)):
            raise TypeError(
                f"cannot coerce {val!r} to tuple for config override")
        return tuple(val)
    if cur_t is bool and isinstance(val, str):
        low = val.lower()
        if low in ("true", "1"):
            return True
        if low in ("false", "0"):
            return False
        raise TypeError(f"cannot coerce {val!r} to bool")
    return cur_t(val)


@dataclass(frozen=True)
class Config:
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def override(self, **kv) -> "Config":
        """Dotted-path overrides: cfg.override(**{"train.lr": 3e-4})."""
        out = self
        for key, val in kv.items():
            parts = key.split(".")
            if len(parts) == 1:
                out = replace(out, **{key: val})
                continue
            section = getattr(out, parts[0])
            section = replace(section, **{
                parts[1]: _coerce(val, getattr(section, parts[1]))})
            out = replace(out, **{parts[0]: section})
        return out


def apply_overrides(cfg: Config, items) -> Config:
    """Apply CLI ``--override field=value`` strings — the ONE parser shared
    by every CLI entry point (train/eval/export). Values that parse as
    Python literals (ints, floats, tuples) are evaluated; anything else
    stays a string and is coerced per-field by ``Config.override``."""
    import ast
    for item in items:
        key, val = item.split("=", 1)
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass  # keep string
        cfg = cfg.override(**{key: val})
    return cfg


# --- The five BASELINE presets [B:6–12] -------------------------------------

PRESETS: dict[str, Config] = {}


def _register(cfg: Config) -> Config:
    PRESETS[cfg.name] = cfg
    return cfg


# [B:7] Pong 64×64 grayscale, 4-keypoint encoder-decoder — the PR1 ref.
pong64 = _register(Config(
    name="pong64",
    model=ModelConfig(num_keypoints=4, out_channels=1, sigma=0.1),
    data=DataConfig(dataset="synthetic_pong", image_size=64, channels=1,
                    pair_mode="temporal"),
    # min_spread 0.65: midpoint of the measured failure/healthy separation
    # (0.46 vs 0.88/0.95, benchmarks/quality.json; early-step separation
    # verified on-chip at spread_check_step — BASELINE.md r5 reroll study;
    # only pong64 has a DEMONSTRATED failure mode, so only it ships a
    # pinned threshold).
    train=TrainConfig(model_kind="autoencoder", batch_size=64, lr=1e-3,
                      min_spread=0.65),
))

# [B:8] CelebA 128×128 faces, 10 keypoints, Gaussian-heatmap reconstruction.
celeba128 = _register(Config(
    name="celeba128",
    model=ModelConfig(num_keypoints=10, out_channels=3, sigma=0.1),
    data=DataConfig(dataset="celeba", image_size=128, channels=3,
                    pair_mode="warp"),
    train=TrainConfig(model_kind="autoencoder", batch_size=32, lr=1e-3),
))

# [B:9] Transporter-style paired-frame Atari with TPS warp augmentation.
transporter_atari = _register(Config(
    name="transporter_atari",
    model=ModelConfig(num_keypoints=4, out_channels=1, sigma=0.1),
    data=DataConfig(dataset="atari", image_size=64, channels=1,
                    pair_mode="temporal"),
    train=TrainConfig(model_kind="transporter", batch_size=64, lr=1e-3),
))

# [B:10] 256×256 human-pose frames, 16 keypoints, perceptual loss.
pose256 = _register(Config(
    name="pose256",
    model=ModelConfig(num_keypoints=16, out_channels=3, sigma=0.05,
                      encoder_filters=(32, 32, 64, 64, 128, 128),
                      encoder_strides=(1, 2, 1, 2, 1, 2),
                      decoder_filters=(128, 128, 64, 32),
                      decoder_upsample=(True, True, True, False)),
    data=DataConfig(dataset="pose", image_size=256, channels=3,
                    pair_mode="warp"),
    # b128 validated round 3 (batch sweep benchmarks/bench_pose_remat.py):
    # XLA buffer reuse keeps the step peak sublinear in batch (b64 9.72 GiB,
    # b128 11.89, b256 14.38 of 16) and b128 is the throughput optimum —
    # 672 fps full loop (preflight 12.15 GiB step + 0.51 eval) vs 460 at b64
    # and 609 at b256. Joint locking measured in the b64 band: 0.071 @2k
    # steps (b64: 0.041 @2k / 0.061 @6k; run variance spans that band —
    # see BASELINE.md for the showcase records).
    # The r2 worker-kill was root-caused to LONG SINGLE DISPATCHES (a ~70 s
    # scan chunk trips the worker's execution deadline), fixed by train()'s
    # chunk cap; total HBM is preflighted before the first step.
    train=TrainConfig(model_kind="autoencoder", loss="perceptual",
                      batch_size=128, lr=1e-3),
))

# [B:11] Data-parallel run, fully device-side decode/augment/prefetch.
dp_celeba = _register(replace(
    celeba128, name="dp_celeba",
    train=replace(celeba128.train, batch_size=256, data_parallel=True),
))


def get_config(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
