"""Traffic kind ``train_replay_vgg``: ``train_replay``'s replayed step under
the perceptual loss on a VGG-19 trunk drawn from the seed.

It runs its own instance of ``drivers/train_replay.py`` (``spec.driver``
builds a fresh module at each call), so the set-up, the window, the trace
and the comparison are the code that times ``celeba128.train_b128``; only
the configuration differs. Before handing over it checks the
configuration's ``perceptual`` section against the program's config, draws
the trunk (kernels normal with ``draw.variance_over_fan_in`` / fan_in,
zero biases, from ``--seed`` under ``draw.salt``), writes it as a
torchvision ``vgg19`` state dict under ``.portbench_cache/`` for the
program's ``train.vgg_ckpt``, and binds that instance's ``reference_run``
to the perceptual reference (``portbench.reference.perceptual``) on the
same trunk. The file is removed when the run ends.
"""

from __future__ import annotations

import math
import os

import torch

from portbench import spec as specs, weights
from portbench.reference import augment, perceptual

CACHE = specs.ROOT / ".portbench_cache"


def check(conf: dict, cfg) -> None:
    """Stop the run unless the program's config computes ``conf``'s loss:
    the perceptual loss at the same VGG-19 taps."""
    want = tuple(f"vgg19/{t}" for t in conf["taps"])
    got = (cfg.train.loss, tuple(cfg.train.perceptual_layers))
    if got != ("perceptual", want):
        raise SystemExit(f"the program's loss {got} does not compute the "
                         f"configuration's perceptual section {conf}")


def draw_trunk(conf: dict, seed: int, device) -> dict:
    """The trunk's parameters up to its deepest tap, torchvision names."""
    d = conf["draw"]
    p = weights.draw(perceptual.param_shapes(conf["taps"]), seed, d["salt"],
                     device)
    gain = math.sqrt(d["variance_over_fan_in"])
    return {k: v * gain if v.ndim == 4 else v for k, v in p.items()}


def run(ctx: dict) -> dict:
    base = specs.driver("train_replay")
    spec, seed, device = ctx["spec"], ctx["seed"], ctx["device"]
    conf = spec["perceptual"]
    check(conf, specs.program_config(spec, seed))
    trunk = draw_trunk(conf, seed, device)
    CACHE.mkdir(parents=True, exist_ok=True)
    path = CACHE / f"vgg19_{seed}_{os.getpid()}.pth"
    torch.save({k: v.cpu() for k, v in trunk.items()}, path)

    def reference_run(spec, traffic, seed, device, params0, rows,
                      lowp=None) -> dict:
        """``train_replay.reference_run`` with the perceptual loss."""
        model, batch = spec["model"], traffic["batch"]
        factor_dtype = (torch.bfloat16 if spec["compute_dtype"] == "bfloat16"
                        else torch.float32)
        block = max(1, traffic["reference_pixels_a_block"]
                    // model["image_size"] ** 2)
        with base.reference_precision():
            draws = [augment.draw_pair(seed, s, batch, model["channels"],
                                       spec["augment"], factor_dtype, device)
                     for s in range(len(rows))]
            images = [r.float() / 255.0 for r in rows]
            return perceptual.run_steps(params0, trunk, spec, images, draws,
                                        block, lowp)

    base.reference_run = reference_run
    overrides = dict(spec["overrides"], **{"train.vgg_ckpt": str(path)})
    try:
        return base.run(dict(ctx, spec=dict(spec, overrides=overrides)))
    finally:
        path.unlink(missing_ok=True)
