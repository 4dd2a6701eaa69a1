"""The benchmark's FLOP counts against ``FlopCounterMode`` over the
reference at b2: celeba128 at the published widths, 16.24 GFLOP a training
sample and 1.691 GFLOP an extracted image."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, spec
from portbench.reference import model as ref


def conf(name):
    with open(spec.HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def meta(shapes):
    return {k: torch.empty(s, device="meta") for k, s in shapes}


def counted_train(c, batch=2):
    m = c["model"]
    params = {k: v.requires_grad_(True)
              for k, v in meta(ref.param_shapes(m)).items()}
    size = m["image_size"]
    src = torch.rand((batch, m["channels"], size, size), device="meta")
    tgt = torch.rand((batch, m["channels"], size, size), device="meta")
    with FlopCounterMode(display=False) as counter:
        recon, _ = ref.forward(params, m, src, tgt)
        loss = ref.recon_loss(recon, tgt, c["loss"])
        torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return counter.get_total_flops() / batch


def counted_extract(c, batch=2):
    m = c["model"]
    params = meta(ref.param_shapes(m))
    size = m["image_size"]
    x = torch.rand((batch, m["channels"], size, size), device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.extract(params, m, x)
    return counter.get_total_flops() / batch


@pytest.mark.parametrize("name,gflop", [("celeba128", 16.24)])
def test_training_flops_a_sample(name, gflop):
    c = conf(name)
    assert flops.train_flops(c) == counted_train(c)
    assert flops.train_flops(c) / 1e9 == pytest.approx(gflop, rel=1e-3)


@pytest.mark.parametrize("name,gflop", [("celeba128", 1.691)])
def test_extract_flops_an_image(name, gflop):
    c = conf(name)
    assert flops.extract_flops(c["model"]) == counted_extract(c)
    assert flops.extract_flops(c["model"]) / 1e9 == pytest.approx(gflop,
                                                                  rel=1e-3)
