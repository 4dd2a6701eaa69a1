"""The program's host spans (``utils.profiling.span``): recorded only while
a profiler runs, into the profiler's trace and into totals by name.

The CPU tests hold the helper's arithmetic, its trace events and its
thread safety, the serving front's one ``kp.extract.call`` a request, and
an eager perceptual step's ``kp.loss.perceptual`` and ``kp.loss.vgg``.
The ``cuda`` tests hold the spans inside a ``GraphedBucket`` replay and a
``GraphedTrainStep`` replay; they skip here and run on the card with
``--noconftest`` (this file imports no JAX).
"""

import copy
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from keypoints_tpu_torch.configs import apply_overrides, get_config
from keypoints_tpu_torch.export import GraphedBucket
from keypoints_tpu_torch.parallel import dp
from keypoints_tpu_torch.utils import profiling
from keypoints_tpu_torch.utils.profiling import (reset_spans, span,
                                                 span_totals)
from keypoints_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

NARROW = ["model.encoder_filters=(8,16)", "model.encoder_strides=(2,2)",
          "model.groups=4", "model.num_keypoints=4", "data.image_size=32",
          "train.compute_dtype=float32"]


@pytest.fixture(autouse=True)
def clean():
    reset_spans()
    yield
    reset_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_without_a_profiler_a_span_records_nothing_and_builds_no_annotation(
        monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a trace event built with no profiler")

    monkeypatch.setattr(profiling, "_annotation", refuse)
    with span("outer"):
        with span("inner"):
            pass
    assert span_totals() == {}


def test_nested_spans_give_calls_seconds_and_self_seconds():
    with _cpu_profile():
        for _ in range(2):
            with span("outer"):
                time.sleep(0.002)
                with span("inner"):
                    time.sleep(0.004)
    got = span_totals()
    assert set(got) == {"outer", "inner"}
    outer, inner = got["outer"], got["inner"]
    assert outer["calls"] == inner["calls"] == 2
    assert inner["seconds"] >= 0.008
    assert inner["self_seconds"] == pytest.approx(inner["seconds"])
    assert outer["self_seconds"] >= 0.004
    # the parent loses its child with the child's event, so the two
    # parts sum to at most the whole
    assert outer["self_seconds"] + inner["seconds"] <= outer["seconds"]
    assert outer["seconds"] >= 0.012


def test_spans_are_host_events_of_the_trace_with_the_child_inside_the_parent(
        tmp_path):
    with _cpu_profile() as prof:
        with span("kp.parent"):
            with span("kp.child"):
                torch.ones(8).add_(1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    found = {e["name"]: e for e in events
             if e.get("cat") in ("cpu_op", "user_annotation")
             and e["name"] in ("kp.parent", "kp.child")}
    assert set(found) == {"kp.parent", "kp.child"}
    parent, child = found["kp.parent"], found["kp.child"]
    assert parent["ts"] <= child["ts"]
    assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]


def test_reset_spans_clears_the_totals():
    with _cpu_profile():
        with span("a"):
            pass
    assert span_totals()["a"]["calls"] == 1
    reset_spans()
    assert span_totals() == {}


def test_spans_on_many_threads_lose_no_update(monkeypatch):
    """More threads than cores, switching every microsecond: every span
    is counted once and each thread's nesting stays its own. A profiler
    records the thread that started it only, so the check is forced on."""
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    threads, each = 16, 100
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with span("t.outer"):
                    with span("t.inner"):
                        pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(saved)
    got = span_totals()
    n = threads * each
    assert got["t.outer"]["calls"] == got["t.inner"]["calls"] == n
    assert got["t.outer"]["self_seconds"] < got["t.outer"]["seconds"]


def test_a_cpu_extract_records_one_call_span_a_request():
    cfg = apply_overrides(get_config("celeba128"), NARROW)
    extract = dp.make_dp_extract(cfg, None, [2, 4], ["cpu"])
    images = np.zeros((3, 3, 32, 32), np.float32)
    extract(images)                          # not profiled: nothing kept
    assert span_totals() == {}
    with _cpu_profile():
        for n in (1, 3, 4, 6):               # 6: two chunks of the bucket 4
            assert extract(np.zeros((n, 3, 32, 32), np.float32)).shape == (
                n, 4, 2)
    got = span_totals()
    assert got["kp.extract.call"]["calls"] == 4
    assert got["kp.extract.read"]["calls"] == 5
    assert "kp.extract.upload" not in got    # the CPU runs eagerly


VGG19_TAPS = ("vgg19/input", "vgg19/relu1_2", "vgg19/relu2_2",
              "vgg19/relu3_2", "vgg19/relu4_2", "vgg19/relu5_2")


def _perceptual_step(tmp_path):
    """An eager CPU train step under the VGG-19 perceptual loss (seeded
    trunk), its state and a batch."""
    from keypoints_tpu_torch.train import make_loss
    from keypoints_tpu_torch.training import init_state, make_train_step
    cfg = apply_overrides(get_config("celeba128"), NARROW).override(**{
        "train.loss": "perceptual", "train.perceptual_layers": VGG19_TAPS,
        "train.batch_size": 2, "data.data_dir": str(tmp_path)})
    state = init_state(cfg, "cpu")
    batch = torch.rand((2, 3, 32, 32), generator=torch.Generator()
                       .manual_seed(0))
    return make_train_step(cfg, loss=make_loss(cfg, "cpu")), state, batch


def test_an_eager_perceptual_step_spans_the_loss_and_each_trunk_pass(
        tmp_path):
    """One ``kp.loss.perceptual`` a step holding one ``kp.loss.vgg`` a trunk
    pass (the reconstruction's and the target's)."""
    step, state, batch = _perceptual_step(tmp_path)
    with _cpu_profile():
        step(state, batch)
    got = span_totals()
    loss, vgg = got["kp.loss.perceptual"], got["kp.loss.vgg"]
    assert loss["calls"] == 1 and vgg["calls"] == 2
    assert loss["self_seconds"] + vgg["seconds"] <= loss["seconds"]


def test_without_a_profiler_the_loss_spans_build_nothing_and_move_nothing(
        tmp_path, monkeypatch):
    """No profiler: no trace event is built, nothing is recorded, and the
    step's loss and gradients equal a profiled step's bit for bit."""
    step, state, batch = _perceptual_step(tmp_path)
    again = copy.deepcopy(state)
    with _cpu_profile():
        _, profiled = step(again, batch)
    reset_spans()

    def refuse(*args, **kwargs):
        raise AssertionError("a trace event built with no profiler")

    monkeypatch.setattr(profiling, "_annotation", refuse)
    _, plain = step(state, batch)
    assert span_totals() == {}
    assert torch.equal(plain["loss"], profiled["loss"])
    for p, q in zip(state.model.parameters(), again.model.parameters()):
        assert torch.equal(p.grad, q.grad)


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph runs only on the GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_graphed_bucket_spans_its_upload_replay_and_read(cuda):
    """The first call (eager, then the capture; profiled on the host only)
    records no upload and no replay, only the read of its answer; each
    replayed call one upload, one replay, one read."""
    bucket = GraphedBucket(lambda x: x * 2, 4, (3, 8, 8), "float32", cuda,
                           {})
    x = np.ones((4, 3, 8, 8), np.float32)
    with _cpu_profile():
        bucket(x)
    assert set(span_totals()) == {"kp.extract.read"}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            assert np.array_equal(bucket(x), 2 * x)
    got = span_totals()
    assert got["kp.extract.upload"]["calls"] == 3
    assert got["kp.extract.replay"]["calls"] == 3
    assert got["kp.extract.read"]["calls"] == 4


@pytest.mark.cuda
def test_graphed_train_step_spans_prepare_and_replay_inside_the_step(cuda):
    """The first call (eager step, then the capture; profiled on the host
    only) records no span; each replay one ``kp.train_step`` holding one
    prepare and one replay."""
    from keypoints_tpu_torch import train as train_mod
    from keypoints_tpu_torch.training import (init_state,
                                              make_graphed_train_step)

    cfg = get_config("celeba128").override(**{
        "model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
        "model.decoder_filters": (16, 8),
        "model.decoder_upsample": (True, True), "model.groups": 4,
        "data.image_size": 32, "train.batch_size": 4,
        "train.compute_dtype": "float32", "data.dataset": "synthetic_dots"})
    state = init_state(cfg, "cuda")
    source = train_mod.make_batch_iterator(cfg, device="cuda")
    step = make_graphed_train_step(cfg, state, source=source)
    with _cpu_profile():
        step(state)
    assert span_totals() == {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(2):
            step(state)
        torch.cuda.synchronize()
    got = span_totals()
    whole = got["kp.train_step"]
    prepare, replay = got["kp.train_step.prepare"], got["kp.train_step.replay"]
    assert whole["calls"] == prepare["calls"] == replay["calls"] == 2
    assert (whole["self_seconds"] + prepare["seconds"] + replay["seconds"]
            <= whole["seconds"])
