"""The readers of the program's spans: each metric from a synthetic
``span_totals()``, divided by the span's own calls; nothing without spans,
in another cell's traffic, or from a program that has no span helper (a
traced run lays the benchmark over an older checkout too)."""

import pytest

from portbench import spec
from keypoints_tpu_torch.utils import profiling

LABEL = {"kind": "closed_loop_extract", "calls": 99}
TRAIN = {"kind": "train_replay", "steps": 99}
TOTALS = {
    "kp.extract.call": {"calls": 4, "seconds": 0.056, "self_seconds": 0.0008},
    "kp.extract.upload": {"calls": 4, "seconds": 0.008, "self_seconds": 0.008},
    "kp.extract.replay": {"calls": 4, "seconds": 0.0004,
                          "self_seconds": 0.0004},
    "kp.extract.read": {"calls": 4, "seconds": 0.04, "self_seconds": 0.04},
    "kp.train_step": {"calls": 5, "seconds": 0.1, "self_seconds": 0.0002},
    "kp.train_step.prepare": {"calls": 5, "seconds": 0.0015,
                              "self_seconds": 0.0015},
    "kp.train_step.replay": {"calls": 5, "seconds": 0.098,
                             "self_seconds": 0.098},
}
WANT = [
    ("label.upload_host_ms_per_call", LABEL, 2.0),
    ("label.read_wait_ms_per_call", LABEL, 10.0),
    ("label.call_self_ms_per_call", LABEL, 0.2),
    ("train.host_ms_per_step", TRAIN, 0.3),
]


@pytest.mark.parametrize("name,ctx,want", WANT)
def test_each_reader_divides_by_the_spans_own_calls(name, ctx, want,
                                                    monkeypatch):
    monkeypatch.setattr(profiling, "span_totals", lambda: TOTALS)
    assert spec.metric_reader(name).read(dict(ctx)) == pytest.approx(want)


@pytest.mark.parametrize("name,ctx,want", WANT)
def test_each_reader_reads_nothing_without_its_span(name, ctx, want,
                                                    monkeypatch):
    monkeypatch.setattr(profiling, "span_totals", lambda: {})
    assert spec.metric_reader(name).read(dict(ctx)) is None
    other = TRAIN if ctx is LABEL else LABEL
    monkeypatch.setattr(profiling, "span_totals", lambda: TOTALS)
    assert spec.metric_reader(name).read(dict(other)) is None


@pytest.mark.parametrize("name,ctx,want", WANT)
def test_each_reader_reads_nothing_from_a_program_without_spans(
        name, ctx, want, monkeypatch):
    monkeypatch.delattr(profiling, "span_totals")
    assert spec.metric_reader(name).read(dict(ctx)) is None


def test_each_reader_is_listed_for_its_one_cell():
    bench = spec.load()
    cells = {name: "celeba128.train_b128" if ctx is TRAIN
             else "celeba128.label_b256" for name, ctx, _ in WANT}
    for m in bench["per_layer"]:
        if m["name"] in cells:
            assert m["workloads"] == [cells[m["name"]]]
            assert m["source"] == "program_span"
    assert cells.keys() <= {m["name"] for m in bench["per_layer"]}
