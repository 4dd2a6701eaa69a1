"""The result line: exactly the contract's keys, the numbers compared last;
no line and a non-zero exit without a card, or without the program."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import run, spec

TINY = {"traffic": {"batch": 8, "frames": 32, "warmup_calls": 2}}


def test_the_line_has_exactly_the_contracts_keys():
    bench = spec.load()
    cell = spec.cell(bench, "celeba128.label_b256")
    line = run.run_cell(bench, cell, 2 ** 31 + 7, 0.5, False, "cpu",
                        time.perf_counter(), overrides=TINY)
    line.pop("_run")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"label_images_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["checks"]["keypoints"]) == {"value", "limit"}
    json.dumps(line)


def test_no_card_no_line():
    if torch.cuda.is_available():
        pytest.skip("this test needs a machine without CUDA")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "celeba128.label_b256", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 2 and out.stdout == ""


def test_without_the_program_no_line(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "celeba128.label_b256", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert not any(l.startswith("{") for l in out.stdout.splitlines())
