"""On a card (marker ``cuda``; each test skips without one): the control,
the reference computed in float8 in the program's place, fails the limits;
and a run whose timed path is broken underneath comes out not correct,
once for each fault its cell can have that the numbers separate, and once
for a fault that reaches Psi's gradient alone. Runs at small sizes, the look for a card skipped:

    python -m pytest portbench/tests -q -m cuda
"""

import time

import pytest
import torch

from portbench import compare, control, run, spec

SMALL = {
    "celeba128.train_b128": {"config": {"store_frames": 512}},
    "celeba128.label_b256": {"traffic": {"frames": 1024, "warmup_calls": 2}},
}
# Half of the batch left out is not among them: at the paper's widths its
# readings lie within 1-3x of the program's own on every number (PERF.md).
FAULTS = [("celeba128.train_b128", "frozen"), ("celeba128.train_b128", "psi"),
          ("celeba128.label_b256", "alter")]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def one_run(cell_name, seed, hooks=None, control_too=False):
    bench = spec.load()
    line = run.run_cell(bench, spec.cell(bench, cell_name), seed, 1.0, False,
                        "cuda", time.perf_counter(), hooks=hooks,
                        control=control_too, overrides=SMALL[cell_name])
    return line, line.pop("_run")


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_the_control_fails_the_limits(cell_name):
    card()
    _, got = one_run(cell_name, 2 ** 31 + 101, control_too=True)
    limits = spec.read_json("limits", cell_name)
    ok, _ = compare.judge(got["control_numbers"], limits)
    assert not ok, got["control_numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell_name, fault):
    card()
    line, got = one_run(cell_name, 2 ** 31 + 202, hooks=control.FAULTS[fault])
    assert line["correct"] is False, got["numbers"]
