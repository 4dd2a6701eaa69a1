"""The readings the limits of ``correct`` are set from, on a card.

    python3 portbench/control.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...] [--fault none|frozen|half|psi|alter]
        [--records <file>]

For each seed, in one process: one run of the cell as the benchmark makes
it (a short window at the cell's own sizes), printing the numbers the run
compares (the program against the reference: the lower readings), and the
same numbers of the control, the reference computed in float8 put in the
program's place (the upper readings). ``--fault`` breaks the timed path
first: ``frozen`` makes the optimizer's update a no-op (a step that returns
its state unchanged), ``half`` takes the loss over the first half of the
batch alone, ``psi`` scales the gradient that reaches Psi's heatmaps by
2 (a bottleneck backward, K1b or K2's, off by a factor: it reaches Psi's
leaves alone), ``alter`` moves the first answer of every extract call.
``--records`` keeps each training seed's per-leaf norms, from which any
number can be worked out again without the card. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402


def frozen(state) -> None:
    state.optimizer.step = lambda *a, **k: None


#: the factor the ``psi`` fault puts on the gradient of Psi's heatmaps
PSI_SCALE = 2.0


def psi(state) -> None:
    import torch

    class Scaled(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return g * PSI_SCALE

    state.model.keynet.register_forward_hook(
        lambda module, args, out: Scaled.apply(out))


def half(loss):
    def on_half(recon, tgt):
        n = recon.shape[0] // 2
        if loss is None:
            import torch
            return torch.mean((recon[:n] - tgt[:n]) ** 2)
        return loss(recon[:n], tgt[:n])
    return on_half


def alter(keypoints):
    out = keypoints.copy()
    out[0, 0, 0] += 0.5
    return out


FAULTS = {"none": {}, "frozen": {"state": frozen}, "half": {"loss": half},
          "psi": {"state": psi}, "alter": {"extract": alter}}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted(FAULTS), default="none")
    p.add_argument("--records", help="a file to write each seed's records "
                   "of the training steps to (portbench.compare.record), one "
                   "JSON line a seed")
    a = p.parse_args(argv)
    run.set_environment()
    import torch
    from portbench import spec
    bench = spec.load()
    cell = spec.cell(bench, a.workload)
    for seed in a.seeds:
        line = run.run_cell(bench, cell, seed, a.seconds, False, "cuda",
                            time.perf_counter(), hooks=FAULTS[a.fault],
                            control=a.fault == "none")
        got = line.pop("_run")
        if a.records and "records" in got:
            with open(a.records, "a") as f:
                f.write(json.dumps({"seed": seed, "fault": a.fault,
                                    **got["records"]}) + "\n")
        print(json.dumps({"seed": seed, "fault": a.fault,
                          "correct": line["correct"],
                          "numbers": got["numbers"],
                          "control": got.get("control_numbers"),
                          "metrics": {k: v["value"] for k, v
                                      in line["metrics"].items()}}),
              flush=True)
        del line, got
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
