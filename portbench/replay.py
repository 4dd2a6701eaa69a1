"""``drivers/train_replay.py``'s protocol as parts a replayed-train-step
driver can take (``drivers/train_replay_pairs.py`` does): the first steps
kept for the comparison, the replay loop with the loop's metric read every
``log_every`` steps, and the comparison with the reference."""

from __future__ import annotations

import math
import sys
import time

import torch

from portbench import compare

#: Adam's b1: its first moment after update t is b1 m + (1 - b1) g_t
B1 = 0.9


def first_steps(call, state, n_ref: int):
    """Take ``n_ref`` steps → (what the comparison needs: each step's loss,
    the gradients of the first two steps from Adam's first moment, the
    parameters after the steps; the last step's metrics)."""
    net = state.model
    losses, moments = [], []
    for i in range(n_ref):
        _, metrics = call()
        losses.append(float(metrics["loss"]))
        if i < 2:
            moments.append({k: state.optimizer.state[p].get(
                "exp_avg", torch.zeros_like(p)).detach().clone()
                for k, p in net.named_parameters()})
    # g_1 = m_1 / (1 - b1); g_2 = (m_2 - b1 m_1) / (1 - b1)
    grads = [{k: m / (1 - B1) for k, m in moments[0].items()},
             {k: (m - B1 * moments[0][k]) / (1 - B1)
              for k, m in moments[1].items()}]
    after = {k: p.detach().clone() for k, p in net.named_parameters()}
    return {"losses": losses, "grads": grads, "params": after}, metrics


class Replayer:
    """Replays ``call`` (one train step → (state, metrics)), reading the
    loss every ``log_every`` steps as the loop does, and ends each run in a
    device synchronise; ``finite`` stays True while every loss read is."""

    def __init__(self, call, state, log_every: int, device, metrics):
        self.call, self.state, self.log_every = call, state, log_every
        self.device, self.metrics, self.finite = device, metrics, True

    def __call__(self, n=None, until=None):
        done, t0 = 0, time.perf_counter()
        while True:
            _, self.metrics = self.call()
            done += 1
            if self.state.step % self.log_every == 0:
                self.finite &= math.isfinite(float(self.metrics["loss"]))
            if n is not None and done >= n:
                break
            if until is not None and time.perf_counter() - t0 >= until:
                break
        torch.cuda.synchronize(self.device)
        return done, time.perf_counter() - t0

    def last_loss_finite(self) -> bool:
        self.finite &= math.isfinite(float(self.metrics["loss"]))
        return self.finite


def judge(out: dict, prog: dict, got: dict, params0: dict,
          low: dict | None = None) -> None:
    """The program's first steps ``prog`` against the reference's ``got``
    (and the control's ``low``) → ``out``'s ``numbers``, ``records`` and
    ``control_numbers``; the widest leaves printed for the record."""
    ref_rec = compare.record(got, params0)
    rec = compare.record(prog, params0, got)
    out["numbers"] = compare.train_numbers(rec, ref_rec)
    out["records"] = {"program": rec, "reference": ref_rec}
    print(f"widest leaves: {compare.widest(rec, ref_rec)}", file=sys.stderr)
    if low is not None:
        low_rec = compare.record(low, params0, got)
        out["control_numbers"] = compare.train_numbers(low_rec, ref_rec)
        out["records"]["control"] = low_rec
        print(f"control's widest leaves: {compare.widest(low_rec, ref_rec)}",
              file=sys.stderr)
