"""The numbers ``correct`` compares, each beside its limit.

Training: the first steps, each side reduced to a record (:func:`record`):
per leaf, the norms of the gradients of the first two steps as the
optimizer got them (the first taken eagerly, the second the first replay
of the step's CUDA graph) and of the parameters' change over the steps,
and the norms of their differences from the reference's; and each step's
loss. From it:

- ``loss``: the widest relative gap of a step's loss;
- ``grad1``: the first gradient's gap of norms, a leaf's gap being the gap
  between the two sides' norms of it over the larger of the reference's
  norm of it and of the median leaf; the median leaf's;
- ``grad1.keynet``, ``grad2.keynet``: the same over Psi's leaves alone, for
  the first and the second gradient, so that a fault that reaches Psi alone
  (a bottleneck backward off by a factor) moves a number of its own;
- ``diff1``, ``diff2``: the norm of a leaf's difference from the reference
  over the same denominator, the median leaf's, of the first and the
  second gradient. A gap of norms sums independent rounding errors with
  their signs, so it grows as the square root of their size and the float8
  control stands only ~2-3x from the program in it; the difference grows
  with the rounding itself, and the control stands 5x off;
- ``step``: the gap of norms of the change over the steps, the median leaf.

Leaves whose reference gradient in the first step is under a thousandth
of the median leaf's (nought up to rounding, as the keypoint head's bias
under the soft-argmax's shift invariance) are left out. The widest leaf of
each is printed for the record, with its reference gradient
(:func:`widest`).

Keypoints: the largest absolute gap of a coordinate.
"""

from __future__ import annotations

import math
import statistics
import sys

#: a leaf counts when its reference gradient is at least this share of the
#: median leaf's
LEAF_FLOOR = 1e-3
#: Psi's leaves, by the first part of a leaf's name
PSI = "keynet"


def norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def record(side: dict, params0: dict, ref: dict | None = None) -> dict:
    """``side``: ``losses``, ``grads`` (of the first two steps) and
    ``params`` (after the steps) → each step's loss and, per leaf, the norms
    of ``grad1``, ``grad2`` and ``change``; with ``ref``, also the norms of
    their differences from it (``diff``)."""
    def change(d):
        return {k: d["params"][k].double() - params0[k].double()
                for k in params0}
    out = {"losses": list(side["losses"]),
           "grad1": norms(side["grads"][0]), "grad2": norms(side["grads"][1]),
           "change": norms(change(side))}
    if ref is not None:
        a, b = change(side), change(ref)
        out["diff"] = {
            f"grad{i + 1}": norms({k: side["grads"][i][k].double()
                                   - ref["grads"][i][k].double()
                                   for k in params0}) for i in (0, 1)}
        out["diff"]["change"] = norms({k: a[k] - b[k] for k in params0})
    return out


def counted_leaves(ref: dict) -> list:
    median = statistics.median(ref["grad1"].values())
    return sorted(k for k, v in ref["grad1"].items()
                  if v >= LEAF_FLOOR * median)


def _over(ref_norms: dict, leaves: list, top: dict) -> dict:
    """``top[k]`` over the larger of the reference's norm of leaf ``k`` and
    of the median leaf."""
    median = statistics.median(ref_norms[k] for k in leaves)
    return {k: top[k] / max(ref_norms[k], median) for k in leaves}


def leaf_numbers(side: dict, ref: dict) -> dict:
    """Number name → {leaf: its reading}."""
    leaves = counted_leaves(ref)
    psi = [k for k in leaves if k.split(".", 1)[0] == PSI]

    def gap(what, among):
        return _over(ref[what], among, {k: abs(side[what][k] - ref[what][k])
                                        for k in among})
    return {"grad1": gap("grad1", leaves),
            "grad1.keynet": gap("grad1", psi), "grad2.keynet": gap("grad2", psi),
            "diff1": _over(ref["grad1"], leaves, side["diff"]["grad1"]),
            "diff2": _over(ref["grad2"], leaves, side["diff"]["grad2"]),
            "step": gap("change", leaves)}


def train_numbers(side: dict, ref: dict) -> dict:
    """Records (:func:`record`) of one side and of the reference → the
    numbers compared."""
    out = {"loss": max(abs(a - b) / abs(b)
                       for a, b in zip(side["losses"], ref["losses"]))}
    for name, by_leaf in leaf_numbers(side, ref).items():
        out[name] = statistics.median(by_leaf.values())
    return out


def widest(side: dict, ref: dict) -> dict:
    """For the record: of each number, the leaf that reads widest, its
    reading, its reference gradient norm in the first step and the median
    leaf's."""
    median = statistics.median(ref["grad1"].values())
    out = {}
    for name, by_leaf in leaf_numbers(side, ref).items():
        k = max(by_leaf, key=by_leaf.get)
        out[name] = [k, by_leaf[k], ref["grad1"][k], median]
    return out


def keypoint_gap(program, reference) -> float:
    import numpy as np
    return float(np.abs(np.asarray(program, np.float64)
                        - np.asarray(reference, np.float64)).max())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every number finite and at or under its limit, the checks)."""
    checks = {}
    ok = True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks


def print_checks(checks: dict) -> None:
    """The numbers compared beside their limits, as the last lines on
    standard error."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
