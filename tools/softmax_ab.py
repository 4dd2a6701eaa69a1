#!/usr/bin/env python3
"""Times the fused bottleneck (K3) and the bilinear warps (K4, K5) of one
checkout of the port with this checkout's ``chip_smoke.py``, on one NVIDIA
GPU; with ``--softmax`` also the soft-argmax kernels (K1, K1b).

Loads the package of ``--root`` first, then this checkout's
``chip_smoke.py`` over it, and runs its timing functions there: phase 2's
build (the kernels' registers and spills), ``fused_times`` (phase 19: K3
against K1 then K2 at the three presets' bottlenecks, both variants),
``wide_times`` (phase 23: K1, K1b and K3 at b128 K=10 96^2 and 128^2, the
block path), ``warp_times`` (phase 9: K4 and K5 at celeba128's b128
3x128^2 bf16 warp, K4 also on the f32 image) and ``dense_route_times``
(phase 25: ``make_pair`` of b128 3x32^2 images, K4's one route, and K4
alone at one of its TPS grids); with ``--softmax`` also
``softmax_and_extract_times`` (phase 9: K1 and K1b at ``SOFTMAX_TIMES``;
the extract's images/s); with ``--steps`` also ``train_step_times`` of
the celeba128 b128 step (20 steps a run, as phase 9, then a
torch.profiler table of 5 steps, as phase 10) and the pose256 b128 step
(10 a run, as phase 14), each the median of 3 runs. Two trees thus
get the same timer, shapes and bounds in one run on one card; time them in
turns (parent, change, change, parent):

    python3 tools/softmax_ab.py --root DIR

``--root`` defaults to this checkout. ``--set NAME=VALUE`` (repeatable)
times a copy of the root's package, made under ``runs/`` and removed
after, whose ``csrc`` constant ``constexpr int NAME`` is VALUE: e.g.
``--set kFusedWarps=4`` (K3's heatmaps a block). Each line ends with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import re
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def with_constants(root: Path, settings: list[str], into: Path) -> Path:
    """A copy of ``root``'s package under ``into`` with each ``NAME=VALUE``
    of ``settings`` written into the one ``constexpr int NAME = ...;`` of
    its ``csrc``; returns the copy's root."""
    dst = into / "tree"
    shutil.copytree(root / "keypoints_tpu_torch", dst / "keypoints_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    sources = sorted((dst / "keypoints_tpu_torch" / "csrc").glob("*.cu*"))
    for setting in settings:
        name, value = setting.split("=")
        found = 0
        for src in sources:
            text, n = re.subn(rf"constexpr int {name} = -?\d+;",
                              f"constexpr int {name} = {int(value)};",
                              src.read_text())
            found += n
            src.write_text(text)
        if found != 1:
            raise SystemExit(f"{found} constants {name} in the csrc of {root}")
    return dst


def run(root: Path, softmax: bool, steps: bool) -> int:
    sys.path.insert(0, str(root))
    import keypoints_tpu_torch  # noqa: F401  (the package chip_smoke gets)
    got = Path(keypoints_tpu_torch.__file__).resolve().parent.parent
    if got != root:
        print(f"keypoints_tpu_torch came from {got}, not {root}",
              file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    try:
        card = smoke.device_phase()
        smoke.build_phase()
        smoke.phase(f"K3, K4 and K5 of {root} on {card}")
        if softmax:
            smoke.softmax_and_extract_times(card)
        smoke.fused_times(card)
        smoke.wide_times(card)
        smoke.warp_times(card)
        small, draws = smoke.dense_route_inputs()
        smoke.dense_route_times(card, small, draws.source.contiguous())
        if steps:
            cfg, state, step, images = smoke._train_setup("celeba128")
            ms = smoke.train_step_times(card, (cfg, state, step, images),
                                        steps=20)
            smoke._profile("celeba128 train step", lambda: step(state, images),
                           5, card, ms, {})
            smoke.train_step_times(card, smoke._train_setup("pose256"),
                                   steps=10)
    except smoke.SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE)
    parser.add_argument("--set", action="append", default=[],
                        metavar="NAME=VALUE")
    parser.add_argument("--softmax", action="store_true")
    parser.add_argument("--steps", action="store_true")
    args = parser.parse_args()
    root = args.root.resolve()
    if not args.set:
        return run(root, args.softmax, args.steps)
    (HERE / "runs").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "runs") as tmp:
        return run(with_constants(root, args.set, Path(tmp)), args.softmax,
                   args.steps)


if __name__ == "__main__":
    sys.exit(main())
