#!/usr/bin/env python3
"""Times the soft-argmax kernels (K1, K1b) and the fused bottleneck (K3) of
one checkout of the port with this checkout's ``chip_smoke.py``, on one
NVIDIA GPU.

Loads the package of ``--root`` first, then this checkout's
``chip_smoke.py`` over it, and runs two of its timing functions there:
``softmax_and_extract_times`` (phase 9: K1 and K1b, both variants, at
``SOFTMAX_TIMES`` against bound, plain version and launch floor; the
extract's images/s) and ``fused_times`` (phase 19: K3 against K1 then K2 at
the three presets' bottlenecks, both variants). Two trees thus get the same
timer, shapes and bounds in one run on one card; time them in turns
(parent, change, change, parent):

    python3 tools/softmax_ab.py --root DIR

``--root`` defaults to this checkout. Each line ends with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE)
    args = parser.parse_args()
    root = args.root.resolve()
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
        smoke.phase(f"K1, K1b and K3 of {root} on {card}")
        smoke.softmax_and_extract_times(card)
        smoke.fused_times(card)
    except smoke.SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
