"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. It needs CUDA cards, as many as the cell asks
for, and exits with code 2 (no result) without them. Set-up (weights and
inputs drawn from the seed, the program built, every shape it will use
run once) counts as ``setup_s``, from the start of this process to the
first timed step or request; then the window lasts ``--seconds``. With
``--trace 1`` a short stretch after the window is profiled, and the line
carries the cell's per-layer metrics; with ``--trace 0`` its end-to-end
metrics. After the window the program's outputs are compared with the
plain reference (``correct``), each number compared printed beside its
limit as the last lines on standard error and under ``checks``, the last
key of the line. It exits with code 3 (no result) if ``jax``, ``jaxlib``,
``flax`` or the JAX package ``keypoints_tpu`` was imported.

Build and kernel caches stay in fixed directories inside the checkout:
the program's kernel library builds into ``keypoints_tpu_torch/_build/``,
the rest under ``.portbench_cache/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
#: top-level modules that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "keypoints_tpu")


def set_environment() -> None:
    """Fixed cache directories inside the checkout, for every cache a
    library the program uses may keep."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device, t_start: float, hooks=None,
             control: bool = False, overrides=None) -> dict:
    """Set up, measure and check one cell → the result line (a dict) and,
    under ``_run``, what the driver returned. ``hooks`` break the timed path
    for the fault tests; ``overrides`` change the configuration's or the
    traffic's numbers for tests at small sizes."""
    import torch
    from portbench import compare, spec

    device = torch.device(device)
    conf = spec.read_json("configs", cell["config"])
    traffic = spec.read_json("traffic", cell["traffic"])
    limits = spec.read_json("limits", cell["name"])
    for section, values in (overrides or {}).items():
        {"config": conf, "traffic": traffic}[section].update(values)
    phases = [("torch imported", time.perf_counter() - t_start)]
    ctx = {"spec": conf, "traffic": traffic, "seed": seed,
           "seconds": seconds, "trace": traced, "device": device,
           "t_start": t_start, "hooks": hooks or {}, "control": control,
           "mark": lambda name: phases.append(
               (name, time.perf_counter() - t_start))}
    got = spec.driver(traffic["kind"]).run(ctx)
    print("set-up, seconds from the start: " + ", ".join(
        f"{name} {t:.2f}" for name, t in phases), file=sys.stderr)

    metrics = {}
    if traced:
        layer = dict(got["layer"], trace=got.get("trace"), traffic=traffic)
        for m in spec.metrics_of(bench, "per_layer", cell["name"]):
            value = spec.metric_reader(m["name"]).read(layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(got["e2e"], setup_s=got["setup_s"])
        for m in spec.metrics_of(bench, "end_to_end", cell["name"]):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    ok, checks = compare.judge(got["numbers"], limits)
    if device.type == "cuda":
        kind, count = torch.cuda.get_device_name(device), cell["chips"]
    else:
        kind, count = "cpu", 1
    line = {"correct": bool(ok and got["sound"]),
            "attempted": int(got["attempted"]), "failed": int(got["failed"]),
            "metrics": metrics,
            "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                       "kind": kind, "count": count,
                       "memory_peak_bytes": int(got["memory_peak_bytes"])}}
    tr = got.get("trace")
    if traced and tr is not None:
        line["device"]["busy_s"] = tr["busy_s"]
        line["device"]["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks
    line["_run"] = got
    return line


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()
    sys.path.insert(0, str(ROOT))
    from portbench import compare, spec

    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the program on NVIDIA "
              "cards", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    line = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                    "cuda", T_START)
    line.pop("_run")
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark "
              f"may not load JAX or the JAX package", file=sys.stderr)
        return 3
    compare.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
