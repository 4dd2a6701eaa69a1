"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json`` (whose ``kind`` names the driver,
``drivers/<kind>.py``), the limits of its comparison ``limits/<cell>.json``
and each per-layer metric ``metrics/<metric>.py``. A later cell, mix or
metric is new files and new entries; no file here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def check_names(bench: dict) -> list[str]:
    """What in ``bench`` breaks the rules for names and units: every
    ``name``, ``config``, ``traffic`` and key of ``reduced`` of at most 64
    letters, digits, ``_``, ``.`` and ``-`` (not starting with ``.`` or
    ``-``); a unit of 1 to 16 of those, ``/`` and ``%``; no name twice
    among the metrics, the cells or the configurations."""
    bad = []

    def name(where, value):
        if not isinstance(value, str) or not NAME.match(value):
            bad.append(f"{where}: bad name {value!r}")

    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = set()
        for i, entry in enumerate(bench.get(group, [])):
            n = entry.get("name")
            name(f"{group}[{i}].name", n)
            if n in seen:
                bad.append(f"{group}: {n!r} twice")
            seen.add(n)
            if group == "workloads":
                name(f"{group}[{i}].config", entry.get("config"))
                name(f"{group}[{i}].traffic", entry.get("traffic"))
            if group == "configs":
                for key in entry.get("reduced", []):
                    name(f"{group}[{i}].reduced", key)
            if group in ("end_to_end", "per_layer"):
                unit = entry.get("unit")
                if not isinstance(unit, str) or not UNIT.match(unit):
                    bad.append(f"{group}[{i}].unit: bad unit {unit!r}")
    metrics = [m["name"] for g in ("end_to_end", "per_layer")
               for m in bench.get(g, [])]
    if len(metrics) != len(set(metrics)):
        bad.append("a metric name is used twice")
    return bad


def cell(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                     f"{[w['name'] for w in bench['workloads']]}")


def read_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str):
    return load_module(HERE / "drivers" / f"{kind}.py",
                       f"portbench_driver_{kind}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


def metrics_of(bench: dict, group: str, cell_name: str) -> list[dict]:
    """The ``group`` metrics that cell ``cell_name`` reports."""
    out = []
    for m in bench[group]:
        if "workloads" not in m or cell_name in m["workloads"]:
            out.append(m)
    return out


def program_config(conf: dict, seed: int | None = None):
    """The program's preset with the configuration file's overrides (and
    the seed), held to the file's sizes: a preset that drifted from the
    file stops the run."""
    from keypoints_tpu_torch.configs import get_config
    cfg = get_config(conf["preset"]).override(**conf.get("overrides", {}))
    if seed is not None:
        cfg = cfg.override(**{"train.seed": seed})
    m, t = cfg.model, cfg.train
    have = {"channels": cfg.data.channels, "image_size": cfg.data.image_size,
            "num_keypoints": m.num_keypoints, "out_channels": m.out_channels,
            "sigma": m.sigma, "temperature": m.temperature,
            "softmax_variant": m.softmax_variant,
            "encoder_filters": list(m.encoder_filters),
            "encoder_strides": list(m.encoder_strides),
            "decoder_filters": list(m.decoder_filters),
            "decoder_upsample": list(m.decoder_upsample), "groups": m.groups}
    checks = [(have, conf["model"]), ({"kind": t.loss}, conf["loss"]),
              ({"lr": t.lr, "warmup_steps": t.warmup_steps, "steps": t.steps},
               conf["optimizer"]),
              (t.compute_dtype, conf["compute_dtype"]),
              (t.batch_size, conf["train_batch"])]
    for got, wanted in checks:
        if got != wanted:
            raise SystemExit(f"preset {conf['preset']!r} with its overrides "
                             f"gives {got}, the configuration file {wanted}")
    return cfg
