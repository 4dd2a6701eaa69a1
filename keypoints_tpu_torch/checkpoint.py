"""Checkpoints — port of ``keypoints_tpu/checkpoint.py``.

Native training checkpoints (``checkpoint.py:28-50``, on Orbax in JAX):
:class:`CheckpointManager` keeps one file a step, ``{directory}/{step}.pt``,
holding the model's ``state_dict`` under ``"state_dict"`` (the key JAX's
``load_torch_checkpoint`` unwraps, so ``keypoints-convert convert`` takes a
step file as it is), the optimizer's under ``"optimizer"``, the step, the
preset's name and :data:`FORMAT`. Under a process group rank 0 alone
writes and prunes; the file is the same for one process and for many, so
a data-parallel run resumes on one card and the other way round. A step is
written with ``torch.save`` to a
``.tmp`` name and ``os.replace``d into place, so a crash never leaves a
half-written file under a step's name (a leftover ``.tmp`` is ignored);
steps beyond ``max_to_keep`` are deleted after the replace. The train
step's draws are a pure function of (seed, step)
(``training.step_generator``), so no random state is saved, as in JAX.
``make_manager``, ``save`` and ``restore_latest`` keep their JAX names.

Weights from the JAX package (``checkpoint.py:103-153``) and from the
reference (``checkpoint.py:51-88``, ``:147-173``, ``:178-243``). The
port's modules carry the flax parameter paths as names
(``encoder.Conv_0.weight``, ``keynet.trunk.GroupNorm_0.weight``,
``decoder.head.bias``, ...), so a state dict written by ``keypoints-convert
export-torch`` with no ``--rename`` loads as it is:

* ``state_dict_from_flax(params)`` turns nested flax params (numpy arrays,
  or anything ``np.asarray`` takes) into that state dict — conv kernels
  HWIO → OIHW, ``kernel``/``scale`` → ``weight`` — with numpy alone;
* ``load_checkpoint(path)`` reads a ``.pt`` state dict, or the newest
  step's model of a trainer directory;
* ``load_model_state(model, state_dict)`` loads ``encoder.*``, ``keynet.*``
  and ``decoder.*`` into the whole model, the autoencoder or the
  Transporter (the same three trees), with ``strict=True``;
* ``convert_state_dict`` / ``export_state_dict`` rename a state dict
  between the reference's module names (``DuaneNielsen/keypoints``' torch
  layout, e.g. ``tests/golden/torch_model.py``) and the port's, with a
  longest-prefix ``rename`` map as JAX's ``convert_torch_state_dict`` takes
  (tensors stay OIHW), and ``assert_state_dict_matches`` reports missing,
  extra and mis-shaped keys against a model; the CLI (``python -m
  keypoints_tpu_torch.checkpoint convert`` / ``export-torch``,
  ``keypoints-torch-convert``) is ``keypoints-convert``'s counterpart.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
from torch import nn

from keypoints_tpu_torch.parallel import multihost


def _invert_leaf(leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax leaf → (torch leaf name, torch-layout array)."""
    if leaf == "kernel":
        if value.ndim == 4:                      # HWIO → OIHW
            return "weight", np.transpose(value, (3, 2, 0, 1))
        if value.ndim == 2:                      # IO → OI
            return "weight", np.transpose(value, (1, 0))
        return "weight", value
    if leaf == "scale":                          # norm gain
        return "weight", value
    return leaf, value


def state_dict_from_flax(params: Mapping) -> dict[str, np.ndarray]:
    """Nested flax params → flat torch-layout state dict (name → ndarray).

    Keys come in sorted path order, as ``jax.tree_util`` flattens dicts;
    bf16 leaves become float32.
    """
    out: dict[str, np.ndarray] = {}

    def walk(node: Mapping, prefix: list[str]) -> None:
        for key in sorted(node):
            value = node[key]
            if isinstance(value, Mapping):
                walk(value, prefix + [str(key)])
                continue
            arr = np.asarray(value)
            if arr.dtype.name == "bfloat16":     # no torch/numpy bridge
                arr = arr.astype(np.float32)
            leaf, arr = _invert_leaf(str(key), arr)
            out[".".join(prefix + [leaf])] = arr

    walk(params, [])
    return out


#: version of the step files' layout (``{"format", "step", "preset",
#: "state_dict", "optimizer"}``); format 1 held the model under ``"model"``
FORMAT = 2
#: the model's key in each format that restores
MODEL_KEYS = {1: "model", 2: "state_dict"}


class CheckpointManager:
    """Training checkpoints in ``directory``: ``{step}.pt`` files, the
    newest ``max_to_keep`` kept. Saves are synchronous;
    :meth:`wait_until_finished` exists for the JAX manager's callers."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> list[int]:
        """The saved steps, oldest first (``.tmp`` files are not steps)."""
        return sorted(int(name[:-3]) for name in os.listdir(self.directory)
                      if name.endswith(".pt") and name[:-3].isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, preset: str = "") -> None:
        """Write ``state`` (a ``training.TrainState``) as step ``step``; on
        rank 0 only under a process group (every rank holds the same
        state)."""
        if not multihost.is_primary():
            return
        payload = {"format": FORMAT, "step": int(step), "preset": preset,
                   "state_dict": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict()}
        final = self.path(step)
        tmp = final + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, step: int, state):
        """Load step ``step`` into ``state``'s model and optimizer in place
        and set its step; → ``state``.

        The file is read onto the CPU: ``load_state_dict`` copies the
        parameters and moments to their device, and the optimizer's step
        counts go where the optimizer keeps them (:func:`load_optimizer_state`:
        on the card for the capturable Adam of a CUDA run, on the host
        otherwise), whichever optimizer wrote the file.
        """
        payload = torch.load(self.path(step), map_location="cpu",
                             weights_only=True)
        key = MODEL_KEYS.get(payload.get("format"))
        if key is None:
            raise ValueError(f"{self.path(step)}: checkpoint format "
                             f"{payload.get('format')!r}, expected one of "
                             f"{sorted(MODEL_KEYS)}")
        state.model.load_state_dict(payload[key])
        load_optimizer_state(state.optimizer, payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def wait_until_finished(self) -> None:
        """No-op: :meth:`save` has returned only once its file is in place."""


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         saved: Mapping) -> None:
    """Load a saved optimizer state (the moments, the step counts and the
    rate) into ``optimizer``, which keeps its own groups' other settings:
    the config sets the hyperparameters, and ``capturable`` (with the
    device its step counts live on) is the optimizer's own, so a file of a
    CPU run or of a non-capturable Adam loads into the capturable Adam of a
    CUDA run and the other way round. A rate tensor takes the saved rate in
    place: a CUDA graph of the step reads that tensor."""
    groups = optimizer.param_groups
    if len(groups) != len(saved["param_groups"]):
        raise ValueError(f"saved optimizer has {len(saved['param_groups'])} "
                         f"parameter groups, this one {len(groups)}")
    rates = []
    for group, kept in zip(groups, saved["param_groups"]):
        rate = group["lr"]
        if isinstance(rate, torch.Tensor):
            rates.append(rate.fill_(float(kept["lr"])))
        else:
            rates.append(float(kept["lr"]))
    optimizer.load_state_dict({
        "state": saved["state"],
        "param_groups": [{**{k: v for k, v in g.items() if k != "params"},
                          "params": s["params"]}
                         for g, s in zip(groups, saved["param_groups"])]})
    for group, rate in zip(optimizer.param_groups, rates):
        group["lr"] = rate


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, max_to_keep)


def save(manager: CheckpointManager, step: int, state,
         preset: str = "") -> None:
    manager.save(step, state, preset)


def restore_latest(manager: CheckpointManager, state):
    """→ (step, state restored in place) from the newest checkpoint, or
    (None, state) untouched."""
    step = manager.latest_step()
    if step is None:
        return None, state
    return step, manager.restore(step, state)


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A model state dict on the CPU, from a ``torch.save``d state dict (the
    file ``keypoints-convert export-torch`` writes), a trainer step file, or
    a trainer directory (its newest step)."""
    if os.path.isdir(path):
        manager = CheckpointManager(path)
        step = manager.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {path}")
        path = manager.path(step)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and obj.get("format") in MODEL_KEYS:
        return obj[MODEL_KEYS[obj["format"]]]
    return obj


def load_model_state(model: nn.Module, state_dict: Mapping) -> None:
    """Load a full state dict into ``model`` with ``strict=True``.

    A key the model does not have raises ``KeyError``; a key it has and the
    dict lacks raises torch's ``RuntimeError``. Values may be tensors or
    numpy arrays; each is copied into the parameter in place, in the
    parameter's dtype and on its device.
    """
    own = model.state_dict()
    trees = ", ".join(sorted({k.split(".")[0] + ".*" for k in own}))
    tensors = {}
    for key, value in state_dict.items():
        if key not in own:
            raise KeyError(f"unexpected state-dict key {key!r}: "
                           f"{type(model).__name__} has {trees}")
        tensors[key] = (value if isinstance(value, torch.Tensor)
                        else torch.from_numpy(np.array(value)))
    model.load_state_dict(tensors, strict=True)


# --- reference-layout state dicts: keypoints-convert's counterpart ---------

def _renamed(name: str, rename: list[tuple[str, str]]) -> str:
    for src, dst in rename:
        if name == src or name.startswith(src + "."):
            return dst + name[len(src):]
    return name


def _rename_all(state_dict: Mapping, rename: Optional[Mapping[str, str]]
                ) -> dict[str, torch.Tensor]:
    """``state_dict`` with every key's longest matching '.'-separated
    prefix of ``rename`` replaced; values as CPU tensors."""
    order = sorted((rename or {}).items(), key=lambda kv: -len(kv[0]))
    out: dict[str, torch.Tensor] = {}
    for name, value in state_dict.items():
        new = _renamed(name, order)
        if new in out:
            raise ValueError(f"{name!r} renames to {new!r}, which another "
                             f"key already took")
        out[new] = (value.detach().cpu() if isinstance(value, torch.Tensor)
                    else torch.from_numpy(np.array(value)))
    return out


def convert_state_dict(state_dict: Mapping,
                       rename: Optional[Mapping[str, str]] = None
                       ) -> dict[str, torch.Tensor]:
    """A reference-layout torch state dict (``DuaneNielsen/keypoints``'
    module names, e.g. ``encoder.blocks.0.0.weight``) → the port's names
    (the flax paths, ``encoder.Conv_0.weight``), the counterpart of JAX's
    ``convert_torch_state_dict``: ``rename`` maps reference module-path
    prefixes to the port's, longest prefix first on '.'-separated paths.
    Tensors stay OIHW (both sides are torch); leaf names stay ``weight``
    and ``bias``."""
    return _rename_all(state_dict, rename)


def export_state_dict(state_dict: Mapping,
                      rename: Optional[Mapping[str, str]] = None
                      ) -> dict[str, torch.Tensor]:
    """The inverse of :func:`convert_state_dict`: the port's names →
    reference names, ``rename`` mapping the port's prefixes to the
    reference's (the inversion, ``{v: k for k, v in ...}``, of a
    convert-direction map); JAX's ``export_torch_state_dict``. Values
    become float32 where they were bfloat16, as JAX's export does."""
    return {k: v.float() if v.dtype == torch.bfloat16 else v
            for k, v in _rename_all(state_dict, rename).items()}


def assert_state_dict_matches(state_dict: Mapping, model: nn.Module) -> None:
    """Raise with the missing, extra and mis-shaped keys when
    ``state_dict`` does not fit ``model`` (JAX's
    ``assert_tree_shapes_match``)."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(np.shape(v)) for k, v in state_dict.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    if missing or extra or bad:
        lines = [f"missing: {missing}", f"extra: {extra}",
                 *(f"shape {k}: got {got[k]} want {want[k]}" for k in bad)]
        raise ValueError("converted state dict mismatch:\n"
                         + "\n".join(lines))


def _preset_model(preset: str, overrides: list[str]) -> nn.Module:
    """The preset's model on the CPU, for its names and shapes."""
    from keypoints_tpu_torch.configs import apply_overrides, get_config
    from keypoints_tpu_torch.training import build_model
    return build_model(apply_overrides(get_config(preset), overrides), "cpu")


def _cli(argv=None) -> None:
    """``python -m keypoints_tpu_torch.checkpoint convert <ref.pt> <out.pt>
    [--rename map.json] [--preset P]`` writes a state dict in the port's
    names that ``eval``, ``serve``, ``export`` and ``video``
    ``--checkpoint`` load; ``export-torch <trainer_dir> <out.pt> --preset
    P [--override ...] [--rename inv.json]`` writes the newest step's model
    in reference names."""
    import argparse
    import json

    p = argparse.ArgumentParser(
        description="convert state dicts between the reference's torch "
                    "names and the port's")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert", help="reference state dict -> the port's")
    c.add_argument("torch_path")
    c.add_argument("out_path", help="output .pt file")
    c.add_argument("--rename", default=None,
                   help="JSON file mapping reference module prefixes to the "
                        "port's (flax) paths")
    c.add_argument("--preset", default=None,
                   help="validate the converted shapes against this preset")
    e = sub.add_parser("export-torch",
                       help="trainer checkpoint -> reference state dict")
    e.add_argument("checkpoint_dir", help="trainer checkpoint directory "
                                          "(its newest step)")
    e.add_argument("out_path", help="output .pt file")
    e.add_argument("--preset", required=True,
                   help="config preset the checkpoint was trained with")
    e.add_argument("--override", nargs="*", default=[],
                   help="config overrides the checkpoint was trained with")
    e.add_argument("--rename", default=None,
                   help="JSON file mapping the port's module prefixes to "
                        "reference paths (the inversion of a convert map)")
    args = p.parse_args(argv)

    rename = None
    if args.rename:
        with open(args.rename) as f:
            rename = json.load(f)
    if args.cmd == "convert":
        obj = torch.load(args.torch_path, map_location="cpu",
                         weights_only=True)
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        sd = convert_state_dict(obj, rename)
        if args.preset:
            assert_state_dict_matches(sd, _preset_model(args.preset, []))
            print(f"shapes validated against preset {args.preset!r}")
        torch.save(sd, args.out_path)
        print(f"wrote {len(sd)} tensors in the port's names to "
              f"{args.out_path}")
        return
    step = (CheckpointManager(args.checkpoint_dir).latest_step()
            if os.path.isdir(args.checkpoint_dir) else None)
    if step is None:
        raise SystemExit(f"no checkpoint found in {args.checkpoint_dir!r}")
    sd = load_checkpoint(CheckpointManager(args.checkpoint_dir).path(step))
    assert_state_dict_matches(sd, _preset_model(args.preset, args.override))
    torch.save(export_state_dict(sd, rename), args.out_path)
    print(f"wrote torch state dict (step {step}) to {args.out_path}")


if __name__ == "__main__":
    _cli()
