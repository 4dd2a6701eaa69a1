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

Weights from the JAX package (``checkpoint.py:103-153``). The port's modules carry the flax parameter paths as names
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
  Transporter (the same three trees), with ``strict=True``.
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
        counts stay on the host, where torch keeps them for a fresh
        non-fused Adam (a count on the card would be read back every step).
        """
        payload = torch.load(self.path(step), map_location="cpu",
                             weights_only=True)
        key = MODEL_KEYS.get(payload.get("format"))
        if key is None:
            raise ValueError(f"{self.path(step)}: checkpoint format "
                             f"{payload.get('format')!r}, expected one of "
                             f"{sorted(MODEL_KEYS)}")
        state.model.load_state_dict(payload[key])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def wait_until_finished(self) -> None:
        """No-op: :meth:`save` has returned only once its file is in place."""


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
