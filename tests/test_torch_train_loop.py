"""The port's train loop, checkpoints and CLI on the CPU: the contracts of
the JAX package's ``tests/test_end_to_end.py`` and
``tests/test_train_integration.py``, held by the port itself.

The loop adds nothing to the step: its first steps equal
``make_train_step`` applied to its source's batches, and the step is held
against JAX elsewhere (``tests/test_torch_train.py``). Resume is bit for
bit for the three source kinds: a synthetic generator, a store resident on
the device and a store streamed from the host. Narrow widths:
``encoder_filters=(8, 16)``, 32², b4, float32.
"""

import itertools
import json
import os
import subprocess

import numpy as np
import pytest
import torch

from keypoints_tpu_torch import checkpoint as ckpt
from keypoints_tpu_torch import train as train_mod
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.data import device as dev
from keypoints_tpu_torch.data.records import FrameStore, episode_pairs
from keypoints_tpu_torch.training import init_state, make_train_step

SMALL = {"model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
         "model.decoder_filters": (16, 8),
         "model.decoder_upsample": (True, True), "model.groups": 4,
         "data.image_size": 32, "train.batch_size": 4,
         "train.compute_dtype": "float32"}
SMALL_ARGS = [f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
              for k, v in SMALL.items()]


def _small(preset="pong64", **over):
    return get_config(preset).override(**{**SMALL, **over})


def _dots(ckdir, steps, **over):
    return _small(**{"data.dataset": "synthetic_dots", "train.steps": steps,
                     "train.log_every": 100, "train.eval_every": 1000,
                     "train.checkpoint_every": 4,
                     "train.checkpoint_dir": ckdir, **over})


def _store_cfg(tmp_path, ckdir, steps, **over):
    """transporter_atari at narrow widths on a 64-frame scripted store."""
    frames = (np.random.RandomState(0).rand(64, 1, 32, 32) * 255).astype(
        np.uint8)
    path = tmp_path / "data" / "atari_32.npy"
    if not path.exists():
        FrameStore.write(str(path), frames, episode_pairs([32, 32], 2))
    return _small("transporter_atari", **{
        "data.data_dir": str(tmp_path / "data"), "data.loader_workers": 2,
        "train.steps": steps, "train.log_every": 100,
        "train.eval_every": 1000, "train.checkpoint_every": 4,
        "train.checkpoint_dir": str(tmp_path / ckdir), **over})


def _assert_states_equal(a, b):
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, s in sa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert a.step == b.step


@pytest.mark.parametrize("source", ["synthetic", "resident", "stream"])
def test_resume_is_bit_exact(source, tmp_path, monkeypatch):
    """train(8) == train(4) + resume to 8, model and optimizer."""
    monkeypatch.chdir(tmp_path)
    if source == "synthetic":
        def cfg(ckdir, steps):
            return _dots(ckdir, steps)
        kind = train_mod.SyntheticBatches
    else:
        def cfg(ckdir, steps):
            return _store_cfg(tmp_path, ckdir, steps)
        kind = train_mod.DeviceResidentBatches
        if source == "stream":
            monkeypatch.setattr(dev, "device_memory_budget",
                                lambda *a, **k: 0)
            kind = type(train_mod.prefetch(iter(())))
    assert isinstance(train_mod.make_batch_iterator(cfg("x", 1),
                                                    device="cpu"), kind)
    full = train_mod.train(cfg("ck_full", 8), device="cpu")
    train_mod.train(cfg("ck_split", 4), device="cpu")
    resumed = train_mod.train(cfg("ck_split", 8), device="cpu")
    _assert_states_equal(full, resumed)
    restored = ckpt.CheckpointManager("ck_split/transporter_atari"
                                      if source != "synthetic" else
                                      "ck_split/pong64").restore(
        8, init_state(cfg("y", 8), "cpu"))
    _assert_states_equal(full, restored)


def test_interrupt_saves_checkpoint_and_resume_is_exact(tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)

    def cfg(ckdir):
        return _dots(ckdir, 8, **{"train.log_every": 4,
                                  "train.checkpoint_every": 1000})

    full = train_mod.train(cfg("int_full"), device="cpu")
    calls = {"n": 0}
    orig = train_mod.Logger.scalars

    def interrupting_scalars(self, step, **kw):
        orig(self, step, **kw)
        calls["n"] += 1
        if calls["n"] == 1:                    # first log tick = step 4
            raise KeyboardInterrupt
    monkeypatch.setattr(train_mod.Logger, "scalars", interrupting_scalars)
    with pytest.raises(KeyboardInterrupt):
        train_mod.train(cfg("int_split"), device="cpu")
    monkeypatch.setattr(train_mod.Logger, "scalars", orig)
    assert ckpt.CheckpointManager("int_split/pong64").all_steps() == [4]
    _assert_states_equal(full, train_mod.train(cfg("int_split"),
                                               device="cpu"))


def test_interrupt_inside_a_step_does_not_save(tmp_path, monkeypatch):
    """Ctrl-C inside a step (its update may be half applied) leaves the
    last checkpoint standing."""
    monkeypatch.chdir(tmp_path)
    real = train_mod.make_train_step

    def interrupted_at_6(cfg, loss=None):
        step = real(cfg, loss)

        def wrapped(state, batch):
            if state.step == 5:
                raise KeyboardInterrupt
            return step(state, batch)
        return wrapped
    monkeypatch.setattr(train_mod, "make_train_step", interrupted_at_6)
    with pytest.raises(KeyboardInterrupt):
        train_mod.train(_dots("ck", 8), device="cpu")
    assert ckpt.CheckpointManager("ck/pong64").all_steps() == [4]


def test_interrupt_inside_save_does_not_double_save(tmp_path, monkeypatch):
    orig_save = train_mod.ckpt.save
    calls = {"n": 0}

    def interrupting_save(mgr, step, state, preset=""):
        orig_save(mgr, step, state, preset)   # the save itself completes
        calls["n"] += 1
        if calls["n"] == 1:                   # Ctrl-C before last_saved
            raise KeyboardInterrupt
    monkeypatch.setattr(train_mod.ckpt, "save", interrupting_save)
    cfg = _dots(str(tmp_path / "int_insave"), 8,
                **{"train.log_every": 4})
    with pytest.raises(KeyboardInterrupt):
        train_mod.train(cfg, device="cpu")
    assert calls["n"] == 1
    monkeypatch.setattr(train_mod.ckpt, "save", orig_save)
    assert train_mod.train(cfg, device="cpu").step == 8
    assert (tmp_path / "int_insave" / "pong64" / "8.pt").is_file()


def test_train_cli_resume(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = ["--preset", "pong64", "--steps", "4", "--device", "cpu",
            "--override", *SMALL_ARGS, "train.log_every=2",
            "train.eval_every=100", "train.checkpoint_every=2",
            "data.dataset=synthetic_dots"]
    train_mod.main(args)
    assert "step      4" in capsys.readouterr().out
    train_mod.main(args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step      6" in out


def test_training_is_deterministic():
    """Same seed → bit-identical loss trajectory."""
    cfg = _dots("unused", 5)

    def run():
        state = init_state(cfg, "cpu")
        step = make_train_step(cfg)
        src = train_mod.make_batch_iterator(cfg, device="cpu")
        losses = []
        for i in range(5):
            state, m = step(state, src.sample_at(i))
            losses.append(float(m["loss"]))
        return losses

    assert run() == run()


@pytest.mark.parametrize("preset,over", [
    ("pong64", {"data.dataset": "synthetic_dots"}),
    ("celeba128", {"data.dataset": "synthetic_dots"}),       # warp mode
    ("pong64", {})])                                          # scripted Pong
def test_loop_steps_equal_make_train_step_on_its_batches(preset, over,
                                                         tmp_path):
    cfg = _small(preset, **{"train.steps": 3, "train.log_every": 100,
                            "train.eval_every": 1000,
                            "train.checkpoint_every": 1000,
                            "train.checkpoint_dir": str(tmp_path), **over})
    looped = train_mod.train(cfg, device="cpu")
    state = init_state(cfg, "cpu")
    step = make_train_step(cfg)
    for batch in itertools.islice(
            train_mod.make_batch_iterator(cfg, device="cpu"), 3):
        state, _ = step(state, batch)
    _assert_states_equal(looped, state)


def test_best_tracker_logic(tmp_path):
    state = init_state(_dots("unused", 1), "cpu")
    bt = train_mod.BestTracker(str(tmp_path / "b"))
    assert bt.update(1, 0.5, state)
    assert not bt.update(2, 0.6, state)          # worse: no save
    assert not bt.update(3, float("nan"), state)  # NaN: never best
    assert bt.update(4, 0.4, state)
    bt.finish()
    assert ckpt.CheckpointManager(str(tmp_path / "b")).all_steps() == [4]
    bt2 = train_mod.BestTracker(str(tmp_path / "b"))  # a restart
    assert bt2.best == 0.4 and bt2.step == 4
    assert not bt2.update(5, 0.45, state)


def test_best_tracker_crash_reconciliation(tmp_path):
    state = init_state(_dots("unused", 1), "cpu")
    bt = train_mod.BestTracker(str(tmp_path / "b"))
    assert bt.update(4, 0.5, state)
    # json replaced for a step-10 improvement whose save never landed
    with open(tmp_path / "b" / "best.json", "w") as f:
        json.dump({"step": 10, "eval_loss": 0.3,
                   "previous": {"step": 4, "eval_loss": 0.5}}, f)
    bt2 = train_mod.BestTracker(str(tmp_path / "b"))
    assert bt2.best == 0.5 and bt2.step == 4
    assert not bt2.update(11, 0.55, state)


@pytest.mark.parametrize("source", ["synthetic", "resident"])
def test_train_keeps_best_checkpoint(source, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    over = {"train.steps": 8, "train.log_every": 4, "train.eval_every": 4,
            "train.checkpoint_every": 8}
    if source == "synthetic":
        cfg = _dots("ck", 8, **over)
        want = {"held_out": True, "scoring": "synthetic_draw", "rows": 4}
    else:
        cfg = _store_cfg(tmp_path, "ck", 8, **over)
        want = {"held_out": True, "scoring": "store_tail", "rows": 4}
    train_mod.train(cfg, logdir=str(tmp_path / "tb"), device="cpu")
    best_dir = os.path.join(cfg.train.checkpoint_dir, f"{cfg.name}_best")
    with open(os.path.join(best_dir, "best.json")) as f:
        meta = json.load(f)
    assert np.isfinite(meta["eval_loss"]) and meta["step"] in (4, 8)
    assert {k: meta[k] for k in want} == want
    restored = ckpt.CheckpointManager(best_dir).restore(
        meta["step"], init_state(cfg, "cpu"))
    assert restored.step == meta["step"]
    rows = [json.loads(line) for line in
            (tmp_path / "tb" / "metrics.jsonl").read_text().splitlines()]
    for key in ("loss", "grad_norm", "keypoint_spread", "eval_loss"):
        assert [r["step"] for r in rows if key in r] == [4, 8], key
        assert all(np.isfinite(r[key]) for r in rows if key in r)


def test_discovery_failure_detection_and_quarantine(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    over = ["--device", "cpu", "--override", *SMALL_ARGS,
            "data.dataset=synthetic_dots", "train.log_every=4",
            "train.eval_every=4", "train.checkpoint_every=4",
            "train.checkpoint_dir=ck", "train.spread_check_step=4"]
    with pytest.raises(SystemExit) as ei:
        train_mod.main(["--preset", "pong64", "--steps", "8",
                        "--abort-on-plateau", *over, "train.min_spread=10.0"])
    assert ei.value.code == train_mod.EXIT_DISCOVERY_FAILURE
    assert (tmp_path / "ck" / "pong64_failed_seed0").is_dir()
    assert not (tmp_path / "ck" / "pong64").exists()
    train_mod.main(["--preset", "pong64", "--steps", "8",
                    "--abort-on-plateau", *over, "train.min_spread=1e-9"])
    assert (tmp_path / "ck" / "pong64" / "8.pt").is_file()


def test_abort_on_plateau_requires_threshold():
    with pytest.raises(SystemExit):
        train_mod.main(["--preset", "celeba128", "--abort-on-plateau",
                        "--device", "cpu"])


class _FakeProc:
    launches: list = []

    def __init__(self, cmd, **kw):
        self.launches.append(cmd)

    def wait(self):
        return train_mod.EXIT_DISCOVERY_FAILURE


def test_supervise_passes_discovery_failure_through(monkeypatch):
    monkeypatch.setattr(_FakeProc, "launches", [])
    monkeypatch.setattr(subprocess, "Popen", _FakeProc)
    code = train_mod._supervise(["--preset", "pong64"], max_restarts=3)
    assert code == train_mod.EXIT_DISCOVERY_FAILURE
    assert len(_FakeProc.launches) == 1
    assert _FakeProc.launches[0][1:3] == ["-m", "keypoints_tpu_torch.train"]


def test_reroll_supervise_composes_user_seed_offset(monkeypatch):
    monkeypatch.setattr(_FakeProc, "launches", [])
    monkeypatch.setattr(subprocess, "Popen", _FakeProc)
    code = train_mod._reroll_supervise(["--preset", "pong64"], 2,
                                       base_offset=5)
    assert code == train_mod.EXIT_DISCOVERY_FAILURE
    offsets = [c[c.index("--seed-offset") + 1] for c in _FakeProc.launches]
    assert offsets == ["5", "6", "7"]


def test_reroll_cli_strips_and_forwards_seed_offset(monkeypatch):
    seen = {}

    def fake_reroll(child_argv, n, base_offset=0):
        seen.update(argv=child_argv, n=n, base=base_offset)
        return 0
    monkeypatch.setattr(train_mod, "_reroll_supervise", fake_reroll)
    with pytest.raises(SystemExit) as ei:
        train_mod.main(["--preset", "pong64", "--reroll-on-plateau", "2",
                        "--seed-offset", "5"])
    assert ei.value.code == 0
    assert seen["n"] == 2 and seen["base"] == 5
    assert "--seed-offset" not in seen["argv"]
    assert "--reroll-on-plateau" not in seen["argv"]


@pytest.mark.parametrize("store", [False, True])
def test_train_cli_dry_run_prints_the_source_and_writes_nothing(
        store, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    if store:
        cfg = _store_cfg(tmp_path, "ck", 4)
        args = ["--preset", "transporter_atari", "--override", *SMALL_ARGS,
                f"data.data_dir={cfg.data.data_dir}"]
        kind = "DeviceResidentBatches"
    else:
        args = ["--preset", "pong64", "--override", *SMALL_ARGS,
                "data.dataset=synthetic_dots"]
        kind = "SyntheticBatches"
    before = sorted(os.listdir(tmp_path))
    train_mod.main(["--steps", "4", "--dry-run", "--device", "cpu",
                    "--logdir", str(tmp_path / "dr_logs"), *args])
    out = capsys.readouterr().out
    assert "dry run:" in out and f"source {kind} (in-step" in out
    assert '"batch_size": 4' in out and "frames/s" not in out
    assert sorted(os.listdir(tmp_path)) == before


def test_train_cli_rejects_abbreviated_and_conflicting_flags():
    with pytest.raises(SystemExit):
        train_mod.main(["--preset", "pong64", "--super", "2"])
    with pytest.raises(SystemExit):
        train_mod.main(["--preset", "pong64", "--dry-run", "--profile",
                        "/nonexistent"])


def test_train_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train_mod.train(_dots("unused", 1))
    with pytest.raises(SystemExit, match="--device cpu"):
        train_mod.main(["--preset", "pong64"])


def test_device_faults_get_the_crash_hint(tmp_path, monkeypatch):
    def failing(cfg, loss=None):
        def step(state, batch):
            raise RuntimeError("fused_bottleneck kernel launch failed: "
                               "CUDA error 700")
        return step
    monkeypatch.setattr(train_mod, "make_train_step", failing)
    with pytest.raises(RuntimeError, match="No checkpoint has been written"):
        train_mod.train(_dots(str(tmp_path), 8), device="cpu")


def test_fault_hook_fires_once(tmp_path, monkeypatch):
    marker = tmp_path / "fired"
    monkeypatch.setenv(train_mod.FAULT_ENV, f"2:{marker}")
    with pytest.raises(RuntimeError, match="injected fault at step 2"):
        train_mod.train(_dots(str(tmp_path / "ck"), 4), device="cpu")
    assert marker.exists()
    assert train_mod.train(_dots(str(tmp_path / "ck"), 4),
                           device="cpu").step == 4


def test_train_loop_with_grad_accum(tmp_path):
    cfg = _dots(str(tmp_path), 4, **{"train.grad_accum": 2,
                                     "train.eval_every": 4})
    assert train_mod.train(cfg, device="cpu").step == 4


def test_profile_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    train_mod.main(["--preset", "pong64", "--steps", "2", "--device", "cpu",
                    "--profile", str(tmp_path / "prof"), "--override",
                    *SMALL_ARGS, "data.dataset=synthetic_dots",
                    "train.log_every=1"])
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


# --- checkpoints ----------------------------------------------------------------

def test_checkpoint_manager_keeps_max_to_keep_and_ignores_tmp(tmp_path):
    state = init_state(_dots("unused", 1), "cpu")
    mgr = ckpt.make_manager(str(tmp_path / "m"), max_to_keep=2)
    assert mgr.latest_step() is None
    assert ckpt.restore_latest(mgr, state) == (None, state)
    for step in (3, 10, 7):
        state.step = step
        ckpt.save(mgr, step, state, "pong64")
    assert mgr.all_steps() == [7, 10]
    # a crash inside a save leaves only a .tmp, which is not a step
    (tmp_path / "m" / "12.pt.tmp").write_bytes(b"half a file")
    assert mgr.latest_step() == 10
    payload = torch.load(mgr.path(10), weights_only=True)
    assert payload["format"] == ckpt.FORMAT and payload["step"] == 10
    assert payload["preset"] == "pong64"
    assert set(payload) == {"format", "step", "preset", "state_dict",
                            "optimizer"}
    fresh = init_state(_dots("unused", 1), "cpu")
    step, restored = ckpt.restore_latest(mgr, fresh)
    assert step == 10 and restored is fresh and fresh.step == 10


def test_load_checkpoint_of_a_trainer_directory(tmp_path):
    state = train_mod.train(_dots(str(tmp_path), 8), device="cpu")
    sd = ckpt.load_checkpoint(str(tmp_path / "pong64"))
    assert sd.keys() == state.model.state_dict().keys()
    for k, v in state.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert ckpt.load_checkpoint(str(tmp_path / "pong64" / "8.pt")).keys() \
        == sd.keys()
    torch.save(sd, tmp_path / "sd.pt")                  # a plain state dict
    assert ckpt.load_checkpoint(str(tmp_path / "sd.pt")).keys() == sd.keys()
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "pong64_best" / "x"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ckpt.load_checkpoint(str(tmp_path / "empty"))


def test_logger_writes_null_for_non_finite(tmp_path):
    from keypoints_tpu_torch.viz import Logger
    log = Logger(str(tmp_path / "l"))
    log.scalars(3, a=1.5, b=float("nan"), c=float("inf"))
    log.close()
    assert json.loads((tmp_path / "l" / "metrics.jsonl").read_text()) == \
        {"step": 3, "a": 1.5, "b": None, "c": None}
    Logger(None).scalars(1, a=1.0)                      # a no-op
