"""The port's process-group bootstrap (``keypoints_tpu_torch.parallel.multihost``).

Single-process semantics with ``torch.distributed`` monkeypatched (the
environment ``torchrun`` sets reaches ``init_process_group``; the rank's
card is made current first), the CLIs' calls, and one real two-rank gloo
group on the CPU (subprocesses that import no JAX, ``init_method=
"file://..."``): the helpers under the group, the trainer's dry run and
its refusals, and each rank's shard of a host stream. The counterpart of
``tests/test_multihost.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from keypoints_tpu_torch import eval as eval_mod
from keypoints_tpu_torch import serve as serve_mod
from keypoints_tpu_torch import train as train_mod
from keypoints_tpu_torch.parallel import multihost
from keypoints_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_group(monkeypatch):
    """No torchrun environment, and ``init_process_group`` must not run."""
    for key in TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("must not be called")))


def test_initialize_is_a_noop_without_a_world(no_group, monkeypatch):
    multihost.initialize()
    monkeypatch.setenv("WORLD_SIZE", "1")
    multihost.initialize()
    assert not dist.is_initialized()


def _recording(monkeypatch, cards: int) -> list:
    """Patch the group's and the card's calls to record them in order."""
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(("init", backend,
                                                            kw)))
    monkeypatch.setattr(dist, "get_rank", lambda *a: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", str(d))))
    return calls


@pytest.mark.parametrize("cards,local_world,backend,want", [
    (0, 2, None, "gloo"),            # no card: gloo on the CPU
    (2, 2, None, "nccl"),            # a card a rank: NCCL
    (1, 2, None, "gloo"),            # two ranks share a card: gloo
    (2, 2, "gloo", "gloo"),          # the CLIs' --device cpu
])
def test_initialize_passes_the_env_and_picks_the_backend(
        monkeypatch, cards, local_world, backend, want):
    for key, value in (("RANK", "1"), ("WORLD_SIZE", "2"),
                       ("LOCAL_RANK", "1"),
                       ("LOCAL_WORLD_SIZE", str(local_world)),
                       ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29511")):
        monkeypatch.setenv(key, value)
    calls = _recording(monkeypatch, cards)
    multihost.initialize(backend)
    card = f"cuda:{1 % cards}" if cards else None
    init = ("init", want,
            {"device_id": torch.device(card) if want == "nccl" else None})
    assert calls == ([("set_device", card)] if cards else []) + [init]


def test_host_shard_and_local_batch_size(no_group, monkeypatch):
    assert multihost.host_shard() == (0, 1)
    assert multihost.local_batch_size(64) == 64
    assert multihost.is_primary()
    multihost.barrier()                   # no group: returns
    monkeypatch.setattr(multihost, "host_shard", lambda: (1, 2))
    assert multihost.local_batch_size(64) == 32
    assert not multihost.is_primary()
    with pytest.raises(ValueError, match="not divisible"):
        multihost.local_batch_size(63)


class _Initialized(Exception):
    pass


@pytest.mark.parametrize("cli,argv", [
    ("train", ["--preset", "pong64", "--dry-run", "--device", "cpu"]),
    ("train", ["--preset", "pong64", "--dry-run"]),
    ("eval", ["--preset", "celeba128", "--checkpoint", "x.pt", "--device",
              "cpu"]),
    ("serve", ["--preset", "celeba128", "--device", "cpu"]),
])
def test_clis_call_initialize_first(monkeypatch, cli, argv):
    """Each CLI joins torchrun's group before it touches a device or a
    file (a recorded call, then a stop), asking for gloo with --device
    cpu."""
    calls = []

    def initialize(backend=None):
        calls.append(backend)
        raise _Initialized

    monkeypatch.setattr(multihost, "initialize", initialize)
    main = {"train": train_mod.main, "eval": eval_mod.main,
            "serve": serve_mod._cli}[cli]
    with pytest.raises(_Initialized):
        main(argv)
    assert calls == ["gloo" if "cpu" in argv else None]


WORKER = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, out = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + out + "/store",
                        rank=rank, world_size=2)
os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
from keypoints_tpu_torch import train as train_mod
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.data import device as dev
from keypoints_tpu_torch.data.records import FrameStore
from keypoints_tpu_torch.parallel import multihost

multihost.initialize()                       # a group exists: no-op
assert multihost.host_shard() == (rank, 2)
assert multihost.local_batch_size(64) == 32
try:
    multihost.local_batch_size(63)
    raise AssertionError("63 rows split over 2 ranks")
except ValueError:
    pass
assert multihost.is_primary() == (rank == 0)
multihost.barrier()
assert multihost.min_max(rank) == (0, 1) and multihost.min_max(7) == (7, 7)

SMALL = ["model.encoder_filters=8,16", "model.encoder_strides=2,2",
         "model.decoder_filters=16,8", "model.decoder_upsample=True,True",
         "model.groups=4", "data.image_size=32",
         "train.compute_dtype=float32", "data.dataset=synthetic_dots"]
train_mod.main(["--preset", "pong64", "--dry-run", "--device", "cpu",
                "--override", *SMALL, "train.batch_size=4"])
for bad in ("train.batch_size=5", "train.data_parallel=False"):
    try:
        train_mod.main(["--preset", "pong64", "--dry-run", "--device", "cpu",
                        "--override", *SMALL, bad])
        raise AssertionError(bad + " was not refused")
    except ValueError as e:
        print("refused", bad, ":", e, flush=True)

# a missing store: rank 0 generates it, once, and rank 1 writes nothing;
# the ranks disagree on whether it fits, and both take the stream
from keypoints_tpu_torch.data import faces, records
generated, stored = [], []
real_generate, real_write = faces.generate_face_store, records.FrameStore.write
faces.generate_face_store = lambda *a, **k: (generated.append(a[0]),
                                             real_generate(*a, **k))[1]
records.FrameStore.write = staticmethod(
    lambda *a, **k: (stored.append(a[0]), real_write(*a, **k))[1])
train_mod.fits_in_memory = lambda *a, **k: rank == 0
cfg = get_config("celeba128").override(**{
    "data.image_size": 32, "data.data_dir": out + "/gen",
    "train.batch_size": 8, "data.loader_workers": 1})
it = train_mod.make_batch_iterator(cfg, device="cpu")
print("GENERATED", rank, len(generated), len(stored), type(it).__name__,
      tuple(next(it).shape), flush=True)
faces.generate_face_store, records.FrameStore.write = (
    real_generate, staticmethod(real_write))
train_mod.fits_in_memory = dev.fits_in_memory

# the ranks restore different steps: both refuse before ``replicate``
from keypoints_tpu_torch import checkpoint as ckpt, training
cfg = get_config("pong64").override(**{
    "model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
    "model.decoder_filters": (16, 8), "model.decoder_upsample": (True, True),
    "model.groups": 4, "data.image_size": 32, "train.batch_size": 4,
    "train.compute_dtype": "float32", "data.dataset": "synthetic_dots",
    "train.steps": 4, "train.checkpoint_dir": out + "/ck"})
ckpt.save(ckpt.make_manager(out + "/ck/pong64"), 3,
          training.init_state(cfg, "cpu"), "pong64")
multihost.barrier()
if rank == 1:
    train_mod.ckpt.restore_latest = lambda mgr, state: (None, state)
try:
    train_mod.train(cfg, device="cpu")
    raise AssertionError("ranks at different steps trained")
except RuntimeError as e:
    print("REFUSED", rank, e, flush=True)

# each rank's shard of a host stream: half the batch, disjoint frames
frames = np.arange(64, dtype=np.uint8)[:, None, None, None] * np.ones(
    (1, 1, 32, 32), np.uint8)
if rank == 0:
    os.makedirs(out + "/data")
    FrameStore.write(out + "/data/celeba_32.npy", np.repeat(frames, 3, 1))
dist.barrier()
dev.device_memory_budget = lambda *a, **k: 0
cfg = get_config("celeba128").override(**{
    "data.image_size": 32, "data.data_dir": out + "/data",
    "train.batch_size": 8, "data.loader_workers": 1})
it = train_mod.make_batch_iterator(cfg, device="cpu")
seen = set()
for _ in range(4):
    batch = next(it)
    assert batch.shape[0] == 4, batch.shape
    seen |= {int(round(float(v) * 255)) for v in batch[:, 0, 0, 0]}
print("SHARD", rank, sorted(seen), flush=True)
dist.destroy_process_group()
'''


def test_two_rank_group(tmp_path):
    """Two real gloo ranks: the helpers answer for the group, the dry run
    reports ``dp=True`` and the world, a batch that does not split and
    ``train.data_parallel=False`` are refused, a missing store is
    generated by rank 0 alone, the ranks take one kind of source when they
    disagree on whether the store fits, ranks that restored different
    steps refuse to train, and the ranks' stream shards are half the batch
    each and disjoint."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp_path)], cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
        assert f"[rank {r}/2] dry run:" in log and "dp=True (2 rank(s))" in log
        assert log.count("refused") == 2 and "not divisible by 2" in log
    assert ('"batch_size": 4' in logs[0]) and ('"batch_size"' not in logs[1])
    shards = [eval(next(line.split(" ", 2)[2] for line in log.splitlines()
                        if line.startswith("SHARD")))
              for log in logs]
    assert shards[0] and shards[1] and not set(shards[0]) & set(shards[1])
    # the missing store: generated and written by rank 0 alone, once;
    # both ranks on the stream though rank 0 alone found that it fits
    assert "GENERATED 0 1 1 generator (4, 3, 32, 32)" in logs[0]
    assert "GENERATED 1 0 0 generator (4, 3, 32, 32)" in logs[1]
    assert sorted(os.listdir(tmp_path / "gen")) == ["celeba_32.npy",
                                                    "celeba_32_meta.json"]
    for r, log in enumerate(logs):
        assert f"REFUSED {r} rank {r} restored step {3 if r == 0 else None}"\
               f"; the ranks restored steps -1 to 3" in log
