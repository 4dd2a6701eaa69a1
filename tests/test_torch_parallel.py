"""The port's data parallelism (``keypoints_tpu_torch.parallel.dp``) on the CPU.

Two gloo ranks, each a subprocess that imports no JAX (one thread each,
``init_method="file://..."`` so parallel test workers never race for a
port), run every multi-rank case once and write what they saw; the tests
read it (a module fixture):

* the world-2 DP step against one process on all 16 temporal pairs, and
  against JAX's ``make_dp_train_step`` on 8 virtual devices (loss,
  ``grad_norm`` and the averaged gradients on the same numpy params);
* the persistent gradient bucket (``dp.GradBucket``): the gradients its
  views, never rebound; the step through it against the per-call bucket
  it replaced (``all_reduce_mean`` below) and against the split step
  (``compute_grads``, the eager all-reduce, ``apply``) that the gloo CUDA
  graphs replay, bit for bit, at world 2 and at world 1;
* the ranks' warp draws (distinct), and their parameters (equal bits);
* resume at world 2, bit for bit, over a synthetic source and a host
  stream, with rank 0 the only rank that writes; a single process's
  checkpoint resumed by the group, and the group's by a single process.

Narrow widths: ``encoder_filters=(8, 16)``, 32², float32.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from keypoints_tpu.configs import get_config as jax_get_config
from keypoints_tpu.parallel import (data_parallel_mesh as jax_mesh,
                                    make_dp_extract as jax_dp_extract,
                                    make_dp_train_step as jax_dp_step,
                                    replicate as jax_replicate,
                                    shard_batch as jax_shard_batch)
from keypoints_tpu.training import TrainState as JaxTrainState
from keypoints_tpu_torch import checkpoint as ckpt
from keypoints_tpu_torch import train as train_mod
from keypoints_tpu_torch.checkpoint import (load_model_state,
                                            state_dict_from_flax)
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.data.augment import draw_pair
from keypoints_tpu_torch.parallel import dp
from keypoints_tpu_torch.serve import (BatchingExtractor, make_live_extract,
                                       serving_devices)
from keypoints_tpu_torch.testing import (NOISE_GRADIENT, random_flax_params,
                                         random_images, share_cpu_threads)
from keypoints_tpu_torch.training import (init_state, make_schedule,
                                          make_train_step, step_generator,
                                          warp_config)

share_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
# celeba128 at narrow widths, 16 temporal pairs; warmup 1 so steps 2-3 move
NARROW = {"model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
          "model.decoder_filters": (16, 8),
          "model.decoder_upsample": (True, True), "model.groups": 4,
          "model.num_keypoints": 4, "data.image_size": 32,
          "train.compute_dtype": "float32"}
TEMPORAL = {**NARROW, "data.pair_mode": "temporal", "train.batch_size": 16,
            "train.warmup_steps": 1}
DP_STEPS = 3
# pong64 at narrow widths for the loop: b4 (2 rows a rank), every cadence
# at 3 steps (checkpoints, logs, the spread check and best-checkpoint
# scoring all run under the group)
LOOP = {"model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
        "model.decoder_filters": (16, 8),
        "model.decoder_upsample": (True, True), "model.groups": 4,
        "data.image_size": 32, "train.batch_size": 4,
        "train.compute_dtype": "float32", "train.log_every": 3,
        "train.eval_every": 3, "train.checkpoint_every": 3}
SOURCES = {"synthetic": ("pong64", {"data.dataset": "synthetic_dots",
                                    "data.pair_mode": "warp"}),
           "stream": ("transporter_atari", {"data.loader_workers": 2})}

WORKER = r'''
import builtins, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
sys.modules["torch.utils.tensorboard"] = None   # metrics.jsonl alone
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + out + "/store",
                        rank=rank, world_size=world)
from keypoints_tpu_torch import train as train_mod, training
from keypoints_tpu_torch.checkpoint import (load_model_state,
                                            state_dict_from_flax)
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.data import device as dev
from keypoints_tpu_torch.data.records import FrameStore, episode_pairs
from keypoints_tpu_torch.parallel import dp
from keypoints_tpu_torch.testing import random_flax_params, random_images

TEMPORAL, NARROW, LOOP, SOURCES, DP_STEPS = __CONSTANTS__
res = {}

# the DP step on this rank's 8 of the 16 temporal pairs
cfg = get_config("celeba128").override(**TEMPORAL)
state = training.init_state(cfg, "cpu")
load_model_state(state.model, state_dict_from_flax(random_flax_params(cfg, 0)))
dp.replicate(state.model, state.optimizer)
step = dp.make_dp_train_step(cfg, dist.group.WORLD)
pair = (torch.from_numpy(random_images(16, cfg, 1)),
        torch.from_numpy(random_images(16, cfg, 2)))
batch = dp.shard_batch(pair, rank, world)
for i in range(DP_STEPS):
    state, m = step(state, batch)
    res[f"loss{i}"], res[f"grad_norm{i}"] = m["loss"], m["grad_norm"]
    if i == 0:
        res["grads"] = {k: p.grad.clone()
                        for k, p in state.model.named_parameters()}
res["params"] = state.model.state_dict()

# the bucket: 3 steps through it (its views' addresses after each), through
# the per-call bucket it replaced, and split as the gloo graphs split it
def all_reduce_mean(params, loss, group):
    params = list(params)
    bucket = torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
        for p in params] + [loss.detach().reshape(1).float()])
    dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=group)
    bucket.div_(dist.get_world_size(group))
    offset = 0
    for p in params:
        if p.grad is not None:
            p.grad = bucket[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return bucket[-1]

def split_step(step, state, batch):
    step.prepare(state)
    value = step.compute_grads(state, batch)
    state.bucket.put_loss(value)
    state.bucket.all_reduce(dist.group.WORLD)
    metrics = step.apply(state, state.bucket.mean(dist.group.WORLD))
    state.step += 1
    return state, metrics

res["bucket"] = {}
for kind in ("bucket", "per_call", "split"):
    state = training.init_state(cfg, "cpu")
    load_model_state(state.model,
                     state_dict_from_flax(random_flax_params(cfg, 0)))
    dp.replicate(state.model, state.optimizer)
    step = dp.make_dp_train_step(cfg, dist.group.WORLD)
    if kind == "per_call":
        step.reduce = lambda state, value: all_reduce_mean(
            state.model.parameters(), value, dist.group.WORLD)
    run = {"metrics": [], "grads": [], "ptrs": [], "in_bucket": []}
    for i in range(DP_STEPS):
        if kind == "split" and i:
            state, m = split_step(step, state, batch)
        else:
            state, m = step(state, batch)
        run["metrics"].append({k: v.clone() for k, v in m.items()})
        run["grads"].append({k: p.grad.clone()
                             for k, p in state.model.named_parameters()})
        run["ptrs"].append([p.grad.data_ptr()
                            for p in state.model.parameters()])
        if state.bucket is not None:
            base = state.bucket.flat.untyped_storage().data_ptr()
            run["in_bucket"].append(all(
                p.grad.untyped_storage().data_ptr() == base
                for p in state.model.parameters()))
    run["params"] = state.model.state_dict()
    res["bucket"][kind] = run

# warp mode: the same images on both ranks, the draws each rank's step made
drawn = []
real_draw = training.draw_pair
training.draw_pair = lambda *a, **k: drawn.append(real_draw(*a, **k)) or drawn[-1]
cfg = get_config("celeba128").override(**{**NARROW, "train.batch_size": 4})
state = training.init_state(cfg, "cpu")
step = dp.make_dp_train_step(cfg, dist.group.WORLD)
state, _ = step(state, torch.from_numpy(random_images(2, cfg, 3)))
training.draw_pair = real_draw
res["warp_source"] = drawn[0].source

# the loop at world 2; what each rank writes while it runs
frames = (np.random.RandomState(0).rand(64, 1, 32, 32) * 255).astype(np.uint8)
if rank == 0:
    os.makedirs(out + "/data", exist_ok=True)
    FrameStore.write(out + "/data/atari_32.npy", frames,
                     episode_pairs([32, 32], 2))
dist.barrier()
dev.device_memory_budget = lambda *a, **k: 0     # the store streams
written, real_save, real_open = [], torch.save, builtins.open

def save(obj, f, *a, **k):
    written.append(str(f))
    return real_save(obj, f, *a, **k)

def opener(file, mode="r", *a, **k):
    if set(mode) & set("wax+"):
        written.append(str(file))
    return real_open(file, mode, *a, **k)

torch.save, builtins.open = save, opener

def run(source, ckdir, steps, logdir=None):
    preset, over = SOURCES[source]
    cfg = get_config(preset).override(**{
        **LOOP, **over, "data.data_dir": out + "/data",
        "train.steps": steps, "train.checkpoint_dir": out + "/" + ckdir})
    state = train_mod.train(cfg, logdir, device="cpu")
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(), "step": state.step}

for source in SOURCES:
    res[source + "_full"] = run(source, source + "_full", 6,
                                out + "/" + source + "_logs")
    run(source, source + "_split", 3)
    res[source + "_resumed"] = run(source, source + "_split", 6)
# the group resumes a single process's step-3 checkpoint
res["from_single"] = run("synthetic", "single", 6)
torch.save, builtins.open = real_save, real_open
res["written"] = written
torch.save(res, out + "/" + str(rank) + ".pt")
dist.destroy_process_group()
'''


def _loop_cfg(source: str, out: Path, ckdir: str, steps: int):
    preset, over = SOURCES[source]
    return get_config(preset).override(**{
        **LOOP, **over, "data.data_dir": str(out / "data"),
        "train.steps": steps, "train.checkpoint_dir": str(out / ckdir)})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (``WORKER``), after a single process trained
    the step-3 checkpoint the group resumes."""
    out = tmp_path_factory.mktemp("dp")
    train_mod.train(_loop_cfg("synthetic", out, "single", 3), device="cpu")
    script = out / "worker.py"
    script.write_text(WORKER.replace("__CONSTANTS__", repr(
        (TEMPORAL, NARROW, LOOP, SOURCES, DP_STEPS))))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(WORLD), str(out)], cwd=out, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return out, [torch.load(out / f"{r}.pt", weights_only=False)
                 for r in range(WORLD)], logs


def _assert_equal(a, b, what: str = ""):
    """Two nested results equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


def test_ranks_hold_equal_parameters(ranks):
    _, (r0, r1), _ = ranks
    for key in ("params", "grads", "synthetic_full", "stream_full",
                "from_single"):
        _assert_equal(r0[key], r1[key], key)
    for i in range(DP_STEPS):
        assert r0[f"loss{i}"] == r1[f"loss{i}"]
        assert r0[f"grad_norm{i}"] == r1[f"grad_norm{i}"]


def test_dp_step_matches_one_process(ranks):
    """World 2 on 8 pairs a rank against one process on all 16: loss within
    1e-5 relative each step, parameters within 1e-4 relative + 2e-5 after
    3 steps (``NOISE_GRADIENT`` within the learning rates' sum), JAX's bars
    for its own DP step."""
    _, (r0, _), _ = ranks
    cfg = get_config("celeba128").override(**TEMPORAL)
    state = init_state(cfg, "cpu")
    load_model_state(state.model, state_dict_from_flax(
        random_flax_params(cfg, 0)))
    step = make_train_step(cfg)
    pair = (torch.from_numpy(random_images(16, cfg, 1)),
            torch.from_numpy(random_images(16, cfg, 2)))
    for i in range(DP_STEPS):
        state, metrics = step(state, pair)
        assert r0[f"loss{i}"].item() == pytest.approx(
            metrics["loss"].item(), rel=1e-5)
    lr_sum = sum(make_schedule(cfg)(i) for i in range(DP_STEPS))
    for name, p in state.model.state_dict().items():
        if name in NOISE_GRADIENT:
            np.testing.assert_allclose(r0["params"][name], p, rtol=0,
                                       atol=2 * lr_sum, err_msg=name)
        else:
            np.testing.assert_allclose(r0["params"][name], p, rtol=1e-4,
                                       atol=2e-5, err_msg=name)


def test_dp_step_matches_jax_dp_on_eight_devices(ranks):
    """JAX's ``make_dp_train_step`` over the 8 virtual devices against the
    port's world 2, one step on the same params and pairs: loss and
    grad_norm within 1e-5 relative, each averaged gradient within 2e-5
    (``tests/test_torch_train.py``'s bars). JAX's gradients come out of a
    transformation that keeps them as its state and moves nothing."""
    _, (r0, _), _ = ranks
    jcfg = jax_get_config("celeba128").override(**TEMPORAL)
    cfg = get_config("celeba128").override(**TEMPORAL)
    params = random_flax_params(cfg, 0)
    mesh = jax_mesh()
    assert mesh.devices.size == 8
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa: E731
    keep = optax.GradientTransformation(lambda p: zeros(p),
                                        lambda g, s, p=None: (zeros(g), g))
    state = jax_replicate(mesh, JaxTrainState(jnp.zeros((), jnp.int32),
                                              params, keep.init(params)))
    batch = jax_shard_batch(mesh, (jnp.asarray(random_images(16, cfg, 1)),
                                   jnp.asarray(random_images(16, cfg, 2))))
    state, metrics = jax_dp_step(jcfg, mesh, tx=keep)(
        state, batch, jax.random.PRNGKey(0))
    assert r0["loss0"].item() == pytest.approx(float(metrics["loss"]),
                                               rel=1e-5)
    assert r0["grad_norm0"].item() == pytest.approx(
        float(metrics["grad_norm"]), rel=1e-5)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                       state.opt_state))
    assert set(want) == set(r0["grads"])
    for name, grad in want.items():
        np.testing.assert_allclose(r0["grads"][name].numpy(), grad, rtol=0,
                                   atol=2e-5, err_msg=name)


def test_gradients_are_views_of_one_persistent_bucket(ranks):
    """After each world-2 DP step every ``.grad`` lies in the bucket, at
    the address it had after the first step."""
    _, results, _ = ranks
    for r in results:
        run = r["bucket"]["bucket"]
        assert run["in_bucket"] == [True] * DP_STEPS
        assert run["ptrs"][1:] == run["ptrs"][:-1]
    per_call = results[0]["bucket"]["per_call"]
    assert per_call["in_bucket"] == []
    assert per_call["ptrs"][0] != per_call["ptrs"][1]


@pytest.mark.parametrize("kind", ["per_call", "split"])
def test_bucket_step_equals_the_per_call_bucket_and_the_split_step(ranks,
                                                                   kind):
    """The step through the persistent bucket against the per-call bucket
    it replaced (``all_reduce_mean``), and against the split step the
    gloo graphs replay: each step's averaged gradients, loss and
    ``grad_norm``, and the parameters after 3 steps, equal bit for bit on
    both ranks; and the bucket step is the package's DP step."""
    _, results, _ = ranks
    for r in results:
        _assert_equal(r["bucket"]["bucket"]["metrics"],
                      r["bucket"][kind]["metrics"], f"{kind} metrics")
        _assert_equal(r["bucket"]["bucket"]["grads"],
                      r["bucket"][kind]["grads"], f"{kind} grads")
        _assert_equal(r["bucket"]["bucket"]["params"],
                      r["bucket"][kind]["params"], f"{kind} params")
        _assert_equal(r["bucket"]["bucket"]["params"], r["params"], "params")


def test_split_step_equals_the_step_at_world_one(tmp_path):
    """A one-rank gloo group in this process: 3 steps through the bucket
    equal 3 split steps (``compute_grads``, the eager all-reduce,
    ``apply``), and both the single-process step, bit for bit."""
    import torch.distributed as dist
    cfg = get_config("celeba128").override(**TEMPORAL)
    pair = (torch.from_numpy(random_images(8, cfg, 1)),
            torch.from_numpy(random_images(8, cfg, 2)))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        runs = {}
        for kind in ("single", "bucket", "split"):
            state = init_state(cfg, "cpu")
            step = (make_train_step(cfg) if kind == "single"
                    else dp.make_dp_train_step(cfg, dist.group.WORLD))
            metrics = []
            for i in range(DP_STEPS):
                if kind == "split" and i:
                    step.prepare(state)
                    value = step.compute_grads(state, pair)
                    state.bucket.put_loss(value)
                    state.bucket.all_reduce(dist.group.WORLD)
                    m = step.apply(state, state.bucket.mean(dist.group.WORLD))
                    state.step += 1
                else:
                    state, m = step(state, pair)
                metrics.append({k: v.clone() for k, v in m.items()})
            runs[kind] = (metrics, state.model.state_dict(),
                          state.optimizer.state_dict()["state"])
            assert (state.bucket is None) == (kind == "single")
    finally:
        dist.destroy_process_group()
    _assert_equal(runs["bucket"], runs["single"], "bucket")
    _assert_equal(runs["split"], runs["single"], "split")


def test_shard_generator_is_step_generator_at_world_one_and_ranks_differ(
        ranks):
    for seed, step in ((0, 0), (5, 17)):
        a = dp.shard_generator(seed, step, 0, 1, "cpu")
        b = step_generator(seed, step, "cpu")
        assert torch.equal(torch.rand(64, generator=a),
                           torch.rand(64, generator=b))
    _, (r0, r1), _ = ranks
    cfg = get_config("celeba128").override(**{**NARROW,
                                              "train.batch_size": 4})
    single = draw_pair(step_generator(cfg.train.seed, 0, "cpu"),
                       (2, 3, 32, 32), warp_config(cfg)).source
    assert r0["warp_source"].shape == single.shape
    assert not torch.equal(r0["warp_source"], r1["warp_source"])
    assert not torch.equal(r1["warp_source"], single)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_dp_resume_is_bit_exact_and_only_rank_zero_writes(ranks, source):
    """train(6) == train(3) + a resumed train(3) at world 2, in every
    tensor of the model and the optimizer; rank 1 wrote nothing, rank 0
    its checkpoints, ``best.json`` and ``metrics.jsonl``; the group's
    step-6 checkpoint resumes in one process as the state it saved."""
    out, (r0, r1), logs = ranks
    _assert_equal(r0[f"{source}_full"], r0[f"{source}_resumed"], source)
    assert r0[f"{source}_full"]["step"] == 6
    assert r1["written"] == []
    mine = [os.path.relpath(p, out) for p in r0["written"]]
    preset = SOURCES[source][0]
    assert f"{source}_full/{preset}/6.pt.tmp" in mine
    assert f"{source}_full/{preset}_best/best.json.tmp" in mine
    assert f"{source}_logs/metrics.jsonl" in mine
    rows = [json.loads(r) for r in (out / f"{source}_logs" / "metrics.jsonl")
            .read_text().splitlines()]
    assert [r["step"] for r in rows if "loss" in r] == [3, 6]
    assert "resumed from step 3" in logs[0]
    assert "[rank 1/2] step      6 loss" in logs[1]
    cfg = _loop_cfg(source, out, f"{source}_full", 6)
    one = ckpt.CheckpointManager(str(out / f"{source}_full" / preset)
                                 ).restore(6, init_state(cfg, "cpu"))
    _assert_equal(one.model.state_dict(), r0[f"{source}_full"]["model"])


def test_group_resumes_a_single_process_checkpoint(ranks):
    _, (r0, _), logs = ranks
    assert r0["from_single"]["step"] == 6
    assert logs[0].count("resumed from step 3") == 3


# --- data-parallel serving over CPU replicas ---------------------------------

SERVE = {**NARROW, "model.num_keypoints": 3}


@pytest.fixture(scope="module")
def served():
    cfg = get_config("celeba128").override(**SERVE)
    sd = state_dict_from_flax(random_flax_params(cfg, 0))
    return cfg, sd, dp.make_dp_extract(cfg, sd, (8, 16), ["cpu", "cpu"])


def test_dp_extract_matches_one_device(served):
    """Pad-up, exact bucket and split requests against the one-device
    extract of the same state at the same slab size, within 1e-6."""
    cfg, sd, ext = served
    one = make_live_extract(cfg, sd, (4, 8), "cpu")
    assert ext.max_batch == 16 and ext.meta["data_parallel_devices"] == 2
    rs = np.random.RandomState(11)
    for n in (1, 5, 8, 13, 16, 40):
        images = rs.rand(n, 3, 32, 32).astype(np.float32)
        got = ext(images)
        assert got.shape == (n, 3, 2)
        np.testing.assert_allclose(got, one(images), rtol=0, atol=1e-6)


def test_dp_extract_matches_jax_dp_extract_on_eight_devices(served):
    """The port's two CPU replicas against JAX's ``make_dp_extract`` over
    the 8 virtual devices, the same params and requests (pad-up, exact,
    split), within 1e-4 (``tests/test_torch_serve.py``'s bar against
    JAX's extract)."""
    cfg, _, ext = served
    jcfg = jax_get_config("celeba128").override(**SERVE)
    ref = jax_dp_extract(jcfg, random_flax_params(cfg, 0), (8, 16),
                         jax_mesh())
    assert ref.meta["data_parallel_devices"] == 8
    rs = np.random.RandomState(12)
    for n in (3, 16, 21):
        images = rs.rand(n, 3, 32, 32).astype(np.float32)
        np.testing.assert_allclose(ext(images), np.asarray(ref(images)),
                                   rtol=0, atol=1e-4)


def test_serving_devices(monkeypatch):
    """``--devices N`` takes the first N cards of a bare ``cuda``; ``cpu``
    and an explicit ``cuda:k`` serve on that device alone."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert serving_devices("cuda") == [torch.device("cuda", 0),
                                       torch.device("cuda", 1)]
    assert serving_devices("cuda", 1) == [torch.device("cuda", 0)]
    assert serving_devices("cpu") == serving_devices("cpu", 1) == [
        torch.device("cpu")]
    assert serving_devices("cuda:1") == [torch.device("cuda", 1)]
    for device, n in (("cuda", 3), ("cuda", 0), ("cpu", 2), ("cuda:0", 2)):
        with pytest.raises(SystemExit, match="--devices"):
            serving_devices(device, n)


def test_dp_extract_rejects_bad_buckets(served):
    cfg, sd, _ = served
    with pytest.raises(ValueError, match="not divisible"):
        dp.make_dp_extract(cfg, sd, (6, 5), ["cpu", "cpu"])
    with pytest.raises(ValueError, match="invalid bucket"):
        dp.make_dp_extract(cfg, sd, (), ["cpu", "cpu"])
    with pytest.raises(ValueError, match="input_dtype"):
        dp.make_dp_extract(cfg, sd, (2,), ["cpu", "cpu"], "float16")
    assert dp.make_dp_extract(cfg, sd, (5,), ["cpu"]).max_batch == 5


def test_dp_extract_through_batching_extractor_with_uint8(served):
    """Concurrent requests coalesce into one bucket split over the two
    replicas; uint8 frames are rescaled on the device."""
    import threading

    cfg, sd, ext = served
    u8 = dp.make_dp_extract(cfg, sd, (8, 16), ["cpu", "cpu"], "uint8")
    frames = np.random.RandomState(4).randint(
        0, 256, (6, 3, 32, 32)).astype(np.uint8)
    want = ext(frames.astype(np.float32) / 255.0)
    batcher = BatchingExtractor(u8, u8.max_batch, max_delay_ms=50)
    try:
        got = [None] * 3
        threads = [threading.Thread(
            target=lambda i=i: got.__setitem__(
                i, batcher.extract(frames[2 * i:2 * i + 2])))
            for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    np.testing.assert_allclose(np.concatenate(got), want, rtol=0, atol=1e-6)
