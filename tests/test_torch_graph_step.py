"""The train step split for CUDA graphs (``training.TrainStep``,
``make_graphed_train_step``) on the CPU, and the graph on the card.

The step's draws now come from persistent generators, reseeded before each
step: they must draw exactly what the fresh generators of
``training.step_generator`` and ``parallel.dp.shard_generator`` draw, for
the warp draws and for the in-step sources. The refactored eager step is
held to the committed JAX references (no JAX needed: the references are
files). The ``cuda`` tests hold a small config's graphed step to its eager
step bit for bit, for both pair modes, a streamed source, the VGG-19
perceptual loss and celeba128 at the benchmark's paper widths (whose eager
step folds each of its 23 conv biases into the GroupNorm + ReLU kernels),
and the
data-parallel step's graphs to the eager DP step: one NCCL rank in this
process and two gloo ranks on the card in subprocesses, each two graphs
around an eager all-reduce; they skip here and
run on the card with ``--noconftest``.
"""

import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from keypoints_tpu_torch import train as train_mod
from keypoints_tpu_torch.checkpoint import (load_model_state,
                                            load_optimizer_state,
                                            state_dict_from_flax)
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.data.augment import draw_pair, pair_from_draws
from keypoints_tpu_torch.data.records import FrameStore, episode_pairs
from keypoints_tpu_torch.kernels import group_norm_cuda, pool_cuda
from keypoints_tpu_torch.parallel import dp
from keypoints_tpu_torch.testing import (GROUP_NORM_BLOCKS,
                                         grad_norm_tolerance,
                                         random_flax_params, random_images,
                                         reference_draws, share_cpu_threads)
from keypoints_tpu_torch.training import (TrainStep, init_state,
                                          make_graphed_train_step,
                                          make_train_step, step_generator,
                                          warp_config)

share_cpu_threads()

DATA = Path(__file__).parent / "data"
ROOT = Path(__file__).resolve().parent.parent
SMALL = {"model.encoder_filters": (8, 16), "model.encoder_strides": (2, 2),
         "model.decoder_filters": (16, 8),
         "model.decoder_upsample": (True, True), "model.groups": 4,
         "data.image_size": 32, "train.batch_size": 4,
         "train.compute_dtype": "float32"}
# docs/PARITY.md's train bars, as chip_smoke.py holds the card to them
TRAIN_RTOL = 1e-4
TRAIN_KP_TOL = 1e-4
# the celeba128_vgg19 configuration's taps (portbench/configs)
VGG19_TAPS = ("vgg19/input", "vgg19/relu1_2", "vgg19/relu2_2",
              "vgg19/relu3_2", "vgg19/relu4_2", "vgg19/relu5_2")
# celeba128's paper widths, as the benchmark's configuration runs them
PAPER = {k: tuple(v) for k, v in json.loads(
    (ROOT / "portbench" / "configs" / "celeba128.json").read_text()
)["overrides"].items() if k.startswith("model.")}


def _small(preset="pong64", **over):
    return get_config(preset).override(**{**SMALL, **over})


def _store(tmp_path):
    frames = (np.random.RandomState(0).rand(64, 1, 32, 32) * 255).astype(
        np.uint8)
    path = tmp_path / "data" / "atari_32.npy"
    FrameStore.write(str(path), frames, episode_pairs([32, 32], 2))
    return str(tmp_path / "data")


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("seed", [0, 5])
def test_warp_draws_equal_a_fresh_step_generator(seed):
    """prepare() reseeds one persistent generator: step after step it draws
    the warps and factors ``step_generator(seed, step)`` draws, and
    compute() leaves the step count to the caller."""
    cfg = _small("celeba128", **{"train.seed": seed,
                                 "data.dataset": "synthetic_dots"})
    state = init_state(cfg, "cpu")
    step = make_train_step(cfg)
    assert isinstance(step, TrainStep)
    shape, wcfg = (4, 3, 32, 32), warp_config(cfg)
    gens = set()
    for i in range(4):
        state.step = i
        step.prepare(state)
        gens.add(id(step.generator))
        got = draw_pair(step.generator, shape, wcfg)
        want = draw_pair(step_generator(seed, i, "cpu"), shape, wcfg)
        assert _equal(got, want), i
    assert len(gens) == 1
    images = torch.from_numpy(random_images(4, cfg, 1))
    step.prepare(state)
    step.compute(state, images)
    assert state.step == 3


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 1)])
@pytest.mark.parametrize("source", ["synthetic_pong", "synthetic_dots",
                                    "resident"])
def test_in_step_sources_draw_what_fresh_generators_draw(source, world,
                                                         rank, tmp_path):
    """``generator_at(i)`` reseeds the source's one generator; its batch i
    equals ``sample`` on a fresh ``shard_generator(seed + salt, i)``."""
    if source == "resident":
        cfg = _small("transporter_atari",
                     **{"data.data_dir": _store(tmp_path)})
    else:
        cfg = _small(**{"data.dataset": source})
    src = train_mod.make_batch_iterator(cfg, device="cpu")
    assert isinstance(src, train_mod.InStepBatches)
    src.rank, src.world = rank, world
    for i in (0, 1, 7):
        gen = src.generator_at(i)
        assert gen is src.generator_at(i + 1)
        got = src.sample_at(i)
        want = src.sample(dp.shard_generator(
            cfg.train.seed + src._key_salt, i, rank, world, "cpu"), src.batch)
        assert _equal(got, want), i


def test_dp_step_draws_are_the_rank_generators():
    """A DP step's warp draws are ``shard_generator``'s of its rank."""
    cfg = _small("celeba128", **{"data.dataset": "synthetic_dots"})
    step = make_train_step(cfg)
    step.rank, step.world = 1, 3
    state = init_state(cfg, "cpu")
    state.step = 2
    step.prepare(state)
    shape = (4, 3, 32, 32)
    assert _equal(draw_pair(step.generator, shape, warp_config(cfg)),
                  draw_pair(dp.shard_generator(cfg.train.seed, 2, 1, 3,
                                               "cpu"), shape,
                            warp_config(cfg)))


def test_diversity_anneal_is_a_tensor_the_step_fills():
    cfg = _small(**{"data.dataset": "synthetic_dots",
                    "train.keypoint_diversity": 0.05,
                    "train.diversity_steps": 4})
    state = init_state(cfg, "cpu")
    step = make_train_step(cfg)
    scales = []
    for i in range(6):
        state.step = i
        step.prepare(state)
        scales.append(step.lam_scale.item())
    assert scales == [1.0, 0.75, 0.5, 0.25, 0.0, 0.0]


def _reference_steps(ref, cfg, batch_fn, draws=None):
    """3 f32 steps of the port's eager step on the CPU from the reference's
    params: → step-1 keypoints, losses, grad norms, per-parameter
    gradient norms after step 1."""
    state = init_state(cfg, "cpu")
    load_model_state(state.model, state_dict_from_flax(
        random_flax_params(cfg, ref["param_seed"])))
    src, tgt = batch_fn(0)
    with torch.no_grad():
        kp = state.model(src, tgt)[1].numpy()
    step = make_train_step(cfg)
    losses, norms, grads = [], [], {}
    for i in range(3):
        state, m = step(state, batch_fn(i, raw=True),
                        None if draws is None else draws[i])
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i == 0:
            grads = {k: p.grad.norm().item()
                     for k, p in state.model.named_parameters()}
    return kp, losses, norms, grads


def _check_reference(got, want):
    kp, losses, norms, grads = got
    assert np.abs(kp - np.asarray(want["keypoints"])).max() <= TRAIN_KP_TOL
    np.testing.assert_allclose(losses, want["loss"], rtol=TRAIN_RTOL)
    np.testing.assert_allclose(norms, want["grad_norm"], rtol=TRAIN_RTOL)
    assert grads.keys() == want["grad_norms"].keys()
    for k, v in want["grad_norms"].items():
        assert abs(grads[k] - v) <= grad_norm_tolerance(
            v, want["grad_norm"][0]), k


def test_eager_step_meets_the_committed_celeba128_reference():
    """Full-width celeba128, f32, b2, 3 steps on JAX's draws."""
    ref = json.loads((DATA / "torch_port_celeba128_train.json").read_text())
    cfg = get_config(ref["preset"]).override(**ref["overrides"])
    images = torch.from_numpy(random_images(ref["batch"], cfg,
                                            ref["image_seed"]))
    draws = reference_draws(ref, "cpu")

    def batch(i, raw=False):
        return images if raw else pair_from_draws(images, draws[0],
                                                  warp_config(cfg))
    _check_reference(_reference_steps(ref, cfg, batch, draws), ref)


@pytest.mark.parametrize("variant", ["marginal", "joint"])
def test_eager_step_meets_the_committed_transporter_reference(variant):
    """Full-width transporter_atari, f32, b2, 3 temporal steps a variant."""
    ref = json.loads(
        (DATA / "torch_port_transporter_atari_train.json").read_text())
    cfg = get_config(ref["preset"]).override(**{
        **ref["overrides"], "model.softmax_variant": variant})
    pair = tuple(torch.from_numpy(random_images(ref["batch"], cfg, s))
                 for s in ref["image_seeds"])
    _check_reference(_reference_steps(ref, cfg, lambda i, raw=False: pair),
                     ref["runs"][variant])


@pytest.mark.parametrize("store", [False, True])
def test_dry_run_names_the_dispatch(store, tmp_path, capsys):
    over = ({"data.data_dir": _store(tmp_path)} if store
            else {"data.dataset": "synthetic_dots"})
    cfg = _small("transporter_atari" if store else "pong64", **over)
    train_mod.train(cfg, dry_run=True, device="cpu")
    line = capsys.readouterr().out.splitlines()[0]
    assert "1 step/eager dispatch" in line and "dp=False" in line


def test_the_graph_needs_the_card():
    state = init_state(_small(), "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        make_graphed_train_step(_small(), state)


def test_optimizer_state_loads_into_a_capturable_optimizer():
    """A step file's Adam state (host step counts, a float rate) loads into
    an optimizer that keeps its own capturable setting and its rate
    tensor, which takes the saved rate in place."""
    cfg = _small(**{"data.dataset": "synthetic_dots"})
    state = init_state(cfg, "cpu")
    step = make_train_step(cfg)
    src = train_mod.make_batch_iterator(cfg, device="cpu")
    for i in range(2):
        state, _ = step(state, src.sample_at(i))
    saved = state.optimizer.state_dict()
    assert not saved["param_groups"][0]["capturable"]
    params = list(init_state(cfg, "cpu").model.parameters())
    rate = torch.zeros(())
    capturable = torch.optim.Adam(params, lr=rate, capturable=True)
    load_optimizer_state(capturable, saved)
    group = capturable.param_groups[0]
    assert group["capturable"] and group["lr"] is rate
    assert rate.item() == pytest.approx(saved["param_groups"][0]["lr"])
    for p, s in zip(params, saved["state"].values()):
        got = capturable.state[p]
        assert got["step"].dtype == torch.float32
        assert got["step"].item() == s["step"].item() == 2
        assert torch.equal(got["exp_avg"], s["exp_avg"])
    with pytest.raises(ValueError, match="parameter groups"):
        load_optimizer_state(capturable, {**saved, "param_groups": []})


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph runs only on the GPU")
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield torch.device("cuda")
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = flags


def _layouts_kept(state):
    """The parameters and their gradients stay NCHW-contiguous (the nets'
    activations alone go channels_last on the card); under a gradient
    bucket every gradient is still a view of its buffer."""
    flat = state.bucket.flat if state.bucket is not None else None
    for p in state.model.parameters():
        assert p.is_contiguous() and p.grad is not None
        assert p.grad.is_contiguous()
        if flat is not None:
            assert (p.grad.untyped_storage().data_ptr()
                    == flat.untyped_storage().data_ptr())


def _states_equal(a, b):
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict()["state"], \
        b.optimizer.state_dict()["state"]
    for i, s in sa.items():
        for k, v in s.items():
            assert torch.equal(v, sb[i][k]), (i, k)
    assert a.step == b.step


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["warp", "temporal", "stream", "perceptual",
                                  "paper"])
def test_graphed_step_equals_the_eager_step_bit_for_bit(case, cuda,
                                                        tmp_path,
                                                        monkeypatch):
    """1 eager + 4 replayed steps equal 5 eager steps: every parameter,
    Adam's state and each step's metrics. ``perceptual``: the VGG-19
    perceptual loss in bf16 (the frozen trunk, its K6 pools forward and
    backward) inside the graph; ``paper``: celeba128 at the benchmark's
    paper widths in bf16 (at 32², batch 4). The nets run channels_last: the
    NHWC GroupNorm + ReLU pair and never the NCHW one, each launch with its
    block's conv bias, the parameters and their gradients NCHW."""
    pools = (pool_cuda.launches, pool_cuda.bwd_launches)
    norms = (group_norm_cuda.launches, group_norm_cuda.nhwc_launches,
             group_norm_cuda.bias_folds)
    if case == "warp":
        cfg = _small("celeba128", **{"data.dataset": "synthetic_dots"})
    elif case == "paper":
        cfg = _small("celeba128", **{**PAPER, "model.groups": 8,
                                     "data.dataset": "synthetic_dots",
                                     "train.compute_dtype": "bfloat16"})
    elif case == "perceptual":
        cfg = _small("celeba128", **{
            "data.dataset": "synthetic_dots", "train.loss": "perceptual",
            "train.perceptual_layers": VGG19_TAPS,
            "train.compute_dtype": "bfloat16",
            "data.data_dir": str(tmp_path)})
    elif case == "temporal":
        cfg = _small(**{"data.dataset": "synthetic_pong"})
    else:
        monkeypatch.setattr(train_mod, "fits_in_memory", lambda *a, **k:
                            False)
        cfg = _small("transporter_atari",
                     **{"data.data_dir": _store(tmp_path)})
    sources = [train_mod.make_batch_iterator(cfg, device="cuda")
               for _ in range(2)]
    in_step = isinstance(sources[0], train_mod.InStepBatches)
    assert in_step == (case != "stream")
    eager, graphed = init_state(cfg, "cuda"), init_state(cfg, "cuda")
    loss = train_mod.make_loss(cfg, "cuda")
    assert (loss is None) == (case != "perceptual")
    step = make_train_step(cfg, loss=loss)
    graph_step = make_graphed_train_step(
        cfg, graphed, source=sources[1] if in_step else None, loss=loss)
    stream = None if in_step else iter(sources[1])
    for i, batch in enumerate(itertools.islice(
            sources[0] if not in_step else (sources[0].sample_at(j)
                                            for j in itertools.count()), 5)):
        eager, want = step(eager, batch)
        if i == 0:
            first_folds = group_norm_cuda.bias_folds - norms[2]
        graphed, got = (graph_step(graphed) if in_step
                        else graph_step(graphed, next(stream)))
        assert torch.equal(want["loss"], got["loss"]), i
        assert torch.equal(want["grad_norm"], got["grad_norm"]), i
    assert len(graph_step.graphs) == 1
    _states_equal(eager, graphed)
    assert group_norm_cuda.launches == norms[0]
    assert group_norm_cuda.nhwc_launches > norms[1]
    assert (group_norm_cuda.bias_folds - norms[2]
            == group_norm_cuda.nhwc_launches - norms[1])
    if case == "paper":
        assert first_folds == sum(GROUP_NORM_BLOCKS.values()) == 23
    _layouts_kept(eager)
    _layouts_kept(graphed)
    # 6 eager steps and the capture went through K6 (a replay calls no
    # wrapper), four pools forward twice and backward once a step
    if case == "perceptual":
        assert (pool_cuda.launches - pools[0],
                pool_cuda.bwd_launches - pools[1]) == (7 * 8, 7 * 4)


def _run_steps(state, fn, n):
    """``n`` calls of ``fn`` → each step's metrics, cloned."""
    out = []
    for _ in range(n):
        state, m = fn(state)
        out.append({k: v.clone() for k, v in m.items()})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["warp", "temporal"])
def test_graphed_dp_step_equals_the_eager_dp_step_bit_for_bit(case, cuda,
                                                              tmp_path):
    """A one-rank NCCL group: 1 eager + 4 replayed DP steps, two graphs
    around the eager all-reduce, equal 5 eager DP steps and 5 graphed
    single-process steps: every parameter, Adam's state and each step's
    metrics."""
    import torch.distributed as dist
    cfg = _small("celeba128" if case == "warp" else "pong64",
                 **{"data.dataset": ("synthetic_dots" if case == "warp"
                                     else "synthetic_pong")})
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        group = dist.group.WORLD
        sources = [train_mod.make_batch_iterator(cfg, device="cuda")
                   for _ in range(3)]
        states = [init_state(cfg, "cuda") for _ in range(3)]
        eager = make_train_step(cfg, group=group)
        dp_graph = make_graphed_train_step(cfg, states[1], source=sources[1],
                                           group=group)
        bare_graph = make_graphed_train_step(cfg, states[2],
                                             source=sources[2])
        runs = [_run_steps(states[0], lambda st: eager(
                    st, sources[0].sample_at(st.step)), 5),
                _run_steps(states[1], dp_graph, 5),
                _run_steps(states[2], bare_graph, 5)]
        assert len(dp_graph.graphs) == 2 and len(bare_graph.graphs) == 1
        assert "around an eager nccl all-reduce" in dp_graph.dispatch
        for other, state in zip(runs[1:], states[1:]):
            for want, got in zip(runs[0], other):
                assert all(torch.equal(want[k], got[k]) for k in want)
            _states_equal(states[0], state)
        assert states[1].bucket is not None and states[2].bucket is None
        for state in states:
            _layouts_kept(state)
    finally:
        dist.destroy_process_group()


GLOO_RANK = r'''
import sys
import torch
import torch.distributed as dist
rank, out = int(sys.argv[1]), sys.argv[2]
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
dist.init_process_group("gloo", init_method="file://" + out + "/store",
                        rank=rank, world_size=2)
from keypoints_tpu_torch import train as train_mod
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.parallel import dp
from keypoints_tpu_torch.training import (init_state, make_graphed_train_step,
                                          make_train_step)
cfg = get_config("pong64").override(**__SMALL__)
res = {}
for kind in ("eager", "graph"):
    source = train_mod.make_batch_iterator(cfg, device="cuda")
    state = init_state(cfg, "cuda")
    dp.replicate(state.model, state.optimizer)
    if kind == "graph":
        step = make_graphed_train_step(cfg, state, source=source,
                                       group=dist.group.WORLD)
        fn = step
    else:
        step = make_train_step(cfg, group=dist.group.WORLD)
        fn = lambda st: step(st, source.sample_at(st.step))
    metrics = []
    for _ in range(5):
        state, m = fn(state)
        metrics.append({k: v.cpu() for k, v in m.items()})
    if kind == "graph":
        res["graphs"], res["dispatch"] = len(step.graphs), step.dispatch
    res[kind] = {"metrics": metrics,
                 "model": {k: v.cpu() for k, v in
                           state.model.state_dict().items()},
                 "adam": {i: {k: v.cpu() for k, v in s.items()} for i, s in
                          state.optimizer.state_dict()["state"].items()}}
torch.save(res, out + "/" + str(rank) + ".pt")
dist.destroy_process_group()
'''


def _nested_equal(a, b, what=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _nested_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _nested_equal(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


@pytest.mark.cuda
def test_two_gloo_ranks_graphed_equal_two_eager_gloo_ranks(cuda, tmp_path):
    """Two gloo ranks sharing the card, each 1 eager + 4 replays of two
    graphs around the eager all-reduce against 5 eager DP steps: equal
    bits in every parameter, Adam moment and metric, and the ranks
    equal."""
    script = tmp_path / "rank.py"
    script.write_text(GLOO_RANK.replace("__SMALL__", repr(
        {**SMALL, "data.dataset": "synthetic_pong"})))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp_path)], cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    ranks = [torch.load(tmp_path / f"{r}.pt", weights_only=False)
             for r in range(2)]
    for res in ranks:
        assert res["graphs"] == 2
        assert res["dispatch"] == ("2 CUDA graphs/step around an eager "
                                   "gloo all-reduce")
        _nested_equal(res["eager"], res["graph"], "graph vs eager")
    _nested_equal(ranks[0]["graph"], ranks[1]["graph"], "rank 1 vs rank 0")
