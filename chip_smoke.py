#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Drives the ported paths of ``keypoints_tpu_torch`` at full width
through their user entry points, with weights made from a seed: celeba128's
keypoint-serving path (``make_server``) and training step (``init_state`` +
``make_train_step``, b128, bf16, augmentation inside), pose256's training
step (``init_state`` + ``make_train_step(cfg, loss=make_loss(cfg))``, b128,
bf16: 256² augmentation through the field warp, the VGG-16 perceptual loss
with its max pools), and transporter_atari's training step (``init_state``
+ ``make_train_step`` in temporal mode, the preset's b64, bf16, on
scripted-Pong pairs drawn on the card), with the joint soft-argmax and
with the preset's marginal one (the fused bottleneck kernel in both); the
banded warps K7 and K8 through their entry points (``kernels.experimental``)
at celeba128's and pose256's b128 warps; and the eval CLI (``python -m
keypoints_tpu_torch.eval``) of celeba128, pose256 and transporter_atari
(joint) at b64; the train loop (``python -m keypoints_tpu_torch.train`` and
``train()``: transporter_atari on the committed ``data/atari_64.npy``,
pong64 on scripted Pong, celeba128 on a face store it generates) with its
checkpoints and bit-exact resume, its step one CUDA graph a step
(``make_graphed_train_step``, held against the eager step bit for bit in
phase 36), and store-backed eval of its checkpoint;
data parallelism: dp_celeba's step (b256) through ``make_dp_train_step``
in a one-rank NCCL group, eager and graphed (two CUDA graphs a step
around the eager all-reduce, phase 37), the train CLI under ``torchrun``
with two gloo ranks on the card (the same two graphs a step), and the
server on ``--devices 1``, each bucket one CUDA graph (phase 38
holds every serving bucket's graph to its eager answer); the deployment path:
extractors exported with ``torch.export`` (``keypoints_tpu_torch.export``,
K1 as the custom op ``keypoints_tpu_torch::spatial_softmax_fwd``) and
their consumers, ``serve --artifact``, ``eval --artifact --overlay`` and
``video --artifact``; and the tools (``utils.debug``,
``utils.profiling``).

   1. device    torch/CUDA versions, ``nvidia-smi`` name and power limit
   2. build     the one kernel library, every ``csrc/*.cu`` built by nvcc
                (one process per source, in parallel), with ptxas's
                register counts
   3. kernel    the CUDA soft-argmax forward against its plain version:
                both variants, both align_corners, T in {1.0, 0.7}, at
                the presets' N and the warp path's other layouts (H != W,
                1x64, 64x1, ragged widths, an unaligned base)
   4. kernels   the training slice's kernels against their plain versions:
                soft-argmax backward (both variants, both align_corners,
                T in {1.0, 0.7}, the same layouts; two calls, equal bits),
                Gaussian raster
                forward and backward (celeba128's, pose256's and
                transporter_atari's shapes, ragged ones; the backward twice,
                equal bits), bilinear warp K4 (f32 and bf16, zeros and
                border, both align_corners, b128 3x128^2, a ragged case, the
                dense route's b128 3x32^2, the tiles' ragged edges, NaN
                points, points far outside, B = 70,000)
   5. parity    full-width KeyNet in float32 (TF32 off) against the JAX
                keypoints committed in tests/data/torch_port_celeba128_extract.json
   6. serve     ``make_server`` (celeba128, bf16, buckets 1 8 64 256) on a free
                port, then a second one with ``--input-dtype uint8``; HTTP
                requests, concurrent ones included, checked against the same
                model with the plain soft-argmax; the wrappers' counts (a
                bucket's eager warm-up and its capture), K1 once a replayed
                bucket call (torch.profiler)
   7. train     full-width celeba128 in float32 (TF32 off), 3 train steps
     parity     on the warps and jitter factors JAX drew, on the card and on
                the CPU, against tests/data/torch_port_celeba128_train.json
   8. train     full-width celeba128 at b128 in bf16, 30 steps with the
                port's own draws: finite losses, float32 parameters, launch
                counts of the run
   9. times     CUDA-event medians: each kernel at the main paths' shapes
                against its plain version (and F.grid_sample for the dense
                warp), with its bound, the field warp at 3x128^2, K4 also
                on the f32 image; K1 and
                K1b, both variants, at N = 256 16^2, 1,280, 2,048 and
                10,240 32^2 and 1,280 64^2 against bound, plain and their
                launch floor (N = 1, 1x1); extract images/s; train ms/step,
                frames/s
  10. profile   torch.profiler over the extract (b256, b1024, live n=1 and
                n=8) and over 5 train steps: device time against wall time,
                the ops that take the device time, each kernel's share
  11. kernels   the pose256 slice's kernels against their plain versions:
                the field warp (f32 and bf16, zeros and border, b128
                3x256^2 and 3x128^2 at the augmentations' fields, ragged
                cases, F = 2 and F = 512, a zoom that overflows the staging
                budget; bit for bit equal to upsample + K4, staged and with
                direct gathers), the 2x2 max pool forward and
                backward, bit-exact (f32 and bf16, smooth and tied inputs,
                at pose256's VGG-16 pools and the VGG-19 loss's four
                pools at 128^2); the soft-argmax and raster
                kernels, forward and backward, at N = 2,048, sigma 0.05
  12. train     full-width pose256 in float32 (TF32 off), 3 train steps on
     parity     JAX's draws and one seeded VGG file, on the card and on the
                CPU, against tests/data/torch_port_pose256_train.json
  13. train     full-width pose256 at b128 in bf16, 20 steps with the port's
                own draws: finite losses, float32 parameters, launch counts
                of the run, peak device memory
  14. times     the field warp and the pool against bound, plain and
                library (the pool also at the VGG-19 loss's four 128^2
                pools against its bound); the field warp's two designs (staged, direct
                gathers) against upsample + dense warp at 256^2 and 128^2;
                the bottleneck kernels at N = 2,048; the perceptual loss
                alone; train ms/step and frames/s
  15. profile   torch.profiler over 2 pose256 train steps: device time,
                ops, each kernel's share
  16. kernel    the fused bottleneck (K3) against its plain version and its
                autograd: both variants, both align_corners, T in {1.0,
                0.7}, at transporter_atari's b64 16^2, a ragged shape, the
                joint celeba128 and pose256 shapes, 64^2, phase 3's other
                layouts, an unaligned base, maps of 8x4100, 4x13000
                and 3x12400 (tables past 48 KB of shared memory, the
                last from 65x8 heatmaps) and of 7x13, 5x3 and 16x16 (the
                map writing's branches); its keypoints and maps against
                K1 then K2 on the same heatmaps, and against its own maps
                4 bytes past a 16-byte boundary, bit for bit
  17. train     full-width transporter_atari in float32 (TF32 off), 3 train
     parity     steps per variant (marginal, joint) on seeded temporal pairs,
                card and CPU, against
                tests/data/torch_port_transporter_atari_train.json
  18. train     full-width transporter_atari at b64 in bf16, 30 steps on
                scripted-Pong pairs drawn on the card, joint then marginal:
                finite, falling losses, float32 parameters, launches per step
  19. times     K3 against K1 + K2 back to back, the plain version and the
                bound at the three shapes, both variants; K2 alone at N =
                256 16^2 and its launch floor at N = 1, 1x1; the transporter
                step's ms/step and pairs/s per variant; torch.profiler over
                its steps: device time, ops, each kernel's share
  20. kernels   the banded warps K7 and K8 against their plain versions
                (within one bf16 ulp) and, where the window holds, against
                K4 (bit for bit): b128 3x128^2 (y_window 40) and 3x256^2
                (y_window 75) at the augmentation's grids, both paddings,
                no band, a 1,024-wide image, a grid aligned to 8 bytes but
                not 16, ragged shapes (odd Wo, Wo < 32, Wo = 600),
                violated windows at 128 and 256 rows; then
                the two entry points once at each main shape, counted
  21. times     K7 and K8 against the bound, the plain version,
                F.grid_sample and K4 at both shapes; launches per call
  22. eval      the eval CLI on the card for celeba128, pose256 and
                transporter_atari (joint) at full width, b64, seeded weights
                in a state dict: in this process with the launches counted,
                then as ``python -m keypoints_tpu_torch.eval``; f32
                ``evaluate`` against tests/data/torch_port_celeba128_eval.json;
                bulk extraction (b1024 x 8) against one batch
  23. wide      heatmaps above 64 a side (the block-per-heatmap kernels): K1,
     heatmaps   K1b and K3 forward and backward against their plain versions
                at 65^2, 96^2, 128^2 and 65x200 (and maps of 7x13 and
                5x3), both variants, both align_corners; K3 against K1
                then K2 and its unaligned maps bit for bit; the
                dispatchers (spatial_softmax, extract_and_render) at 65^2,
                96^2 and 128^2, forward and backward, counted; then the
                times of K1, K1b and K3 at b128 K=10 96^2 and 128^2 against
                the bound and the plain version, K3 against K1 then K2
  24. wide      celeba128's widths with stride-1 encoders (128^2
     train      heatmaps), b32, bf16, 5 steps per variant (K3 in both):
                finite losses, float32 parameters, exact launches per step
  25. route     celeba128's b128 bf16 step with its field warps through K5
     A/B        and through upsample + K4, in turns (new, old, old, new);
                make_pair alone both ways, the two pairs equal; the dense
                route (make_pair of 32^2 images) counted (K4's launches),
                K4's two warps there within one bf16 ulp of plain, and
                timed, with K4 alone at one of its TPS grids
  26. route     celeba128's b128 bf16 step with its marginal bottleneck
     A/B        through K1 then K2 (patched in here) and through the
                package's K3, in turns (old, new, new, old); one step of
                each route counted, only K3's toward the kernels line
  27. train     ``python -m keypoints_tpu_torch.train`` of transporter_atari
     CLI        and pong64: 40 steps, and 20 + a resumed 20, equal bits,
                each process's step captured as a CUDA graph after its
                first step
  28. loop      ``train()`` in this process (graphed): kernels per step and
                eval on the card, counted from torch.profiler, and the
                wrappers' counts; the stream path, loop overhead against
                the graphed step alone, the cuDNN-deterministic A/B
  29. store     store eval of phase 27's checkpoint, card vs CPU
     eval
  30. dp step   dp_celeba (b256 bf16) through ``make_dp_train_step`` in a
                one-rank NCCL group: 3 steps equal the bare step's bit for
                bit, launches of 20 steps, ms/step against the bare step
                in turns, the gradient all-reduce alone through the
                persistent bucket (CUDA events and torch.profiler),
                torch.profiler over 5 DP steps
  31. dp CLI    ``torchrun --nproc_per_node 2 -m keypoints_tpu_torch.train
                --preset pong64`` (gloo, both ranks on the card, each step
                two CUDA graphs around the eager all-reduce, as each rank
                says): 20 steps against 10 + a resumed 10, equal bits,
                both ranks' losses equal, rank 0's files only; dp_celeba
                dry runs over an empty data dir (rank 0 alone generates
                the store; both name the graphed dispatch); two gloo ranks
                spawned here: the bucket's all-reduce host time, pong64's
                graphed DP step against its eager DP step bit for bit,
                ms/step of both in turns
  32. dp serve  the server on ``--devices 1`` at buckets 1/8/64/256, bit
                for bit the one-device extract, n=1 p50; launches counted;
                ``make_dp_extract`` over two replicas on the card at
                8/64/256, bit for bit the one-device extract of each half;
                K1 once a replayed call a replica (torch.profiler)
  33. export    celeba128's bundle of buckets 1/8/64/256 (float32 and uint8
                in) and transporter_atari at b64 exported on the card: the
                seconds and MB; each graph holds the K1 op once and no
                plain soft-argmax op; the artifact's keypoints against
                ``make_live_extract``'s at each bucket (equal bits);
                one K1 launch a replayed bucket call (torch.profiler); the
                wrappers count each bucket's first call and capture; b256 images/s of
                artifact and live from the host in turns; K1's host µs
                through the op and through the ctypes wrapper in turns
  34. artifact  ``python -m keypoints_tpu_torch.export`` of the bundle;
      CLIs      then, started together, ``serve --artifact``, ``eval
                --artifact --overlay`` and ``eval --checkpoint`` at b64,
                and ``video --artifact`` over 600 frames of
                data/atari_64.npy; the server's answers at n = 1, 3 and
                300 equal to the in-process artifact's bits, its n=1 p50
                beside phase 6's; the two eval records' keypoint metrics
                within 1e-4; the video's frames/s in this process
  35. tools     ``utils.profiling.timed`` on a K1 call against CUDA
                events; ``trace`` of two artifact calls (graph replays)
                holds the K1 kernel;
                ``guard_metrics`` raises on a NaN loss; ``assert_finite``
                names the non-finite tensor of a state dict on the card
  36. graph     ``make_graphed_train_step`` against ``make_train_step``:
      step      celeba128 and pose256 b128 (a fixed batch copied into the
                graph), transporter_atari b64 joint and marginal (the
                resident store sampled inside the graph), pong64 b64
                (scripted Pong drawn inside the graph), bf16, cuDNN
                deterministic: 1 eager + 3 replayed steps equal 4 eager
                steps bit for bit (parameters, Adam's state, metrics);
                kernels a step from torch.profiler, eager and replayed;
                the capture's seconds and bytes; ms/step in turns (eager,
                graph, graph, eager) and the device's idle share
  37. dp graph  dp_celeba b256 bf16 in a one-rank NCCL group on a fixed
      step      batch: the DP step graphed (two graphs around the eager
                all-reduce), the bare step graphed and the eager DP step, 1
                eager + 3 replays against 4 eager steps, equal bits in
                every parameter, Adam moment and metric; the captures'
                seconds and bytes; kernels a step (torch.profiler), idle
                share, ms/step in turns (eager, graph, graph, eager)
  38. serving   each serving bucket's CUDA graph against the eager bucket
      graphs    function it replaced (patched in the script only): live
                celeba128 at 1/8/64/256, float32 and uint8, two replicas
                at 8/64/256, phase 33's artifact, equal bits on new images
                at every call; the captures' seconds and bytes; K1 once a
                call and the idle share (torch.profiler), host ms a bucket
                call and the n=1 HTTP p50 of ``--preset`` and
                ``--artifact`` servers, eager and graphed in turns; a
                bucket whose capture fails raises at every call
  39. group norm the GroupNorm + ReLU kernels against their plain
                version, forward (y, mean, rstd) and backward (dx, dgamma,
                dbeta), bf16 and f32, at every norm shape of celeba128 at
                its paper widths (the benchmark's; b128 and b256), one
                pose256 (read twice) and one transporter_atari shape,
                ragged, C/G 1 and unaligned ones (scalar loads); two runs
                bit for bit; the launches of a paper-width train step (23
                forward, 23 backward) and no aten GroupNorm kernel in its
                replays (torch.profiler); device times against the bound,
                the plain chain and the library's bf16 chain

Run from a checkout:  python3 chip_smoke.py
The card's ``nvidia-smi`` line, then a JSON object of the kernels
(``{"kernels": [...]}``), then ``{"ok": true, "device": {...}}`` are the
last three lines of stdout. Any failed check exits non-zero before they are
printed; so does a machine without CUDA, or a copy of this file without the
rest of the repository.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import zipfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from keypoints_tpu_torch.checkpoint import (load_model_state,  # noqa: E402
                                            state_dict_from_flax)
from keypoints_tpu_torch.configs import get_config  # noqa: E402
from keypoints_tpu_torch.data.augment import (pair_from_draws,  # noqa: E402
                                              random_warp_field, warp_field)
from keypoints_tpu_torch.data.synthetic import scripted_pong_pair  # noqa: E402
from keypoints_tpu_torch import eval as peval  # noqa: E402
from keypoints_tpu_torch.eval import float32_precision  # noqa: E402
from keypoints_tpu_torch.kernels import _build  # noqa: E402
from keypoints_tpu_torch.kernels import extract_and_render  # noqa: E402
from keypoints_tpu_torch.kernels import gaussian_maps  # noqa: E402
from keypoints_tpu_torch.kernels import spatial_softmax  # noqa: E402
from keypoints_tpu_torch.kernels import experimental as banded  # noqa: E402
from keypoints_tpu_torch.kernels import experimental_cuda as ecu  # noqa: E402
from keypoints_tpu_torch.kernels import fused_bottleneck_cuda as fbc  # noqa: E402
from keypoints_tpu_torch.kernels import gaussian_cuda as gcu  # noqa: E402
from keypoints_tpu_torch.kernels import group_norm_cuda as gnc  # noqa: E402
from keypoints_tpu_torch.kernels import pool_cuda as pcu  # noqa: E402
from keypoints_tpu_torch.kernels import spatial_softmax_cuda as ssc  # noqa: E402
from keypoints_tpu_torch.kernels import warp_cuda as wcu  # noqa: E402
from keypoints_tpu_torch.ops.experimental import \
    warp_bilinear_rowwin as plain_rowwin  # noqa: E402
from keypoints_tpu_torch.ops.experimental import \
    warp_bilinear_tree as plain_tree  # noqa: E402
from keypoints_tpu_torch.ops.fused_bottleneck import \
    softargmax_raster as plain_bottleneck  # noqa: E402
from keypoints_tpu_torch.ops.gaussian import \
    gaussian_maps as plain_gaussian  # noqa: E402
from keypoints_tpu_torch.ops.group_norm import \
    group_norm_relu as plain_gn_relu  # noqa: E402
from keypoints_tpu_torch.ops.group_norm import \
    group_norm_relu_stats  # noqa: E402
from keypoints_tpu_torch.ops.pool import max_pool_2x2 as plain_pool  # noqa: E402
from keypoints_tpu_torch.ops.spatial_softmax import \
    spatial_softmax as plain_softmax  # noqa: E402
from keypoints_tpu_torch.ops.warp import grid_sample as plain_warp  # noqa: E402
from keypoints_tpu_torch.ops.warp import upsample_field_aligned  # noqa: E402
from keypoints_tpu_torch.serve import (build_parser, http_extract,  # noqa: E402
                                       http_meta, make_live_extract,
                                       make_server)
from keypoints_tpu_torch.models import autoencoder, nets  # noqa: E402
from keypoints_tpu_torch.testing import (GROUP_NORM_BLOCKS,  # noqa: E402
                                         GROUP_NORM_OTHER, bf16_ulp,
                                         decode_f32, fused_grad_tolerance,
                                         fused_map_tolerance,
                                         grad_norm_tolerance,
                                         group_norm_inputs,
                                         group_norm_relu_edge,
                                         random_flax_params, random_images,
                                         softmax_grad_tolerance,
                                         random_vgg_params, reference_draws,
                                         reference_eval_batch,
                                         reference_warp_draws,
                                         write_torchvision_vgg)
from keypoints_tpu_torch.train import make_loss  # noqa: E402
from keypoints_tpu_torch.training import (build_model,  # noqa: E402
                                          freeze_for_inference, init_state,
                                          make_extract_fn,
                                          make_extract_many_fn,
                                          make_graphed_train_step,
                                          make_train_step,
                                          step_generator, warp_config)

KERNEL_TOL = 2e-5      # soft-argmax forward: f32 both sides, sum order only
GRAD_TOL = 1e-5        # soft-argmax backward, Gaussian maps, f32 warp
RASTER_GRAD_RTOL = 1e-4  # Gaussian backward: sums over H*W in another order
JAX_TOL = 1e-3         # docs/PARITY.md keypoint bar
TRAIN_RTOL = 1e-4      # train parity: loss and grad_norm per step
TRAIN_KP_TOL = 1e-4    # train parity: step-1 keypoints
FIELD_TOL = 3e-5       # TPS field from JAX's draws: JAX's own f32 error
SERVE_TOL = 1e-4       # same bf16 heatmaps, kernel vs plain soft-argmax
SERVE_PROFILED_CALLS = 5   # replayed bucket calls under torch.profiler
BUCKETS = (1, 8, 64, 256)
U8_BUCKETS = (1, 8)
FIELD_WARP_TOL = 1e-4  # f32 field warp: JAX's bar for its field kernel
TRAIN_BATCH = 128      # bench.py's celeba128 train step; pose256's preset
TRAIN_STEPS = 30
POSE_STEPS = 20
# the VGG-19 perceptual loss's four pool inputs at celeba128's 128^2, b128:
# the pools of the celeba128_vgg19 train step
VGG19_POOLS = ((TRAIN_BATCH, 64, 128, 128), (TRAIN_BATCH, 128, 64, 64),
               (TRAIN_BATCH, 256, 32, 32), (TRAIN_BATCH, 512, 16, 16))
REFERENCE = ROOT / "tests" / "data" / "torch_port_celeba128_extract.json"
TRAIN_REFERENCE = ROOT / "tests" / "data" / "torch_port_celeba128_train.json"
POSE_REFERENCE = ROOT / "tests" / "data" / "torch_port_pose256_train.json"
TRANSPORTER_REFERENCE = (ROOT / "tests" / "data"
                         / "torch_port_transporter_atari_train.json")
TRANSPORTER_STEPS = 30
META_KEYS = {"format", "version", "batches", "image_size", "channels",
             "num_keypoints", "input_dtype", "data_parallel_devices"}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM data sheet, float32 outside tensor cores

# name -> (module, counter, source, TPU kernel it replaces, launches a step
# on each of PATHS)
KERNELS = {
    "spatial_softmax_fwd": (ssc, "launches", "spatial_softmax.cu",
                            "spatial_softmax_pallas.py:151", (0, 0, 0, 0)),
    "spatial_softmax_bwd": (ssc, "bwd_launches", "spatial_softmax.cu",
                            "spatial_softmax_pallas.py:157", (1, 1, 1, 1)),
    "gaussian_fwd": (gcu, "launches", "gaussian.cu", "gaussian_pallas.py:32",
                     (0, 0, 0, 0)),
    "gaussian_bwd": (gcu, "bwd_launches", "gaussian.cu",
                     "gaussian_pallas.py:40", (1, 1, 1, 1)),
    "warp_bilinear": (wcu, "launches", "warp.cu", "warp_pallas.py:93",
                      (0, 0, 0, 0)),
    "warp_field": (wcu, "field_launches", "warp.cu", "warp_pallas.py:237",
                   (2, 2, 0, 0)),
    "max_pool_fwd": (pcu, "launches", "pool.cu", "pool_pallas.py:92",
                     (0, 4, 0, 0)),
    "max_pool_bwd": (pcu, "bwd_launches", "pool.cu", "pool_pallas.py:102",
                     (0, 2, 0, 0)),
    "softargmax_raster_fwd": (fbc, "launches", "fused_bottleneck.cu",
                              "fused_bottleneck.py:44", (1, 1, 2, 2)),
    "warp_band": (ecu, "tree_launches", "warp_experimental.cu",
                  "experimental.py:70", (0, 0, 0, 0)),
    "warp_rowwin": (ecu, "rowwin_launches", "warp_experimental.cu",
                    "experimental.py:210", (0, 0, 0, 0)),
}
PATHS = ("celeba128", "pose256", "transporter_atari joint",
         "transporter_atari marginal")
# the Gaussian raster's shapes (N, H, W, sigma): celeba128's, pose256's and
# transporter_atari's train steps, then ragged ones
RASTER_CASES = [(1280, 32, 32, 0.1), (2048, 32, 32, 0.05), (256, 16, 16, 0.1),
                (6, 13, 29, 0.1), (1, 13, 29, 0.1)]


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def reset_counts() -> None:
    for mod, counter, *_ in KERNELS.values():
        setattr(mod, counter, 0)


def read_counts() -> dict:
    return {name: getattr(mod, counter)
            for name, (mod, counter, *_) in KERNELS.items()}


def cuda_median_ms(fn, runs: int = 25, reps: int = 1,
                   queue_behind_sleep: bool = True) -> float:
    """Median time of one ``fn()`` call by CUDA events, over ``runs`` runs.

    Each run times ``reps`` calls. With ``queue_behind_sleep`` the calls are
    enqueued while the GPU spins in a ~5 ms sleep, so they run back to back
    and the events see device time only; without it the events also see the
    host's launch cost, as a caller making one call at a time does.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queue_behind_sleep:
            torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def device_phase() -> str:
    phase("1 device")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}", flush=True)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"({torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"visible)", flush=True)
    return card


def build_phase() -> None:
    phase("2 build")
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel library {_build.library_path().name} from "
          f"{', '.join(p.name for p in _build.sources())} ready in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    for line in _build.build_log.splitlines():
        if line.startswith("[") or "registers" in line or "spill" in line:
            print(line.strip(), flush=True)


# the warp path's layouts beyond the presets' (N, H, W): H != W on both
# sides of 32 rows, one row, one column, ragged widths of several chunks
LAYOUT_SHAPES = [(3, 64, 16), (3, 16, 64), (2, 1, 64), (2, 64, 1), (5, 31, 33)]


def _unaligned(shape, rs) -> torch.Tensor:
    """Seeded heatmaps of ``shape`` in a contiguous slice 4 bytes off a
    16-byte boundary: the warp path's scalar-load layout."""
    n = int(np.prod(shape))
    flat = torch.from_numpy((3 * rs.randn(n + 1)).astype(np.float32)).cuda()
    x = flat[1:].view(shape)
    check(x.is_contiguous() and x.data_ptr() % 16 == 4, "unaligned slice")
    return x


def kernel_phase() -> float:
    phase("3 kernel vs plain (CUDA soft-argmax forward, f32)")
    rs = np.random.RandomState(0)
    worst = 0.0
    shapes = [(10, 32, 32), (2560, 32, 32), (10240, 32, 32), (40, 16, 16),
              (7, 13, 29), (256, 16, 16), (2048, 32, 32), *LAYOUT_SHAPES,
              "unaligned"]
    for shape in shapes:
        if shape == "unaligned":
            x = _unaligned((1, 40, 32, 32), rs)
        else:
            n, h, w = shape
            x = torch.from_numpy((3 * rs.randn(1, n, h, w)).astype(np.float32))
            x = x.cuda()
        for variant in ("marginal", "joint"):
            for align in (True, False):
                for t in (1.0, 0.7):
                    got = ssc.spatial_softmax_cuda(x, t, variant, align)
                    torch.cuda.synchronize()
                    want = plain_softmax(x, t, variant, align)
                    err = (got - want).abs().max().item()
                    worst = max(worst, err)
                    check(err <= KERNEL_TOL, f"kernel vs plain {err} > "
                          f"{KERNEL_TOL} at {shape} {variant} "
                          f"align={align} T={t}")
        print(f"{shape}: 8 cases, max|d| so far {worst:.3e}", flush=True)
    # a flat heatmap centres; a sharp corner peak lands on the corner
    flat = torch.zeros((1, 1, 8, 8), device="cuda")
    peak = torch.full((1, 1, 16, 16), -30.0, device="cuda")
    peak[0, 0, 0, 15] = 30.0
    for variant in ("marginal", "joint"):
        kp_flat = ssc.spatial_softmax_cuda(flat, 1.0, variant, True)
        kp_peak = ssc.spatial_softmax_cuda(peak, 1.0, variant, True)
        torch.cuda.synchronize()
        check(kp_flat.abs().max().item() <= 1e-6, f"flat {variant} off centre")
        check((kp_peak[0, 0].cpu() - torch.tensor([1.0, -1.0])).abs().max()
              .item() <= 1e-4, f"corner peak {variant}: {kp_peak.tolist()}")
    print(f"worst max|d| {worst:.3e} (tolerance {KERNEL_TOL})", flush=True)
    return worst


def _dense_warp_cases(rs) -> list:
    """K4's cases (what, f32 image, grid): celeba128's b128 3x128^2, a
    ragged image, the dense route's b128 3x32^2, the tiles' ragged edges (Ho
    not a multiple of 32, Wo not one of 64, odd Wo over two tiles, Wo = 1),
    a grid with NaN points,
    a grid far outside the image ([-5, 5]) and B = 70,000 (images along two
    grid dimensions); grids span [-1.2, 1.2] unless said otherwise."""
    def inputs(shape, out_hw, span=1.2):
        img = torch.from_numpy(rs.rand(*shape).astype(np.float32)).cuda()
        grid = torch.from_numpy(((rs.rand(shape[0], *out_hw, 2) * 2 - 1)
                                 * span).astype(np.float32)).cuda()
        return img, grid
    cases = [("b128 3x128^2", *inputs((TRAIN_BATCH, 3, 128, 128), (128, 128))),
             ("13x29 -> 11x17", *inputs((2, 3, 13, 29), (11, 17))),
             ("b128 3x32^2", *inputs((TRAIN_BATCH, 3, 32, 32), (32, 32))),
             ("40x50 -> 45x70", *inputs((1, 3, 40, 50), (45, 70))),
             ("20x24 -> 33x65", *inputs((2, 3, 20, 24), (33, 65))),
             ("16x16 -> 37x1", *inputs((2, 3, 16, 16), (37, 1))),
             ("out of range", *inputs((2, 3, 48, 40), (40, 72), span=5.0)),
             ("B = 70000", *inputs((70000, 1, 2, 2), (2, 2)))]
    img, grid = inputs((2, 3, 64, 64), (64, 64))
    grid[rs.rand(*grid.shape) < 0.05] = float("nan")
    cases.append(("NaN points", img, grid))
    return cases


def _dense_warp_error(img, grid, got, padding, align, what) -> float:
    """K4's result against the plain version (f32 within GRAD_TOL and
    F.grid_sample's, bf16 within one bf16 ulp). A NaN point reads as one far
    outside the image, as the kernel's corner math takes it: 0 under zeros
    padding, the border under border padding (the plain version cannot
    index at NaN; F.grid_sample, which gives NaN under zeros padding, is
    held to the grids without NaN)."""
    nan = bool(torch.isnan(grid).any())
    want = plain_warp(img, torch.nan_to_num(grid, nan=-10.0), padding, align)
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if img.dtype == torch.float32:
        check(err <= GRAD_TOL, f"warp {what}: {err}")
        if not nan:
            lib = F.grid_sample(img, grid, "bilinear", padding, align)
            check((got - lib).abs().max().item() <= GRAD_TOL,
                  f"warp vs F.grid_sample {what}")
    else:
        check(bool((diff <= bf16_ulp(want)).all()),
              f"warp {what}: more than one bf16 ulp ({err})")
    return err


def _plain_grad(fn, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    x = x.detach().clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(fn(x), x, g)
    return grad


def training_kernels_phase() -> dict:
    """The kernels of the train step against their plain versions (and
    their autograd), at the main path's shapes and at ragged ones."""
    phase("4 training-slice kernels vs plain")
    rs = np.random.RandomState(1)
    errs = {}

    def record(name, err, tol, what):
        errs[name] = max(errs.get(name, 0.0), err)
        check(err <= tol, f"{name} {what}: {err} > {tol}")

    # soft-argmax backward (K1b): both variants, both align_corners, T in
    # {1.0, 0.7}; a second call gives the same bits
    cases = 0
    for shape in [(128, 10, 32, 32), (1, 7, 13, 29), (2, 3, 64, 64),
                  (3, 2, 1, 5), (64, 4, 16, 16), (128, 16, 32, 32),
                  *((1, *s) for s in LAYOUT_SHAPES), "unaligned"]:
        if shape == "unaligned":
            x = _unaligned((4, 10, 32, 32), rs)
            shape = tuple(x.shape)
        else:
            x = torch.from_numpy((3 * rs.randn(*shape)).astype(np.float32))
            x = x.cuda()
        g = torch.from_numpy(rs.randn(*shape[:2], 2).astype(np.float32)).cuda()
        for variant in ("marginal", "joint"):
            for align in (True, False):
                for t in (1.0, 0.7):
                    kp = ssc.spatial_softmax_cuda(x, t, variant, align)
                    got = ssc.spatial_softmax_bwd_cuda(x, kp, g, t, variant,
                                                       align)
                    again = ssc.spatial_softmax_bwd_cuda(x, kp, g, t,
                                                         variant, align)
                    torch.cuda.synchronize()
                    what = f"{shape} {variant} align={align} T={t}"
                    check(torch.equal(got, again), f"spatial_softmax_bwd "
                          f"{what}: two calls differ")
                    want = _plain_grad(lambda u: plain_softmax(
                        u, t, variant, align), x, g)
                    record("spatial_softmax_bwd",
                           (got - want).abs().max().item(), GRAD_TOL, what)
                    cases += 1
    print(f"soft-argmax backward: {cases} cases, max|d| "
          f"{errs['spatial_softmax_bwd']:.3e} (tolerance {GRAD_TOL}), two "
          f"calls equal bit for bit", flush=True)

    # Gaussian raster forward and backward (K2): celeba128's, pose256's and
    # transporter_atari's rasters, ragged ones (W % 4 != 0, N = 1); the
    # backward twice, for equal bits
    for n, h, w, sigma in RASTER_CASES:
        kp = torch.from_numpy((rs.rand(n, 2) * 2.2 - 1.1).astype(np.float32))
        kp = kp.cuda()
        g = torch.from_numpy(rs.randn(n, h, w).astype(np.float32)).cuda()
        for align in (True, False):
            maps = gcu.gaussian_fwd_cuda(kp, h, w, sigma, align)
            dkp = gcu.gaussian_bwd_cuda(kp, g, sigma, align)
            again = gcu.gaussian_bwd_cuda(kp, g, sigma, align)
            torch.cuda.synchronize()
            what = f"N={n} {h}x{w} sigma {sigma} align={align}"
            check(torch.equal(dkp, again), f"gaussian_bwd {what}: two calls "
                  f"differ")

            def plain(t):
                return plain_gaussian(t[None], h, w, sigma, align)[0]
            record("gaussian_fwd", (maps - plain(kp)).abs().max().item(),
                   GRAD_TOL, what)
            want = _plain_grad(plain, kp, g)
            err = (dkp - want).abs().max().item()
            errs["gaussian_bwd"] = max(errs.get("gaussian_bwd", 0.0), err)
            scale = want.abs().max().item()
            check(err <= RASTER_GRAD_RTOL * scale,
                  f"gaussian_bwd {what}: {err} > {RASTER_GRAD_RTOL} x {scale}")
    print(f"Gaussian raster: {2 * len(RASTER_CASES)} cases, forward max|d| "
          f"{errs['gaussian_fwd']:.3e} (tolerance {GRAD_TOL}), backward max|d|"
          f" {errs['gaussian_bwd']:.3e} (tolerance {RASTER_GRAD_RTOL} of the "
          f"gradient's max), two backward calls equal bit for bit",
          flush=True)

    # bilinear warp (K4): celeba128's b128 3x128^2, the dense route's
    # b128 3x32^2, then the tiles' ragged edges, a grid with NaN points, one
    # far outside the image, and more images than a grid dimension holds
    cases = 0
    for what, img32, grid in _dense_warp_cases(rs):
        for dtype in (torch.float32, torch.bfloat16):
            img = img32.to(dtype)
            for padding in ("zeros", "border"):
                for align in (True, False):
                    got = wcu.warp_bilinear_cuda(img, grid, padding, align)
                    torch.cuda.synchronize()
                    case = f"{what} {dtype} {padding} align={align}"
                    check(got.dtype == dtype, f"warp output {got.dtype}")
                    err = _dense_warp_error(img, grid, got, padding, align,
                                            case)
                    errs["warp_bilinear"] = max(errs.get("warp_bilinear", 0.0),
                                                err)
                    cases += 1
    print(f"warp: {cases} cases, max|d| {errs['warp_bilinear']:.3e} (f32 "
          f"tolerance {GRAD_TOL}, also against F.grid_sample; bf16 within "
          f"one bf16 ulp of plain)", flush=True)
    return errs


def parity_phase() -> None:
    phase("5 full-width celeba128 f32 vs committed JAX keypoints")
    ref = json.loads(REFERENCE.read_text())
    cfg = get_config(ref["preset"]).override(
        **{"train.compute_dtype": "float32"})
    with float32_precision():
        model = build_model(cfg, "cuda")
        load_model_state(model, state_dict_from_flax(
            random_flax_params(cfg, ref["param_seed"])))
        images = random_images(ref["n_images"], cfg, ref["image_seed"])
        kp = make_extract_fn(freeze_for_inference(model))(
            torch.from_numpy(images).cuda())
        kp = kp.cpu().numpy()
    want = np.asarray(ref["keypoints"], np.float32)
    check(kp.shape == want.shape, f"shape {kp.shape} != {want.shape}")
    check(bool(np.isfinite(kp).all()), "non-finite keypoints")
    err = float(np.abs(kp - want).max())
    print(f"{ref['n_images']} images, {cfg.model.num_keypoints} keypoints: "
          f"max|d| vs JAX = {err:.3e} (tolerance {JAX_TOL})", flush=True)
    check(err <= JAX_TOL, f"full-width f32 vs JAX {err} > {JAX_TOL}")


def start_server(ckpt: str, buckets, *extra: str):
    """``make_server`` on a free port, serving from a thread."""
    args = build_parser().parse_args(
        ["--preset", "celeba128", "--checkpoint", ckpt, "--port", "0",
         "--batch", *map(str, buckets), *extra])
    httpd, batcher = make_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, batcher, thread


def stop_server(httpd, batcher, thread) -> None:
    httpd.shutdown()
    httpd.server_close()
    batcher.close()
    thread.join(timeout=30)
    check(not thread.is_alive(), "server thread still running")


def serve_phase(tmp: str) -> dict:
    """The serving path: the servers' build, warm-up and every request."""
    phase(f"6 serve (celeba128, bf16, float32 server on buckets "
          f"{' '.join(map(str, BUCKETS))}, uint8 server on "
          f"{' '.join(map(str, U8_BUCKETS))})")
    cfg = get_config("celeba128")
    params = random_flax_params(cfg, 0)
    state = {k: torch.from_numpy(v) for k, v in
             state_dict_from_flax(params).items()}
    ckpt = os.path.join(tmp, "celeba128_seed0.pt")
    torch.save(state, ckpt)

    # Reference: the same bf16 model with the plain soft-argmax, on the
    # request zero-padded to a bucket. cuDNN picks its bf16 conv algorithm
    # by batch size, so a row's heatmap depends on the bucket it ran in
    # (H100: B=16 and 256 differ from B=2, 8 and 64 by up to 3.9e-3 in
    # heatmaps, 3.8e-4 in keypoints; row position and reruns are exact).
    # Each answer is held to the reference at the bucket it ran in; a
    # coalesced request may have run in any bucket from its own up to the
    # one that covers all concurrent rows, and is held to the closest.
    ref_model = build_model(cfg, "cuda")
    load_model_state(ref_model, state)
    freeze_for_inference(ref_model)
    m = cfg.model

    def reference(images: np.ndarray, bucket: int) -> np.ndarray:
        n = images.shape[0]
        x = np.zeros((bucket,) + images.shape[1:], np.float32)
        x[:n] = images
        with torch.inference_mode():
            hm = ref_model.keynet(torch.from_numpy(x).cuda()).float()
            kp = plain_softmax(hm, m.temperature, m.softmax_variant, True)
        return kp[:n].cpu().numpy()

    rs = np.random.RandomState(2)
    worst = 0.0
    latencies = []

    def verify(what: str, buckets, images: np.ndarray, got: np.ndarray,
               rows_in_flight: int | None = None) -> None:
        nonlocal worst
        n = images.shape[0]
        x = (images if images.dtype == np.float32
             else images.astype(np.float32) / 255.0)
        check(got.shape == (n, m.num_keypoints, 2),
              f"{what}: shape {got.shape}")
        check(bool(np.isfinite(got).all()), f"{what}: non-finite")
        top = next(b for b in buckets if b >= (rows_in_flight or n))
        err, bucket = min(
            (float(np.abs(got - reference(x, b)).max()), b)
            for b in buckets if b >= n and b <= top)
        worst = max(worst, err)
        print(f"{what}: max|d| vs plain at b{bucket} = {err:.3e}",
              flush=True)
        check(err <= SERVE_TOL, f"{what}: {err} > {SERVE_TOL}")

    reset_counts()
    server = start_server(ckpt, BUCKETS)
    url = f"http://localhost:{server[0].server_address[1]}"
    try:
        meta = http_meta(url)
        check(set(meta) == META_KEYS, f"GET / keys {sorted(meta)}")
        check(meta["batches"] == list(BUCKETS), f"buckets {meta['batches']}")

        for n in (1, 5, 64):
            images = rs.rand(n, 3, 128, 128).astype(np.float32)
            verify(f"float32 n={n}", BUCKETS, images,
                   http_extract(url, images))
        images = rs.randint(0, 256, (3, 3, 128, 128)).astype(np.uint8)
        verify("uint8 n=3 (float32 server)", BUCKETS, images,
               http_extract(url, images))

        requests = [rs.rand(2, 3, 128, 128).astype(np.float32)
                    for _ in range(8)]
        answers: list = [None] * len(requests)

        def client(i: int) -> None:
            answers[i] = http_extract(url, requests[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in threads), "concurrent requests hung")
        in_flight = sum(r.shape[0] for r in requests)
        for i, (images, got) in enumerate(zip(requests, answers)):
            check(got is not None, f"concurrent request {i} got no answer")
            verify(f"concurrent n=2 #{i}", BUCKETS, images, got, in_flight)

        one = rs.rand(1, 3, 128, 128).astype(np.float32)
        for _ in range(5):
            http_extract(url, one)
        for _ in range(30):
            t0 = time.perf_counter()
            http_extract(url, one)
            latencies.append(time.perf_counter() - t0)
        # a bucket call replays its CUDA graph, which calls no wrapper:
        # its launches come from the profiler
        extract = server[1]._extract
        replay, _, _ = profiled_launches(lambda: extract(one),
                                         SERVE_PROFILED_CALLS)
    finally:
        stop_server(*server)

    # --input-dtype uint8: raw frames go to the card as they are and are
    # rescaled /255 there
    server = start_server(ckpt, U8_BUCKETS, "--input-dtype", "uint8")
    url = f"http://localhost:{server[0].server_address[1]}"
    try:
        meta = http_meta(url)
        check(meta["input_dtype"] == "uint8", f"input_dtype {meta}")
        for n in (1, 3):
            images = rs.randint(0, 256, (n, 3, 128, 128)).astype(np.uint8)
            verify(f"uint8 n={n} (uint8 server)", U8_BUCKETS, images,
                   http_extract(url, images))
    finally:
        stop_server(*server)

    counts = read_counts()
    launches = counts["spatial_softmax_fwd"]
    captures = len(BUCKETS) + len(U8_BUCKETS)
    print(f"kernel launches during serving, by the wrappers: {counts} (each "
          f"bucket's eager warm-up call and its capture, {captures} "
          f"buckets); by torch.profiler, a replayed bucket call: {replay}",
          flush=True)
    check(launches == 2 * captures and all(
        v == 0 for k, v in counts.items() if k != "spatial_softmax_fwd"),
        f"wrapper counts {counts}: 2 a bucket expected (its eager call and "
        f"its capture; a replay calls no wrapper)")
    check(replay == {k: int(k == "spatial_softmax_fwd")
                     for k in PROFILED_KERNELS},
          f"a replayed bucket call launched {replay}, K1 once expected")
    return {"launches": launches, "serve_max_abs_err": worst,
            "http_p50_ms": float(np.median(latencies)) * 1e3}


def train_parity_phase(number: int, reference: Path, tmp: str) -> None:
    """3 full-width f32 steps on JAX's warps and factors, on the card (the
    kernels) and on this machine's CPU (the plain versions), against the
    committed JAX reference; and the port's TPS fields from JAX's draws.
    A perceptual preset's VGG weights are ``random_vgg_params`` of the
    reference's seed, in a torchvision-layout file as JAX read them."""
    ref = json.loads(reference.read_text())
    phase(f"{number} train parity: full-width {ref['preset']} f32 (TF32 "
          f"off), 3 steps on JAX's draws, card and CPU vs committed JAX "
          f"reference")
    overrides = dict(ref["overrides"])
    if "vgg_seed" in ref:
        overrides["train.vgg_ckpt"] = os.path.join(
            tmp, f"vgg16_seed{ref['vgg_seed']}.pth")
        write_torchvision_vgg(random_vgg_params(ref["vgg_seed"]),
                              overrides["train.vgg_ckpt"])
    cfg = get_config(ref["preset"]).override(**overrides)
    fields = torch.from_numpy(decode_f32(ref["fields"], ref["fields_shape"]))
    runs = {}
    with float32_precision():
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            field_err = max(
                (warp_field(d, warp_config(cfg)).cpu() - fields[i, j]).abs()
                .max().item()
                for i, step_draws in enumerate(reference_warp_draws(ref,
                                                                    device))
                for j, d in enumerate(step_draws))
            print(f"{device}: TPS fields from JAX's draws, max|d| vs JAX's "
                  f"fields {field_err:.3e} (tolerance {FIELD_TOL})",
                  flush=True)
            check(field_err <= FIELD_TOL, f"{device} TPS fields {field_err}")
            state = init_state(cfg, device)
            load_model_state(state.model, state_dict_from_flax(
                random_flax_params(cfg, ref["param_seed"])))
            images = torch.from_numpy(random_images(
                ref["batch"], cfg, ref["image_seed"])).to(device)
            draws = reference_draws(ref, device)
            src, tgt = pair_from_draws(images, draws[0], warp_config(cfg))
            with torch.no_grad():
                kp = state.model(src, tgt)[1].cpu().numpy()
            step = make_train_step(cfg, loss=make_loss(cfg, device))
            losses, norms, grads = [], [], {}
            for i, d in enumerate(draws):
                state, metrics = step(state, images, d)
                losses.append(metrics["loss"].item())
                norms.append(metrics["grad_norm"].item())
                if i == 0:
                    grads = {k: p.grad.norm().item()
                             for k, p in state.model.named_parameters()}
            check(all(p.dtype == torch.float32
                      for p in state.model.parameters()), "non-f32 params")
            runs[device] = (kp, losses, norms, grads)
            kp_err = float(np.abs(kp - np.asarray(ref["keypoints"])).max())
            loss_rel = max(abs(a / b - 1) for a, b in zip(losses,
                                                         ref["loss"]))
            norm_rel = max(abs(a / b - 1) for a, b in zip(norms,
                                                         ref["grad_norm"]))
            worst_param = max(abs(grads[k] - v) / grad_norm_tolerance(
                v, ref["grad_norm"][0]) for k, v in ref["grad_norms"].items())
            print(f"{device}: losses {losses} grad_norms {norms} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
            print(f"{device} vs JAX: step-1 keypoints max|d| {kp_err:.3e} "
                  f"(tolerance {TRAIN_KP_TOL}); loss rel {loss_rel:.3e}, "
                  f"grad_norm rel {norm_rel:.3e} (tolerance {TRAIN_RTOL}); "
                  f"per-parameter gradient norms at {worst_param:.3f} of "
                  f"their tolerance", flush=True)
            check(kp_err <= TRAIN_KP_TOL, f"{device} keypoints {kp_err}")
            check(loss_rel <= TRAIN_RTOL, f"{device} loss rel {loss_rel}")
            check(norm_rel <= TRAIN_RTOL, f"{device} grad_norm rel {norm_rel}")
            check(grads.keys() == ref["grad_norms"].keys(), "parameter names")
            check(worst_param <= 1.0, f"{device} per-parameter grad norms")
    card, cpu = runs["cuda"], runs["cpu"]
    print(f"card vs CPU: keypoints max|d| "
          f"{float(np.abs(card[0] - cpu[0]).max()):.3e}, loss rel "
          f"{max(abs(a / b - 1) for a, b in zip(card[1], cpu[1])):.3e}, "
          f"grad_norm rel "
          f"{max(abs(a / b - 1) for a, b in zip(card[2], cpu[2])):.3e}",
          flush=True)


def _train_setup(preset: str, batch: int = TRAIN_BATCH):
    """A user's train step: ``init_state`` and ``make_train_step`` with the
    preset's loss (``make_loss``: the VGG perceptual loss for pose256, with
    the seeded trunk), on a batch of seeded images."""
    cfg = get_config(preset).override(**{"train.batch_size": batch})
    state = init_state(cfg, "cuda")
    images = torch.from_numpy(random_images(batch, cfg, 4)).cuda()
    return cfg, state, make_train_step(cfg, loss=make_loss(cfg)), images


def train_phase(number: int, preset: str, steps: int):
    """The training path: ``steps`` steps, counts reset just before; every
    kernel of the path launched as often as a step launches it."""
    phase(f"{number} train ({preset} full width, b{TRAIN_BATCH}, bf16, "
          f"{steps} steps, the port's own draws)")
    cfg, state, step, images = _train_setup(preset)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        state, metrics = step(state, images)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    losses = torch.stack(losses).cpu().numpy()
    print(f"{steps} steps in {wall:.2f}s (first steps include cuDNN's "
          f"set-up); losses {losses[0]:.5f} -> {losses[-1]:.5f}, min "
          f"{losses.min():.5f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    print(f"kernel launches during training: {counts}", flush=True)
    check(bool(np.isfinite(losses).all()), f"non-finite losses {losses}")
    check(all(p.dtype == torch.float32 for p in state.model.parameters()),
          "parameters are not float32 after bf16 steps")
    for name, (*_, per_step) in KERNELS.items():
        want = per_step[PATHS.index(preset)] * steps
        check(counts[name] >= want,
              f"{name} launched {counts[name]} times in {steps} steps "
              f"(>= {want} expected)")
    return counts, (cfg, state, step, images)


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bottleneck_cases(b: int, k: int, sigma: float, seed: int) -> dict:
    """The soft-argmax and raster kernels at b x k heatmaps of 32^2: name ->
    (kernel call, plain call, library call or None, bound)."""
    n, hw = b * k, 32 * 32
    rs = np.random.RandomState(seed)
    x = torch.from_numpy((3 * rs.randn(b, k, 32, 32)).astype(np.float32))
    x = x.cuda()
    kp = ssc.spatial_softmax_cuda(x)
    g_kp = torch.from_numpy(rs.randn(b, k, 2).astype(np.float32)).cuda()
    x_req = x.clone().requires_grad_(True)
    kp_plain = plain_softmax(x_req)
    heat_bytes = n * hw * 4
    return {
        "spatial_softmax_fwd": (
            lambda: ssc.spatial_softmax_cuda(x),
            lambda: plain_softmax(x), None,
            _bound(heat_bytes + n * 8, 3 * n * hw)),
        "spatial_softmax_bwd": (
            lambda: ssc.spatial_softmax_bwd_cuda(x, kp, g_kp),
            lambda: torch.autograd.grad(kp_plain, x_req, g_kp,
                                        retain_graph=True), None,
            _bound(2 * heat_bytes + 2 * n * 8, 4 * n * hw)),
        **_raster_cases(n, 32, 32, sigma, seed)}


def _raster_cases(n: int, h: int, w: int, sigma: float, seed: int) -> dict:
    """The raster kernels (K2) alone at N maps of h x w: name -> (kernel
    call, plain call, library call or None, bound), as _bottleneck_cases."""
    rs = np.random.RandomState(seed)
    kp = torch.from_numpy((rs.rand(n, 2) * 2.2 - 1.1).astype(np.float32))
    kp = kp.cuda()
    g = torch.from_numpy(rs.randn(n, h, w).astype(np.float32)).cuda()
    kp_req = kp.clone().requires_grad_(True)
    maps_plain = plain_gaussian(kp_req[None], h, w, sigma, True)
    heat_bytes = n * h * w * 4
    return {
        "gaussian_fwd": (
            lambda: gcu.gaussian_fwd_cuda(kp, h, w, sigma),
            lambda: plain_gaussian(kp[None], h, w, sigma, True), None,
            _bound(heat_bytes + n * 8, 10 * n * h * w)),
        "gaussian_bwd": (
            lambda: gcu.gaussian_bwd_cuda(kp, g, sigma),
            lambda: torch.autograd.grad(maps_plain, kp_req, g[None],
                                        retain_graph=True), None,
            _bound(heat_bytes + 2 * n * 8, 14 * n * h * w))}


def _time_cases(cases: dict, card: str, reps: int = 20,
                plain_reps: int = 5, label: str = "") -> dict:
    """Kernel, plain and library device times (kernel again last) of each
    case, printed beside its bound."""
    out = {}
    for name, (kernel, plain, library, (bound_ms, bound_by)) in cases.items():
        k_ms = cuda_median_ms(kernel, reps=reps)
        p_ms = cuda_median_ms(plain, reps=plain_reps)
        l_ms = cuda_median_ms(library, reps=reps) if library else None
        k_again = cuda_median_ms(kernel, reps=reps)
        out[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
        lib = f", library {l_ms * 1e3:.2f} us" if l_ms is not None else ""
        print(f"{name}{label}: kernel {k_ms * 1e3:.2f} us (again "
              f"{k_again * 1e3:.2f}), plain {p_ms * 1e3:.2f} us{lib}; bound "
              f"{bound_ms * 1e3:.2f} us by {bound_by} = "
              f"{bound_ms / k_ms:.1%} of the kernel's time  [{card}]",
              flush=True)
    return out


def kernel_times_phase(card: str, trainer) -> dict:
    """Each kernel at the train step's shapes (b128, K=10, 32^2 heatmaps,
    3x128^2 bf16 images, the field warp at the augmentation's F = 33 field,
    K4 at the same field upsampled): device time by CUDA events with the
    calls queued behind a sleep (inputs L2-warm), the plain version's time,
    the library call's where there is one, and the bound."""
    phase(f"9 times on {card}")
    cfg, *_ = trainer
    cases = _bottleneck_cases(TRAIN_BATCH, cfg.model.num_keypoints,
                              cfg.model.sigma, 3)
    out = _time_cases(cases, card)
    out.update(warp_times(card))
    return out


def warp_times(card: str) -> dict:
    """K4 and K5 at celeba128's train-step warp (b128 3x128^2 images, the
    augmentation's F = 33 field; K4 at that field upsampled to 128^2): bf16
    against bound, plain and library; K4 also on the f32 image (ROADMAP
    B.4). Returns the bf16 entries, the kernels line's."""
    b = TRAIN_BATCH
    cfg = get_config("celeba128")
    rs = np.random.RandomState(4)
    img = torch.from_numpy(rs.rand(b, 3, 128, 128).astype(np.float32)).cuda()
    img32, img = img, img.to(torch.bfloat16)
    field = random_warp_field(step_generator(0, 0, "cuda"), b,
                              warp_config(cfg)).contiguous()
    grid = upsample_field_aligned(field, 128, 128).contiguous()
    grid_bf16 = grid.to(torch.bfloat16)

    def bound(image, points_bytes, ops_a_pixel):
        return _bound(2 * image.nelement() * image.element_size()
                      + points_bytes, ops_a_pixel * b * 128 * 128
                      + 8 * image.nelement())
    out = _time_cases({
        "warp_bilinear": (
            lambda: wcu.warp_bilinear_cuda(img, grid, "border", True),
            lambda: plain_warp(img, grid, "border", True),
            lambda: F.grid_sample(img, grid_bf16, "bilinear", "border", True),
            bound(img, grid.nelement() * 4, 30)),
        "warp_field": (
            lambda: wcu.warp_field_cuda(img, field, 128, 128, "border", True),
            lambda: plain_warp(img, upsample_field_aligned(field, 128, 128),
                               "border", True), None,
            bound(img, field.nelement() * 4, 50))}, card)
    print("warp library call: F.grid_sample on the bf16 image takes only a "
          "bf16 grid, so it reads the grid cast to bf16", flush=True)
    _time_cases({"warp_bilinear": (
        lambda: wcu.warp_bilinear_cuda(img32, grid, "border", True),
        lambda: plain_warp(img32, grid, "border", True),
        lambda: F.grid_sample(img32, grid, "bilinear", "border", True),
        bound(img32, grid.nelement() * 4, 30))}, card, label=" f32 image")
    return out


# K1 and K1b's timed shapes (B, K, H, W): transporter_atari b64,
# celeba128 b128, pose256 b128, extract b1024, and 64^2 (several chunks)
SOFTMAX_TIMES = {"transporter_atari b64": (64, 4, 16, 16),
                 "celeba128 b128": (128, 10, 32, 32),
                 "pose256 b128": (128, 16, 32, 32),
                 "extract b1024": (1024, 10, 32, 32),
                 "64^2 b128": (128, 10, 64, 64)}


def softmax_and_extract_times(card: str) -> None:
    """K1 and K1b, both variants, at SOFTMAX_TIMES against the bound, the
    plain version and their launch floor (N = 1, 1x1); K1's marginal
    forward also as one call with its launch; then the extract's
    images/s."""
    rs = np.random.RandomState(3)
    one = torch.zeros((1, 1, 1, 1), device="cuda")
    g_one = torch.zeros((1, 1, 2), device="cuda")
    floor = {}
    for variant in ("marginal", "joint"):
        kp_one = ssc.spatial_softmax_cuda(one, 1.0, variant)
        floor[variant] = (
            cuda_median_ms(lambda: ssc.spatial_softmax_cuda(one, 1.0, variant),
                           reps=20),
            cuda_median_ms(lambda: ssc.spatial_softmax_bwd_cuda(
                one, kp_one, g_one, 1.0, variant), reps=20))
        print(f"soft-argmax {variant} launch floor (N = 1, 1x1): K1 "
              f"{floor[variant][0] * 1e3:.2f} us, K1b "
              f"{floor[variant][1] * 1e3:.2f} us  [{card}]", flush=True)
    for label, (b, k, h, w) in SOFTMAX_TIMES.items():
        n, hw = b * k, h * w
        x = torch.from_numpy((3 * rs.randn(b, k, h, w)).astype(np.float32))
        x = x.cuda()
        g = torch.from_numpy(rs.randn(b, k, 2).astype(np.float32)).cuda()
        heat = n * hw * 4
        for variant in ("marginal", "joint"):
            kp = ssc.spatial_softmax_cuda(x, 1.0, variant)
            x_req = x.clone().requires_grad_(True)
            kp_plain = plain_softmax(x_req, 1.0, variant)
            timed = _time_cases({
                "K1": (lambda: ssc.spatial_softmax_cuda(x, 1.0, variant),
                       lambda: plain_softmax(x, 1.0, variant), None,
                       _bound(heat + n * 8, 3 * n * hw)),
                "K1b": (lambda: ssc.spatial_softmax_bwd_cuda(x, kp, g, 1.0,
                                                             variant),
                        lambda: torch.autograd.grad(kp_plain, x_req, g,
                                                    retain_graph=True),
                        None, _bound(2 * heat + 2 * n * 8, 4 * n * hw))},
                card, label=f" {label} {variant} (N={n}, {h}x{w})")
            print(f"  over the launch floor: K1 "
                  f"{(timed['K1']['ms'] - floor[variant][0]) * 1e3:.2f} us, "
                  f"K1b {(timed['K1b']['ms'] - floor[variant][1]) * 1e3:.2f} "
                  f"us  [{card}]", flush=True)
        if label == "extract b1024":
            call = cuda_median_ms(lambda: ssc.spatial_softmax_cuda(
                x, 1.0, "marginal", True), queue_behind_sleep=False)
            print(f"  one K1 marginal call with its launch: "
                  f"{call * 1e3:.1f} us  [{card}]", flush=True)

    cfg = get_config("celeba128")
    model = build_model(cfg, "cuda")
    load_model_state(model, state_dict_from_flax(random_flax_params(cfg, 0)))
    freeze_for_inference(model)
    m = cfg.model

    def plain_path(images):
        hm = model.keynet(images).float()
        return plain_softmax(hm, m.temperature, m.softmax_variant, True)

    for b in (256, 1024):
        images = torch.from_numpy(random_images(b, cfg, 4)).cuda()
        with torch.inference_mode():
            kernel_ms = cuda_median_ms(lambda: model.extract_keypoints(images),
                                       runs=20, reps=2)
            plain_ms = cuda_median_ms(lambda: plain_path(images),
                                      runs=20, reps=2)
            kernel_again = cuda_median_ms(
                lambda: model.extract_keypoints(images), runs=20, reps=2)
        print(f"extract b{b} bf16: kernel path {b / kernel_ms * 1e3:.0f} "
              f"images/s ({kernel_ms:.3f} ms, again {kernel_again:.3f} ms), "
              f"plain path {b / plain_ms * 1e3:.0f} images/s "
              f"({plain_ms:.3f} ms)  [{card}]", flush=True)


def train_step_times(card: str, trainer, steps: int = 20, label: str = "",
                     unit: str = "frames") -> float:
    """ms per train step by CUDA events around ``steps`` steps (median of 3
    runs), and by the host clock to a synchronise; steps already warm.
    ``trainer``'s last item is what each step takes: an image batch, or a
    (source, target) pair in temporal mode."""
    cfg, state, step, images = trainer
    for _ in range(3):
        state, _ = step(state, images)
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            state, _ = step(state, images)
        end.record()
        end.synchronize()
        runs.append((start.elapsed_time(end) / steps,
                     (time.perf_counter() - t0) / steps * 1e3))
    ms = float(np.median([r[0] for r in runs]))
    b = cfg.train.batch_size
    print(f"{label or cfg.name} train step b{b} bf16: {ms:.3f} ms/step by "
          f"CUDA events "
          f"(runs {', '.join(f'{r[0]:.3f}' for r in runs)}; host clock "
          f"{', '.join(f'{r[1]:.3f}' for r in runs)}), "
          f"{b / ms * 1e3:.0f} {unit}/s  [{card}]", flush=True)
    return ms


def _profile(label: str, fn, calls: int, card: str, wall_ms: float,
             kernels: dict) -> None:
    """Device time of ``calls`` calls of ``fn`` under torch.profiler: the
    sum of the kernels and copies it saw on the card, each kernel's share
    of it and the profiler's table, beside ``wall_ms`` (taken without the
    profiler). No idle share: a sum of device time over a wall is not
    one (the benchmark's ``*.device_idle_pct`` is)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not on_card:
        print(f"{label}: wall {wall_ms:.3f} ms/call; device time not "
              f"measured (the profiler saw no device events)  [{card}]",
              flush=True)
        return
    device = sum(e.time_range.elapsed_us() for e in on_card) / calls / 1e3
    shares = []
    for name, keys in kernels.items():
        t = sum(e.time_range.elapsed_us() for e in on_card
                if any(key in e.name for key in keys)) / calls / 1e3
        shares.append(f"{name} {t:.4f} ms ({t / device:.2%})")
    print(f"{label}: wall {wall_ms:.3f} ms/call, device {device:.3f} "
          f"ms/call ({calls} calls)  [{card}]", flush=True)
    if shares:
        print("  kernels: " + "; ".join(shares), flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=50),
          flush=True)


def profile_phase(card: str, trainer, step_ms: float) -> None:
    """Where the device time goes, by torch.profiler. Wall time is taken
    without the profiler over the same calls: by the host clock over calls
    queued back to back (extract on the card), as the median of single
    calls (live extract: each call ends in its D2H copy; the host's clock
    is noisy on a shared machine, so the median of many), or by CUDA events
    (train). Device time is the sum of the kernels and copies the profiler
    saw on the card (one stream, so they do not overlap)."""
    phase(f"10 profile on {card}")
    cfg = get_config("celeba128")
    state_dict = state_dict_from_flax(random_flax_params(cfg, 0))
    model = build_model(cfg, "cuda")
    load_model_state(model, state_dict)
    freeze_for_inference(model)
    live = make_live_extract(cfg, state_dict, (1, 8), "cuda")
    softargmax = {"soft-argmax": ("marginal_fwd", "joint_fwd")}

    def wall(fn, calls):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e3

    def median_call(fn, calls=200):
        for _ in range(20):
            fn()
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

    rs = np.random.RandomState(5)
    with torch.inference_mode():
        for b in (256, 1024):
            images = torch.from_numpy(random_images(b, cfg, 4)).cuda()
            fn = (lambda: model.extract_keypoints(images))
            _profile(f"extract b{b} bf16, images on the card", fn, 5, card,
                     wall(fn, 5), softargmax)
    for n in (1, 8):
        images = rs.rand(n, 3, 128, 128).astype(np.float32)
        fn = (lambda: live(images))
        _profile(f"live extract n={n} (H2D, Psi, soft-argmax, D2H; wall = "
                 f"median of 200 calls)", fn, 20, card, median_call(fn),
                 softargmax)

    _, state, step, images = trainer

    def train_step():
        step(state, images)

    _profile(f"train step b{TRAIN_BATCH} bf16 (wall = CUDA-event ms/step)",
             train_step, 5, card, step_ms,
             {"fused bottleneck": ("fused_fwd",),
              "soft-argmax bwd": ("marginal_bwd",),
              "raster bwd": ("gaussian_bwd",),
              "field warp": ("warp_field",)})


def pose_kernels_phase() -> dict:
    """The pose256 slice's kernels against their plain versions: the field
    warp at both augmentations' shapes and at ragged ones (and against
    upsample + K4 bit for bit), the max pool forward and backward at the
    VGG pools' shapes (pose256's VGG-16 and the 128^2 VGG-19 loss's), bit
    for bit; the soft-argmax and raster kernels at
    the path's 2,048 heatmaps."""
    phase("11 pose256-slice kernels vs plain")
    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {"warp_field": 0.0, "max_pool_fwd": 0.0, "max_pool_bwd": 0.0}

    def uniform(*shape, lo=-1.2, hi=1.2):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    # field warp (K5): the augmentations' fields (pose256's, celeba128's),
    # then fields spanning [-1.2, 1.2] (points outside the image) at ragged
    # shapes, F above and below the output size, Ho != H, odd Wo, F = 2 and
    # F at its limit, and a strong zoom with shear whose tiles overflow the
    # staging budget; against the plain version, and bit for bit against
    # upsample + the dense-grid kernel (K4), staged (the default) and with
    # direct gathers (stage_bytes=0)
    def augment_field(preset, size):
        field = random_warp_field(step_generator(0, 1, "cuda"), TRAIN_BATCH,
                                  warp_config(get_config(preset)))
        return ((TRAIN_BATCH, 3, size, size), field.contiguous(), (size, size))

    def zoom_shear(b, f):
        axis = torch.linspace(-1, 1, f, device="cuda")
        y, x = torch.meshgrid(axis, axis, indexing="ij")
        return torch.stack([4 * x + 1.5 * y, 4 * y], -1).expand(
            b, f, f, 2).contiguous()
    cases = [augment_field("pose256", 256), augment_field("celeba128", 128),
             ((2, 3, 45, 61), uniform(2, 9, 9, 2), (37, 53)),
             ((3, 3, 20, 30), uniform(3, 33, 33, 2), (19, 23)),
             ((2, 3, 64, 48), uniform(2, 33, 33, 2), (80, 36)),
             ((2, 3, 64, 64), uniform(2, 33, 33, 2), (64, 63)),
             ((2, 3, 40, 40), uniform(2, 2, 2, 2), (40, 40)),
             ((1, 3, 40, 40), uniform(1, wcu.MAX_FIELD, wcu.MAX_FIELD, 2),
              (50, 70)),
             ((2, 3, 256, 256), zoom_shear(2, 33), (256, 256))]
    n_cases = same = 0
    for shape, field, out_hw in cases:
        img32 = torch.rand(shape, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            img = img32.to(dtype)
            for padding in ("zeros", "border"):
                for align in (True, False):
                    k4 = wcu.warp_bilinear_cuda(img, upsample_field_aligned(
                        field, *out_hw).contiguous(), padding, align)
                    want = plain_warp(img, upsample_field_aligned(
                        field, *out_hw), padding, align)
                    for stage in (None, 0):
                        got = wcu.warp_field_cuda(img, field, *out_hw,
                                                  padding, align,
                                                  stage_bytes=stage)
                        torch.cuda.synchronize()
                        what = (f"{shape} F={field.shape[1]} -> {out_hw} "
                                f"{dtype} {padding} align={align} "
                                f"stage_bytes={stage}")
                        check(got.dtype == dtype and got.shape == want.shape,
                              f"warp_field {what}: {got.dtype} {got.shape}")
                        check(torch.equal(got, k4), f"warp_field {what}: "
                              f"not upsample + K4 bit for bit")
                        diff = (got.float() - want.float()).abs()
                        errs["warp_field"] = max(errs["warp_field"],
                                                 diff.max().item())
                        if dtype == torch.float32:
                            check(diff.max().item() <= FIELD_WARP_TOL,
                                  f"warp_field {what}: {diff.max().item()}")
                        else:
                            check(bool((diff <= bf16_ulp(want)).all()),
                                  f"warp_field {what}: more than one bf16 ulp")
                        n_cases += 1
    print(f"field warp: {n_cases} cases, each equal to upsample + K4 bit for "
          f"bit; max|d| vs plain {errs['warp_field']:.3e} (f32 tolerance "
          f"{FIELD_WARP_TOL}, bf16 within one bf16 ulp of plain)", flush=True)

    # max pool (K6), forward and backward: equal to the plain version and
    # to F.max_pool2d, on smooth values and on quantised values with ReLU
    # zeros (most windows tied): pose256's two VGG-16 pools, the VGG-19
    # loss's four at 128^2, a ragged toy shape
    n_cases = 0
    for shape in ((TRAIN_BATCH, 64, 256, 256), (TRAIN_BATCH, 128, 128, 128),
                  *VGG19_POOLS, (3, 5, 6, 10)):
        pooled = (*shape[:2], shape[2] // 2, shape[3] // 2)
        for kind in ("smooth", "ties"):
            if kind == "smooth":
                x32 = torch.randn(shape, generator=gen, device="cuda")
            else:
                x32 = torch.randint(-2, 4, shape, generator=gen,
                                    device="cuda").clamp_min(0) * 0.5
            g32 = torch.randn(pooled, generator=gen, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                x, g = x32.to(dtype), g32.to(dtype)
                y = pcu.max_pool_fwd_cuda(x)
                dx = pcu.max_pool_bwd_cuda(x, g)
                torch.cuda.synchronize()
                what = f"{shape} {kind} {dtype}"
                want_y = plain_pool(x)
                want_dx = _plain_grad(plain_pool, x, g)
                errs["max_pool_fwd"] = max(errs["max_pool_fwd"], (
                    y.float() - want_y.float()).abs().max().item())
                errs["max_pool_bwd"] = max(errs["max_pool_bwd"], (
                    dx.float() - want_dx.float()).abs().max().item())
                check(torch.equal(y, want_y), f"max_pool_fwd {what}")
                check(torch.equal(dx, want_dx), f"max_pool_bwd {what}")
                check(torch.equal(y, F.max_pool2d(x, 2, 2)),
                      f"max_pool_fwd vs F.max_pool2d {what}")
                check(torch.equal(dx, _plain_grad(
                    lambda t: F.max_pool2d(t, 2, 2), x, g)),
                    f"max_pool_bwd vs F.max_pool2d's gradient {what}")
                del y, dx, want_y, want_dx
                n_cases += 1
    print(f"max pool: {n_cases} cases, forward and backward equal to the "
          f"plain version and to F.max_pool2d bit for bit", flush=True)

    # the soft-argmax and raster kernels at this path's shapes: b128 x 16
    # heatmaps of 32^2, sigma 0.05, with phase 4's tolerances
    cfg = get_config("pose256").model
    cases = _bottleneck_cases(TRAIN_BATCH, cfg.num_keypoints, cfg.sigma, 5)
    for name, (kernel, plain, *_) in cases.items():
        want = plain()
        want = want[0] if isinstance(want, tuple) else want
        got = kernel().reshape(want.shape)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        errs[name] = max(errs.get(name, 0.0), err)
        tol = {"spatial_softmax_fwd": KERNEL_TOL,
               "gaussian_bwd": RASTER_GRAD_RTOL * want.abs().max().item()
               }.get(name, GRAD_TOL)
        print(f"{name} N={TRAIN_BATCH * cfg.num_keypoints} 32x32 sigma "
              f"{cfg.sigma}: max|d| {err:.3e} (tolerance {tol:.3e})",
              flush=True)
        check(err <= tol, f"{name} at pose256's shape: {err} > {tol}")
    return errs


def pose_times_phase(card: str) -> dict:
    """The pose256 slice's kernels at b128 (3x256^2 bf16 images, the VGG
    pools in bf16, 16 keypoints): device time, plain and library times and
    the bound, as in phase 9; the pool also at the VGG-19 loss's four
    pools at 128^2; the field warp against upsample + dense warp
    at 256^2 and 128^2; the bottleneck kernels at N = 2,048."""
    phase(f"14 pose256 times on {card}")
    b = TRAIN_BATCH
    cfg = get_config("pose256")
    gen = torch.Generator(device="cuda").manual_seed(14)
    field = random_warp_field(step_generator(0, 2, "cuda"), b,
                              warp_config(cfg)).contiguous()
    img = torch.rand((b, 3, 256, 256), generator=gen,
                     device="cuda").to(torch.bfloat16)
    cases = {"warp_field": (
        lambda: wcu.warp_field_cuda(img, field, 256, 256, "border", True),
        lambda: plain_warp(img, upsample_field_aligned(field, 256, 256),
                           "border", True), None,
        _bound(2 * img.nelement() * 2 + field.nelement() * 4,
               50 * b * 256 * 256 + 8 * img.nelement()))}
    pool_shapes = {"pool1": (b, 64, 256, 256), "pool2": (b, 128, 128, 128)}
    pool_inputs = {}
    for label, shape in pool_shapes.items():
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16).relu()
        g = torch.randn((*shape[:2], shape[2] // 2, shape[3] // 2),
                        generator=gen, device="cuda", dtype=torch.bfloat16)
        x_req = x.clone().requires_grad_(True)
        pool_inputs[label] = (x, g, x_req, plain_pool(x_req),
                              F.max_pool2d(x_req, 2, 2))
    out = _time_cases(cases, card, label=" 3x256^2")
    # the kernels' line reports the field warp at celeba128's 3x128^2 (phase 9)
    del out["warp_field"]
    for label, (x, g, x_req, y_plain, y_lib) in pool_inputs.items():
        nx, ny = x.nelement() * 2, x.nelement() // 2
        pool = _time_cases({
            "max_pool_fwd": (
                lambda: pcu.max_pool_fwd_cuda(x), lambda: plain_pool(x),
                lambda: F.max_pool2d(x, 2, 2),
                _bound(nx + ny, 3 * x.nelement() // 4)),
            "max_pool_bwd": (
                lambda: pcu.max_pool_bwd_cuda(x, g),
                lambda: torch.autograd.grad(y_plain, x_req, g,
                                            retain_graph=True),
                lambda: torch.autograd.grad(y_lib, x_req, g,
                                            retain_graph=True),
                _bound(2 * nx + ny, 2 * x.nelement()))},
            card, reps=10, plain_reps=3, label=f" {label} {tuple(x.shape)}")
        if label == "pool1":
            out.update(pool)
    print("pool library calls: F.max_pool2d and its autograd backward "
          "(max_pool2d_with_indices_backward); the kernels' line reports "
          "pool1, the larger call", flush=True)
    # the VGG-19 loss's pools at 128^2, bf16 after a ReLU as in its step:
    # each kernel against its bound (no plain or library time: phase 11
    # holds them equal to both)
    for i, shape in enumerate(VGG19_POOLS):
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16).relu()
        g = torch.randn((*shape[:2], shape[2] // 2, shape[3] // 2),
                        generator=gen, device="cuda", dtype=torch.bfloat16)
        nx, ny = x.nelement() * 2, x.nelement() // 2
        for name, run, (bound_ms, bound_by) in (
                ("max_pool_fwd", lambda: pcu.max_pool_fwd_cuda(x),
                 _bound(nx + ny, 3 * x.nelement() // 4)),
                ("max_pool_bwd", lambda: pcu.max_pool_bwd_cuda(x, g),
                 _bound(2 * nx + ny, 2 * x.nelement()))):
            k_ms = cuda_median_ms(run, reps=20)
            print(f"{name} vgg19 pool{i + 1} {shape}: kernel "
                  f"{k_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.2f} us by "
                  f"{bound_by} = {bound_ms / k_ms:.1%} of the kernel's time  "
                  f"[{card}]", flush=True)
        del x, g

    # the field kernel's two designs, in turns: tiles staged in shared
    # memory (the kept one) and direct gathers (stage_bytes=0, the branch a
    # tile over the budget takes), and the path it replaces, upsample +
    # dense warp, at pose256's 3x256^2 and celeba128's 3x128^2
    for size in (256, 128):
        cfg_s = get_config("pose256" if size == 256 else "celeba128")
        fld = random_warp_field(step_generator(0, 3, "cuda"), b,
                                warp_config(cfg_s)).contiguous()
        im = img if size == 256 else img[:, :, :128, :128].contiguous()
        runs = {
            "staged": lambda: wcu.warp_field_cuda(im, fld, size, size,
                                                  "border", True),
            "direct": lambda: wcu.warp_field_cuda(im, fld, size, size,
                                                  "border", True,
                                                  stage_bytes=0),
            "upsample + K4": lambda: wcu.warp_bilinear_cuda(
                im, upsample_field_aligned(fld, size, size), "border", True)}
        order = ("staged", "direct", "upsample + K4", "direct", "staged")
        t = [cuda_median_ms(runs[name], reps=20) for name in order]
        print(f"field warp b{b} 3x{size}^2 bf16 ({cfg_s.name}'s field), us: "
              f"staged {t[0] * 1e3:.2f} / {t[4] * 1e3:.2f}, direct gathers "
              f"{t[1] * 1e3:.2f} / {t[3] * 1e3:.2f}, upsample + dense-grid "
              f"kernel {t[2] * 1e3:.2f}  [{card}]", flush=True)

    _time_cases(_bottleneck_cases(b, cfg.model.num_keypoints,
                                  cfg.model.sigma, 5), card,
                label=f" N={b * cfg.model.num_keypoints}")

    # the perceptual loss alone: the VGG trunk on a reconstruction (f32,
    # with its backward) and on a bf16 target, as the step runs it
    loss = make_loss(cfg)
    recon = torch.rand((b, 3, 256, 256), generator=gen,
                       device="cuda").requires_grad_(True)
    vgg_ms = cuda_median_ms(lambda: torch.autograd.grad(loss(recon, img),
                                                        recon), runs=5)
    print(f"perceptual loss b{b} 256^2 (VGG-16 to relu3_3 on recon and "
          f"target, bf16 convs), forward and backward: {vgg_ms:.3f} ms  "
          f"[{card}]", flush=True)
    return out


def pose_profile_phase(card: str, trainer, step_ms: float) -> None:
    phase(f"15 profile on {card}")
    _, state, step, images = trainer

    def train_step():
        step(state, images)

    _profile(f"pose256 train step b{TRAIN_BATCH} bf16 (wall = CUDA-event "
             f"ms/step)", train_step, 2, card, step_ms,
             {"fused bottleneck": ("fused_fwd",),
              "soft-argmax bwd": ("marginal_bwd",),
              "raster bwd": ("gaussian_bwd",),
              "field warp": ("warp_field",),
              "pool fwd": ("max_pool_fwd",),
              "pool bwd": ("max_pool_bwd",)})


# the fused bottleneck's shapes: transporter_atari's b64 (the main path), a
# ragged one, and the joint celeba128 and pose256 bottlenecks at b128; then
# the warp path's other layouts (several chunks at 64^2, LAYOUT_SHAPES), an
# unaligned base, and maps whose coordinate table passes K3's old 4,096
# limit of Ho + Wo or the default 48 KB of shared memory (warp and block path)
BOTTLENECK_CASES = {"atari b64": ((64, 4, 16, 16), (16, 16), 0.1),
                    "ragged": ((1, 7, 13, 29), (11, 17), 0.1),
                    "celeba128 b128": ((128, 10, 32, 32), (32, 32), 0.1),
                    "pose256 b128": ((128, 16, 32, 32), (32, 32), 0.05),
                    "64x64": ((2, 3, 64, 64), (64, 64), 0.1),
                    **{"x".join(map(str, s[1:])): ((1, *s), s[1:], 0.1)
                       for s in LAYOUT_SHAPES},
                    "unaligned": ((4, 10, 32, 32), (32, 32), 0.1),
                    "8x4100 maps": ((2, 3, 32, 32), (8, 4100), 0.1),
                    "4x13000 maps": ((1, 2, 16, 16), (4, 13000), 0.1),
                    "65x8 to 3x12400": ((1, 2, 65, 8), (3, 12400), 0.1),
                    # the output sizes the map writing branches on: Wo % 4
                    # != 0 with Ho * Wo odd (scalar stores), Wo < 4, and
                    # float4 runs of a 16-wide map from 32^2 heatmaps
                    "7x13 maps": ((2, 5, 16, 16), (7, 13), 0.1),
                    "5x3 maps": ((2, 5, 13, 29), (5, 3), 0.1),
                    "16x16 maps": ((4, 10, 32, 32), (16, 16), 0.1)}


def _unaligned_maps_equal(x, kp, maps, t, sigma, align, variant) -> bool:
    """K3 with its maps 4 bytes past a 16-byte boundary (pixel by pixel
    stores) gives ``kp`` and ``maps`` bit for bit."""
    buf = torch.empty(maps.numel() + 1, device="cuda")
    off = buf[1:].view(maps.shape)
    kp_off = torch.empty_like(kp)
    fbc._launch(x, kp_off, off, t, sigma, align, variant)
    torch.cuda.synchronize()
    return torch.equal(kp_off, kp) and torch.equal(off, maps)


def fused_kernel_phase() -> dict:
    """K3 against its plain version (forward) and its autograd (the
    composed backward), and against K1 then K2 on the same heatmaps, bit
    for bit; both variants, both align_corners, T in {1.0, 0.7}."""
    phase("16 fused bottleneck (K3) vs plain")
    rs = np.random.RandomState(16)
    worst = {"kp": 0.0, "maps": 0.0, "dh": 0.0, "dh_share": 0.0}
    cases = 0
    for label, (shape, (ho, wo), sigma) in BOTTLENECK_CASES.items():
        if label == "unaligned":
            x = _unaligned(shape, rs)
        else:
            x = torch.from_numpy((3 * rs.randn(*shape)).astype(np.float32))
            x = x.cuda()
        g_kp = torch.from_numpy(rs.randn(*shape[:2], 2).astype(np.float32))
        g_maps = torch.from_numpy(rs.randn(*shape[:2], ho, wo)
                                  .astype(np.float32))
        g_kp, g_maps = g_kp.cuda(), g_maps.cuda()
        for variant, align, t in itertools.product(
                ("joint", "marginal"), (True, False), (1.0, 0.7)):
            what = f"{label} {variant} align={align} T={t}"
            kp, maps = fbc.softargmax_raster_cuda(x, ho, wo, t, sigma, align,
                                                  variant)
            torch.cuda.synchronize()
            kp_p, maps_p = plain_bottleneck(x, ho, wo, t, sigma, align,
                                            variant)
            e_kp = (kp - kp_p).abs().max().item()
            e_maps = (maps - maps_p).abs().max().item()
            check(e_kp <= KERNEL_TOL, f"K3 keypoints {what}: {e_kp}")
            check(e_maps <= fused_map_tolerance(sigma),
                  f"K3 maps {what}: {e_maps}")
            kp1 = ssc.spatial_softmax_cuda(x, t, variant, align)
            maps2 = gcu.gaussian_fwd_cuda(kp1.reshape(-1, 2), ho, wo, sigma,
                                          align)
            check(torch.equal(kp, kp1)
                  and torch.equal(maps, maps2.reshape(maps.shape)),
                  f"K3 {what}: not K1 then K2 bit for bit")
            check(_unaligned_maps_equal(x, kp, maps, t, sigma, align, variant),
                  f"K3 {what}: maps 4 bytes past a 16-byte boundary differ")

            xk = x.clone().requires_grad_(True)
            torch.autograd.backward(fbc.softargmax_raster_autograd(
                xk, ho, wo, t, sigma, align, variant), (g_kp, g_maps))
            xr = x.clone().requires_grad_(True)
            torch.autograd.backward(plain_bottleneck(
                xr, ho, wo, t, sigma, align, variant), (g_kp, g_maps))
            torch.cuda.synchronize()
            diff = (xk.grad - xr.grad).abs()
            tol = fused_grad_tolerance(x, ho, wo, t, sigma, align, variant,
                                       g_kp, g_maps)
            check(bool((diff <= tol).all()),
                  f"K3 dheatmaps {what}: {diff.max().item()}")
            worst["kp"] = max(worst["kp"], e_kp)
            worst["maps"] = max(worst["maps"], e_maps)
            worst["dh"] = max(worst["dh"], diff.max().item())
            worst["dh_share"] = max(worst["dh_share"],
                                    (diff / tol).max().item())
            cases += 1
    print(f"K3: {cases} cases; keypoints max|d| {worst['kp']:.3e} (tolerance "
          f"{KERNEL_TOL}), maps max|d| {worst['maps']:.3e} (tolerance "
          f"{fused_map_tolerance(0.1):.2e} at sigma 0.1, "
          f"{fused_map_tolerance(0.05):.2e} at 0.05), "
          f"dheatmaps max|d| {worst['dh']:.3e} (at {worst['dh_share']:.3f} of "
          f"its elementwise tolerance); keypoints and maps equal to K1 then "
          f"K2 bit for bit in all {cases} cases, and with the maps 4 bytes "
          f"past a 16-byte boundary", flush=True)
    return {"softargmax_raster_fwd": max(worst["kp"], worst["maps"])}


def transporter_parity_phase() -> None:
    """3 full-width f32 temporal-mode steps per variant on the card (the
    kernels: K3 for joint) and on this machine's CPU (the plain versions),
    against the committed JAX reference."""
    ref = json.loads(TRANSPORTER_REFERENCE.read_text())
    phase(f"17 train parity: full-width {ref['preset']} f32 (TF32 off), 3 "
          f"steps per variant on seeded pairs, card and CPU vs committed JAX "
          f"reference")
    with float32_precision():
        for variant, want in ref["runs"].items():
            cfg = get_config(ref["preset"]).override(**{
                **ref["overrides"], "model.softmax_variant": variant})
            for device in ("cuda", "cpu"):
                t0 = time.perf_counter()
                state = init_state(cfg, device)
                load_model_state(state.model, state_dict_from_flax(
                    random_flax_params(cfg, ref["param_seed"])))
                src, tgt = (torch.from_numpy(random_images(
                    ref["batch"], cfg, s)).to(device)
                    for s in ref["image_seeds"])
                with torch.no_grad():
                    kp = state.model(src, tgt)[1].cpu().numpy()
                step = make_train_step(cfg)
                losses, norms, grads = [], [], {}
                for i in range(ref["steps"]):
                    state, metrics = step(state, (src, tgt))
                    losses.append(metrics["loss"].item())
                    norms.append(metrics["grad_norm"].item())
                    if i == 0:
                        grads = {k: p.grad.norm().item()
                                 for k, p in state.model.named_parameters()}
                check(all(p.dtype == torch.float32
                          for p in state.model.parameters()), "non-f32 params")
                kp_err = float(np.abs(kp - np.asarray(want["keypoints"]))
                               .max())
                loss_rel = max(abs(a / b - 1)
                               for a, b in zip(losses, want["loss"]))
                norm_rel = max(abs(a / b - 1)
                               for a, b in zip(norms, want["grad_norm"]))
                worst_param = max(
                    abs(grads[k] - v) / grad_norm_tolerance(
                        v, want["grad_norm"][0])
                    for k, v in want["grad_norms"].items())
                print(f"{variant} {device}: losses {losses} grad_norms {norms}"
                      f" ({time.perf_counter() - t0:.1f}s); vs JAX: step-1 "
                      f"keypoints max|d| {kp_err:.3e} (tolerance "
                      f"{TRAIN_KP_TOL}), loss rel {loss_rel:.3e}, grad_norm "
                      f"rel {norm_rel:.3e} (tolerance {TRAIN_RTOL}), "
                      f"per-parameter gradient norms at {worst_param:.3f} of "
                      f"their tolerance", flush=True)
                check(kp_err <= TRAIN_KP_TOL,
                      f"{variant} {device} keypoints {kp_err}")
                check(loss_rel <= TRAIN_RTOL,
                      f"{variant} {device} loss rel {loss_rel}")
                check(norm_rel <= TRAIN_RTOL,
                      f"{variant} {device} grad_norm rel {norm_rel}")
                check(grads.keys() == want["grad_norms"].keys(),
                      "parameter names")
                check(worst_param <= 1.0,
                      f"{variant} {device} per-parameter grad norms")


def transporter_train_phase(variant: str, steps: int):
    """transporter_atari's training path at the preset's b64 in bf16:
    ``steps`` scripted-Pong pairs drawn on the card first (the raster
    kernel renders the ball), then ``steps`` temporal-mode steps with the
    counts reset just before; every kernel launched exactly as often as a
    step of this variant launches it."""
    cfg = get_config("transporter_atari").override(
        **{"model.softmax_variant": variant})
    b = cfg.train.batch_size
    phase(f"18 train (transporter_atari full width, softmax_variant={variant},"
          f" b{b}, bf16, {steps} steps on scripted-Pong pairs drawn on the "
          f"card)")
    state = init_state(cfg, "cuda")
    step = make_train_step(cfg)
    reset_counts()
    pairs = [scripted_pong_pair(step_generator(cfg.train.seed, i, "cuda"), b,
                                cfg.data.image_size)[:2]
             for i in range(steps)]
    torch.cuda.synchronize()
    drawn = read_counts()
    print(f"{steps} pairs of 2x{b}x1x{cfg.data.image_size}^2 frames: "
          f"raster launches {drawn['gaussian_fwd']} (2 a pair), mean pixel "
          f"{torch.stack([p[0].mean() for p in pairs]).mean().item():.4f}",
          flush=True)
    check(drawn["gaussian_fwd"] == 2 * steps, f"pong raster launches {drawn}")
    reset_counts()
    t0 = time.perf_counter()
    losses = []
    for pair in pairs:
        state, metrics = step(state, pair)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    losses = torch.stack(losses).cpu().numpy()
    print(f"{steps} steps in {wall:.2f}s (first steps include cuDNN's "
          f"set-up); losses {losses[0]:.5f} -> {losses[-1]:.5f}, mean of the "
          f"first 5 {losses[:5].mean():.5f}, of the last 5 "
          f"{losses[-5:].mean():.5f}", flush=True)
    print(f"kernel launches during training: {counts}", flush=True)
    check(bool(np.isfinite(losses).all()), f"non-finite losses {losses}")
    check(losses[-5:].mean() < losses[:5].mean(),
          f"losses did not fall: {losses}")
    check(all(p.dtype == torch.float32 for p in state.model.parameters()),
          "parameters are not float32 after bf16 steps")
    path = PATHS.index(f"transporter_atari {variant}")
    for name, (*_, per_step) in KERNELS.items():
        want = per_step[path] * steps
        check(counts[name] == want, f"{name} launched {counts[name]} times "
              f"in {steps} {variant} steps ({want} expected)")
    return counts, (cfg, state, step, pairs[0])


def _fused_cases(shape, out_hw, sigma: float, variant: str, seed: int):
    """K3 at one shape: (kernel, plain, library, bound) for ``_time_cases``
    and the unfused K1 then K2 pair on the same heatmaps."""
    b, k, h, w = shape
    ho, wo = out_hw
    n = b * k
    x = torch.from_numpy((3 * np.random.RandomState(seed).randn(*shape))
                         .astype(np.float32)).cuda()

    def unfused():
        kp = ssc.spatial_softmax_cuda(x, 1.0, variant)
        return gcu.gaussian_fwd_cuda(kp.reshape(n, 2), ho, wo, sigma)
    case = (lambda: fbc.softargmax_raster_cuda(x, ho, wo, 1.0, sigma, True,
                                               variant),
            lambda: plain_bottleneck(x, ho, wo, 1.0, sigma, True, variant),
            None,
            _bound(n * h * w * 4 + n * ho * wo * 4 + n * 8,
                   6 * n * h * w + 10 * n * ho * wo))
    return case, unfused


def fused_times(card: str) -> dict:
    """K3 at the three presets' bottleneck shapes, both variants: device
    time (calls queued behind a sleep, inputs L2-warm) against K1 + K2 back
    to back, the plain version and the byte bound. Returns transporter_atari
    b64 joint's entry, the kernels line's."""
    out = {}
    for label in ("atari b64", "celeba128 b128", "pose256 b128"):
        shape, out_hw, sigma = BOTTLENECK_CASES[label]
        for variant in ("joint", "marginal"):
            case, unfused = _fused_cases(shape, out_hw, sigma, variant, 19)
            timed = _time_cases({"softargmax_raster_fwd": case}, card,
                                label=f" {label} {variant} (N="
                                f"{shape[0] * shape[1]}, "
                                f"{shape[2]}x{shape[3]} -> "
                                f"{out_hw[0]}x{out_hw[1]})")
            k1k2 = cuda_median_ms(unfused, reps=20)
            print(f"  K1 then K2 on the same heatmaps: {k1k2 * 1e3:.2f} us "
                  f"(K3 {timed['softargmax_raster_fwd']['ms'] * 1e3:.2f})  "
                  f"[{card}]", flush=True)
            if label == "atari b64" and variant == "joint":
                out.update(timed)         # the main path's shape and variant
    return out


def transporter_times_phase(card: str, trainers: dict) -> dict:
    """K3 against K1 + K2 (``fused_times``); K2 alone at N = 256 16^2 and
    its launch floor at N = 1, 1x1; then each variant's train step and a
    torch.profiler breakdown of it."""
    phase(f"19 transporter times on {card}")
    out = fused_times(card)
    # the raster alone at transporter_atari's shape (the joint step's
    # backward, the marginal step's forward and backward, the Pong ball),
    # then at N = 1, 1x1: the launch floor
    _time_cases(_raster_cases(256, 16, 16, 0.1, 19), card,
                label=" N=256 16x16 sigma 0.1 (transporter_atari)")
    floor = {name: cuda_median_ms(kernel, reps=20) for name, (kernel, *_)
             in _raster_cases(1, 1, 1, 0.1, 19).items()}
    print(f"launch floor (N = 1, 1x1): gaussian_fwd "
          f"{floor['gaussian_fwd'] * 1e3:.2f} us, gaussian_bwd "
          f"{floor['gaussian_bwd'] * 1e3:.2f} us  [{card}]", flush=True)
    profiled = {"fused bottleneck": ("fused_fwd",),
                "soft-argmax fwd": ("joint_fwd", "marginal_fwd"),
                "soft-argmax bwd": ("joint_bwd", "marginal_bwd"),
                "raster fwd": ("gaussian_fwd",),
                "raster bwd": ("gaussian_bwd",)}
    for variant, trainer in trainers.items():
        cfg, state, step, pair = trainer
        label = f"transporter_atari {variant}"
        ms = train_step_times(card, trainer, steps=20, label=label,
                              unit="pairs")

        def train_step():
            step(state, pair)
        _profile(f"{label} train step b{cfg.train.batch_size} bf16 (wall = "
                 f"CUDA-event ms/step)", train_step, 5, card, ms, profiled)
    return out


# the banded warps' shapes: b128 bf16 images at the port's own warp grids,
# with each size's warp_y_window (keypoints_tpu.data.augment.warp_y_window)
BANDED_SHAPES = {"celeba128": (128, 40), "pose256": (256, 75)}
BANDED = {"warp_band": (ecu.warp_bilinear_tree_cuda, plain_tree,
                        banded.warp_bilinear_tree),
          "warp_rowwin": (ecu.warp_bilinear_rowwin_cuda, plain_rowwin,
                          banded.warp_bilinear_rowwin)}


def _banded_inputs(preset: str, size: int, seed: int):
    """A b128 3 x size^2 bf16 batch and a warp grid of ``preset``'s
    augmentation (its coarse field upsampled to the image)."""
    cfg = get_config(preset)
    rs = np.random.RandomState(seed)
    img = torch.from_numpy(rs.rand(TRAIN_BATCH, 3, size, size)
                           .astype(np.float32)).cuda().to(torch.bfloat16)
    field = random_warp_field(step_generator(seed, 0, "cuda"), TRAIN_BATCH,
                              warp_config(cfg))
    return img, upsample_field_aligned(field, size, size).contiguous()


def _alternating_grid(transpose: bool) -> torch.Tensor:
    """tests/test_experimental_kernels.py's violated-window grid, 64 x 64:
    y alternates between -0.9 and 0.9 from output row to output row (every
    8-row block spans the image), or with ``transpose`` from column to
    column (every row spans it)."""
    xs = torch.linspace(-0.9, 0.9, 64)
    ys = torch.where(torch.arange(64) % 2 == 0, -0.9, 0.9)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    if transpose:
        gy = gy.T
    return torch.stack([gx, gy], -1)[None].contiguous().cuda()


def banded_kernels_phase() -> tuple[dict, dict]:
    """K7 and K8 against their plain versions (within one bf16 ulp) and,
    where the window holds, against K4 (bit for bit); no band, rows read in
    place, violated windows; then the two entry points once at each main
    shape with the counts reset: the launches of their path."""
    phase("20 banded warps (K7, K8) vs plain and vs K4")
    errs = {name: 0.0 for name in BANDED}

    def held(name, got, want, what):
        check(got.dtype == torch.bfloat16 and got.shape == want.shape,
              f"{name} {what}: {got.dtype} {tuple(got.shape)}")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        errs[name] = max(errs[name], err)
        check(bool((diff <= bf16_ulp(want)).all()),
              f"{name} {what}: more than one bf16 ulp from plain ({err})")
        return err

    cases = [(f"{preset} b{TRAIN_BATCH} 3x{size}^2 y_window {win}",
              *_banded_inputs(preset, size, 20), win, True)
             for preset, (size, win) in BANDED_SHAPES.items()]
    rs = np.random.RandomState(20)
    img, grid = cases[1][1:3]
    # K7 without a band
    cases.append(("256^2 no band", img[:4], grid[:4], None, True))
    # a 1,024-wide image
    cases.append(("256x1024 -> 256^2",
                  torch.from_numpy(rs.rand(2, 3, 256, 1024).astype(np.float32))
                  .cuda().to(torch.bfloat16), grid[:2], 75, True))
    # a grid aligned to 8 bytes but not 16: one pixel a thread
    unaligned = torch.empty(grid[:4].numel() + 2, device="cuda")
    unaligned = unaligned[2:].view(grid[:4].shape).copy_(grid[:4])
    cases.append(("256^2, grid 8-byte aligned", img[:4], unaligned, 75, True))
    # ragged widths (odd Wo: one pixel a thread; Wo < 32; 600 wide: a 38 KB
    # K7 band) and points outside the image
    for (hw, (ho, wo)) in (((48, 36), (16, 20)), ((48, 36), (8, 21)),
                           ((64, 96), (8, 600))):
        for align in (True, False):
            cases.append((f"ragged {hw[0]}x{hw[1]} -> {ho}x{wo} "
                          f"align={align}",
                          torch.from_numpy(rs.rand(2, 3, *hw)
                                           .astype(np.float32)).cuda()
                          .to(torch.bfloat16),
                          torch.from_numpy((rs.rand(2, ho, wo, 2) * 2.4 - 1.2)
                                           .astype(np.float32)).cuda(), 8,
                          align))
    for what, img, grid, win, align in cases:
        for padding in ("zeros", "border"):
            k4 = wcu.warp_bilinear_cuda(img, grid, padding, align)
            unbanded = plain_tree(img, grid, padding, align, None)
            for name, (kernel, plain, _) in BANDED.items():
                if win is None and name == "warp_rowwin":
                    continue
                got = kernel(img, grid, padding, align, win)
                torch.cuda.synchronize()
                want = plain(img, grid, padding, align, win)
                err = held(name, got, want, f"{what} {padding}")
                holds = torch.equal(want, unbanded)
                same = torch.equal(got, k4)
                print(f"{name} {what} {padding}: max|d| vs plain {err:.3e}; "
                      f"window {'holds' if holds else 'violated'}; "
                      f"{'equal to' if same else 'differs from'} K4",
                      flush=True)
                if holds:
                    check(same, f"{name} {what} {padding}: window holds but "
                          f"the result differs from K4")

    # violated windows at 128 and 256 rows: rows past each band read as 0
    for h in (128, 256):
        img = torch.from_numpy(np.random.RandomState(29).rand(1, 3, h, 64)
                               * 0.8 + 0.1).float().cuda().to(torch.bfloat16)
        for name, transpose in (("warp_band", False), ("warp_rowwin", True)):
            kernel, plain, _ = BANDED[name]
            grid = _alternating_grid(transpose)
            got = kernel(img, grid, "zeros", True, 32)
            torch.cuda.synchronize()
            err = held(name, got, plain(img, grid, "zeros", True, 32),
                       f"violated window, {h} rows")
            # the samples at y = 0.9 (odd rows, or odd columns) lie past
            # the band
            zeroed = got[..., 1::2] if transpose else got[:, :, 1::2]
            check(bool((zeroed == 0).all()), f"{name}: the out-of-band "
                  f"samples of a violated window are not 0")
            check(bool((got[:, :, ::2, ::2] > 0).all()),
                  f"{name}: in-band samples of a violated window are 0")
            print(f"{name} violated window ({h} rows, y alternating by "
                  f"{'column' if transpose else 'row'}, y_window 32): "
                  f"max|d| vs plain {err:.3e}; the {zeroed.numel()} "
                  f"out-of-band samples are 0", flush=True)

    # the entry points once at each main shape: the launches of their path
    reset_counts()
    for what, img, grid, win, _ in cases[:2]:
        for name, (*_, entry) in BANDED.items():
            entry(img, grid, "border", True, win)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"kernel launches of the entry points at the two main shapes: "
          f"{counts}", flush=True)
    for name in KERNELS:
        want = 2 if name in BANDED else 0
        check(counts[name] == want, f"{name} launched {counts[name]} times "
              f"by the banded entry points ({want} expected)")
    return errs, counts


def banded_times_phase(card: str) -> dict:
    """K7 and K8 at the two main shapes: device time (calls queued behind a
    sleep, inputs L2-warm) against the byte bound, the plain version,
    F.grid_sample on the bf16 image and K4 on the same grid; the launches a
    call makes."""
    phase(f"21 banded warp times on {card}")
    out = {}
    for preset, (size, win) in BANDED_SHAPES.items():
        img, grid = _banded_inputs(preset, size, 21)
        grid_bf16 = grid.to(torch.bfloat16)
        pixels = TRAIN_BATCH * size * size
        bound = _bound(2 * img.nelement() * img.element_size()
                       + grid.nelement() * 4, 30 * pixels + 8 * img.nelement())
        cases = {name: (
            (lambda k=kernel: k(img, grid, "border", True, win)),
            (lambda p=plain: p(img, grid, "border", True, win)),
            lambda: F.grid_sample(img, grid_bf16, "bilinear", "border", True),
            bound) for name, (kernel, plain, _) in BANDED.items()}
        timed = _time_cases(cases, card, plain_reps=2,
                            label=f" {preset} b{TRAIN_BATCH} 3x{size}^2 "
                            f"y_window {win}")
        k4 = cuda_median_ms(lambda: wcu.warp_bilinear_cuda(img, grid,
                                                           "border", True),
                            reps=20)
        reset_counts()
        for kernel, *_ in BANDED.values():
            kernel(img, grid, "border", True, win)
        per_call = read_counts()
        print(f"  K4 on the same grid: {k4 * 1e3:.2f} us; launches per call: "
              f"K7 {per_call['warp_band']}, K8 {per_call['warp_rowwin']}  "
              f"[{card}]", flush=True)
        if preset == "celeba128":
            out.update(timed)
    print("library call: F.grid_sample on the bf16 image takes only a bf16 "
          "grid, so it reads the grid cast to bf16", flush=True)
    return out

EVAL_REFERENCE = ROOT / "tests" / "data" / "torch_port_celeba128_eval.json"
EVAL_BATCH = 64
EVAL_RTOL = 1e-4       # eval parity: eval_loss
EVAL_KP_TOL = 1e-4     # eval parity: keypoints
LANDMARK_TOL = 1e-5    # eval parity: landmarks carried into the target
EVAL_RECORD_KEYS = {"preset", "step", "metrics", "source", "held_out", "rows",
                    "requested_rows", "gt"}
# preset, overrides, the kernels one eval of b64 launches: the pair
# (celeba128's warps, pose256's field warps, the Pong frames' raster), the
# bottleneck, pose256's VGG pools on the reconstruction and the target
EVAL_CASES = {
    "celeba128": ([], {"warp_field": 2, "softargmax_raster_fwd": 1}),
    "pose256": ([], {"warp_field": 2, "softargmax_raster_fwd": 1,
                     "max_pool_fwd": 4}),
    "transporter_atari": (["model.softmax_variant=joint"],
                          {"gaussian_fwd": 2, "softargmax_raster_fwd": 2}),
}


def eval_phase(card: str, tmp: str) -> list:
    """The eval CLI on the card for celeba128, pose256 and transporter_atari
    (joint) at full width and b64, with seeded weights saved as the state
    dict ``serve`` loads: in this process with the counts reset (the
    launches of the path), then as ``python -m keypoints_tpu_torch.eval``;
    f32 ``evaluate`` against the committed JAX reference; bulk extraction
    against per-batch extraction at b1024."""
    phase(f"22 eval on {card}")
    path_counts = []
    for preset, (overrides, want) in EVAL_CASES.items():
        cfg = get_config(preset)
        ckpt = os.path.join(tmp, f"{preset}.pt")
        torch.save({k: torch.from_numpy(v) for k, v in state_dict_from_flax(
            random_flax_params(cfg, 0)).items()}, ckpt)
        # data.data_dir without a store: the synthetic eval set
        argv = ["--preset", preset, "--checkpoint", ckpt, "--batch",
                str(EVAL_BATCH), "--override", f"data.data_dir={tmp}",
                *overrides]
        reset_counts()
        t0 = time.perf_counter()
        in_process = peval.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        path_counts.append(counts)
        print(f"{preset} eval b{EVAL_BATCH} in this process: {wall:.2f}s "
              f"(first call of the preset), launches {counts}", flush=True)
        for name in KERNELS:
            check(counts[name] == want.get(name, 0),
                  f"{preset} eval launched {name} {counts[name]} times "
                  f"({want.get(name, 0)} expected)")
        out = os.path.join(tmp, f"{preset}.json")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "keypoints_tpu_torch.eval",
                              *argv, "--json", out], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(run.returncode == 0, f"{preset} eval CLI exited "
              f"{run.returncode}: {run.stderr[-2000:]}")
        record = json.loads(Path(out).read_text())
        print(f"{preset} eval CLI ({wall:.2f}s): {run.stdout.splitlines()[-2]}",
              flush=True)
        for result in (record, in_process):
            check(set(result) == EVAL_RECORD_KEYS,
                  f"{preset} record keys {sorted(result)}")
            check(result["source"] == "synthetic" and result["held_out"]
                  and result["rows"] == EVAL_BATCH and result["step"] is None,
                  f"{preset} record {result}")
            check(all(np.isfinite(v) for v in result["metrics"].values()),
                  f"{preset} metrics {result['metrics']}")

    ref = json.loads(EVAL_REFERENCE.read_text())
    cfg = get_config(ref["preset"]).override(**ref["overrides"])
    b = ref["batch"]
    src, tgt, pos = reference_eval_batch(ref, "cuda")
    model = build_model(cfg, "cuda")
    load_model_state(model, state_dict_from_flax(
        random_flax_params(cfg, ref["param_seed"])))
    got = peval.evaluate(model, src, tgt, true_positions=pos.cpu().numpy())
    _, kp = peval.eval_forward(model, src, tgt)
    want = ref["metrics"]
    loss_rel = abs(got["eval_loss"] - want["eval_loss"]) / want["eval_loss"]
    kp_err = float(np.abs(kp.cpu().numpy()
                          - decode_f32(ref["keypoints"], (b, 10, 2))).max())
    pos_err = float(np.abs(pos.cpu().numpy() - decode_f32(
        ref["target_positions"], (b, 4, 2))).max())
    print(f"eval parity, full-width {ref['preset']} f32 b{b} on JAX's draws: "
          f"eval_loss {got['eval_loss']:.6f} vs JAX {want['eval_loss']:.6f} "
          f"(rel {loss_rel:.2e}, tolerance {EVAL_RTOL}); keypoints max|d| "
          f"{kp_err:.2e} (tolerance {EVAL_KP_TOL}); carried landmarks max|d| "
          f"{pos_err:.2e} (tolerance {LANDMARK_TOL}); locking_mean "
          f"{got['locking_mean']:.5f} vs {want['locking_mean']:.5f}",
          flush=True)
    check(loss_rel <= EVAL_RTOL, f"eval_loss rel {loss_rel}")
    check(kp_err <= EVAL_KP_TOL, f"eval keypoints {kp_err}")
    check(pos_err <= LANDMARK_TOL, f"carried landmarks {pos_err}")

    # bulk extraction: 8 batches of 1024 queued, one sync, against one batch
    cfg = get_config("celeba128")
    model = build_model(cfg, "cuda")
    load_model_state(model, state_dict_from_flax(random_flax_params(cfg, 0)))
    freeze_for_inference(model)
    batches = torch.from_numpy(np.stack([random_images(1024, cfg, 40 + i)
                                         for i in range(8)])).cuda()
    many = make_extract_many_fn(model)
    one = make_extract_fn(model)
    check(torch.equal(many(batches[:2])[1], one(batches[1])),
          "extract_many differs from per-batch extraction")
    many_ms = cuda_median_ms(lambda: many(batches), runs=10,
                             queue_behind_sleep=False)
    one_ms = cuda_median_ms(lambda: one(batches[0]), runs=10,
                            queue_behind_sleep=False)
    print(f"extract_many b1024 x N=8 bf16: {8 * 1024 / many_ms * 1e3:.0f} "
          f"images/s ({many_ms:.3f} ms a call); per batch b1024: "
          f"{1024 / one_ms * 1e3:.0f} images/s ({one_ms:.3f} ms)  [{card}]",
          flush=True)
    return path_counts


# heatmaps above 64 a side (the block-per-heatmap kernels): shape, raster
# size, sigma
WIDE_CASES = [((2, 3, 65, 65), (65, 65), 0.1),
              ((128, 10, 96, 96), (96, 96), 0.1),
              ((128, 10, 128, 128), (128, 128), 0.1),
              ((2, 3, 65, 200), (33, 100), 0.05),
              # the block path's scalar stores: Wo % 4 != 0, Wo < 4
              ((2, 3, 65, 65), (7, 13), 0.1),
              ((2, 3, 70, 96), (5, 3), 0.05)]
# celeba128's widths with stride-1 encoders: 128^2 heatmaps
WIDE_TRAIN = {"model.encoder_strides": (1, 1, 1, 1, 1),
              "model.decoder_upsample": (False, False, False),
              "train.batch_size": 32}
WIDE_STEPS = 5
# launches a step of WIDE_TRAIN, by variant
WIDE_PER_STEP = {
    variant: {"softargmax_raster_fwd": 1, "spatial_softmax_bwd": 1,
              "gaussian_bwd": 1, "warp_field": 2}
    for variant in ("joint", "marginal")}


def wide_kernels_phase(card: str) -> None:
    """K1, K1b and K3 above 64 a side against their plain versions and
    autograd, K3 against K1 then K2 bit for bit, the dispatchers counted;
    then the times at b128 K=10 96^2 and 128^2."""
    phase("23 wide heatmaps (K1, K1b, K3 block path) vs plain")
    rs = np.random.RandomState(23)
    worst = {"kp": 0.0, "dh": 0.0, "maps": 0.0, "dh3_share": 0.0}
    cases = same = 0
    for shape, (ho, wo), sigma in WIDE_CASES:
        x = torch.from_numpy((3 * rs.randn(*shape)).astype(np.float32)).cuda()
        g_kp = torch.from_numpy(rs.randn(*shape[:2], 2).astype(np.float32))
        g_maps = torch.from_numpy(rs.randn(*shape[:2], ho, wo)
                                  .astype(np.float32))
        g_kp, g_maps = g_kp.cuda(), g_maps.cuda()
        for variant in ("joint", "marginal"):
            for align in (True, False):
                what = f"{'x'.join(map(str, shape))} {variant} align={align}"
                kp = ssc.spatial_softmax_cuda(x, 0.7, variant, align)
                dh = ssc.spatial_softmax_bwd_cuda(x, kp, g_kp, 0.7, variant,
                                                  align)
                torch.cuda.synchronize()
                e_kp = (kp - plain_softmax(x, 0.7, variant, align)).abs() \
                    .max().item()
                e_dh = (dh - _plain_grad(
                    lambda t: plain_softmax(t, 0.7, variant, align), x, g_kp)
                ).abs().max().item()
                check(e_kp <= KERNEL_TOL, f"K1 {what}: {e_kp}")
                check(e_dh <= softmax_grad_tolerance(*shape[2:]),
                      f"K1b {what}: {e_dh}")
                kp3, maps = fbc.softargmax_raster_cuda(x, ho, wo, 0.7, sigma,
                                                       align, variant)
                torch.cuda.synchronize()
                kp_p, maps_p = plain_bottleneck(x, ho, wo, 0.7, sigma, align,
                                                variant)
                e_kp3 = (kp3 - kp_p).abs().max().item()
                e_maps = (maps - maps_p).abs().max().item()
                check(e_kp3 <= KERNEL_TOL, f"K3 keypoints {what}: {e_kp3}")
                check(e_maps <= fused_map_tolerance(sigma),
                      f"K3 maps {what}: {e_maps}")
                maps2 = gcu.gaussian_fwd_cuda(kp.reshape(-1, 2), ho, wo,
                                              sigma, align)
                bits = (torch.equal(kp3, kp)
                        and torch.equal(maps, maps2.reshape(maps.shape))
                        and _unaligned_maps_equal(x, kp3, maps, 0.7, sigma,
                                                  align, variant))
                check(bits, f"K3 {what}: not K1 then K2 bit for bit")
                same += int(bits)
                xk = x.clone().requires_grad_(True)
                torch.autograd.backward(fbc.softargmax_raster_autograd(
                    xk, ho, wo, 0.7, sigma, align, variant), (g_kp, g_maps))
                xr = x.clone().requires_grad_(True)
                torch.autograd.backward(plain_bottleneck(
                    xr, ho, wo, 0.7, sigma, align, variant), (g_kp, g_maps))
                torch.cuda.synchronize()
                diff = (xk.grad - xr.grad).abs()
                tol = fused_grad_tolerance(x, ho, wo, 0.7, sigma, align,
                                           variant, g_kp, g_maps)
                check(bool((diff <= tol).all()),
                      f"K3 dheatmaps {what}: {diff.max().item()}")
                worst["kp"] = max(worst["kp"], e_kp, e_kp3)
                worst["dh"] = max(worst["dh"],
                                  e_dh / softmax_grad_tolerance(*shape[2:]))
                worst["maps"] = max(worst["maps"], e_maps)
                worst["dh3_share"] = max(worst["dh3_share"],
                                         (diff / tol).max().item())
                cases += 1
    print(f"{cases} cases: keypoints (K1, K3) max|d| {worst['kp']:.3e} "
          f"(tolerance {KERNEL_TOL}), K1b at {worst['dh']:.3f} of its "
          f"tolerance (testing.softmax_grad_tolerance: 1e-5 up to 64 a "
          f"side, then in proportion to the side), K3 maps max|d| "
          f"{worst['maps']:.3e}, K3 "
          f"dheatmaps at {worst['dh3_share']:.3f} of their tolerance; K3 "
          f"equal to K1 then K2 bit for bit in {same} of {cases}", flush=True)

    # the dispatchers, forward and backward, counted
    for side in (65, 96, 128):
        x = torch.from_numpy((3 * rs.randn(4, 5, side, side))
                             .astype(np.float32)).cuda()
        for variant in ("joint", "marginal"):
            xs = x.clone().requires_grad_(True)
            xe = x.clone().requires_grad_(True)
            reset_counts()
            kp = spatial_softmax(xs, 1.0, variant, True)
            kp.sum().backward()
            kp_e, maps_e = extract_and_render(xe, side, side, 1.0, 0.1,
                                              variant, True)
            (kp_e.sum() + maps_e.sum()).backward()
            torch.cuda.synchronize()
            counts = read_counts()
            want = {"spatial_softmax_fwd": 1, "spatial_softmax_bwd": 2,
                    "gaussian_fwd": 0, "gaussian_bwd": 1,
                    "softargmax_raster_fwd": 1}
            got = {k: counts[k] for k in want}
            check(got == want, f"dispatchers {side}^2 {variant}: {got}")
            check(bool(torch.isfinite(xs.grad).all()
                       and torch.isfinite(xe.grad).all()),
                  f"dispatchers {side}^2 {variant}: non-finite gradient")
            err = (kp_e - plain_softmax(x, 1.0, variant, True)).abs().max()
            check(err.item() <= KERNEL_TOL,
                  f"extract_and_render {side}^2 {variant}: {err.item()}")
        print(f"dispatchers at {side}^2: spatial_softmax and "
              f"extract_and_render forward and backward through the "
              f"kernels, both variants", flush=True)

    wide_times(card, rs)


def wide_times(card: str, rs=None) -> None:
    """K1, K1b and K3 at b128 K=10 96^2 and 128^2 (the block path), both
    variants, against the bound and the plain version; K3 against K1 then
    K2 on the same heatmaps."""
    rs = rs or np.random.RandomState(23)
    for side in (96, 128):
        b, k = 128, 10
        n, hw = b * k, side * side
        x = torch.from_numpy(rs.randn(b, k, side, side).astype(np.float32))
        x = x.cuda()
        g_kp = torch.from_numpy(rs.randn(b, k, 2).astype(np.float32)).cuda()
        heat = n * hw * 4
        for variant in ("joint", "marginal"):
            kp = ssc.spatial_softmax_cuda(x, 1.0, variant)
            x_req = x.clone().requires_grad_(True)
            kp_plain = plain_softmax(x_req, 1.0, variant)
            cases = {
                "spatial_softmax_fwd": (
                    lambda v=variant: ssc.spatial_softmax_cuda(x, 1.0, v),
                    lambda v=variant: plain_softmax(x, 1.0, v), None,
                    _bound(heat + n * 8, 3 * n * hw)),
                "spatial_softmax_bwd": (
                    lambda v=variant, kp=kp: ssc.spatial_softmax_bwd_cuda(
                        x, kp, g_kp, 1.0, v),
                    lambda kp_plain=kp_plain, x_req=x_req: torch.autograd.grad(
                        kp_plain, x_req, g_kp, retain_graph=True), None,
                    _bound(2 * heat + 2 * n * 8, 4 * n * hw)),
                "softargmax_raster_fwd": (
                    lambda v=variant: fbc.softargmax_raster_cuda(
                        x, side, side, 1.0, 0.1, True, v),
                    lambda v=variant: plain_bottleneck(x, side, side, 1.0,
                                                       0.1, True, v), None,
                    _bound(2 * heat + n * 8, 6 * n * hw + 10 * n * hw)),
            }
            timed = _time_cases(cases, card, plain_reps=2,
                                label=f" {variant} (N={n}, {side}x{side})")
            k1k2 = cuda_median_ms(lambda v=variant: gcu.gaussian_fwd_cuda(
                ssc.spatial_softmax_cuda(x, 1.0, v).reshape(n, 2), side, side,
                0.1), reps=20)
            print(f"  K1 then K2 on the same heatmaps: {k1k2 * 1e3:.2f} us "
                  f"(K3 {timed['softargmax_raster_fwd']['ms'] * 1e3:.2f})  "
                  f"[{card}]", flush=True)


def wide_train_phase(card: str) -> list:
    """A user's train step (``init_state`` + ``make_train_step``) of
    celeba128's widths with stride-1 encoders, so the heatmaps are 128^2:
    b32 bf16, ``WIDE_STEPS`` steps per variant with the counts reset just
    before; exact launches per step."""
    phase(f"24 wide train (celeba128 widths, stride-1 encoders, 128^2 "
          f"heatmaps, b{WIDE_TRAIN['train.batch_size']}, bf16, "
          f"{WIDE_STEPS} steps per variant) on {card}")
    path_counts = []
    for variant, per_step in WIDE_PER_STEP.items():
        cfg = get_config("celeba128").override(
            **{**WIDE_TRAIN, "model.softmax_variant": variant})
        state = init_state(cfg, "cuda")
        step = make_train_step(cfg, loss=make_loss(cfg))
        images = torch.from_numpy(random_images(cfg.train.batch_size, cfg,
                                                24)).cuda()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        losses = []
        for _ in range(WIDE_STEPS):
            state, metrics = step(state, images)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        path_counts.append(counts)
        losses = torch.stack(losses).cpu().numpy()
        print(f"{variant}: {WIDE_STEPS} steps in {wall:.2f}s (the first "
              f"includes cuDNN's set-up), losses {losses}; launches "
              f"{counts}", flush=True)
        check(bool(np.isfinite(losses).all()), f"{variant}: losses {losses}")
        check(all(p.dtype == torch.float32 for p in state.model.parameters()),
              f"{variant}: parameters are not float32 after bf16 steps")
        for name in KERNELS:
            want = per_step.get(name, 0) * WIDE_STEPS
            check(counts[name] == want, f"{variant}: {name} launched "
                  f"{counts[name]} times in {WIDE_STEPS} steps ({want} "
                  f"expected)")
        train_step_times(card, (cfg, state, step, images), steps=5,
                         label=f"celeba128 stride-1 {variant}")
        del state, step
        torch.cuda.empty_cache()
    return path_counts


def route_phase(card: str) -> list:
    """celeba128's field warps by route: the b128 bf16 train step (a user's
    ``make_train_step``) with them through the field kernel K5, the
    package's route, and through upsample + the dense-grid kernel K4, the
    JAX package's route at 128 wide (reproduced here, and only here, by
    patching ``data.augment.warp_sample_field``), in turns new, old, old,
    new; ``make_pair`` alone both ways, and both routes' pairs equal bit for
    bit; then the route that still reaches K4, ``make_pair`` of 32^2 images
    (F = 33 is not below 32, so the exact TPS grid), counted, its pair
    equal to the one from its draws and K4's two warps at those draws
    within one bf16 ulp of plain."""
    phase(f"25 route A/B: celeba128's field warps through K5 or upsample + "
          f"K4, b{TRAIN_BATCH} bf16, on {card}")
    from keypoints_tpu_torch.data import augment
    from keypoints_tpu_torch.data.augment import make_pair
    from keypoints_tpu_torch.kernels import warp_sample
    package_route = augment.warp_sample_field

    def old_route(image, field, out_height, out_width, padding_mode="zeros",
                  align_corners=True):
        return warp_sample(image, upsample_field_aligned(
            field.float(), out_height, out_width), padding_mode,
            align_corners)

    routes = {"K5": package_route, "upsample + K4": old_route}

    def on(route, fn):
        augment.warp_sample_field = routes[route]
        try:
            return fn()
        finally:
            augment.warp_sample_field = package_route

    trainer = _train_setup("celeba128")
    cfg = trainer[0]
    wcfg = warp_config(cfg)
    images = trainer[3].to(torch.bfloat16)
    pairs = {route: on(route, lambda: make_pair(
        step_generator(0, 25, "cuda"), images, wcfg)) for route in routes}
    check(all(torch.equal(a, b) for a, b in zip(*pairs.values())),
          "the two routes' pairs differ")
    order = ("K5", "upsample + K4", "upsample + K4", "K5")
    step_ms = {route: [] for route in routes}
    pair_ms = {route: [] for route in routes}
    for route in order:
        step_ms[route].append(on(route, lambda: train_step_times(
            card, trainer, steps=20, label=f"celeba128, field warps through "
            f"{route},")))
    for route in order:
        pair_ms[route].append(on(route, lambda: cuda_median_ms(
            lambda: make_pair(step_generator(0, 25, "cuda"), images, wcfg),
            runs=20, queue_behind_sleep=False)))
    print(f"route A/B, ms (new, old, old, new): train step K5 "
          f"{step_ms['K5'][0]:.3f} / {step_ms['K5'][1]:.3f}, upsample + K4 "
          f"{step_ms['upsample + K4'][0]:.3f} / "
          f"{step_ms['upsample + K4'][1]:.3f}; make_pair b{TRAIN_BATCH} "
          f"3x128^2 bf16 K5 {pair_ms['K5'][0]:.4f} / {pair_ms['K5'][1]:.4f}, "
          f"upsample + K4 {pair_ms['upsample + K4'][0]:.4f} / "
          f"{pair_ms['upsample + K4'][1]:.4f}  [{card}]", flush=True)
    del trainer
    torch.cuda.empty_cache()

    small, draws = dense_route_inputs()
    torch.cuda.synchronize()
    reset_counts()
    pair = make_pair(step_generator(0, 26, "cuda"), small, wcfg)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"make_pair b{TRAIN_BATCH} 3x32^2 (the dense TPS grid): launches "
          f"{counts}", flush=True)
    for name in KERNELS:
        want = 2 if name == "warp_bilinear" else 0
        check(counts[name] == want, f"{name} launched {counts[name]} times by "
              f"the dense route ({want} expected)")
    check(all(torch.equal(a, b) for a, b in zip(
        pair, augment.pair_from_draws(small, draws, wcfg))),
        "the dense route's pair differs from the pair of its draws")
    err = 0.0
    for side, grid in (("source", draws.source), ("target", draws.target)):
        got = wcu.warp_bilinear_cuda(small, grid.contiguous(), "border", True)
        err = max(err, _dense_warp_error(small, grid, got, "border", True,
                                         f"dense route {side}"))
    print(f"  K4 at the dense route's two TPS grids: max|d| {err:.3e} "
          f"against plain (within one bf16 ulp)", flush=True)
    dense_route_times(card, small, draws.source.contiguous())
    return [counts]


def dense_route_inputs():
    """The dense route's inputs: seeded b128 3x32^2 bf16 images and the
    draws ``make_pair`` takes for them from ``step_generator(0, 26)`` with
    celeba128's warp settings (two exact TPS grids, two sets of factors)."""
    from keypoints_tpu_torch.data.augment import draw_pair
    gen = torch.Generator(device="cuda").manual_seed(25)
    small = torch.rand((TRAIN_BATCH, 3, 32, 32), generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    draws = draw_pair(step_generator(0, 26, "cuda"), tuple(small.shape),
                      warp_config(get_config("celeba128")), small.dtype)
    return small, draws


def dense_route_times(card: str, small: torch.Tensor,
                      grid: torch.Tensor) -> None:
    """The route that still reaches K4, ``make_pair`` of the b128 3x32^2
    bf16 images ``small`` (F = 33 is not below 32, so the exact TPS grid):
    one call with its launches and host work, as phase 25 times make_pair
    at 128^2; then K4 alone at ``grid``, one of that route's TPS grids,
    against bound and plain."""
    from keypoints_tpu_torch.data.augment import make_pair
    wcfg = warp_config(get_config("celeba128"))
    pair_ms = cuda_median_ms(lambda: make_pair(
        step_generator(0, 26, "cuda"), small, wcfg), runs=20,
        queue_behind_sleep=False)
    print(f"make_pair b{TRAIN_BATCH} 3x32^2 bf16 (the dense route): "
          f"{pair_ms:.4f} ms a call  [{card}]", flush=True)
    _time_cases({"warp_bilinear": (
        lambda: wcu.warp_bilinear_cuda(small, grid, "border", True),
        lambda: plain_warp(small, grid, "border", True), None,
        _bound(2 * small.nelement() * 2 + grid.nelement() * 4,
               30 * TRAIN_BATCH * 32 * 32 + 8 * small.nelement()))}, card,
        label=f" b{TRAIN_BATCH} 3x32^2 bf16")


def bottleneck_route_phase(card: str) -> list:
    """ROADMAP B.1: celeba128's b128 bf16 step (a user's
    ``make_train_step``) with its marginal bottleneck through the package's
    route (K3) and through K1 then K2, the latter reached by patching
    ``models.autoencoder.extract_and_render`` here only, in turns (K1 then
    K2, K3, K3, K1 then K2); one step of each route counted and checked.
    Returns the package route's counts only: the patched route is no path
    of the package. Phase 19 times the kernels alone at the three presets'
    bottlenecks, both variants."""
    phase(f"26 route A/B: celeba128's marginal bottleneck through K1 then K2 "
          f"or K3, b{TRAIN_BATCH} bf16, on {card}")
    from keypoints_tpu_torch.models import autoencoder
    package_route = autoencoder.extract_and_render

    def unfused(heatmaps, out_height, out_width, temperature, sigma, variant,
                align_corners):
        kp = spatial_softmax(heatmaps, temperature, variant, align_corners)
        return kp, gaussian_maps(kp, out_height, out_width, sigma,
                                 align_corners)

    routes = {"K1 then K2": (unfused, {"spatial_softmax_fwd": 1,
                                       "gaussian_fwd": 1}),
              "K3": (package_route, {"softargmax_raster_fwd": 1})}

    def on(route, fn):
        autoencoder.extract_and_render = routes[route][0]
        try:
            return fn()
        finally:
            autoencoder.extract_and_render = package_route

    trainer = _train_setup("celeba128")
    cfg, state, step, images = trainer
    check(cfg.model.softmax_variant == "marginal", "celeba128 is marginal")
    route_counts = {}
    for route, (_, fwd) in routes.items():
        on(route, lambda: step(state, images))
        torch.cuda.synchronize()
        reset_counts()
        on(route, lambda: step(state, images))
        torch.cuda.synchronize()
        counts = route_counts[route] = read_counts()
        want = {**fwd, "spatial_softmax_bwd": 1, "gaussian_bwd": 1,
                "warp_field": 2}
        for name in KERNELS:
            check(counts[name] == want.get(name, 0), f"route {route}: {name} "
                  f"launched {counts[name]} times in a step")
    order = ("K1 then K2", "K3", "K3", "K1 then K2")
    step_ms = {route: [] for route in routes}
    for route in order:
        step_ms[route].append(on(route, lambda: train_step_times(
            card, trainer, steps=20, label=f"celeba128, marginal bottleneck "
            f"through {route},")))
    print(f"route A/B, ms (old, new, new, old): train step K1 then K2 "
          f"{step_ms['K1 then K2'][0]:.3f} / {step_ms['K1 then K2'][1]:.3f}, "
          f"K3 {step_ms['K3'][0]:.3f} / {step_ms['K3'][1]:.3f}  [{card}]",
          flush=True)
    del trainer, state, step
    torch.cuda.empty_cache()
    return [route_counts["K3"]]



# phase 27: the train CLI at each preset's full width, and its resume
CLI_PRESETS = ("transporter_atari", "pong64")
CLI_STEPS = 40
CLI_OVERRIDES = ["train.checkpoint_every=20", "train.log_every=10",
                 "train.eval_every=20", "train.max_to_keep=1"]
# phase 28: train() in this process; preset -> (overrides, steps, launches
# a step, launches an eval, launches once: the scoring pair's warps, the
# first eval's rows of a synthetic source)
LOOP_CASES = {
    "transporter_atari": ({}, 30,
                          {"softargmax_raster_fwd": 2,
                           "spatial_softmax_bwd": 1, "gaussian_bwd": 1},
                          {"spatial_softmax_fwd": 1,
                           "softargmax_raster_fwd": 2}, {}),
    "celeba128": ({"train.batch_size": 32}, 30,
                  {"warp_field": 2, "softargmax_raster_fwd": 1,
                   "spatial_softmax_bwd": 1, "gaussian_bwd": 1},
                  {"spatial_softmax_fwd": 1, "softargmax_raster_fwd": 1},
                  {"warp_field": 2}),
    "pong64": ({}, 15,
               {"gaussian_fwd": 2, "softargmax_raster_fwd": 1,
                "spatial_softmax_bwd": 1, "gaussian_bwd": 1},
               {"spatial_softmax_fwd": 1, "softargmax_raster_fwd": 1},
               {"gaussian_fwd": 4}),
}
LOOP_EVAL_EVERY = 15
STREAM_STEPS = 6
OVERHEAD_STEPS = (10, 40)
STORE_EVAL_RTOL = 1e-4   # store eval: card f32 (TF32 off) vs the CPU


def _same_tensors(a, b, what: str) -> int:
    """Check two checkpoint payloads equal bit for bit, tensor by tensor;
    → the count of tensors compared."""
    if isinstance(a, torch.Tensor):
        check(isinstance(b, torch.Tensor) and a.dtype == b.dtype
              and a.shape == b.shape and torch.equal(a, b),
              f"{what} differs")
        return 1
    if isinstance(a, dict):
        check(isinstance(b, dict) and a.keys() == b.keys(),
              f"{what}: keys differ")
        return sum(_same_tensors(a[k], b[k], f"{what}.{k}") for k in a)
    if isinstance(a, (list, tuple)):
        check(len(a) == len(b), f"{what}: lengths differ")
        return sum(_same_tensors(x, y, f"{what}[{i}]")
                   for i, (x, y) in enumerate(zip(a, b)))
    check(a == b, f"{what}: {a!r} != {b!r}")
    return 0


def train_cli_phase(card: str, tmp: str) -> str:
    """``python -m keypoints_tpu_torch.train`` at full width: transporter_atari
    on the committed ``data/atari_64.npy`` (resident on the card) and pong64
    (scripted Pong drawn on the card), 40 steps in one process, then 20 and
    a resumed 20 in two, each process's step captured as one CUDA graph
    after its first step and replayed; the final checkpoints, model and
    optimizer, equal bit for bit. → the uninterrupted transporter_atari
    run's directory."""
    phase(f"27 train CLI and resume, full width, on {card}")
    for preset in CLI_PRESETS:
        runs = {}
        for run, steps in (("full", CLI_STEPS), ("split", CLI_STEPS // 2),
                           ("split", CLI_STEPS)):
            logdir = os.path.join(tmp, f"{preset}_{run}_{steps}_logs")
            argv = [sys.executable, "-m", "keypoints_tpu_torch.train",
                    "--preset", preset, "--steps", str(steps), "--logdir",
                    logdir, "--override",
                    f"train.checkpoint_dir={os.path.join(tmp, run)}",
                    *CLI_OVERRIDES]
            t0 = time.perf_counter()
            out = subprocess.run(argv, cwd=ROOT, capture_output=True,
                                 text=True, timeout=600)
            wall = time.perf_counter() - t0
            check(out.returncode == 0, f"{preset} train CLI ({run}, {steps} "
                  f"steps) exited {out.returncode}: {out.stderr[-3000:]}")
            lines = out.stdout.splitlines()
            print(f"{preset} {run} {steps} steps: {wall:.2f}s wall (process "
                  f"start, kernel load, store, steps); "
                  f"{' | '.join(l for l in lines if l.startswith('step') or 'resumed' in l or 'CUDA graph' in l)}",
                  flush=True)
            if run == "split" and steps == CLI_STEPS:
                check(f"resumed from step {CLI_STEPS // 2}" in out.stdout,
                      f"{preset}: the second process did not resume")
            first = CLI_STEPS // 2 + 1 if run == "split" and steps == \
                CLI_STEPS else 1
            check(f"captured as one CUDA graph after step {first}"
                  in out.stdout, f"{preset} {run}: the step was not "
                  f"captured after step {first}")
            rows = [json.loads(l) for l in
                    Path(logdir, "metrics.jsonl").read_text().splitlines()]
            for key in ("loss", "grad_norm", "keypoint_spread"):
                vals = [r[key] for r in rows if key in r]
                check(bool(vals) and all(v is not None and np.isfinite(v)
                                         for v in vals),
                      f"{preset} {run}: {key} in metrics.jsonl: {vals}")
            runs[run] = os.path.join(tmp, run, preset)
        for run, directory in runs.items():
            files = sorted(os.listdir(directory))
            check(files == [f"{CLI_STEPS}.pt"], f"{preset} {run}: "
                  f"max_to_keep=1 kept {files}")
            check(os.path.exists(os.path.join(tmp, run, f"{preset}_best",
                                              "best.json")),
                  f"{preset} {run}: no best.json")
        full, split = (torch.load(os.path.join(runs[r], f"{CLI_STEPS}.pt"),
                                  map_location="cpu", weights_only=True)
                       for r in ("full", "split"))
        n = _same_tensors(full, split, f"{preset} checkpoint")
        best = json.loads(Path(tmp, "full", f"{preset}_best",
                               "best.json").read_text())
        print(f"{preset}: step-{CLI_STEPS} checkpoints of the uninterrupted "
              f"and the resumed run equal bit for bit ({n} tensors, model "
              f"and optimizer); best {best}", flush=True)
    return os.path.join(tmp, "full", "transporter_atari")


def _loop_cfg(preset: str, tmp: str, **over):
    overrides, steps, *_ = LOOP_CASES[preset]
    return get_config(preset).override(**{
        **overrides, "train.steps": steps, "train.log_every": 10,
        "train.eval_every": LOOP_EVAL_EVERY,
        "train.checkpoint_every": LOOP_EVAL_EVERY,
        "train.checkpoint_dir": os.path.join(tmp, f"loop_{preset}"),
        "data.data_dir": (os.path.join(tmp, "data") if preset == "celeba128"
                          else "data"), **over})


def train_loop_phase(card: str, tmp: str) -> list:
    """``train()`` in this process at full width, its step one CUDA graph a
    step: transporter_atari on the committed store, celeba128 at b32 on a
    face store it generates, pong64 on scripted Pong; the kernels each run
    launched on the card, counted from torch.profiler's kernel names,
    against its steps and evals, and the wrappers' counts (the first,
    eager step, the capture, the evals); the stream path of
    transporter_atari (``fits_in_memory`` patched here only); the loop's
    ms/step against ``make_graphed_train_step`` alone; then celeba128's
    b128 bf16 eager step with cuDNN's deterministic setting off and on, in
    turns. → the wrappers' counts of the runs."""
    phase(f"28 train loop in this process, full width, on {card}")
    from keypoints_tpu_torch import train as train_mod
    path_counts = []
    for preset, (_, steps, per_step, per_eval, once) in LOOP_CASES.items():
        cfg = _loop_cfg(preset, tmp)
        if preset == "celeba128":
            # the trainer generates the store; this phase times the loop
            train_mod.make_batch_iterator(cfg, device="cuda")
            store = Path(cfg.data.data_dir, "celeba_128.npy")
            print(f"face store {store.name}: "
                  f"{np.load(store, mmap_mode='r').shape}, "
                  f"{store.stat().st_size / 1e6:.1f} MB", flush=True)
        reset_counts()
        runs = []
        on_card, _, wall = profiled_launches(
            lambda: runs.append(train_mod.train(cfg)), 1, _card_op)
        state = runs[0]
        counts = read_counts()
        path_counts.append(counts)
        evals = steps // LOOP_EVAL_EVERY
        want = {name: per_step.get(name, 0) * steps
                + per_eval.get(name, 0) * evals + once.get(name, 0)
                for name in PROFILED_KERNELS}
        print(f"{preset} b{cfg.train.batch_size} train(): {steps} steps, "
              f"{evals} evals in {wall / 1e3:.2f}s under torch.profiler; "
              f"kernels on the card {on_card}; wrapper launches {counts}",
              flush=True)
        check(state.step == steps, f"{preset}: train() stopped at "
              f"{state.step}")
        for name in PROFILED_KERNELS:
            check(on_card[name] == want[name], f"{preset} loop ran {name} "
                  f"{on_card[name]} times on the card ({want[name]} "
                  f"expected)")
            # the eager first step and the capture; replays count nothing
            wrapped = want[name] - per_step.get(name, 0) * (steps - 2)
            check(counts[name] == wrapped, f"{preset} loop's wrapper "
                  f"counted {name} {counts[name]} times ({wrapped} "
                  f"expected)")
        del state, runs
        torch.cuda.empty_cache()

    # the stream path, forced: host reads, pinned copies, the same step
    real = train_mod.fits_in_memory
    train_mod.fits_in_memory = lambda *a, **k: False
    try:
        cfg = _loop_cfg("transporter_atari", tmp, **{
            "train.steps": STREAM_STEPS, "train.eval_every": 1000,
            "train.checkpoint_every": 1000,
            "train.checkpoint_dir": os.path.join(tmp, "stream")})
        check(not isinstance(train_mod.make_batch_iterator(cfg),
                             train_mod.InStepBatches),
              "the patched budget did not take the stream path")
        reset_counts()
        runs = []
        on_card, _, wall = profiled_launches(
            lambda: runs.append(train_mod.train(cfg)), 1, _card_op)
        state = runs[0]
        counts = read_counts()
    finally:
        train_mod.fits_in_memory = real
    path_counts.append(counts)
    print(f"transporter_atari through the host stream: {STREAM_STEPS} "
          f"steps in {wall / 1e3:.2f}s under torch.profiler; kernels on the "
          f"card {on_card}; wrapper launches {counts}", flush=True)
    check(state.step == STREAM_STEPS and on_card["softargmax_raster_fwd"]
          == 2 * STREAM_STEPS and on_card["spatial_softmax_bwd"]
          == STREAM_STEPS, f"stream path: step {state.step}, {on_card}")
    check(counts["softargmax_raster_fwd"] == 4
          and counts["spatial_softmax_bwd"] == 2,
          f"stream path: wrapper counts {counts} (the eager step and the "
          f"capture)")
    del state, runs

    # the loop's own cost: its ms/step between the log reads at steps 10
    # and 40 of one run (the logger's scalars patched here to note the
    # time; each read waits for the card), against make_graphed_train_step
    # on the same in-step source with the same reads, both with cuDNN
    # deterministic, in turns (loop, bare, bare, loop)
    first, last = OVERHEAD_STEPS
    for preset in ("transporter_atari", "celeba128"):
        ms = {"loop": [], "bare": []}
        for turn, kind in enumerate(("loop", "bare", "bare", "loop")):
            cfg = _loop_cfg(preset, tmp, **{
                "train.steps": last, "train.eval_every": 1000,
                "train.checkpoint_every": 1000,
                "train.checkpoint_dir": os.path.join(
                    tmp, f"overhead_{preset}_{turn}")})
            if kind == "loop":
                ticks = {}
                scalars = train_mod.Logger.scalars

                def noting(self, step, **kv):
                    if "loss" in kv:
                        ticks[step] = time.perf_counter()
                    return scalars(self, step, **kv)
                train_mod.Logger.scalars = noting
                try:
                    train_mod.train(cfg)
                finally:
                    train_mod.Logger.scalars = scalars
                ms["loop"].append((ticks[last] - ticks[first])
                                  / (last - first) * 1e3)
                continue
            flags = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            try:
                state = init_state(cfg, "cuda")
                source = train_mod.make_batch_iterator(cfg, device="cuda")
                step = make_graphed_train_step(cfg, state, source=source)
                t0 = None
                for i in range(last):
                    state, metrics = step(state)
                    if (i + 1) % 10 == 0:
                        float(metrics["loss"])      # the loop's log read
                        if i + 1 == first:
                            t0 = time.perf_counter()
                ms["bare"].append((time.perf_counter() - t0)
                                  / (last - first) * 1e3)
            finally:
                (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark) = flags
            del state, step, source
        print(f"{preset} b{cfg.train.batch_size} bf16, steps {first + 1}-"
              f"{last} (host clock, a loss read every 10 steps): train() "
              f"loop {' / '.join(f'{v:.3f}' for v in ms['loop'])} ms/step, "
              f"make_graphed_train_step on the source "
              f"{' / '.join(f'{v:.3f}' for v in ms['bare'])} (loop, bare, "
              f"bare, loop): overhead "
              f"{np.mean(ms['loop']) - np.mean(ms['bare']):+.3f} ms/step  "
              f"[{card}]", flush=True)
        torch.cuda.empty_cache()

    # cuDNN's deterministic setting, the cost of bit-exact resume
    trainer = _train_setup("celeba128")
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    det_ms = {False: [], True: []}
    try:
        for det in (False, True, True, False):
            torch.backends.cudnn.deterministic = det
            torch.backends.cudnn.benchmark = False
            det_ms[det].append(train_step_times(
                card, trainer, steps=20, label=f"celeba128, cuDNN "
                f"deterministic {'on' if det else 'off'},"))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    print(f"cuDNN deterministic A/B, celeba128 b{TRAIN_BATCH} bf16 step, ms "
          f"(off, on, on, off): off {det_ms[False][0]:.3f} / "
          f"{det_ms[False][1]:.3f}, on {det_ms[True][0]:.3f} / "
          f"{det_ms[True][1]:.3f}: {np.mean(det_ms[True]) - np.mean(det_ms[False]):+.3f} "
          f"ms/step  [{card}]", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return path_counts


def store_eval_phase(card: str, tmp: str, ckdir: str) -> list:
    """``python -m keypoints_tpu_torch.eval --preset transporter_atari
    --checkpoint`` phase 27's directory: the store's held-out tail (the
    committed ``data/atari_64.npy`` has no sidecar), 64 rows; then the same
    checkpoint in float32 (TF32 off) on the card, counted, against the
    port's plain path on the CPU. → the counts of the card's eval."""
    phase(f"29 store eval of phase 27's checkpoint on {card}")
    out = os.path.join(tmp, "store_eval.json")
    argv = ["--preset", "transporter_atari", "--checkpoint", ckdir]
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "keypoints_tpu_torch.eval",
                          *argv, "--json", out], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(run.returncode == 0, f"store eval CLI exited {run.returncode}: "
          f"{run.stderr[-2000:]}")
    record = json.loads(Path(out).read_text())
    print(f"store eval CLI ({wall:.2f}s): {run.stdout.splitlines()[-2]}",
          flush=True)
    check(set(record) == EVAL_RECORD_KEYS and record["source"] == "store"
          and record["held_out"] is True and record["rows"] == EVAL_BATCH
          and record["step"] == CLI_STEPS and record["gt"] is None,
          f"store eval record {record}")
    check(np.isfinite(record["metrics"]["eval_loss"]),
          f"store eval metrics {record['metrics']}")
    f32 = ["--override", "train.compute_dtype=float32"]
    reset_counts()
    card_f32 = peval.main(argv + f32)
    torch.cuda.synchronize()
    counts = read_counts()
    cpu_f32 = peval.main(argv + f32 + ["--device", "cpu"])
    rel = (abs(card_f32["metrics"]["eval_loss"]
               - cpu_f32["metrics"]["eval_loss"])
           / cpu_f32["metrics"]["eval_loss"])
    print(f"store eval f32 (TF32 off): card {card_f32['metrics']['eval_loss']:.7f}"
          f" vs CPU plain {cpu_f32['metrics']['eval_loss']:.7f}, rel "
          f"{rel:.2e} (tolerance {STORE_EVAL_RTOL}); launches {counts}  "
          f"[{card}]", flush=True)
    check(rel <= STORE_EVAL_RTOL, f"store eval card vs CPU rel {rel}")
    check(card_f32["rows"] == EVAL_BATCH and counts == {
        name: 2 if name == "softargmax_raster_fwd" else 0 for name in KERNELS},
        f"store eval on the card: {card_f32}, {counts}")
    return [counts]


# phase 30: dp_celeba's DP step at world 1 (NCCL, in this process)
DP_PRESET = "dp_celeba"
DP_EQUAL_STEPS = 3
DP_COUNT_STEPS = 20
DP_PER_STEP = {"warp_field": 2, "softargmax_raster_fwd": 1,
               "spatial_softmax_bwd": 1, "gaussian_bwd": 1}
# phase 31: the train CLI under torchrun, two ranks on the card (gloo)
DP_CLI_STEPS = 20
GLOO_EQUAL_STEPS = 4       # 1 eager + 3 replays against 4 eager steps
DP_CLI_OVERRIDES = ["train.checkpoint_every=10", "train.log_every=10",
                    "train.eval_every=10", "train.max_to_keep=1"]


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _nccl_world_one() -> tuple:
    """Join a one-rank NCCL group on card 0 in this process, cuDNN
    deterministic as ``train()`` runs a step; → cuDNN's flags before, for
    :func:`_leave_group`."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return flags


def _leave_group(flags: tuple) -> None:
    import torch.distributed as dist
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = flags
    dist.destroy_process_group()


def dp_step_phase(card: str) -> list:
    """dp_celeba (celeba128's widths, b256, bf16) through
    ``make_dp_train_step`` in a one-rank NCCL group in this process, cuDNN
    deterministic as ``train()`` runs it: its first steps against
    ``make_train_step``'s, bit for bit; its launches over 20 steps; its
    ms/step against the bare step's in turns (dp, bare, bare, dp); the
    gradient all-reduce alone (``GradBucket.reduce_mean``: the loss copied
    into the persistent bucket, NCCL, the divide) and NCCL alone on the
    bucket by CUDA events; torch.profiler over 5 DP steps. → the counts of
    the 20 steps."""
    import torch.distributed as dist
    from keypoints_tpu_torch.parallel import dp as dp_mod
    phase(f"30 dp step: {DP_PRESET} b256 bf16, NCCL at world 1, on {card}")
    cfg = get_config(DP_PRESET)
    check(cfg.train.batch_size == 256 and cfg.train.data_parallel
          and cfg.train.compute_dtype == "bfloat16", f"{DP_PRESET}: {cfg}")
    flags = _nccl_world_one()
    try:
        group = dist.group.WORLD
        images = torch.from_numpy(random_images(256, cfg, 4)).cuda()
        runs = {"bare": (init_state(cfg, "cuda"), make_train_step(cfg)),
                "dp": (init_state(cfg, "cuda"),
                       dp_mod.make_dp_train_step(cfg, group))}
        losses = {}
        for kind, (state, step) in runs.items():
            losses[kind] = [step(state, images)[1]["loss"]
                            for _ in range(DP_EQUAL_STEPS)]
        bare, dp = (runs[k][0].model.state_dict() for k in ("bare", "dp"))
        check(all(torch.equal(bare[k], dp[k]) for k in bare)
              and torch.equal(torch.stack(losses["bare"]),
                              torch.stack(losses["dp"])),
              "the one-rank DP step differs from the bare step")
        # a resumed rank's replicate: rank 0's parameters and Adam state,
        # the step counts staged through the card for NCCL
        dp_mod.replicate(runs["dp"][0].model, runs["dp"][0].optimizer)
        check(all(torch.equal(bare[k], dp[k]) for k in bare),
              "replicate changed a one-rank group's parameters")
        n_params = sum(p.numel() for p in runs["dp"][0].model.parameters())
        print(f"{DP_EQUAL_STEPS} steps: the one-rank DP step's parameters "
              f"({len(bare)} tensors, {n_params:,} values) and losses "
              f"equal the bare step's bit for bit; losses "
              f"{[round(float(v), 6) for v in losses['dp']]}", flush=True)

        state, step = runs["dp"]
        torch.cuda.synchronize()
        reset_counts()
        for _ in range(DP_COUNT_STEPS):
            state, metrics = step(state, images)
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"{DP_COUNT_STEPS} DP steps: launches {counts}, loss "
              f"{float(metrics['loss']):.5f}", flush=True)
        for name in KERNELS:
            want = DP_PER_STEP.get(name, 0) * DP_COUNT_STEPS
            check(counts[name] == want, f"DP step launched {name} "
                  f"{counts[name]} times ({want} expected)")

        ms = {"dp": [], "bare": []}
        for kind in ("dp", "bare", "bare", "dp"):
            ms[kind].append(train_step_times(
                card, (cfg, *runs[kind], images), steps=20,
                label=f"{DP_PRESET} {kind}, cuDNN deterministic,"))
        print(f"{DP_PRESET} b256 bf16 ms/step (dp, bare, bare, dp): dp "
              f"{ms['dp'][0]:.3f} / {ms['dp'][1]:.3f}, bare "
              f"{ms['bare'][0]:.3f} / {ms['bare'][1]:.3f}: "
              f"{np.mean(ms['dp']) - np.mean(ms['bare']):+.3f} ms/step; "
              f"{256 / np.mean(ms['dp']) * 1e3:.0f} frames/s  [{card}]",
              flush=True)

        loss = torch.zeros((), device="cuda")
        bucket = state.bucket
        check(bucket is not None and bucket.flat.numel() == n_params + 1,
              f"the DP state's gradient bucket: {bucket}")

        def reduce():
            bucket.reduce_mean(loss, group)
        # one call a run queued behind the sleep: its host time stays
        # inside the sleep, so the events see device time only
        reduce_ms = cuda_median_ms(reduce)
        reduce_host_ms = cuda_median_ms(reduce, reps=10,
                                        queue_behind_sleep=False)
        flat = torch.zeros(n_params + 1, device="cuda")
        nccl_ms = cuda_median_ms(lambda: dist.all_reduce(flat, group=group))
        print(f"gradient all-reduce ({n_params + 1:,} float32, "
              f"{(n_params + 1) * 4 / 1e6:.2f} MB; CUDA events, medians of "
              f"25): GradBucket.reduce_mean {reduce_ms * 1e3:.2f} us of "
              f"device time (loss copy, NCCL, divide, loss clone; one call "
              f"queued), {reduce_host_ms * 1e3:.2f} us a call back to back "
              f"(host bound); NCCL alone {nccl_ms * 1e3:.2f} us  [{card}]",
              flush=True)
        _profile("GradBucket.reduce_mean alone (wall = CUDA events a call)",
                 reduce, 20, card, reduce_host_ms,
                 {"loss copy and clone": ("copy",), "NCCL": ("nccl",),
                  "divide": ("Div",)})

        def dp_step():
            step(state, images)
        _profile(f"{DP_PRESET} DP step b256 bf16 (wall = CUDA-event "
                 f"ms/step)", dp_step, 5, card, float(np.mean(ms["dp"])),
                 {"all-reduce (NCCL)": ("nccl", "AllReduce"),
                  "field warp": ("warp_field",),
                  "fused bottleneck": ("fused_fwd",)})
    finally:
        _leave_group(flags)
    return [counts]


def _dp_gloo_rank(rank: int, world: int, port: int, out: str) -> None:
    """One of two gloo ranks on card 0, cuDNN deterministic: the host time
    of ``GradBucket.reduce_mean`` over dp_celeba's gradients (median of
    20); pong64's DP step (full width, b64 over the two ranks, scripted
    Pong drawn on the card) graphed (two CUDA graphs around the eager
    all-reduce: 1 eager + GLOO_EQUAL_STEPS - 1 replays) against eager
    (GLOO_EQUAL_STEPS steps), the two held equal bit for bit here; then
    ms/step of each by CUDA events and the host clock in turns (eager,
    graph, graph, eager). Writes ``{out}/{rank}.json`` and the graphed
    run's state to ``{out}/{rank}.pt``."""
    import torch.distributed as dist
    from keypoints_tpu_torch import train as train_mod
    from keypoints_tpu_torch.parallel import dp as dp_mod
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    group = dist.group.WORLD
    try:
        model = build_model(get_config(DP_PRESET), "cuda")
        for p in model.parameters():
            p.grad = torch.randn_like(p)
        bucket = dp_mod.GradBucket(model.parameters())
        loss = torch.ones((), device="cuda")
        reduce_s = []
        for i in range(23):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            bucket.reduce_mean(loss, group)
            torch.cuda.synchronize()
            if i >= 3:
                reduce_s.append(time.perf_counter() - t0)
        del model, bucket

        cfg = get_config("pong64")
        runs, metrics = {}, {}
        for kind in ("eager", "graph"):
            source = train_mod.make_batch_iterator(cfg, device="cuda")
            state = init_state(cfg, "cuda")
            dp_mod.replicate(state.model, state.optimizer)
            if kind == "graph":
                graph = make_graphed_train_step(cfg, state, source=source,
                                                group=group)
                fn = graph
            else:
                step = make_train_step(cfg, group=group)

                def fn(st, step=step, source=source):
                    return step(st, source.sample_at(st.step))
            metrics[kind] = []
            for _ in range(GLOO_EQUAL_STEPS):
                state, m = fn(state)
                metrics[kind].append({k: v.clone() for k, v in m.items()})
            runs[kind] = (state, fn)
        n = _same_tensors(runs["graph"][0].model.state_dict(),
                          runs["eager"][0].model.state_dict(), "model")
        n += _same_tensors(runs["graph"][0].optimizer.state_dict()["state"],
                           runs["eager"][0].optimizer.state_dict()["state"],
                           "Adam state")
        n += _same_tensors(metrics["graph"], metrics["eager"], "metrics")
        torch.save({k: v.cpu() for k, v in
                    runs["graph"][0].model.state_dict().items()},
                   os.path.join(out, f"{rank}.pt"))
        ms = {"eager": [], "graph": []}
        for kind in ("eager", "graph", "graph", "eager"):
            state, fn = runs[kind]
            box = [state]

            def one(fn=fn, box=box):
                box[0], _ = fn(box[0])
            ms[kind].append(_step_ms(one, 20))
        Path(out, f"{rank}.json").write_text(json.dumps({
            "reduce_s": reduce_s, "tensors": n, "ms": ms,
            "losses": [float(m["loss"]) for m in metrics["graph"]],
            "dispatch": graph.dispatch, "graphs": len(graph.graphs),
            "capture_s": graph.capture_seconds,
            "pool_bytes": graph.pool_bytes}))
    finally:
        dist.destroy_process_group()


def _torchrun_train(tmp: str, run: str, steps: int) -> tuple:
    """Start ``torchrun`` of two pong64 trainer ranks into ``tmp/dp_{run}``,
    its output to ``{logdir}.out``/``.err`` (no pipe to fill while other
    runs are waited for); → (process, logdir, start time)."""
    logdir = os.path.join(tmp, f"dp_{run}_{steps}_logs")
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m", "keypoints_tpu_torch.train",
            "--preset", "pong64", "--steps", str(steps), "--logdir", logdir,
            "--override",
            f"train.checkpoint_dir={os.path.join(tmp, 'dp_' + run)}",
            *DP_CLI_OVERRIDES]
    with open(logdir + ".out", "w") as out, open(logdir + ".err", "w") as err:
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=out, stderr=err)
    return proc, logdir, time.perf_counter()


def _check_torchrun(proc, logdir: str, t0: float, run: str, steps: int,
                    start: int) -> None:
    """Wait for a ``_torchrun_train`` run: both ranks logged the same loss
    and grad norm at each of its log steps, and ``metrics.jsonl`` holds
    each step once (rank 0 alone writes it)."""
    import re
    proc.wait(timeout=600)
    wall = time.perf_counter() - t0
    out, err = (Path(logdir + ext).read_text() for ext in (".out", ".err"))
    check(proc.returncode == 0, f"torchrun pong64 ({run}, {steps} steps) "
          f"exited {proc.returncode}: {out[-2000:]} {err[-3000:]}")
    check("process group: gloo, 2 ranks" in out, f"no gloo group: "
          f"{out[-2000:]}")
    logged = {}
    for rank, step_no, rest in re.findall(
            r"\[rank (\d)/2\] step +(\d+) (loss \S+ grad \S+)", out):
        logged.setdefault(int(step_no), {})[rank] = rest
    check(sorted(logged) == list(range(start + 10, steps + 1, 10))
          and all(len(v) == 2 and len(set(v.values())) == 1
                  for v in logged.values()),
          f"{run} {steps}: ranks' logged losses {logged}")
    rows = [json.loads(r) for r in
            Path(logdir, "metrics.jsonl").read_text().splitlines()]
    check([r["step"] for r in rows if "loss" in r] == sorted(logged),
          f"{run} {steps}: metrics.jsonl rows {rows}")
    check(not start or f"resumed from step {start}" in out,
          "the second torchrun did not resume")
    captured = (f"train step captured as two CUDA graphs around an eager "
                f"all-reduce after step {start + 1}")
    check(all(f"[rank {r}/2] {captured}" in out for r in range(2)),
          f"{run} {steps}: no rank said '{captured}': {out[-2000:]}")
    print(f"pong64 dp {run} {steps} steps: {wall:.2f}s wall (torchrun, 2 "
          f"processes, kernel load, steps); "
          f"{' | '.join(f'{k}: {v}' for k, v in sorted(logged.items()))}",
          flush=True)


def _torchrun_store(tmp: str) -> tuple:
    """Start ``torchrun`` of two dp_celeba dry runs over an empty
    ``data.data_dir``: rank 0 must generate the face store, once, while
    rank 1 waits; → (process, data dir, output file)."""
    data = os.path.join(tmp, "dp_store_data")
    os.makedirs(data)
    log = os.path.join(tmp, "dp_store.out")
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m", "keypoints_tpu_torch.train",
            "--preset", DP_PRESET, "--dry-run", "--override",
            f"data.data_dir={data}"]
    with open(log, "w") as out:
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT)
    return proc, data, log


def _check_torchrun_store(proc, data: str, log: str) -> None:
    """Wait for ``_torchrun_store``: one generation, by rank 0; the store
    and its sidecar the only files; both ranks on the resident source."""
    proc.wait(timeout=600)
    out = Path(log).read_text()
    check(proc.returncode == 0, f"torchrun {DP_PRESET} --dry-run exited "
          f"{proc.returncode}: {out[-3000:]}")
    check(out.count("generating synthetic face store") == 1,
          f"the face store was not generated once: {out[-3000:]}")
    files = sorted(os.listdir(data))
    check(files == ["celeba_128.npy", "celeba_128_meta.json"],
          f"data dir after the dry runs: {files}")
    check(all(f"[rank {rank}/2] dry run: preset '{DP_PRESET}'" in out
              for rank in range(2))
          and out.count("source DeviceResidentBatches") == 2
          and out.count("dp=True (2 rank(s))") == 2
          and out.count("2 CUDA graphs/step around an eager gloo "
                        "all-reduce (captured after step 1)") == 2,
          f"the ranks' dry runs: {out[-3000:]}")
    print(f"{DP_PRESET} --dry-run at world 2 over an empty data dir: rank 0 "
          f"generated the face store once, both ranks took it resident "
          f"({', '.join(files)})", flush=True)


def dp_cli_phase(card: str, tmp: str) -> None:
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    keypoints_tpu_torch.train --preset pong64`` at the preset's widths,
    both ranks on the one card (gloo): 20 steps, and beside it 10, then a
    resumed 10; the step-20 checkpoints equal in every tensor, each rank's
    logged loss the same, rank 0's files only. Beside them, two dp_celeba
    dry runs over an empty data dir: the store generated by rank 0 alone.
    Every trainer rank replays its step as two CUDA graphs around the
    eager gloo all-reduce, and says so. Then two gloo ranks spawned here:
    the host time of the gradient all-reduce through the bucket, and
    pong64's graphed DP step against its eager DP step, bit for bit, and
    their ms/step in turns."""
    phase(f"31 dp train CLI: torchrun, 2 ranks of pong64 on {card} (gloo)")
    half = DP_CLI_STEPS // 2
    store = _torchrun_store(tmp)
    full = _torchrun_train(tmp, "full", DP_CLI_STEPS)
    first = _torchrun_train(tmp, "split", half)
    _check_torchrun(*first, "split", half, 0)
    second = _torchrun_train(tmp, "split", DP_CLI_STEPS)
    _check_torchrun(*full, "full", DP_CLI_STEPS, 0)
    _check_torchrun(*second, "split", DP_CLI_STEPS, half)
    _check_torchrun_store(*store)
    runs = {run: os.path.join(tmp, "dp_" + run) for run in ("full", "split")}
    for run, directory in runs.items():
        files = {d: sorted(os.listdir(os.path.join(directory, d)))
                 for d in sorted(os.listdir(directory))}
        check(files == {"pong64": [f"{DP_CLI_STEPS}.pt"],
                        "pong64_best": [f"{DP_CLI_STEPS}.pt", "best.json"]}
              or files == {"pong64": [f"{DP_CLI_STEPS}.pt"],
                           "pong64_best": [f"{DP_CLI_STEPS // 2}.pt",
                                           "best.json"]},
              f"dp {run}: files {files}")
    full, split = (torch.load(os.path.join(runs[r], "pong64",
                                           f"{DP_CLI_STEPS}.pt"),
                              map_location="cpu", weights_only=True)
                   for r in ("full", "split"))
    n = _same_tensors(full, split, "dp pong64 checkpoint")
    print(f"pong64 at world 2: step-{DP_CLI_STEPS} checkpoints of the "
          f"uninterrupted and the resumed run equal bit for bit ({n} "
          f"tensors); rank 0 wrote every file, once", flush=True)

    import torch.multiprocessing as mp
    out_dir = os.path.join(tmp, "dp_gloo")
    os.makedirs(out_dir)
    mp.spawn(_dp_gloo_rank, args=(2, _free_port(), out_dir), nprocs=2)
    res = [json.loads(Path(out_dir, f"{r}.json").read_text())
           for r in range(2)]
    print(f"gradient all-reduce through the bucket between two gloo ranks "
          f"on one card ({DP_PRESET}'s gradients, host clock to a "
          f"synchronise, median of 20): rank 0 "
          f"{np.median(res[0]['reduce_s']) * 1e3:.3f} ms, rank 1 "
          f"{np.median(res[1]['reduce_s']) * 1e3:.3f} ms  [{card}]",
          flush=True)
    check(all(r["dispatch"] == "2 CUDA graphs/step around an eager gloo "
              "all-reduce" and r["graphs"] == 2 for r in res),
          f"gloo dispatch {res}")
    graphs = [torch.load(os.path.join(out_dir, f"{r}.pt"),
                         weights_only=True) for r in range(2)]
    n = _same_tensors(graphs[0], graphs[1], "rank 1's graphed pong64")
    check(res[0]["losses"] == res[1]["losses"],
          f"the ranks' losses {res[0]['losses']} / {res[1]['losses']}")
    ms = res[0]["ms"]
    line = "; ".join(
        f"{kind} {' / '.join(f'{e:.3f}' for e, _ in ms[kind])} ms (host "
        f"{' / '.join(f'{h:.3f}' for _, h in ms[kind])})"
        for kind in ("eager", "graph"))
    print(f"pong64 b64 at two gloo ranks on the card: {GLOO_EQUAL_STEPS} "
          f"steps graphed (1 eager + {GLOO_EQUAL_STEPS - 1} replays of two "
          f"graphs around the eager all-reduce) equal {GLOO_EQUAL_STEPS} "
          f"eager DP steps bit for bit on each rank ({res[0]['tensors']} "
          f"tensors: parameters, Adam moments and counts, metrics), the "
          f"ranks' parameters equal ({n} tensors); capture "
          f"{res[0]['capture_s']:.3f}s, {res[0]['pool_bytes'] / 2 ** 20:.1f} "
          f"MiB; rank 0 ms/step, CUDA events over 20 steps, median of 3, in "
          f"turns eager, graph, graph, eager: {line}  [{card}]", flush=True)


def dp_serve_phase(card: str, tmp: str) -> list:
    """The server on ``--devices 1`` (``make_dp_extract`` over the card):
    requests that fill each bucket, answered bit for bit as
    ``make_live_extract`` answers them at the same bucket, then the n=1
    p50 over 30 requests; a replayed bucket call launches K1 once (from
    torch.profiler: a replay calls no wrapper). Then ``make_dp_extract``
    over two replicas on the card (the slab split and the ordered gather)
    at buckets 8/64/256, bit for bit the one-device extract of each half
    at the same slab, K1 once a replica a call. → the counts of the
    server's run."""
    from keypoints_tpu_torch.parallel.dp import make_dp_extract

    phase(f"32 dp serve: --devices 1 on buckets "
          f"{' '.join(map(str, BUCKETS))}, two replicas at 8/64/256, on "
          f"{card}")
    cfg = get_config("celeba128")
    state = {k: torch.from_numpy(v) for k, v in
             state_dict_from_flax(random_flax_params(cfg, 0)).items()}
    ckpt = os.path.join(tmp, "celeba128_seed0.pt")
    torch.save(state, ckpt)
    rs = np.random.RandomState(8)
    requests = {b: rs.rand(b, 3, 128, 128).astype(np.float32)
                for b in BUCKETS}
    one = make_live_extract(cfg, state, BUCKETS, "cuda")
    want = {b: one(x) for b, x in requests.items()}
    del one
    reset_counts()
    server = start_server(ckpt, BUCKETS, "--devices", "1")
    url = f"http://localhost:{server[0].server_address[1]}"
    latencies = []
    try:
        meta = http_meta(url)
        check(meta["data_parallel_devices"] == 1, f"meta {meta}")
        for b, images in requests.items():
            got = http_extract(url, images)
            check(np.array_equal(got, want[b]), f"--devices 1 at b{b} "
                  f"differs from the one-device extract by "
                  f"{np.abs(got - want[b]).max()}")
        one_row = requests[1]
        for i in range(35):
            t0 = time.perf_counter()
            http_extract(url, one_row)
            if i >= 5:
                latencies.append(time.perf_counter() - t0)
        counts = read_counts()
        extract = server[1]._extract
        replay, _, _ = profiled_launches(lambda: extract(requests[8]),
                                         SERVE_PROFILED_CALLS)
    finally:
        stop_server(*server)
    split = (8, 64, 256)
    two = make_dp_extract(cfg, state, split, ["cuda:0", "cuda:0"])
    check(two.meta["data_parallel_devices"] == 2, f"meta {two.meta}")
    half = make_live_extract(cfg, state, [b // 2 for b in split], "cuda")
    for b in split:
        images = requests[b]
        got = two(images)
        want2 = np.concatenate([half(images[:b // 2]), half(images[b // 2:])])
        check(got.shape == want2.shape and np.array_equal(got, want2),
              f"two replicas at b{b} differ from the one-device extract of "
              f"each b{b // 2} half by {np.abs(got - want2).max()}")
    replicas, _, _ = profiled_launches(lambda: two(requests[64]),
                                       SERVE_PROFILED_CALLS)
    del two, half
    print(f"two replicas on the card: answers at b8, b64, b256 equal the "
          f"one-device extract of each half bit for bit; a replayed b64 "
          f"call launches {replicas} (torch.profiler)", flush=True)
    check(replicas == {k: 2 * int(k == "spatial_softmax_fwd")
                       for k in PROFILED_KERNELS},
          f"two replicas' call launched {replicas}, K1 twice expected")
    print(f"--devices 1: answers at b{', b'.join(map(str, BUCKETS))} equal "
          f"the one-device extract bit for bit; http n=1 p50 "
          f"{np.median(latencies) * 1e3:.3f} ms (30 requests, host clock); "
          f"wrapper counts {counts} (each bucket's eager warm-up and "
          f"capture); a replayed bucket call launches {replay} "
          f"(torch.profiler)  [{card}]", flush=True)
    check(counts == {k: 2 * len(BUCKETS) * int(k == "spatial_softmax_fwd")
                     for k in KERNELS},
          f"dp serving wrapper counts {counts}: 2 a bucket expected")
    check(replay == {k: int(k == "spatial_softmax_fwd")
                     for k in PROFILED_KERNELS},
          f"a replayed bucket call launched {replay}, K1 once expected")
    return [counts]


# phase 33: artifacts exported on the card; the plain soft-argmax's ops,
# none of which may be left in a CUDA artifact's graph
EXPORT_OP = "keypoints_tpu_torch.spatial_softmax_fwd.default"
PLAIN_SOFTMAX_OPS = ("softmax", "arange", "sum", "stack", "repeat", "mul.")
ARTIFACT_TIMED_BUCKET = 256
OP_HOST_CALLS = 2000
# phase 34: requests to the --artifact server (300: above the top bucket)
ARTIFACT_REQUESTS = (1, 3, 300)
VIDEO_FRAMES = 600
VIDEO_BUCKET = 64
EVAL_ARTIFACT_TOL = 1e-4


def _graph_targets(pt2: bytes) -> list:
    """The call_function targets of a saved ``.pt2``'s graph."""
    program = torch.export.load(io.BytesIO(pt2))
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function"]


def _check_graph(pt2: bytes, what: str) -> None:
    targets = _graph_targets(pt2)
    plain = [t for t in targets
             if t != EXPORT_OP and any(p in t for p in PLAIN_SOFTMAX_OPS)]
    check(targets.count(EXPORT_OP) == 1 and not plain,
          f"{what}: {targets.count(EXPORT_OP)} K1 op nodes, plain "
          f"soft-argmax ops {plain}")


def _host_ms(fn, calls: int = 20) -> float:
    """Median host-clock ms of ``fn()`` (numpy in, numpy out: each call
    ends in its device-to-host read), after 3 warm calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def export_phase(card: str, tmp: str) -> tuple[list, dict]:
    """Artifacts exported on the card at full width: celeba128's bundle of
    BUCKETS, float32 and uint8 in, and transporter_atari at b64. Each
    graph holds the K1 op once and no plain soft-argmax op; each bucket's
    answers equal ``make_live_extract``'s at that bucket; one K1 launch a
    replayed bucket call (torch.profiler; the wrappers count each bucket's
    eager first call and its capture); images/s of artifact and live at
    b256 in turns;
    host µs of a K1 call through the op and through the ctypes wrapper, in
    turns. → (the counts of the artifact calls, paths phase 34 reuses)."""
    from keypoints_tpu_torch import export

    phase(f"33 export: celeba128 bundle b{'/'.join(map(str, BUCKETS))} "
          f"(float32 and uint8 in), transporter_atari b{VIDEO_BUCKET}, bf16, "
          f"on {card}")
    cfg = get_config("celeba128")
    state = {k: torch.from_numpy(v) for k, v in
             state_dict_from_flax(random_flax_params(cfg, 0)).items()}
    ckpt = os.path.join(tmp, "celeba128_seed0.pt")
    torch.save(state, ckpt)
    t_cfg = get_config("transporter_atari")
    t_state = {k: torch.from_numpy(v) for k, v in
               state_dict_from_flax(random_flax_params(t_cfg, 0)).items()}
    rs = np.random.RandomState(33)
    bundles, counts = {}, []
    for dtype in ("float32", "uint8"):
        t0 = time.perf_counter()
        data = export.export_extract_bundle(cfg, state, BUCKETS, "cuda",
                                            dtype)
        secs = time.perf_counter() - t0
        bundles[dtype] = data
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            for b in BUCKETS:
                _check_graph(z.read(f"b{b}.pt2"), f"celeba128 b{b} {dtype}")
        print(f"celeba128 {dtype} bundle: exported in {secs:.2f}s "
              f"({secs / len(BUCKETS):.2f}s a bucket), "
              f"{len(data) / 1e6:.3f} MB; every bucket's graph holds "
              f"{EXPORT_OP} once and no plain soft-argmax op  [{card}]",
              flush=True)
        art = export.load_extract(data)
        live = make_live_extract(cfg, state, BUCKETS, "cuda", dtype)
        reset_counts()
        diffs = {}
        replays = {}
        for b in BUCKETS:
            x = rs.rand(b, 3, 128, 128).astype(np.float32)
            if dtype == "uint8":
                x = (x * 255).astype(np.uint8)
            got = art(x)
            want = live(x)
            check(got.shape == (b, 10, 2) and bool(np.isfinite(got).all()),
                  f"artifact b{b} {dtype}: shape {got.shape} or non-finite")
            diffs[b] = float(np.abs(got - want).max())
            replays[b], _, _ = profiled_launches(lambda: art(x),
                                                 SERVE_PROFILED_CALLS)
            check(replays[b] == {k: int(k == "spatial_softmax_fwd")
                                 for k in PROFILED_KERNELS},
                  f"artifact b{b} {dtype}: a replayed call launched "
                  f"{replays[b]}, K1 once expected")
        run = read_counts()
        counts.append(run)
        calls = 4 * len(BUCKETS)   # the artifact's and the live's, 2 each
        check(run["spatial_softmax_fwd"] == calls and all(
            v == 0 for k, v in run.items() if k != "spatial_softmax_fwd"),
            f"{dtype} artifact and live: wrapper counts {run}, {calls} "
            f"expected (each bucket's eager first call and its capture)")
        print(f"celeba128 {dtype}: artifact vs make_live_extract at each "
              f"bucket, max|d| {diffs} (0 = equal bits); wrapper counts "
              f"{run} over {len(BUCKETS)} artifact + {len(BUCKETS)} live "
              f"first calls; K1 once a replayed artifact call at every "
              f"bucket (torch.profiler)  [{card}]", flush=True)
        check(max(diffs.values()) <= SERVE_TOL,
              f"artifact vs live {dtype}: {diffs}")
        if dtype == "float32":
            x = rs.rand(ARTIFACT_TIMED_BUCKET, 3, 128, 128).astype(
                np.float32)
            b = ARTIFACT_TIMED_BUCKET
            turns = [("artifact", art), ("live", live), ("live", live),
                     ("artifact", art)]
            ms = [(name, _host_ms(lambda: fn(x))) for name, fn in turns]
            print(f"b{b} float32 extract from the host (upload, Psi, K1, "
                  f"read back), host clock, median of 20, in turns: "
                  + ", ".join(f"{n} {t:.3f} ms ({b / t * 1e3:.0f} images/s)"
                              for n, t in ms) + f"  [{card}]", flush=True)
        del art, live
    t0 = time.perf_counter()
    t_data = export.export_extract(t_cfg, t_state, VIDEO_BUCKET, "cuda")
    secs = time.perf_counter() - t0
    _check_graph(t_data, f"transporter_atari b{VIDEO_BUCKET}")
    t_art = export.load_extract(t_data)
    t_live = make_live_extract(t_cfg, t_state, [VIDEO_BUCKET], "cuda")
    x = rs.rand(VIDEO_BUCKET, 1, 64, 64).astype(np.float32)
    reset_counts()
    got, want = t_art(x), t_live(x)
    counts.append(read_counts())
    check(counts[-1]["spatial_softmax_fwd"] == 4,
          f"transporter artifact and live: wrapper counts {counts[-1]}, 4 "
          f"expected (two first calls and their captures)")
    t_err = float(np.abs(got - want).max())
    print(f"transporter_atari b{VIDEO_BUCKET}: exported in {secs:.2f}s, "
          f"{len(t_data) / 1e6:.3f} MB, graph holds the K1 op once; vs "
          f"make_live_extract max|d| {t_err:.3e}  [{card}]", flush=True)
    check(t_err <= SERVE_TOL, f"transporter artifact vs live {t_err}")
    t_path = os.path.join(tmp, "transporter_atari.pt2")
    Path(t_path).write_bytes(t_data)

    # host cost of a K1 call through the custom op against the ctypes
    # wrapper: 2,000 calls enqueued back to back, host clock, the device
    # faster than the host at N = 2,560 32^2
    hm = torch.from_numpy((3 * rs.randn(256, 10, 32, 32)).astype(
        np.float32)).cuda()
    check(torch.equal(ssc.spatial_softmax_op(hm, 1.0, "marginal", True),
                      ssc.spatial_softmax_cuda(hm, 1.0, "marginal", True)),
          "the op and the wrapper differ")

    def host_us(fn) -> float:
        for _ in range(50):
            fn(hm, 1.0, "marginal", True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OP_HOST_CALLS):
            fn(hm, 1.0, "marginal", True)
        us = (time.perf_counter() - t0) / OP_HOST_CALLS * 1e6
        torch.cuda.synchronize()
        return us

    turns = [("op", ssc.spatial_softmax_op),
             ("ctypes", ssc.spatial_softmax_cuda),
             ("ctypes", ssc.spatial_softmax_cuda),
             ("op", ssc.spatial_softmax_op)]
    us = [(name, host_us(fn)) for name, fn in turns]
    print(f"K1 host time a call, N = 2,560 32^2 marginal, {OP_HOST_CALLS} "
          f"calls back to back, in turns: "
          + ", ".join(f"{n} {u:.2f} us" for n, u in us)
          + f"  [{card}]", flush=True)
    return counts, {"ckpt": ckpt, "transporter": t_path,
                    "bundle": bundles["float32"]}


def _wait_for_server(url: str, proc, log: str,
                     timeout: float = 300.0) -> dict:
    """Poll ``url``'s metadata until it answers; fail if ``proc`` exits."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        check(proc.poll() is None, f"server exited {proc.returncode}: "
              f"{Path(log).read_text()[-2000:]}")
        try:
            return http_meta(url, timeout=2.0)
        except RuntimeError:
            time.sleep(0.5)
    raise SmokeFailure(f"server at {url} did not answer in {timeout}s")


def _start(argv: list, log: str) -> subprocess.Popen:
    """``python -m`` ``argv`` from the checkout, its output to ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                                stdout=f, stderr=subprocess.STDOUT)


def _finish(proc: subprocess.Popen, log: str, what: str) -> str:
    """Wait for ``proc`` and fail unless it exited 0; → its output."""
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    out = Path(log).read_text()
    check(proc.returncode == 0, f"{what} exited {proc.returncode}: "
          f"{out[-2000:]}")
    return out


def artifact_cli_phase(card: str, tmp: str, paths: dict,
                       preset_p50_ms: float) -> None:
    """The CLIs of the artifact path, each as its own process:
    ``export`` of celeba128's bundle; then, all started together,
    ``serve --artifact``, ``eval --artifact --overlay`` and ``eval
    --checkpoint`` of the same weights, and ``video --artifact`` over
    VIDEO_FRAMES frames of the committed data/atari_64.npy; once the
    others have exited, the server's answers at n = 1, 3 and 300 against
    the in-process artifact, bit for bit, and its n=1 p50; then the video
    render in this process, timed."""
    from keypoints_tpu_torch import export
    from keypoints_tpu_torch import video

    phase(f"34 artifact CLIs on {card}")
    bundle = os.path.join(tmp, "extract.zip")
    log = os.path.join(tmp, "export.log")
    t0 = time.perf_counter()
    out = _finish(_start(["keypoints_tpu_torch.export", "--preset",
                          "celeba128", "--checkpoint", paths["ckpt"],
                          "--batch", *map(str, BUCKETS), "--out", bundle],
                         log), log, "export CLI")
    print(f"export CLI ({time.perf_counter() - t0:.2f}s): " + " / ".join(
        line for line in out.splitlines()
        if line.startswith(("wrote", "reload"))), flush=True)

    port = _free_port()
    url = f"http://localhost:{port}"
    png = os.path.join(tmp, "overlay.png")
    video_out = os.path.join(tmp, "t.mp4")
    video_argv = ["--preset", "transporter_atari", "--artifact",
                  paths["transporter"], "--store",
                  str(ROOT / "data" / "atari_64.npy"), "--out", video_out,
                  "--frames", str(VIDEO_FRAMES)]
    runs = {
        "serve": ["keypoints_tpu_torch.serve", "--artifact", bundle, "--port",
                  str(port)],
        "video": ["keypoints_tpu_torch.video", *video_argv]}
    for source, extra in (("checkpoint", ["--checkpoint", paths["ckpt"]]),
                          ("artifact", ["--artifact", bundle, "--overlay",
                                        png])):
        runs[f"eval --{source}"] = [
            "keypoints_tpu_torch.eval", "--preset", "celeba128", *extra,
            "--batch", str(EVAL_BATCH), "--json",
            os.path.join(tmp, f"eval_{source}.json"), "--override",
            f"data.data_dir={tmp}"]
    logs = {name: os.path.join(tmp, f"{name.replace(' --', '_')}.log")
            for name in runs}
    t0 = time.perf_counter()
    procs = {name: _start(argv, logs[name]) for name, argv in runs.items()}
    latencies = []
    try:
        outs = {name: _finish(proc, logs[name], name)
                for name, proc in procs.items() if name != "serve"}
        print(f"eval --checkpoint, eval --artifact --overlay, video "
              f"--artifact and serve --artifact started together: the three "
              f"exited 0 within {time.perf_counter() - t0:.2f}s", flush=True)
        meta = _wait_for_server(url, procs["serve"], logs["serve"])
        print(f"serve --artifact answered {time.perf_counter() - t0:.2f}s "
              f"after its start; meta {meta}", flush=True)
        local = export.load_extract(bundle)
        check(meta == local.meta, f"served meta {meta} != {local.meta}")
        rs = np.random.RandomState(34)
        for n in ARTIFACT_REQUESTS:
            images = rs.rand(n, 3, 128, 128).astype(np.float32)
            got = http_extract(url, images)
            want = local(images)
            check(np.array_equal(got, want), f"serve --artifact n={n} "
                  f"differs from the in-process artifact by "
                  f"{np.abs(got - want).max()}")
        one = rs.rand(1, 3, 128, 128).astype(np.float32)
        for i in range(35):
            t1 = time.perf_counter()
            http_extract(url, one)
            if i >= 5:
                latencies.append(time.perf_counter() - t1)
        del local
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    print(f"serve --artifact: answers at n = "
          f"{', '.join(map(str, ARTIFACT_REQUESTS))} equal the in-process "
          f"artifact's bits; http n=1 p50 {np.median(latencies) * 1e3:.3f} ms "
          f"(30 requests, host clock) against phase 6's --preset server "
          f"{preset_p50_ms:.3f} ms  [{card}]", flush=True)

    records = {source: json.loads(Path(tmp, f"eval_{source}.json").read_text())
               for source in ("checkpoint", "artifact")}
    art, ref = records["artifact"], records["checkpoint"]
    print(f"eval --checkpoint b{EVAL_BATCH}: {ref['metrics']}", flush=True)
    print(f"eval --artifact b{EVAL_BATCH}: {art['metrics']}", flush=True)
    check(art["step"] is None and "eval_loss" not in art["metrics"],
          f"artifact record {art}")
    diffs = {k: abs(v - ref["metrics"][k]) for k, v in art["metrics"].items()}
    check(max(diffs.values()) <= EVAL_ARTIFACT_TOL,
          f"eval --artifact vs --checkpoint metrics {diffs}")
    check(os.path.getsize(png) > 0, "no overlay PNG")
    print(f"eval --artifact vs --checkpoint, keypoint metrics |d| {diffs} "
          f"(tolerance {EVAL_ARTIFACT_TOL}); overlay PNG "
          f"{os.path.getsize(png)} bytes  [{card}]", flush=True)
    check(f"wrote {VIDEO_FRAMES} frames" in outs["video"],
          f"video CLI: {outs['video'][-1000:]}")
    print(f"video CLI: {outs['video'].strip().splitlines()[-1]}", flush=True)
    t0 = time.perf_counter()
    written = video.main(video_argv)
    wall = time.perf_counter() - t0
    check(written == VIDEO_FRAMES, f"video wrote {written} frames")
    print(f"video --artifact in this process: {written} frames in "
          f"{wall:.3f}s ({written / wall:.0f} frames/s: load, extract at "
          f"b{VIDEO_BUCKET}, draw, encode)  [{card}]", flush=True)


def tools_phase(card: str, tmp: str, bundle: bytes) -> None:
    """``utils.profiling.timed`` on a K1 call against CUDA events; ``trace``
    of an artifact call writes a trace with the K1 kernel in it;
    ``guard_metrics`` raises on a NaN metric; ``assert_finite`` names the
    non-finite tensor."""
    from keypoints_tpu_torch import export
    from keypoints_tpu_torch.utils import debug, profiling

    phase(f"35 tools on {card}")
    rs = np.random.RandomState(35)
    hm = torch.from_numpy((3 * rs.randn(256, 10, 32, 32)).astype(
        np.float32)).cuda()
    best, out = profiling.timed(ssc.spatial_softmax_cuda, hm, reps=50)
    check(out.shape == (256, 10, 2), f"timed output {out.shape}")
    events = cuda_median_ms(lambda: ssc.spatial_softmax_cuda(hm),
                            queue_behind_sleep=False)
    print(f"K1 N = 2,560 32^2: utils.profiling.timed best {best * 1e6:.1f} "
          f"us (host clock, a one-element read each call) against CUDA "
          f"events {events * 1e3:.1f} us (with its launch)  [{card}]",
          flush=True)

    art = export.load_extract(bundle)
    x = rs.rand(64, 3, 128, 128).astype(np.float32)
    art(x)
    logdir = os.path.join(tmp, "prof")
    with profiling.trace(logdir) as prof:
        art(x)
        art(x)
    trace_file = os.path.join(logdir, "trace.json")
    kernels = [e for e in prof.key_averages()
               if "marginal_fwd" in e.key and e.device_time_total > 0]
    check(os.path.getsize(trace_file) > 0 and kernels,
          f"trace {trace_file}: no soft-argmax kernel with device time")
    print(f"trace of two b64 artifact calls (graph replays): {trace_file} "
          f"({os.path.getsize(trace_file)} bytes); "
          + ", ".join(f"{e.key[:60]} {e.device_time_total:.1f} us"
                      for e in kernels[:2]) + f"  [{card}]", flush=True)

    def step(state, batch):
        return state, {"loss": batch.mean(), "grad_norm": batch.norm()}

    guarded = debug.guard_metrics(step)
    _, metrics = guarded(None, torch.ones(4, device="cuda"))
    guarded.check(metrics)
    _, metrics = guarded(None, torch.tensor([1.0, float("nan")],
                                            device="cuda"))
    try:
        guarded.check(metrics)
        raise SmokeFailure("guard_metrics let a NaN loss through")
    except FloatingPointError as e:
        print(f"guard_metrics: {e}", flush=True)
    state = build_model(get_config("celeba128"), "cuda").state_dict()
    bad = "keynet.head.weight"
    state[bad].view(-1)[7] = float("inf")
    try:
        debug.assert_finite(state, "params")
        raise SmokeFailure("assert_finite let an Inf through")
    except FloatingPointError as e:
        check(bad in str(e), f"assert_finite named {e}")
        print(f"assert_finite: {e}", flush=True)


# phase 36: the graphed train step against the eager one. case -> (preset,
# overrides, the loop's in-step source or a fixed image batch, kernels a
# step: LOOP_CASES' and phases 9/14/19's)
GRAPH_CASES = {
    "celeba128 b128": ("celeba128", {"train.batch_size": TRAIN_BATCH}, False,
                       {"warp_field": 2, "softargmax_raster_fwd": 1,
                        "spatial_softmax_bwd": 1, "gaussian_bwd": 1}),
    "pose256 b128": ("pose256", {"train.batch_size": TRAIN_BATCH}, False,
                     {"warp_field": 2, "max_pool_fwd": 4, "max_pool_bwd": 2,
                      "softargmax_raster_fwd": 1, "spatial_softmax_bwd": 1,
                      "gaussian_bwd": 1}),
    "transporter_atari joint b64": (
        "transporter_atari", {"model.softmax_variant": "joint"}, True,
        {"softargmax_raster_fwd": 2, "spatial_softmax_bwd": 1,
         "gaussian_bwd": 1}),
    "transporter_atari marginal b64": (
        "transporter_atari", {}, True,
        {"softargmax_raster_fwd": 2, "spatial_softmax_bwd": 1,
         "gaussian_bwd": 1}),
    "pong64 b64": ("pong64", {}, True,
                   {"gaussian_fwd": 2, "softargmax_raster_fwd": 1,
                    "spatial_softmax_bwd": 1, "gaussian_bwd": 1}),
}
GRAPH_EQUAL_STEPS = 4      # 1 eager + 3 replays against 4 eager steps
GRAPH_TIMED_STEPS = {"pose256 b128": 5, "celeba128 b128": 10}   # else 20
GRAPH_PROFILED_STEPS = 3
# the card's spin at each edge of a profiled window (~10 ms at 1.98 GHz)
PROFILE_EDGE_CYCLES = 20_000_000
# each counted kernel's function names, as torch.profiler shows them
PROFILED_KERNELS = {
    "spatial_softmax_fwd": {"marginal_fwd", "joint_fwd", "block_fwd"},
    "spatial_softmax_bwd": {"marginal_bwd", "joint_bwd", "block_marginal_bwd",
                            "block_joint_bwd"},
    "gaussian_fwd": {"gaussian_fwd"}, "gaussian_bwd": {"gaussian_bwd"},
    "warp_bilinear": {"warp_bilinear"}, "warp_field": {"warp_field"},
    "max_pool_fwd": {"max_pool_fwd"}, "max_pool_bwd": {"max_pool_bwd"},
    "softargmax_raster_fwd": {"fused_fwd", "block_fused_fwd"},
}


# phase 36's failing capture: pong64 with a source whose sampling reads a
# value back to the host
CAPTURE_FAILURE = """
from keypoints_tpu_torch import train as train_mod
from keypoints_tpu_torch.configs import get_config
from keypoints_tpu_torch.training import (CaptureError, init_state,
                                          make_graphed_train_step)
cfg = get_config("pong64")
source = train_mod.make_batch_iterator(cfg, device="cuda")
sample = source.sample


def reading(gen, n):
    batch = sample(gen, n)
    float(batch[0].sum())
    return batch


source.sample = reading
state = init_state(cfg, "cuda")
step = make_graphed_train_step(cfg, state, source=source)
try:
    step(state)
    print("captured")
except CaptureError as e:
    print(f"CaptureError after step {state.step}, from "
          f"{type(e.__cause__).__name__}: {str(e).splitlines()[0][:120]}")
"""


def _kernel_name(event_name: str) -> str:
    """The function of a kernel's demangled name: ``marginal_fwd`` of
    ``void (anonymous namespace)::marginal_fwd<2, true>(float const*,
    ...)``."""
    import re
    found = re.search(r"::(\w+)\s*[<(]", event_name)
    return found.group(1) if found else event_name


def profiled_launches(fn, calls: int, warmup=None
                      ) -> tuple[dict, float, float]:
    """torch.profiler over ``calls`` calls of ``fn``: → (launches of each
    counted kernel a call, from the kernel events' names; device ms a call,
    the sum of the kernels and copies on the card; host ms a call around
    the profiled calls, to a synchronise). The profiler traces a first
    ``warmup()`` (default: a call of ``fn``) without recording it, and the
    card spins ~10 ms at each end of the recorded window before the calls
    and after them: kernels at the very edges of a trace can be missed
    (the first K2 and K3 launches of a window have been)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        (warmup or fn)()
        torch.cuda.synchronize()
        prof.step()
        torch.cuda._sleep(PROFILE_EDGE_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / calls * 1e3
        torch.cuda._sleep(PROFILE_EDGE_CYCLES)
        torch.cuda.synchronize()
    # the kernels and copies; not the step's annotation on the card's line,
    # nor the edges' spins
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")
               and "spin_kernel" not in e.name]
    names = [_kernel_name(e.name) for e in on_card]
    counts = {}
    for kernel, fns in PROFILED_KERNELS.items():
        n = sum(name in fns for name in names)
        check(n % calls == 0, f"{kernel}: {n} launches in {calls} calls")
        counts[kernel] = n // calls
    device_ms = sum(e.time_range.elapsed_us() for e in on_card) / calls / 1e3
    return counts, device_ms, host_ms


def _card_op() -> None:
    """One small op on the card: a profiler's warm-up."""
    torch.ones(1, device="cuda").add_(1)


def _step_ms(run, steps: int) -> tuple[float, float]:
    """(CUDA-event ms a step, host ms a step), each the median of 3 runs
    of ``steps`` warm steps; each run ends in a synchronise."""
    torch.cuda.synchronize()
    events, host = [], []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            run()
        end.record()
        end.synchronize()
        events.append(start.elapsed_time(end) / steps)
        host.append((time.perf_counter() - t0) / steps * 1e3)
    return float(np.median(events)), float(np.median(host))


def _optimizer_move(card: str) -> None:
    """How far the capturable Adam (bias corrections on the card in
    float32) moves one eager celeba128 b128 step against torch's default
    Adam (bias corrections on the host in float64), from the same state
    at the schedule's peak rate (step ``warmup_steps``)."""
    cfg = get_config("celeba128").override(
        **{"train.batch_size": TRAIN_BATCH})
    images = torch.from_numpy(random_images(TRAIN_BATCH, cfg, 4)).cuda()
    states = [init_state(cfg, "cuda") for _ in range(2)]
    default = states[1]
    default.optimizer = torch.optim.Adam(default.model.parameters(), lr=0.0,
                                         betas=(0.9, 0.999), eps=1e-8)
    before = [p.detach().clone() for p in default.model.parameters()]
    step = make_train_step(cfg)
    for state in states:
        state.step = cfg.train.warmup_steps
        step(state, images)
    moved = max((a - b).abs().max().item() for a, b in zip(
        states[0].model.parameters(), default.model.parameters()))
    update = max((a - b).abs().max().item() for a, b in zip(
        default.model.parameters(), before))
    print(f"one eager celeba128 b{TRAIN_BATCH} step at the peak rate, "
          f"capturable Adam against torch's default Adam: parameters "
          f"max|d| {moved:.3e}, {moved / update:.3e} of the largest update "
          f"({update:.3e})  [{card}]", flush=True)
    del states, default


def graph_step_phase(card: str) -> list:
    """Each case's step through ``make_graphed_train_step`` (one eager step,
    then replays of the captured graph) against ``make_train_step``'s eager
    steps from the same initial state, cuDNN deterministic as ``train()``
    runs it: after 1 eager + 3 replayed steps against 4 eager ones, every
    parameter, Adam moment and step count and every step's metrics equal
    bit for bit. Launches a step counted from torch.profiler's kernel
    names, eager and replayed; the wrapper counters see the eager step
    and the capture only. The capture's seconds and the bytes it reserved;
    ms a step by CUDA events and the host clock in turns (eager, graph,
    graph, eager) and the device's idle share; pose256's peak memory
    under the graph. → the counts of the graphed runs."""
    phase(f"36 graph step: one CUDA graph a step against the eager step, on "
          f"{card}")
    from keypoints_tpu_torch import train as train_mod
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    path_counts = []
    try:
        _optimizer_move(card)
        for case, (preset, over, in_step, per_step) in GRAPH_CASES.items():
            t_case = time.perf_counter()
            cfg = get_config(preset).override(**over)
            loss = make_loss(cfg)
            if in_step:
                sources = [train_mod.make_batch_iterator(cfg, device="cuda")
                           for _ in range(2)]
                check(all(isinstance(src, train_mod.InStepBatches)
                          for src in sources), f"{case}: not in-step")
                images = None
            else:
                images = torch.from_numpy(random_images(
                    cfg.train.batch_size, cfg, 4)).cuda()
            eager, graphed = init_state(cfg, "cuda"), init_state(cfg, "cuda")
            eager_step = make_train_step(cfg, loss=loss)

            def eager_once():
                nonlocal eager
                batch = (sources[0].sample_at(eager.step) if in_step
                         else images)
                eager, m = eager_step(eager, batch)
                return m

            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            graph_step = make_graphed_train_step(
                cfg, graphed, source=sources[1] if in_step else None,
                loss=loss)

            def graph_once():
                nonlocal graphed
                graphed, m = (graph_step(graphed) if in_step
                              else graph_step(graphed, images))
                return m

            got = [{k: v.clone() for k, v in graph_once().items()}
                   for _ in range(GRAPH_EQUAL_STEPS)]
            torch.cuda.synchronize()
            captured = read_counts()
            peak = torch.cuda.max_memory_allocated()
            want = [{k: v.clone() for k, v in eager_once().items()}
                    for _ in range(GRAPH_EQUAL_STEPS)]
            n = _same_tensors(graphed.model.state_dict(),
                              eager.model.state_dict(), f"{case} model")
            n += _same_tensors(graphed.optimizer.state_dict()["state"],
                               eager.optimizer.state_dict()["state"],
                               f"{case} Adam state")
            n += _same_tensors(got, want, f"{case} metrics")
            check(graphed.step == eager.step == GRAPH_EQUAL_STEPS,
                  f"{case}: steps {graphed.step} / {eager.step}")
            check(all(captured[k] == 2 * per_step.get(k, 0)
                      for k in KERNELS),
                  f"{case}: wrappers counted {captured}, the eager step and "
                  f"the capture of {per_step} expected")
            print(f"{case}: {GRAPH_EQUAL_STEPS} steps graphed (1 eager + "
                  f"{GRAPH_EQUAL_STEPS - 1} replays) and eager equal bit for "
                  f"bit ({n} tensors: parameters, Adam moments and counts, "
                  f"metrics; losses {[round(float(m['loss']), 6) for m in got]}"
                  f"); capture {graph_step.capture_seconds:.3f}s, "
                  f"{graph_step.pool_bytes / 2 ** 20:.1f} MiB reserved by it; "
                  f"peak allocated {peak / 2 ** 30:.2f} GiB, reserved "
                  f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB",
                  flush=True)

            reset_counts()
            launches = {}
            for kind, fn in (("eager", eager_once), ("graph", graph_once)):
                launches[kind], device_ms, host_ms = profiled_launches(
                    fn, GRAPH_PROFILED_STEPS)
                check(all(launches[kind][k] == per_step.get(k, 0)
                          for k in PROFILED_KERNELS),
                      f"{case} {kind}: {launches[kind]} kernels a step, "
                      f"{per_step} expected")
                launches[kind]["device_ms"] = device_ms
            replayed = read_counts()
            check(replayed == {k: (GRAPH_PROFILED_STEPS + 1)
                               * per_step.get(k, 0) for k in KERNELS},
                  f"{case}: wrapper counts over eager steps (a warm-up "
                  f"and {GRAPH_PROFILED_STEPS}) and replays {replayed}: a "
                  f"replay must count nothing")
            path_counts.append(captured)

            steps = GRAPH_TIMED_STEPS.get(case, 20)
            ms = {"eager": [], "graph": []}
            for kind in ("eager", "graph", "graph", "eager"):
                ms[kind].append(_step_ms(
                    eager_once if kind == "eager" else graph_once, steps))
            line = "; ".join(
                f"{kind} {' / '.join(f'{e:.3f}' for e, _ in ms[kind])} ms "
                f"(host {' / '.join(f'{h:.3f}' for _, h in ms[kind])}), "
                f"device {launches[kind]['device_ms']:.3f} ms, idle "
                f"{1 - launches[kind]['device_ms'] / np.mean([e for e, _ in ms[kind]]):.1%}"
                for kind in ("eager", "graph"))
            print(f"{case} bf16 ms/step, CUDA events over {steps} steps, "
                  f"median of 3, in turns eager, graph, graph, eager: {line}; "
                  f"graph - eager "
                  f"{np.mean([e for e, _ in ms['graph']]) - np.mean([e for e, _ in ms['eager']]):+.3f} "
                  f"ms ({time.perf_counter() - t_case:.1f}s)  [{card}]",
                  flush=True)
            del eager, graphed, eager_step, graph_step
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    # a step that reads the card on the host cannot be captured: the
    # capture raises, in its own process, and nothing runs it eagerly
    out = subprocess.run([sys.executable, "-c", CAPTURE_FAILURE],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0 and "CaptureError" in out.stdout,
          f"a capture that reads the card did not raise CaptureError: "
          f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    print(f"a source that reads the card on the host: "
          f"{out.stdout.strip().splitlines()[-1]}", flush=True)
    return path_counts


# phase 37: dp_celeba's DP step graphed in a one-rank NCCL group
DP_GRAPH_EQUAL_STEPS = 4   # 1 eager + 3 replays against 4 eager steps
DP_GRAPH_TIMED_STEPS = 10


def dp_graph_phase(card: str) -> list:
    """dp_celeba (b256 bf16) in a one-rank NCCL group in this process, cuDNN
    deterministic, on one fixed batch copied into the graphs' input: the
    DP step through ``make_graphed_train_step(..., group=...)`` (two CUDA
    graphs a step around the eager NCCL all-reduce), the bare step
    graphed, and the eager DP step: after 1 eager + 3 replayed steps
    against 4 eager ones every parameter, Adam moment and count and every
    step's metrics equal bit for bit, all three. The capture's seconds and
    bytes; kernels a step from torch.profiler, eager and replayed, and the
    device's idle share; ms a step by CUDA events and the host clock in
    turns (eager, graph, graph, eager). → the wrapper counts of the run."""
    import torch.distributed as dist
    from keypoints_tpu_torch.parallel import dp as dp_mod
    phase(f"37 dp graph step: {DP_PRESET} b256 bf16, NCCL at world 1, two "
          f"CUDA graphs a step around the eager all-reduce, on {card}")
    cfg = get_config(DP_PRESET)
    flags = _nccl_world_one()
    try:
        group = dist.group.WORLD
        images = torch.from_numpy(random_images(256, cfg, 4)).cuda()
        states = {kind: init_state(cfg, "cuda")
                  for kind in ("graph", "bare", "eager")}
        steps = {"graph": make_graphed_train_step(cfg, states["graph"],
                                                  group=group),
                 "bare": make_graphed_train_step(cfg, states["bare"]),
                 "eager": dp_mod.make_dp_train_step(cfg, group)}
        check(steps["graph"].dispatch ==
              "2 CUDA graphs/step around an eager nccl all-reduce",
              f"dispatch {steps['graph'].dispatch}")

        def stepper(kind):
            def once():
                states[kind], m = steps[kind](states[kind], images)
                return m
            return once

        ones = {kind: stepper(kind) for kind in states}
        reset_counts()
        got = {kind: [{k: v.clone() for k, v in ones[kind]().items()}
                      for _ in range(DP_GRAPH_EQUAL_STEPS)]
               for kind in states}
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts == {k: 8 * DP_PER_STEP.get(k, 0) for k in KERNELS},
              f"wrapper counts {counts}: the two graphs' eager steps and "
              f"captures and 4 eager DP steps of {DP_PER_STEP} expected")
        n = 0
        for kind in ("bare", "eager"):
            n = _same_tensors(states["graph"].model.state_dict(),
                              states[kind].model.state_dict(),
                              f"graphed DP vs {kind} model")
            n += _same_tensors(states["graph"].optimizer.state_dict()["state"],
                               states[kind].optimizer.state_dict()["state"],
                               f"graphed DP vs {kind} Adam state")
            n += _same_tensors(got["graph"], got[kind],
                               f"graphed DP vs {kind} metrics")
        check(all(st.step == DP_GRAPH_EQUAL_STEPS for st in states.values()),
              f"steps {[st.step for st in states.values()]}")
        check(len(steps["graph"].graphs) == 2
              and states["graph"].bucket is not None,
              "the NCCL DP step is not two graphs over a bucket")
        print(f"{DP_GRAPH_EQUAL_STEPS} steps: the graphed DP step (1 eager + "
              f"{DP_GRAPH_EQUAL_STEPS - 1} replays around the eager NCCL "
              f"all-reduce), the "
              f"graphed bare step and the eager DP step equal bit for bit "
              f"({n} tensors a pair: parameters, Adam moments and counts, "
              f"metrics; losses "
              f"{[round(float(m['loss']), 6) for m in got['graph']]}); "
              f"capture: DP {steps['graph'].capture_seconds:.3f}s, "
              f"{steps['graph'].pool_bytes / 2 ** 20:.1f} MiB, bare "
              f"{steps['bare'].capture_seconds:.3f}s, "
              f"{steps['bare'].pool_bytes / 2 ** 20:.1f} MiB  [{card}]",
              flush=True)

        launches = {}
        for kind in ("eager", "graph"):
            launches[kind], device_ms, _ = profiled_launches(
                ones[kind], GRAPH_PROFILED_STEPS)
            check(all(launches[kind][k] == DP_PER_STEP.get(k, 0)
                      for k in PROFILED_KERNELS),
                  f"DP {kind}: {launches[kind]} kernels a step, "
                  f"{DP_PER_STEP} expected")
            launches[kind]["device_ms"] = device_ms
        ms = {"eager": [], "graph": []}
        for kind in ("eager", "graph", "graph", "eager"):
            ms[kind].append(_step_ms(ones[kind], DP_GRAPH_TIMED_STEPS))
        line = "; ".join(
            f"{kind} {' / '.join(f'{e:.3f}' for e, _ in ms[kind])} ms "
            f"(host {' / '.join(f'{h:.3f}' for _, h in ms[kind])}), "
            f"device {launches[kind]['device_ms']:.3f} ms, idle "
            f"{1 - launches[kind]['device_ms'] / np.mean([e for e, _ in ms[kind]]):.1%}"
            for kind in ("eager", "graph"))
        print(f"{DP_PRESET} b256 bf16 DP ms/step at one NCCL rank, CUDA "
              f"events over {DP_GRAPH_TIMED_STEPS} steps, median of 3, in "
              f"turns eager, graph, graph, eager: {line}; graph - eager "
              f"{np.mean([e for e, _ in ms['graph']]) - np.mean([e for e, _ in ms['eager']]):+.3f} "
              f"ms; kernels a replay {launches['graph']}  [{card}]",
              flush=True)
        del states, steps, ones
        torch.cuda.empty_cache()
    finally:
        _leave_group(flags)
    return [counts]


class _EagerBucket:
    """The eager bucket function the CUDA graphs replaced (phase 38 patches
    it in here only): the numpy batch uploaded from pageable memory, then
    ``run``, one aten op and kernel launch at a time; it captures
    nothing."""

    def __init__(self, run, batch, item_shape, dtype, device, pools):
        self.run, self.device = run, torch.device(device)

    def enqueue(self, images: np.ndarray) -> torch.Tensor:
        return self.run(torch.from_numpy(images).to(self.device))

    def __call__(self, images: np.ndarray) -> np.ndarray:
        return self.enqueue(images).cpu().numpy()


def _buckets_as(cls):
    """A context in which the serving paths build their buckets as
    ``cls``."""
    import contextlib
    from keypoints_tpu_torch import export
    from keypoints_tpu_torch.parallel import dp as dp_mod

    @contextlib.contextmanager
    def patched():
        saved = export.GraphedBucket, dp_mod.GraphedBucket
        export.GraphedBucket = dp_mod.GraphedBucket = cls
        try:
            yield
        finally:
            export.GraphedBucket, dp_mod.GraphedBucket = saved
    return patched()


def _eager_buckets():
    """A context in which the serving paths build :class:`_EagerBucket`s."""
    return _buckets_as(_EagerBucket)


def _recorded_buckets(made: list):
    """A context in which the serving paths' ``GraphedBucket``s are also
    appended to ``made``, for their capture's seconds and bytes."""
    from keypoints_tpu_torch.export import GraphedBucket

    class Recorded(GraphedBucket):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)
    return _buckets_as(Recorded)


def _served_p50(argv: list, eager: bool) -> float:
    """``make_server`` of ``argv`` (eager buckets patched in, or its CUDA
    graphs), warmed; → the median ms of 30 n=1 HTTP requests after 5."""
    import contextlib
    with _eager_buckets() if eager else contextlib.nullcontext():
        httpd, batcher = make_server(build_parser().parse_args(
            [*argv, "--port", "0"]))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://localhost:{httpd.server_address[1]}"
    one = np.random.RandomState(38).rand(1, 3, 128, 128).astype(np.float32)
    latencies = []
    try:
        for i in range(35):
            t0 = time.perf_counter()
            http_extract(url, one)
            if i >= 5:
                latencies.append(time.perf_counter() - t0)
    finally:
        stop_server(httpd, batcher, thread)
    return float(np.median(latencies)) * 1e3


def serving_graphs_phase(card: str, bundle: bytes) -> list:
    """Each serving bucket replayed from its CUDA graph against the eager
    bucket function it replaced (patched in here only), on new images at
    every call: celeba128 (bf16) live at buckets 1/8/64/256, float32 and
    uint8 in; two replicas on the card at 8/64/256; phase 33's float32
    artifact bundle. Equal bits everywhere. The captures' seconds and
    bytes; K1 once a replayed call and the device's idle share
    (torch.profiler) at each bucket; host ms a bucket call, eager and
    graphed in turns; the n=1 HTTP p50 of ``--preset`` and ``--artifact``
    servers, eager and graphed in turns. A bucket whose capture fails
    raises ``CaptureError`` at every call and answers nothing. → the
    wrapper counts of the live extracts, eager and graphed."""
    from keypoints_tpu_torch import export
    from keypoints_tpu_torch.parallel.dp import make_dp_extract
    from keypoints_tpu_torch.export import GraphedBucket
    from keypoints_tpu_torch.training import CaptureError

    phase(f"38 serving graphs: celeba128 buckets "
          f"{'/'.join(map(str, BUCKETS))} (float32, uint8), two replicas, "
          f"the artifact, on {card}")
    t_phase = time.perf_counter()
    cfg = get_config("celeba128")
    state = {k: torch.from_numpy(v) for k, v in
             state_dict_from_flax(random_flax_params(cfg, 0)).items()}
    rs = np.random.RandomState(38)

    def images(b: int, dtype: str) -> np.ndarray:
        x = rs.rand(b, 3, 128, 128).astype(np.float32)
        return (x * 255).astype(np.uint8) if dtype == "uint8" else x

    def pair(build):
        """→ (eager, graphed) extracts of ``build``, and the graphed
        one's buckets."""
        made = []
        with _eager_buckets():
            eager = build()
        with _recorded_buckets(made):
            graph = build()
        return eager, graph, made

    def same(eager, graph, made, buckets, dtype: str, what: str) -> None:
        for b in buckets:
            for call in range(3):
                x = images(b, dtype)
                want, got = eager(x), graph(x)
                check(np.array_equal(got, want), f"{what} b{b} call "
                      f"{call}: graph vs eager max|d| "
                      f"{np.abs(got - want).max()}")
        check(made and all(g.graph is not None for g in made),
              f"{what}: a bucket was not captured")

    reset_counts()
    lives = {}
    for dtype in ("float32", "uint8"):
        eager, graph, made = pair(lambda: make_live_extract(
            cfg, state, BUCKETS, "cuda", dtype))
        same(eager, graph, made, BUCKETS, dtype, f"live {dtype}")
        lives[dtype] = (eager, graph, made)
    counts = read_counts()
    check(counts == {k: 2 * 5 * len(BUCKETS) * int(k == "spatial_softmax_fwd")
                     for k in KERNELS},
          f"wrapper counts {counts}: a bucket's 3 eager calls, the graphed "
          f"bucket's eager first call and its capture (a replay calls no "
          f"wrapper) expected")
    eager, graph, made = pair(lambda: make_dp_extract(
        cfg, state, (8, 64, 256), ["cuda:0", "cuda:0"]))
    same(eager, graph, made, (8, 64, 256), "float32", "two replicas")
    del eager, graph, made
    eager, graph, made = pair(lambda: export.load_extract(bundle))
    same(eager, graph, made, BUCKETS, "float32", "artifact")
    del eager, graph, made
    print(f"graph vs eager, equal bits at every bucket and call: live "
          f"float32 and uint8 at b{'/'.join(map(str, BUCKETS))}, two "
          f"replicas at b8/64/256, the artifact at "
          f"b{'/'.join(map(str, BUCKETS))} (3 calls a bucket, new images "
          f"each)  [{card}]", flush=True)

    eager, graph, made = lives["float32"]
    caps = {g.shape[0]: g for g in made}
    print("captures, live float32: " + ", ".join(
        f"b{b} {g.capture_seconds:.3f}s {g.pool_bytes / 2 ** 20:.1f} MiB"
        for b, g in caps.items()) + f"  [{card}]", flush=True)
    rows = []
    for b in BUCKETS:
        x = images(b, "float32")
        prof = {}
        for kind, fn in (("eager", eager), ("graph", graph)):
            prof[kind] = profiled_launches(lambda: fn(x), SERVE_PROFILED_CALLS)
            check(prof[kind][0] == {k: int(k == "spatial_softmax_fwd")
                                    for k in PROFILED_KERNELS},
                  f"{kind} b{b}: a call launched {prof[kind][0]}, K1 once "
                  f"expected")
        host = {"eager": [], "graph": []}
        for kind in ("eager", "graph", "graph", "eager"):
            fn = eager if kind == "eager" else graph
            host[kind].append(_host_ms(lambda: fn(x), calls=30))
        rows.append(f"b{b}: " + "; ".join(
            f"{kind} {' / '.join(f'{t:.3f}' for t in host[kind])} ms, "
            f"device {prof[kind][1]:.3f} ms, idle "
            f"{1 - prof[kind][1] / np.mean(host[kind]):.1%}"
            for kind in ("eager", "graph")))
    print(f"live float32 bucket call from the host (upload, replay, read "
          f"back; eager: upload, then dispatch op by op), host clock, "
          f"median of 30, in turns eager, graph, graph, eager; K1 once a "
          f"call (torch.profiler): " + " | ".join(rows) + f"  [{card}]",
          flush=True)
    del lives, eager, graph, made

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "celeba128_seed0.pt")
        torch.save(state, ckpt)
        art = os.path.join(tmp, "extract.zip")
        Path(art).write_bytes(bundle)
        servers = {"--preset": ["--preset", "celeba128", "--checkpoint",
                                ckpt, "--batch", *map(str, BUCKETS)],
                   "--artifact": ["--artifact", art]}
        p50 = {}
        for name, argv in servers.items():
            p50[name] = {"eager": [], "graph": []}
            for kind in ("eager", "graph", "graph", "eager"):
                p50[name][kind].append(_served_p50(argv, kind == "eager"))
    print("http n=1 p50, 30 requests after 5, host clock, in turns eager, "
          "graph, graph, eager: " + "; ".join(
              f"{name} eager {' / '.join(f'{t:.3f}' for t in v['eager'])} "
              f"ms, graph {' / '.join(f'{t:.3f}' for t in v['graph'])} ms"
              for name, v in p50.items()) + f"  [{card}]", flush=True)

    calls = []

    def reads_the_card(x):
        calls.append(x.shape)
        return x * float(x.sum())

    failing = GraphedBucket(reads_the_card, 2, (3, 8, 8), "float32", "cuda",
                            {})
    raised = []
    for _ in range(2):
        try:
            failing(np.ones((2, 3, 8, 8), np.float32))
        except CaptureError as e:
            raised.append(str(e).splitlines()[0][:100])
    check(len(raised) == 2 and len(calls) == 2,
          f"a bucket that reads the card: {len(raised)} CaptureErrors in 2 "
          f"calls, its function run {len(calls)} times (the eager call and "
          f"the capture expected)")
    print(f"a bucket whose function reads the card: CaptureError at both "
          f"calls, its function run {len(calls)} times (the first call's "
          f"eager run and the capture; no answer): {raised[0]}", flush=True)
    print(f"phase 38 took {time.perf_counter() - t_phase:.1f}s", flush=True)
    return [counts]


# phase 39: celeba128 at the benchmark's paper widths
# (portbench/configs/celeba128.json); its norm shapes and the further ones
# are testing.GROUP_NORM_BLOCKS and GROUP_NORM_OTHER
GN_PAPER = {"model.encoder_filters": (32, 32, 64, 64, 128, 128, 256, 256),
            "model.encoder_strides": (1, 1, 2, 1, 2, 1, 2, 1),
            "model.decoder_filters": (256, 256, 128, 128, 64, 64, 32),
            "model.decoder_upsample": (False, False, True, False, True, False,
                                       True)}
GN_BLOCKS = GROUP_NORM_BLOCKS
GN_OTHER = GROUP_NORM_OTHER
GN_GROUPS = 8
GN_EPS = 1e-5
GN_LABEL_BATCH = 256
# tolerances, a share of the largest |value| the plain version gives: f32
# on both sides, the statistics' and dx's sums taken in another order; the
# parameter gradients are sums of up to 2**23 f32 terms; bf16 outputs also
# one bf16 spacing at that value (one rounding each side of a boundary)
GN_RTOL = 2e-5
GN_PARAM_RTOL = 1e-4
# (testing.group_norm_relu_edge: at the ReLU's edge, |z| <= 1e-4, two right
# f32 computations can take different masks; dx is compared off the edge,
# and each gradient gets the most the edge's flips can move it as room)


def _gn_tol(want: torch.Tensor, rtol: float, bf16: bool) -> float:
    top = want.float().abs().max()
    return float(rtol * top + (bf16_ulp(top) if bf16 else 0.0))


def _gn_conv_bias(channels: int, dtype, seed: int) -> torch.Tensor:
    """A conv's bias in the compute dtype, drawn on the card from ``seed``,
    about as large as the spread of the conv's output (group_norm_inputs),
    so that the add moves every value."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(channels, device="cuda", generator=gen).to(dtype)


def _gn_bias_grad(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  g: torch.Tensor, groups: int) -> tuple[torch.Tensor, float]:
    """dL/dcb of relu(GroupNorm(x + cb)) at z = x + cb: autograd's dL/dz in
    float64, summed over N, H and W; and the largest channel's sum of
    |dL/dz|, the scale of a float32 sum's error. (At one channel a group
    the norm cancels the bias and dL/dcb is 0 but for rounding, so its own
    size is no scale.)"""
    z = z.double().requires_grad_(True)
    y = F.relu(F.group_norm(z, groups, w.double(), b.double(), GN_EPS))
    dz, = torch.autograd.grad(y, z, g.double())
    return (dz.sum((0, 2, 3)).float(),
            float(dz.abs().sum((0, 2, 3)).max()))


def _gn_check(what: str, shape, groups: int, dtype, seed: int,
              unaligned: bool = False, channels_last: bool = False,
              conv_bias: bool = False) -> None:
    """The kernels against the plain version and its autograd at one shape,
    and a second run of each bit for bit; ``channels_last``: the NHWC pair,
    its y and dx in x's layout; ``conv_bias``: with a conv bias cb folded in
    (as every block on the card runs them), against the plain version on x
    + cb (aten's add), dL/dcb against :func:`_gn_bias_grad`, and
    ``bias_folds`` up by the two forward launches."""
    x, w, b, g = group_norm_inputs(shape, dtype, seed, unaligned,
                                   channels_last)
    cb = (_gn_conv_bias(shape[1], dtype, seed + 1),) if conv_bias else ()
    counts = (gnc.launches, gnc.nhwc_launches, gnc.bias_folds)
    got = gnc.group_norm_relu_fwd_cuda(x, w, b, groups, GN_EPS, *cb)
    got += gnc.group_norm_relu_bwd_cuda(g, x, got[1], got[2], w, b, groups,
                                        *cb)
    again = gnc.group_norm_relu_fwd_cuda(x, w, b, groups, GN_EPS, *cb)
    again += gnc.group_norm_relu_bwd_cuda(g, x, again[1], again[2], w, b,
                                          groups, *cb)
    ran = (gnc.launches - counts[0], gnc.nhwc_launches - counts[1],
           gnc.bias_folds - counts[2])
    check(ran == ((0, 2) if channels_last else (2, 0)) + (2 * len(cb),),
          f"group norm {what}: (NCHW, NHWC, folded) forward launches {ran}")
    check(len(got) == 6 + len(cb),
          f"group norm {what}: {len(got)} outputs")
    check(all(t.stride() == x.stride() for t in (got[0], got[3])),
          f"group norm {what}: y and dx not in x's layout")
    x, g = x.contiguous(), g.contiguous()
    if cb:
        x = x + cb[0][:, None, None]
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = plain_gn_relu(xr, groups, wr, br, GN_EPS)
    want = (y.detach(), *group_norm_relu_stats(x, groups, w, b, GN_EPS)[1:],
            *torch.autograd.grad(y, (xr, wr, br), g))
    del y
    if cb:
        dcb, dcb_scale = _gn_bias_grad(x, w, b, g, groups)
        want += (dcb,)
    edge, room = group_norm_relu_edge(x, w, b, g, groups, GN_EPS)
    bf16 = dtype == torch.bfloat16
    report = []
    for name, k, p, rtol, rounded in zip(
            ("y", "mean", "rstd", "dx", "dgamma", "dbeta", "dcb"), got, want,
            (GN_RTOL, GN_RTOL, GN_RTOL, GN_RTOL, GN_PARAM_RTOL,
             GN_PARAM_RTOL, GN_PARAM_RTOL),
            (bf16, False, False, bf16, False, False, False)):
        d = (k.float() - p.float()).abs()
        if name == "dx":
            d = d.masked_fill(edge, 0)
        if name in room:
            d = (d - room[name]).clamp_min(0)
        err = float(d.max())
        tol = (rtol * dcb_scale if name == "dcb"
               else _gn_tol(p, rtol, rounded))
        report.append(f"{name} {err:.3e} ({tol:.3e})")
        check(err <= tol, f"group norm {what} {dtype}: {name} max|d| {err} "
              f"> {tol}")
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    layout = (" channels_last" if channels_last else "") + (
        " conv bias" if cb else "")
    print(f"{what}{layout} {tuple(shape)} G={groups} {str(dtype)[6:]}: max|d| "
          f"(tolerance) {', '.join(report)} (gradients less the room of "
          f"{int(edge.sum())} values at the ReLU's edge); second run bit for "
          f"bit: {same}", flush=True)
    check(same, f"group norm {what} {dtype}: two runs differ")


def _gn_tag(batch: int, c: int, side: int) -> str:
    return f" b{batch} {c}@{side}^2"


def _gn_time_cases(batch: int, backward: bool) -> dict:
    """bf16 kernel / plain chain / library chain (bf16 GroupNorm and ReLU,
    a yardstick the port never calls) at celeba128's norm shapes, b=batch,
    each without a conv bias and with one folded in (``_cb``: the plain and
    library chains add it first, and their backward also gives its
    gradient): name -> (kernel, plain, library, bound), as _time_cases
    takes them."""
    cases = {}
    for c, side in GN_BLOCKS:
        shape = (batch, c, side, side)
        x, w, b, g = group_norm_inputs(shape, torch.bfloat16, c)
        cb = _gn_conv_bias(c, torch.bfloat16, c + 1)
        numel, tag = x.numel(), _gn_tag(batch, c, side)
        stats = batch * GN_GROUPS * 8 + c * 8
        for fold in ((), (cb,)):
            _, mean, rstd = gnc.group_norm_relu_fwd_cuda(x, w, b, GN_GROUPS,
                                                         GN_EPS, *fold)
            xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
            xl = x.clone().requires_grad_(True)
            wl, bl = (t.to(torch.bfloat16).requires_grad_(True)
                      for t in (w, b))
            cr = tuple(t.clone().requires_grad_(True) for t in fold)

            def added(x, cr=cr):
                return x + cr[0][:, None, None] if cr else x
            cut = "_cb" if fold else ""
            # the fold reads the bias (bytes) and adds it (operations)
            bias_bytes, bias_ops = (2 * c, numel) if fold else (0, 0)
            cases[f"gn_relu_fwd{cut}{tag}"] = (
                lambda x=x, w=w, b=b, f=fold: gnc.group_norm_relu_fwd_cuda(
                    x, w, b, GN_GROUPS, GN_EPS, *f),
                lambda x=x, w=w, b=b, f=fold: plain_gn_relu(
                    x, GN_GROUPS, w, b, GN_EPS, *f),
                lambda x=x, w=wl, b=bl, a=added: F.relu(F.group_norm(
                    a(x), GN_GROUPS, w, b, GN_EPS)),
                _bound(4 * numel + stats + bias_bytes, 8 * numel + bias_ops))
            if backward:
                y = plain_gn_relu(added(xr), GN_GROUPS, wr, br, GN_EPS)
                yl = F.relu(F.group_norm(added(xl), GN_GROUPS, wl, bl,
                                         GN_EPS))
                # with the fold a third (n, c) partial is written and read
                cases[f"gn_relu_bwd{cut}{tag}"] = (
                    lambda x=x, w=w, b=b, g=g, m=mean, r=rstd, f=fold:
                        gnc.group_norm_relu_bwd_cuda(g, x, m, r, w, b,
                                                     GN_GROUPS, *f),
                    lambda y=y, t=(xr, wr, br, *cr), g=g: torch.autograd.grad(
                        y, t, g, retain_graph=True),
                    lambda y=yl, t=(xl, wl, bl, *cr), g=g:
                        torch.autograd.grad(y, t, g, retain_graph=True),
                    _bound(6 * numel + stats + bias_bytes
                           + 2 * batch * c * (12 if fold else 8),
                           12 * numel + bias_ops))
    return cases


def _gn_bias_pass_ms(batch: int, c: int, side: int,
                     channels_last: bool) -> tuple[float, float]:
    """bf16 at one block's shape: the two passes the fold takes out, in ms:
    the conv's bias add in place, as PyTorch runs it after a cuDNN conv,
    and the bias gradient's sum of dL/dz over N, H and W."""
    x, _, _, g = group_norm_inputs((batch, c, side, side), torch.bfloat16,
                                   c, channels_last=channels_last)
    cb = _gn_conv_bias(c, torch.bfloat16, c + 1)
    return (cuda_median_ms(lambda: x.add_(cb[:, None, None]), reps=20),
            cuda_median_ms(lambda: g.sum((0, 2, 3)), reps=20))


def _gn_fold_line(batch: int, folded: float, unfolded: float,
                  bias_ms: dict, what: str, card: str) -> None:
    """A paper-width step's blocks, forward and backward: the kernels with
    the fold against the kernels without it plus the add and the sum it
    takes out (``bias_ms``: (c, side) -> (add, sum) ms, a block)."""
    adds = sum(k * bias_ms[cs][0] for cs, k in GN_BLOCKS.items())
    sums = sum(k * bias_ms[cs][1] for cs, k in GN_BLOCKS.items())
    print(f"a paper-width b{batch} step's {sum(GN_BLOCKS.values())} blocks "
          f"({what}), forward and backward: folded kernels {folded:.3f} ms "
          f"against kernels {unfolded:.3f} ms + bias add {adds:.3f} ms + "
          f"bias sum {sums:.3f} ms = {unfolded + adds + sums:.3f} ms  "
          f"[{card}]", flush=True)


def group_norm_phase(card: str) -> None:
    """The GroupNorm + ReLU kernels: correctness and determinism of the
    NCHW pair, without a conv bias and with one folded in, at every norm
    shape of celeba128's paper-width train (b128) and label (b256) cells
    and at pose256's, transporter_atari's and the general path's; a
    paper-width train step's launches (wrappers, then its replays by the
    profiler: the NHWC pair, the nets being channels_last, every block's
    conv bias folded; no aten GroupNorm kernel left); the NCHW pair's
    times, folded and not, beside the bias add and sum the fold takes
    out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    phase(f"39 group norm + ReLU kernels on {card}")
    for dtype in (torch.bfloat16, torch.float32):
        for conv_bias in (False, True):
            for batch in (TRAIN_BATCH, GN_LABEL_BATCH):
                for c, side in GN_BLOCKS:
                    _gn_check(f"celeba128 b{batch}", (batch, c, side, side),
                              GN_GROUPS, dtype, c + batch,
                              conv_bias=conv_bias)
            for what, shape, groups, unaligned in GN_OTHER:
                _gn_check(what, shape, groups, dtype, 7, unaligned,
                          conv_bias=conv_bias)
            torch.cuda.empty_cache()

    cfg = get_config("celeba128").override(
        **GN_PAPER, **{"train.batch_size": TRAIN_BATCH})
    images = torch.from_numpy(random_images(TRAIN_BATCH, cfg, 4)).cuda()
    state = init_state(cfg, "cuda")
    step = make_train_step(cfg, loss=make_loss(cfg))
    state, _ = step(state, images)
    torch.cuda.synchronize()
    gnc.launches = gnc.bwd_launches = 0
    gnc.nhwc_launches = gnc.nhwc_bwd_launches = gnc.bias_folds = 0
    state, _ = step(state, images)
    torch.cuda.synchronize()
    eager = (gnc.nhwc_launches, gnc.nhwc_bwd_launches)
    blocks = sum(GN_BLOCKS.values())
    print(f"paper-width celeba128 b{TRAIN_BATCH}, an eager step "
          f"(channels_last): {eager[0]} forward and {eager[1]} backward "
          f"launches of the NHWC pair by the wrappers, "
          f"{gnc.launches + gnc.bwd_launches} of the NCHW one, "
          f"{gnc.bias_folds} forward launches with a conv bias folded in "
          f"({blocks} blocks)", flush=True)
    check(eager == (blocks, blocks) and gnc.launches + gnc.bwd_launches == 0,
          f"group norm launches a step {eager}, {blocks} each expected")
    check(gnc.bias_folds == blocks,
          f"{gnc.bias_folds} folded conv biases a step, {blocks} expected")
    state = init_state(cfg, "cuda")
    step = make_graphed_train_step(cfg, state, loss=make_loss(cfg))
    for _ in range(4):
        state, _ = step(state, images)
    torch.cuda.synchronize()
    replays = 2
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PROFILE_EDGE_CYCLES)
        for _ in range(replays):
            state, _ = step(state, images)
        torch.cuda._sleep(PROFILE_EDGE_CYCLES)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    fns = [_kernel_name(n) for n in names]
    counts = {k: fns.count(k) / replays for k in (
        "gn_relu_fwd_held", "gn_relu_fwd", "gn_relu_bwd", "gn_relu_fwd_nhwc",
        "gn_relu_bwd_nhwc", "gn_relu_bwd_params")}
    aten = sorted({n[:80] for n in names if "GroupNorm" in n or any(
        k in n for k in ("RowwiseMoments", "ComputeInternalGradients",
                         "ComputeFusedParams", "GammaBeta"))})
    print(f"a replayed step's group norm kernels (profiler): {counts}; aten "
          f"GroupNorm kernels left: {aten or 'none'}", flush=True)
    check(counts["gn_relu_fwd_nhwc"] == blocks
          and counts["gn_relu_bwd_nhwc"] == counts["gn_relu_bwd_params"]
          == blocks, f"a replayed step launched {counts}")
    check(not aten, f"aten GroupNorm kernels in a replayed step: {aten}")
    del state, step, images
    torch.cuda.empty_cache()

    times = {}
    for batch, backward in ((TRAIN_BATCH, True), (GN_LABEL_BATCH, False)):
        times.update(_time_cases(_gn_time_cases(batch, backward), card,
                                 reps=20, plain_reps=5))
        torch.cuda.empty_cache()
    for cut, what in (("", "norms"), ("_cb", "norms, conv bias folded")):
        totals = {key: sum(k * times[f"gn_relu_{way}{cut}"
                                     + _gn_tag(TRAIN_BATCH, c, side)][key]
                           for (c, side), k in GN_BLOCKS.items()
                           for way in ("fwd", "bwd"))
                  for key in ("ms", "bound_ms", "plain_ms", "library_ms")}
        print(f"a paper-width b{TRAIN_BATCH} step's {blocks} {what}, forward "
              f"and backward: kernels {totals['ms']:.3f} ms, bound "
              f"{totals['bound_ms']:.3f} ms "
              f"({totals['bound_ms'] / totals['ms']:.1%}), plain chain "
              f"{totals['plain_ms']:.3f} ms, library bf16 chain "
              f"{totals['library_ms']:.3f} ms  [{card}]", flush=True)
        times[f"step{cut}"] = totals["ms"]
    bias_ms = {(c, side): _gn_bias_pass_ms(TRAIN_BATCH, c, side, False)
               for c, side in GN_BLOCKS}
    _gn_fold_line(TRAIN_BATCH, times["step_cb"], times["step"], bias_ms,
                  "the NCHW pair", card)


# phase 40: the NHWC pair and the channels_last nets; the shapes timed
# beyond celeba128's, (what, (N, C, H, W)), forward and backward
GN_NHWC_TIMED = [("pose256 b128", (128, 32, 256, 256)),
                 ("transporter_atari b64", (64, 32, 64, 64))]
TRANSPOSES = ("nchwToNhwc", "nhwcToNchw")


@contextlib.contextmanager
def nchw_nets():
    """The nets as they ran before channels_last: NCHW activations on CUDA,
    so the NCHW GroupNorm pair and cuDNN's transposes (the A/B's other
    side)."""
    saved = nets.memory_format, autoencoder.memory_format
    nets.memory_format = autoencoder.memory_format = \
        lambda x: torch.preserve_format
    try:
        yield
    finally:
        nets.memory_format, autoencoder.memory_format = saved


def _gn_nhwc_time(what: str, shape, backward: bool, card: str) -> dict:
    """bf16 at one shape: the NHWC pair, its bound, the NCHW pair on the
    same values in NCHW, the library's bf16 chain on the channels_last
    input; forward, and backward where asked; each also with a conv bias
    folded in (``fwd_cb``, ``bwd_cb``: the library chain adds it first),
    and the bias add and sum the fold takes out (``bias``). → {"fwd":
    {...}, "bwd": {...}, "fwd_cb": ..., "bias": {"add_ms", "sum_ms"}} in
    ms."""
    x, w, b, g = group_norm_inputs(shape, torch.bfloat16, shape[1],
                            channels_last=True)
    cb = _gn_conv_bias(shape[1], torch.bfloat16, shape[1] + 1)
    xn, gn = x.contiguous(), g.contiguous()
    numel, batch, c = x.numel(), shape[0], shape[1]
    stats = batch * GN_GROUPS * 8 + c * 8
    ways = {}
    for fold in ((), (cb,)):
        cut = "_cb" if fold else ""
        bias_bytes, bias_ops = (2 * c, numel) if fold else (0, 0)
        _, mean, rstd = gnc.group_norm_relu_fwd_cuda(x, w, b, GN_GROUPS,
                                                     GN_EPS, *fold)
        xl = x.clone().requires_grad_(True)
        wl, bl = (t.to(torch.bfloat16).requires_grad_(True) for t in (w, b))
        cl = tuple(t.clone().requires_grad_(True) for t in fold)

        def added(x, cl=cl):
            return x + cl[0][:, None, None] if cl else x
        ways["fwd" + cut] = (
            lambda f=fold: gnc.group_norm_relu_fwd_cuda(x, w, b, GN_GROUPS,
                                                        GN_EPS, *f),
            lambda f=fold: gnc.group_norm_relu_fwd_cuda(xn, w, b, GN_GROUPS,
                                                        GN_EPS, *f),
            lambda wl=wl, bl=bl, a=added: F.relu(F.group_norm(
                a(x), GN_GROUPS, wl, bl, GN_EPS)),
            _bound(4 * numel + stats + bias_bytes, 8 * numel + bias_ops)[0])
        if backward:
            yl = F.relu(F.group_norm(added(xl), GN_GROUPS, wl, bl, GN_EPS))
            ways["bwd" + cut] = (
                lambda f=fold, m=mean, r=rstd: gnc.group_norm_relu_bwd_cuda(
                    g, x, m, r, w, b, GN_GROUPS, *f),
                lambda f=fold, m=mean, r=rstd: gnc.group_norm_relu_bwd_cuda(
                    gn, xn, m, r, w, b, GN_GROUPS, *f),
                lambda yl=yl, t=(xl, wl, bl, *cl): torch.autograd.grad(
                    yl, t, g, retain_graph=True),
                _bound(6 * numel + stats + bias_bytes
                       + 2 * batch * c * (12 if fold else 8),
                       12 * numel + bias_ops)[0])
    out = {}
    for way, (nhwc, nchw, library, bound) in ways.items():
        t = {"nhwc_ms": cuda_median_ms(nhwc, reps=20),
             "nchw_ms": cuda_median_ms(nchw, reps=20),
             "library_ms": cuda_median_ms(library, reps=20),
             "bound_ms": bound}
        t["nhwc_again_ms"] = cuda_median_ms(nhwc, reps=20)
        out[way] = t
        print(f"gn_relu_{way}_nhwc {what} {c}@{shape[2]}x{shape[3]}: "
              f"{t['nhwc_ms'] * 1e3:.2f} us (again "
              f"{t['nhwc_again_ms'] * 1e3:.2f}), bound "
              f"{bound * 1e3:.2f} us ({bound / t['nhwc_ms']:.1%}); NCHW "
              f"pair {t['nchw_ms'] * 1e3:.2f} us; library bf16 chain "
              f"(channels_last) {t['library_ms'] * 1e3:.2f} us  [{card}]",
              flush=True)
    out["bias"] = {
        "add_ms": cuda_median_ms(lambda: x.add_(cb[:, None, None]), reps=20),
        "sum_ms": cuda_median_ms(lambda: g.sum((0, 2, 3)), reps=20)}
    for way in ("fwd", "bwd")[:1 + backward]:
        pass_ms = out["bias"]["add_ms" if way == "fwd" else "sum_ms"]
        print(f"gn_relu_{way}_nhwc {what} {c}@{shape[2]}x{shape[3]}: folded "
              f"{out[way + '_cb']['nhwc_ms'] * 1e3:.2f} us against "
              f"{out[way]['nhwc_ms'] * 1e3:.2f} us + the bias "
              f"{'add' if way == 'fwd' else 'sum'} {pass_ms * 1e3:.2f} us = "
              f"{(out[way]['nhwc_ms'] + pass_ms) * 1e3:.2f} us  [{card}]",
              flush=True)
    return out


def _transposes_by_conv(prof) -> tuple[dict, int]:
    """cuDNN's layout transposes in a profiled eager step, by the conv op
    that launched them: → ({(op, its 4-D input shapes): count}, transposes
    under no conv op)."""
    by_conv, loose = {}, 0
    for e in prof.events():
        kernels = [k.name for k in getattr(e, "kernels", [])]
        n = sum(any(t in k for t in TRANSPOSES) for k in kernels)
        if not n:
            continue
        op = e
        while op is not None and "conv" not in op.name:
            op = op.cpu_parent
        if op is None:
            loose += n
            continue
        key = (op.name, tuple(tuple(s) for s in op.input_shapes
                              if len(s) == 4))
        by_conv[key] = by_conv.get(key, 0) + n
    return by_conv, loose


def _at_boundary(shapes) -> bool:
    """Whether a conv of these shapes is at a net's edge: the 3 image
    channels in or out, or Psi's 10 heatmaps out (an activation's or a
    weight's first two dims)."""
    return any(d in (3, 10) for s in shapes for d in s[:2])


def _paper_step(dtype: str, graphed: bool, preset: str = "celeba128"):
    """A b128 train step on the card, warmed (and captured where
    ``graphed``): → run(), one step. celeba128 at its paper widths, pose256
    as its preset has it."""
    over = GN_PAPER if preset == "celeba128" else {}
    cfg = get_config(preset).override(
        **over, **{"train.batch_size": TRAIN_BATCH,
                   "train.compute_dtype": dtype})
    images = torch.from_numpy(random_images(TRAIN_BATCH, cfg, 4)).cuda()
    state = init_state(cfg, "cuda")
    step = (make_graphed_train_step(cfg, state, loss=make_loss(cfg))
            if graphed else make_train_step(cfg, loss=make_loss(cfg)))
    for _ in range(3):
        step(state, images)
    torch.cuda.synchronize()
    return lambda: step(state, images)


def group_norm_nhwc_phase(card: str) -> None:
    """The NHWC GroupNorm + ReLU pair and the channels_last nets: the pair
    against plain at every phase-39 shape in bf16 and f32, without a conv
    bias and with one folded in, twice bit for bit; its times, folded and
    not, against its bound, the NCHW pair and the library's bf16 chain,
    and beside the bias add and sum the fold takes out (at celeba128's
    shapes and pose256's read-twice 32@256^2); cuDNN's layout transposes
    left in a paper-width celeba128
    step (by conv, from an eager step's profile; a graphed replay's total);
    the step channels_last against NCHW in turns, graphed bf16 and eager
    f32 (the f32 rule of ``nets.memory_format``), and pose256's graphed
    bf16 step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    phase(f"40 NHWC group norm + ReLU and channels_last nets on {card}")
    for dtype in (torch.bfloat16, torch.float32):
        for conv_bias in (False, True):
            for batch in (TRAIN_BATCH, GN_LABEL_BATCH):
                for c, side in GN_BLOCKS:
                    _gn_check(f"celeba128 b{batch}", (batch, c, side, side),
                              GN_GROUPS, dtype, c + batch,
                              channels_last=True, conv_bias=conv_bias)
            for what, shape, groups, unaligned in GN_OTHER:
                _gn_check(what, shape, groups, dtype, 7, unaligned,
                          channels_last=True, conv_bias=conv_bias)
            torch.cuda.empty_cache()

    times = {}
    for c, side in GN_BLOCKS:
        times[(c, side)] = _gn_nhwc_time(
            f"celeba128 b{TRAIN_BATCH}", (TRAIN_BATCH, c, side, side), True,
            card)
        _gn_nhwc_time(f"celeba128 b{GN_LABEL_BATCH}",
                      (GN_LABEL_BATCH, c, side, side), False, card)
        torch.cuda.empty_cache()
    for what, shape in GN_NHWC_TIMED:
        _gn_nhwc_time(what, shape, True, card)
        torch.cuda.empty_cache()
    blocks = sum(GN_BLOCKS.values())
    for cut in ("", "_cb"):
        for key in ("nhwc_ms", "nchw_ms", "bound_ms", "library_ms"):
            total = sum(k * (times[cs]["fwd" + cut][key]
                             + times[cs]["bwd" + cut][key])
                        for cs, k in GN_BLOCKS.items())
            print(f"a paper-width b{TRAIN_BATCH} step's {blocks} norms"
                  f"{', conv bias folded' if cut else ''}, forward and "
                  f"backward, {key[:-3]}: {total:.3f} ms  [{card}]",
                  flush=True)
    _gn_fold_line(
        TRAIN_BATCH,
        *(sum(k * (times[cs]["fwd" + cut]["nhwc_ms"]
                   + times[cs]["bwd" + cut]["nhwc_ms"])
              for cs, k in GN_BLOCKS.items()) for cut in ("_cb", "")),
        {cs: (times[cs]["bias"]["add_ms"], times[cs]["bias"]["sum_ms"])
         for cs in GN_BLOCKS}, "the NHWC pair", card)
    for cs in GN_BLOCKS:
        for way in ("fwd", "bwd", "fwd_cb", "bwd_cb"):
            t = times[cs][way]
            verdict = "no slower" if t["nhwc_ms"] <= t["nchw_ms"] else "SLOWER"
            print(f"{way} {cs[0]}@{cs[1]}^2: NHWC {t['nhwc_ms'] * 1e3:.2f} "
                  f"us against NCHW {t['nchw_ms'] * 1e3:.2f} us: {verdict}",
                  flush=True)

    # the transposes of an eager step, by conv, and of a graphed replay
    run = _paper_step("bfloat16", graphed=False)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    by_conv, loose = _transposes_by_conv(prof)
    on_card = sum(any(t in e.name for t in TRANSPOSES) for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    print(f"an eager paper-width step's layout transposes: {on_card} on "
          f"the card, {sum(by_conv.values())} under a conv op, {loose} under "
          f"none; by conv (op, 4-D input shapes): {by_conv}", flush=True)
    attributed = sum(by_conv.values()) + loose
    inside = {k: n for k, n in by_conv.items() if not _at_boundary(k[1])}
    print(f"... between two blocks of Phi, Psi or the decoder: "
          f"{sum(inside.values())}", flush=True)
    del run
    run = _paper_step("bfloat16", graphed=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PROFILE_EDGE_CYCLES)
        run()
        torch.cuda._sleep(PROFILE_EDGE_CYCLES)
        torch.cuda.synchronize()
    replay = sum(any(t in e.name for t in TRANSPOSES) for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    print(f"a graphed replay's layout transposes: {replay}", flush=True)
    del run
    torch.cuda.empty_cache()

    # the step both ways, in turns on one card; pose256's blocks at 256^2
    # take the NHWC pair's read-twice path
    for preset, dtype, graphed, steps in (
            ("celeba128", "bfloat16", True, 30),
            ("celeba128", "float32", False, 20),
            ("pose256", "bfloat16", True, 10)):
        ms = {"channels_last": [], "nchw": []}
        for side in ("channels_last", "nchw", "nchw", "channels_last",
                     "channels_last", "nchw"):
            with (nchw_nets() if side == "nchw" else contextlib.nullcontext()):
                run = _paper_step(dtype, graphed, preset)
                ms[side].append(_step_ms(run, steps)[0])
                del run
                torch.cuda.empty_cache()
        print(f"{preset} b{TRAIN_BATCH} {dtype} "
              f"{'graphed' if graphed else 'eager'} step, ms in turns: "
              f"channels_last {ms['channels_last']}, NCHW {ms['nchw']}  "
              f"[{card}]", flush=True)
    check(attributed == on_card,
          f"transposes attributed {attributed} of {on_card}")
    check(not inside, f"layout transposes between blocks: {inside}")


def main() -> int:
    card = device_phase()
    build_phase()
    softmax_err = kernel_phase()
    errs = training_kernels_phase()
    errs["spatial_softmax_fwd"] = softmax_err
    parity_phase()
    with tempfile.TemporaryDirectory() as tmp:
        served = serve_phase(tmp)
        train_parity_phase(7, TRAIN_REFERENCE, tmp)
    train_counts, trainer = train_phase(8, "celeba128", TRAIN_STEPS)
    times = kernel_times_phase(card, trainer)
    softmax_and_extract_times(card)
    step_ms = train_step_times(card, trainer)
    print(f"http n=1 latency p50 {served['http_p50_ms']:.3f} ms "
          f"(30 requests, host clock)  [{card}]", flush=True)
    profile_phase(card, trainer, step_ms)
    del trainer
    torch.cuda.empty_cache()

    for name, err in pose_kernels_phase().items():
        errs[name] = max(errs.get(name, 0.0), err)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train_parity_phase(12, POSE_REFERENCE, tmp)
    pose_counts, pose_trainer = train_phase(13, "pose256", POSE_STEPS)
    times.update(pose_times_phase(card))
    pose_ms = train_step_times(card, pose_trainer, steps=10)
    pose_profile_phase(card, pose_trainer, pose_ms)
    del pose_trainer
    torch.cuda.empty_cache()

    errs.update(fused_kernel_phase())
    transporter_parity_phase()
    path_counts = [train_counts, pose_counts]
    trainers = {}
    for variant in ("joint", "marginal"):
        counts, trainers[variant] = transporter_train_phase(
            variant, TRANSPORTER_STEPS)
        path_counts.append(counts)
    times.update(transporter_times_phase(card, trainers))
    del trainers
    torch.cuda.empty_cache()

    banded_errs, banded_counts = banded_kernels_phase()
    errs.update(banded_errs)
    path_counts.append(banded_counts)
    times.update(banded_times_phase(card))
    with tempfile.TemporaryDirectory() as tmp:
        path_counts.extend(eval_phase(card, tmp))
    torch.cuda.empty_cache()
    wide_kernels_phase(card)
    path_counts.extend(wide_train_phase(card))
    path_counts.extend(route_phase(card))
    path_counts.extend(bottleneck_route_phase(card))
    with tempfile.TemporaryDirectory() as tmp:
        ckdir = train_cli_phase(card, tmp)
        path_counts.extend(train_loop_phase(card, tmp))
        path_counts.extend(store_eval_phase(card, tmp, ckdir))
    path_counts.extend(dp_step_phase(card))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dp_cli_phase(card, tmp)
        path_counts.extend(dp_serve_phase(card, tmp))
    with tempfile.TemporaryDirectory() as tmp:
        counts, paths = export_phase(card, tmp)
        path_counts.extend(counts)
        artifact_cli_phase(card, tmp, paths, served["http_p50_ms"])
        tools_phase(card, tmp, paths["bundle"])
    path_counts.extend(graph_step_phase(card))
    torch.cuda.empty_cache()
    path_counts.extend(dp_graph_phase(card))
    path_counts.extend(serving_graphs_phase(card, paths["bundle"]))
    group_norm_phase(card)
    group_norm_nhwc_phase(card)

    errs["spatial_softmax_fwd"] = max(errs["spatial_softmax_fwd"],
                                      served["serve_max_abs_err"])
    launches = {name: sum(counts[name] for counts in path_counts)
                for name in KERNELS}
    launches["spatial_softmax_fwd"] += served["launches"]
    for name, count in launches.items():
        check(count > 0, f"{name} was launched no time on the paths")
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"keypoints_tpu_torch/csrc/{source}",
        "replaces": f"keypoints_tpu/kernels/{replaces}",
        "launches": launches[name], "max_abs_err": errs[name],
        **times[name]} for name, (_, _, source, replaces, _)
        in KERNELS.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
