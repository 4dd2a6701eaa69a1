"""Evaluation on a fixed set — port of ``keypoints_tpu/eval.py``.

The eval pass is also the parity set: a fixed batch, a forward pass with
float32 matmuls and convolutions (TF32 off, the counterpart of JAX's
``default_matmul_precision('float32')``), reporting the reconstruction loss
of the training objective, the keypoints' spread and, where ground truth
exists (the synthetic sets), how close each true landmark's nearest
keypoint lies (locking, PCK).

* :func:`evaluate` (``eval.py:23``) takes the model; :func:`eval_forward`
  is its forward pass, (loss, keypoints) on the device.
* :func:`keypoint_metrics` (``:41``): numpy, a copy.
* :func:`synthetic_eval_batch` (``:67``): pose, scripted Pong, faces and
  moving dots; the renderers' numpy seed is drawn from a
  ``torch.Generator`` where JAX draws it from its key.
* :func:`store_eval_batch` (``:132``): the held-out tail of a stored
  dataset (``train.scoring_holdout``), the batch clamped to it; temporal
  mode takes the stored pairs, warp mode makes one pair on the generator,
  carrying ``--landmarks`` into the target where they are given.
* :func:`eval_batch_for` (``:203``): the synthetic sets, and a dataset
  with no store on disk or a store whose sidecar names the synthetic
  origin, go to the generator; any other store (real footage, or a store
  without a sidecar such as the committed ``data/atari_64.npy``) to
  :func:`store_eval_batch`, as in JAX.
* :func:`coordinate_parity` (``:259``).
* ``python -m keypoints_tpu_torch.eval`` (``_cli``, ``:272``): flags
  ``--preset --checkpoint --override --batch --landmarks --json --device
  --seed``. ``--checkpoint`` is a trainer directory (its newest step; the
  record's ``step``) or a ``torch.save``d state dict, the file the port's
  ``serve`` loads (``step`` null); the record has JAX's keys.

Not yet ported: ``--artifact`` (scoring an exported extractor) waits for
the export slice (ROADMAP A.4); ``--overlay`` waits for the tools slice
(A.5).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from keypoints_tpu_torch.checkpoint import (CheckpointManager,
                                            load_checkpoint, load_model_state)
from keypoints_tpu_torch.configs import Config, apply_overrides, get_config
from keypoints_tpu_torch.data.records import (FrameStore, store_path_for,
                                              tail_pair_frames)
from keypoints_tpu_torch.losses import l2_loss
from keypoints_tpu_torch.parallel import multihost
from keypoints_tpu_torch.training import (KeypointModel, build_model,
                                          make_extract_fn, require_device,
                                          warp_config)


@contextlib.contextmanager
def float32_precision():
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block,
    the flags restored after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def eval_forward(model: KeypointModel, src: torch.Tensor, tgt: torch.Tensor,
                 loss: Optional[Callable] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The eval forward pass: (reconstruction loss, target keypoints (B, K,
    2)) on the model's device, with float32 precision and no gradient."""
    recon_loss = loss or l2_loss
    with float32_precision(), torch.no_grad():
        recon, kp = model(src, tgt)
        return recon_loss(recon, tgt), kp


def evaluate(model: KeypointModel, src: torch.Tensor, tgt: torch.Tensor,
             true_positions: Optional[np.ndarray] = None,
             loss: Optional[Callable] = None) -> dict[str, float]:
    """``eval_loss`` (``loss``, L2 by default) and :func:`keypoint_metrics`
    of ``model`` on the (source, target) pair."""
    value, kp = eval_forward(model, src, tgt, loss)
    return {"eval_loss": float(value),
            **keypoint_metrics(kp.cpu().numpy(), true_positions)}


def keypoint_metrics(kp: np.ndarray,
                     true_positions: Optional[np.ndarray] = None
                     ) -> dict[str, float]:
    """Geometry-only metrics on extracted keypoints ``(B, K, 2)``."""
    out = {
        # spread: mean pairwise keypoint distance — collapse indicator
        "keypoint_spread": float(np.mean(np.linalg.norm(
            kp[:, :, None] - kp[:, None], axis=-1))),
        "keypoint_in_bounds": float(np.mean(np.abs(kp) <= 1.0)),
    }
    if true_positions is not None:
        d = np.linalg.norm(
            np.asarray(true_positions)[:, :, None] - kp[:, None], axis=-1)
        dm = d.min(axis=-1)        # each gt landmark → nearest predicted kp
        out["locking_median"] = float(np.median(dm))
        out["locking_mean"] = float(np.mean(dm))
        # PCK: the fraction of ground-truth landmarks with a keypoint within
        # t; coordinates span [-1, 1], so t = 0.1 is 5 % of the image side
        out["pck@0.1"] = float(np.mean(dm <= 0.1))
        out["pck@0.2"] = float(np.mean(dm <= 0.2))
    return out


def _numpy_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 1 << 30, (), generator=generator,
                             device=generator.device))


def synthetic_eval_batch(cfg: Config, batch: int, generator: torch.Generator
                         ) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """→ (src, tgt, true_positions): the preset's synthetic set with ground
    truth, drawn on ``generator`` and made on its device:

    * ``pose``: the stick figure, its 16 joints;
    * ``synthetic_pong``/``atari``: scripted Pong, (ball, paddle, paddle);
    * ``celeba``: the faces, (eye_l, eye_r, nose, mouth);
    * anything else: moving dots at the model's keypoint count.

    Warp-mode sets (faces, pose) are paired as the train step pairs them,
    with the landmarks carried through the target's warp
    (``augment.make_pair_with_positions``); below the coarse-field size, or
    in temporal mode, the pair is the frames twice.
    """
    d = cfg.data
    device = generator.device

    def warp_pair(frames: torch.Tensor, marks: np.ndarray):
        from keypoints_tpu_torch.data.augment import make_pair_with_positions
        wcfg = warp_config(cfg)
        if d.pair_mode != "warp" or not (
                wcfg.field_res and wcfg.field_res < d.image_size):
            return frames, frames, np.asarray(marks)
        src, tgt, marks_t = make_pair_with_positions(
            generator, frames, torch.as_tensor(marks, device=device), wcfg)
        return src, tgt, marks_t.cpu().numpy()

    if d.dataset == "pose":
        from keypoints_tpu_torch.data.pose import (_render_episode,
                                                   generate_episode,
                                                   joint_positions)
        segs = generate_episode(batch,
                                np.random.RandomState(_numpy_seed(generator)))
        return warp_pair(_render_episode(segs, d.image_size, device),
                         joint_positions(segs))
    if d.dataset in ("synthetic_pong", "atari"):
        from keypoints_tpu_torch.data.synthetic import scripted_pong_pair
        f1, f2, state = scripted_pong_pair(generator, batch, d.image_size)
        return f1, f2, state.cpu().numpy()
    if d.dataset == "celeba":
        from keypoints_tpu_torch.data.faces import render_faces
        imgs, marks = render_faces(
            batch, d.image_size, np.random.RandomState(_numpy_seed(generator)))
        return warp_pair(torch.from_numpy(imgs).to(device), marks)
    from keypoints_tpu_torch.data.synthetic import moving_dots_pair
    src, tgt, pos = moving_dots_pair(generator, batch, d.image_size,
                                     num_dots=cfg.model.num_keypoints,
                                     channels=d.channels, max_shift=0.8)
    return src, tgt, pos.cpu().numpy()


#: store origins whose frames come from this repository's own simulators:
#: for these the matching synthetic generator is the ground-truth source
_SYNTHETIC_ORIGIN_FOR = {"pose": "synthetic_pose",
                         "celeba": "synthetic_faces",
                         "atari": "scripted_pong"}


def store_eval_batch(cfg: Config, store: FrameStore, batch: int,
                     generator: torch.Generator,
                     landmarks: Optional[np.ndarray] = None):
    """→ (src, tgt, true_positions | None, info) from a frame store, on
    ``generator``'s device.

    The rows are the store tail that ``train.scoring_holdout`` reserved
    from training, the batch clamped to it so every scored row is held out;
    a store too small to reserve a tail falls back to trained rows, and
    ``info`` says so. Temporal mode takes the stored (frame_t,
    frame_{t+Δ}) pairs; warp mode makes one pair as training does, on
    ``generator``. ``landmarks`` is an optional (num_frames, K, 2) array of
    normalized (x, y) ground truth aligned with the store's frames; warp
    mode carries it into the target. ``info`` is ``{"source": "store",
    "held_out", "rows", "requested_rows", "gt": "landmarks" | None}``.
    """
    from keypoints_tpu_torch.train import scoring_holdout
    d = cfg.data
    temporal = d.pair_mode == "temporal" and store.pairs is not None
    n_items = len(store.pairs) if temporal else len(store.frames)
    holdout = scoring_holdout(cfg, n_items)
    if holdout:
        if batch > holdout:
            print(f"eval batch clamped {batch} -> {holdout}: only the "
                  f"reserved store tail is held out of training "
                  f"(train.scoring_holdout)", flush=True)
        take = min(batch, holdout)
    else:
        print(f"store too small to reserve a held-out tail "
              f"({n_items} items) — eval rows OVERLAP training data",
              flush=True)
        take = min(batch, n_items)
    info = {"source": "store", "held_out": bool(holdout),
            "rows": int(take), "requested_rows": int(batch),
            "gt": "landmarks" if landmarks is not None else None}
    if landmarks is not None and len(landmarks) != len(store.frames):
        raise ValueError(
            f"landmarks rows ({len(landmarks)}) must match store frames "
            f"({len(store.frames)})")
    device = generator.device
    src, tgt, idx = tail_pair_frames(store, d.pair_mode, take, device)
    marks = (None if landmarks is None
             else np.asarray(landmarks[idx], np.float32))
    wcfg = warp_config(cfg)
    if temporal or not (wcfg.field_res and wcfg.field_res < d.image_size):
        return src, tgt, marks, info
    from keypoints_tpu_torch.data.augment import (
        draw_pair, pair_from_draws, pair_with_positions_from_draws)
    frames = src
    draws = draw_pair(generator, tuple(frames.shape), wcfg, frames.dtype)
    if marks is None:
        src, tgt = pair_from_draws(frames, draws, wcfg)
        return src, tgt, None, info
    src, tgt, pos_t = pair_with_positions_from_draws(
        frames, torch.from_numpy(marks).to(device), draws, wcfg)
    return src, tgt, pos_t.cpu().numpy(), info


def eval_batch_for(cfg: Config, batch: int, generator: torch.Generator,
                   landmarks_path: Optional[str] = None
                   ) -> tuple[torch.Tensor, torch.Tensor,
                              Optional[np.ndarray], dict]:
    """The eval set for ``cfg``: → (src, tgt, true_positions | None, info),
    with ``info`` the holdout and ground-truth record ``{"source",
    "held_out", "rows", "requested_rows", "gt"}``.

    * the synthetic datasets, a dataset whose store
      (``{data_dir}/{dataset}_{image_size}.npy``) is not on disk, and a
      store whose sidecar names this dataset's synthetic origin → the
      generator (exact ground truth; a fresh draw is held-out data);
    * any other store (real footage, ingested frames, a store without a
      sidecar) → :func:`store_eval_batch`; locking and PCK only with
      ``landmarks_path``, a (num_frames, K, 2) ``.npy``.
    """
    d = cfg.data

    def synth():
        src, tgt, pos = synthetic_eval_batch(cfg, batch, generator)
        return src, tgt, pos, {"source": "synthetic", "held_out": True,
                               "rows": int(len(src)),
                               "requested_rows": int(batch),
                               "gt": "generator"}

    landmarks = None if landmarks_path is None else np.load(landmarks_path)
    if d.dataset in ("synthetic_dots", "synthetic_pong"):
        if landmarks is not None:
            raise SystemExit(f"--landmarks does not apply to the "
                             f"{d.dataset} generator (GT is built in)")
        return synth()
    sp = store_path_for(d)
    if not os.path.exists(sp):
        if landmarks is not None:
            raise SystemExit(f"--landmarks given but no store at {sp}")
        return synth()                               # trainer-synthesized
    store = FrameStore(sp)
    # both sides guarded: a dataset with no synthetic origin must not
    # match a store without a sidecar
    if (landmarks is None
            and d.dataset in _SYNTHETIC_ORIGIN_FOR
            and store.meta.get("origin") == _SYNTHETIC_ORIGIN_FOR[d.dataset]):
        return synth()
    if landmarks is None:
        print(f"store-backed eval ({sp}): no ground-truth landmarks — "
              f"locking/PCK skipped (pass --landmarks pos.npy with "
              f"(num_frames, K, 2) normalized coords to score them)",
              flush=True)
    return store_eval_batch(cfg, store, batch, generator, landmarks)


def coordinate_parity(model: KeypointModel, golden_fn: Callable,
                      images: np.ndarray) -> float:
    """Max keypoint L2 distance of ``model``'s extraction (float32
    precision) from a golden model's on a fixed set: the <1e-3 bar of
    ``docs/PARITY.md``."""
    device = next(model.parameters()).device
    with float32_precision():
        got = make_extract_fn(model)(torch.as_tensor(images, device=device))
    want = np.asarray(golden_fn(images))
    return float(np.linalg.norm(got.cpu().numpy() - want, axis=-1).max())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="evaluate a checkpoint on the preset's eval set (the "
                    "PyTorch port)")
    p.add_argument("--preset", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="trainer checkpoint directory (its newest step), or "
                        "a .pt state dict (torch.save; the file "
                        "keypoints_tpu_torch.serve loads)")
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--landmarks", default=None, metavar="POS_NPY",
                   help="ground-truth landmarks for store-backed datasets: "
                        "a (num_frames, K, 2) .npy of normalized (x, y) "
                        "aligned with store frame indices — enables "
                        "locking/PCK on real footage")
    p.add_argument("--json", default=None, metavar="OUT_JSON",
                   help="also write the result record here (it is always "
                        "printed as the final 'result: {...}' line)")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on; only an explicit "
                        "--device cpu runs on the CPU")
    p.add_argument("--seed", type=int, default=7,
                   help="seed of the eval set's draws")
    return p


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; → the result record. Under ``torchrun``
    every rank evaluates and rank 0 alone prints and writes."""
    args = build_parser().parse_args(argv)
    multihost.initialize("gloo" if torch.device(args.device).type == "cpu"
                         else None)
    primary = multihost.is_primary()
    device = require_device(args.device, "evaluate")
    cfg = apply_overrides(get_config(args.preset), args.override)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    src, tgt, pos, info = eval_batch_for(cfg, args.batch, generator,
                                         landmarks_path=args.landmarks)
    model = build_model(cfg, device)
    load_model_state(model, load_checkpoint(args.checkpoint))
    step = (CheckpointManager(args.checkpoint).latest_step()
            if os.path.isdir(args.checkpoint) else None)
    if primary:
        print(f"loaded params from {args.checkpoint}"
              f"{'' if step is None else f' (step {step})'}", flush=True)
    # score with the training objective (perceptual presets: VGG loss)
    from keypoints_tpu_torch.train import make_loss
    metrics = evaluate(model, src, tgt, true_positions=pos,
                       loss=make_loss(cfg, device))
    result = {"preset": args.preset, "step": step, "metrics": metrics,
              **info}
    if not primary:
        return result
    for k, v in metrics.items():
        print(f"{k}: {v:.5f}")
    print("result:", json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"result written to {args.json}")
    return result


if __name__ == "__main__":
    main()
