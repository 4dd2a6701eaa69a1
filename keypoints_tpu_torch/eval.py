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
* :func:`eval_batch_for` (``:203``): the synthetic sets, and a dataset
  with no store on disk or a store whose sidecar names the synthetic
  origin, go to the generator, as in JAX. Eval from a stored dataset
  (``store_eval_batch``, which needs ``records.FrameStore`` and
  ``train.scoring_holdout``) raises ``NotImplementedError``: it comes with
  the train-loop and data slice (ROADMAP A.4).
* :func:`coordinate_parity` (``:259``).
* ``python -m keypoints_tpu_torch.eval`` (``_cli``, ``:272``): flags
  ``--preset --checkpoint --override --batch --json --device --seed``.
  ``--checkpoint`` is a ``torch.save``d state dict, the file the port's
  ``serve`` loads; the record has JAX's keys, with ``step`` null (a state
  dict has no step).

Not yet ported: ``--artifact`` (scoring an exported extractor) waits for
the export slice (ROADMAP A.8); ``--overlay`` waits for the tools slice
(A.9); ``--landmarks`` (ground truth for stored footage) for the data slice
(A.4).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from keypoints_tpu_torch.checkpoint import load_checkpoint, load_model_state
from keypoints_tpu_torch.configs import Config, apply_overrides, get_config
from keypoints_tpu_torch.losses import l2_loss
from keypoints_tpu_torch.training import (KeypointModel, build_model,
                                          make_extract_fn, warp_config)


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


def _store_origin(store: str) -> Optional[str]:
    """The ``origin`` of a store's provenance sidecar (``{store}_meta.json``,
    ``keypoints_tpu/data/records.py:45``), None without one."""
    path = store[:-len(".npy")] + "_meta.json"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("origin")


def eval_batch_for(cfg: Config, batch: int, generator: torch.Generator
                   ) -> tuple[torch.Tensor, torch.Tensor,
                              Optional[np.ndarray], dict]:
    """The eval set for ``cfg``: → (src, tgt, true_positions, info), with
    ``info`` the holdout and ground-truth record ``{"source", "held_out",
    "rows", "requested_rows", "gt"}``.

    The synthetic datasets, a dataset whose store
    (``{data_dir}/{dataset}_{image_size}.npy``) is not on disk, and a store
    whose sidecar names this dataset's synthetic origin take the generator
    (exact ground truth; a fresh draw is held-out data), as in JAX. Any
    other store raises ``NotImplementedError``: store-backed eval comes with
    the train-loop and data slice (ROADMAP A.4).
    """
    d = cfg.data

    def synth():
        src, tgt, pos = synthetic_eval_batch(cfg, batch, generator)
        return src, tgt, pos, {"source": "synthetic", "held_out": True,
                               "rows": int(len(src)),
                               "requested_rows": int(batch),
                               "gt": "generator"}

    if d.dataset in ("synthetic_dots", "synthetic_pong"):
        return synth()
    store = os.path.join(d.data_dir, f"{d.dataset}_{d.image_size}.npy")
    if not os.path.exists(store):
        return synth()                               # trainer-synthesized
    if (d.dataset in _SYNTHETIC_ORIGIN_FOR
            and _store_origin(store) == _SYNTHETIC_ORIGIN_FOR[d.dataset]):
        return synth()
    raise NotImplementedError(
        f"eval from the stored dataset {store} is not ported yet: it needs "
        f"records.FrameStore and train.scoring_holdout (ROADMAP A.4); point "
        f"data.data_dir elsewhere to score the synthetic set")


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
                   help=".pt state dict (torch.save; the file "
                        "keypoints_tpu_torch.serve loads)")
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument("--batch", type=int, default=64)
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
    """Run the CLI on ``argv``; → the result record."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available to "
                         f"this torch ({torch.__version__}); pass --device "
                         f"cpu to evaluate on the CPU")
    cfg = apply_overrides(get_config(args.preset), args.override)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    src, tgt, pos, info = eval_batch_for(cfg, args.batch, generator)
    model = build_model(cfg, device)
    load_model_state(model, load_checkpoint(args.checkpoint))
    print(f"loaded params from {args.checkpoint}", flush=True)
    # score with the training objective (perceptual presets: VGG loss)
    from keypoints_tpu_torch.train import make_loss
    metrics = evaluate(model, src, tgt, true_positions=pos,
                       loss=make_loss(cfg, device))
    for k, v in metrics.items():
        print(f"{k}: {v:.5f}")
    result = {"preset": args.preset, "step": None, "metrics": metrics,
              **info}
    print("result:", json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"result written to {args.json}")
    return result


if __name__ == "__main__":
    main()
