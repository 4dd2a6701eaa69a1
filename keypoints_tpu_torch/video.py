"""Keypoint-annotated video rendering — port of ``keypoints_tpu/video.py``.

Run a trained extractor over a frame sequence and write an annotated video:
"does the model track the ball / the face through the episode?" is answered
by watching it.

    python -m keypoints_tpu_torch.video --preset transporter_atari \
        --checkpoint checkpoints/transporter_atari --out tracked.mp4

    # from an exported extractor (python -m keypoints_tpu_torch.export)
    python -m keypoints_tpu_torch.video --preset transporter_atari \
        --artifact t.pt2 --store data/atari_64.npy --out t.mp4

Frames come from the preset's store (episode order: temporal stores are
written in rollout order), an explicit ``--store``, or an image folder
(``--folder``, decoded in memory). Extraction runs on the card
(``training.make_extract_fn``, or the artifact on its own device) at
``--batch`` frames a call; drawing happens on the host.
:func:`render_keypoint_video` is numpy and cv2, a copy of JAX's: where cv2
cannot open a writer it saves the overlay frames as an ``.npz`` beside the
requested path instead, as JAX does.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable

import numpy as np
import torch

from keypoints_tpu_torch.viz import overlay_keypoints


def render_keypoint_video(out_path: str, frames_u8: np.ndarray,
                          extract: Callable[[np.ndarray], np.ndarray],
                          fps: float = 30.0, batch: int = 256,
                          radius: int = 2) -> int:
    """Write an annotated video; returns the number of frames written.

    ``frames_u8``: (N, C, H, W) uint8. ``extract``: (n, C, H, W) float32
    [0,1] numpy → (n, K, 2) normalized keypoints (a live extract on the
    card, a ``BucketedExtract`` artifact, or a
    ``serve.BatchingExtractor.extract``). Writes .mp4 (mp4v) / .avi via cv2
    when importable, else an .npz of overlay frames next to ``out_path``.
    """
    n, _, h, w = frames_u8.shape
    writer, cv2 = None, None
    try:
        import cv2 as _cv2
        cv2 = _cv2
    except ImportError:
        pass

    written = 0
    overlays = []
    for i in range(0, n, batch):
        chunk = frames_u8[i:i + batch]
        imgs = chunk.astype(np.float32) / 255.0
        kp = np.asarray(extract(imgs))
        hwc = overlay_keypoints(imgs, kp, radius=radius)    # (b, H, W, 3) f32
        frames_rgb = (hwc * 255).astype(np.uint8)
        if cv2 is not None:
            if writer is None:
                fourcc = cv2.VideoWriter_fourcc(
                    *("mp4v" if out_path.endswith(".mp4") else "MJPG"))
                writer = cv2.VideoWriter(out_path, fourcc, fps, (w, h))
                if not writer.isOpened():
                    writer = None
                    cv2 = None                     # codec missing: the .npz
            if writer is not None:
                for f in frames_rgb:
                    writer.write(f[:, :, ::-1])    # RGB → BGR
                    written += 1
        if cv2 is None:
            overlays.append(frames_rgb)
            written += len(frames_rgb)
    if writer is not None:
        writer.release()
    elif overlays:
        alt = os.path.splitext(out_path)[0] + ".npz"
        np.savez_compressed(alt, frames=np.concatenate(overlays), fps=fps)
        print(f"cv2 video writer unavailable — wrote frame stack to {alt}")
    return written


def live_extract(cfg, state_dict: dict | None, device: torch.device
                 ) -> Callable[[np.ndarray], np.ndarray]:
    """``cfg``'s model on ``device`` (``state_dict`` as
    ``checkpoint.load_model_state`` takes it; None keeps the init of
    ``train.seed``), frozen for inference → fn(numpy float32 images) ->
    numpy keypoints, one upload and one read a call."""
    from keypoints_tpu_torch.checkpoint import load_model_state
    from keypoints_tpu_torch.training import (build_model,
                                              freeze_for_inference,
                                              make_extract_fn)
    model = build_model(cfg, device, seed=cfg.train.seed)
    if state_dict is not None:
        load_model_state(model, state_dict)
    extract = make_extract_fn(freeze_for_inference(model))
    return lambda imgs: extract(torch.from_numpy(imgs).to(device)
                                ).cpu().numpy()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="render a keypoint-annotated video from a trained model "
                    "(the PyTorch port)")
    p.add_argument("--preset", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="a .pt state dict or a trainer checkpoint directory "
                        "(its newest step); omit for random-init (smoke)")
    p.add_argument("--artifact", default=None,
                   help="exported extractor (python -m "
                        "keypoints_tpu_torch.export) -- no checkpoint or "
                        "model build needed; oversized frame batches split "
                        "across buckets")
    p.add_argument("--store", default=None,
                   help="frame store .npy (default: the preset's store)")
    p.add_argument("--folder", default=None,
                   help="image folder instead of a store")
    p.add_argument("--out", required=True, help=".mp4 or .avi path")
    p.add_argument("--frames", type=int, default=600)
    p.add_argument("--start", type=int, default=0,
                   help="first store frame (skip rollout warmup)")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device to extract on (an artifact's own "
                        "device); only an explicit --device cpu runs on the "
                        "CPU")
    return p


def main(argv=None) -> int:
    """Run the CLI on ``argv``; → the number of frames written."""
    from keypoints_tpu_torch.configs import apply_overrides, get_config
    from keypoints_tpu_torch.data.records import (FrameStore,
                                                  load_image_folder,
                                                  store_path_for)
    from keypoints_tpu_torch.training import require_device

    args = build_parser().parse_args(argv)
    device = require_device(args.device, "extract")
    cfg = apply_overrides(get_config(args.preset), args.override)
    d = cfg.data
    if args.folder:
        frames = load_image_folder(args.folder, d.image_size, d.channels,
                                   limit=args.frames)
    else:
        store = FrameStore(args.store or store_path_for(d))
        frames = np.asarray(
            store.frames[args.start:args.start + args.frames])

    if args.artifact:
        from keypoints_tpu_torch.export import load_extract
        fn = load_extract(args.artifact, device)
        kp_count = fn.meta["num_keypoints"]
    else:
        state_dict = None
        if args.checkpoint:
            from keypoints_tpu_torch.checkpoint import load_checkpoint
            state_dict = load_checkpoint(args.checkpoint)
            print(f"rendering with params from {args.checkpoint}")
        fn = live_extract(cfg, state_dict, device)
        kp_count = cfg.model.num_keypoints

    written = render_keypoint_video(args.out, frames, fn,
                                    fps=args.fps, batch=args.batch)
    print(f"wrote {written} frames to {args.out} "
          f"({d.image_size}px, K={kp_count})")
    return written



def _cli(argv=None) -> None:
    """The ``keypoints-torch-video`` console script: :func:`main`, whose return
    value would otherwise become the exit status."""
    main(argv)


if __name__ == "__main__":
    main()
