"""Offline rollout collection → packed FrameStore — port of ``keypoints_tpu/data/collect.py``.

The collector takes real ALE frames (``gymnasium``/``gym``) where those are
installed and ``make`` succeeds, else the scripted Pong simulator: ball and
paddles, 64² grayscale. The scripted rollouts run JAX's numpy
``RandomState`` physics on the host, so the ball and paddle positions equal
JAX's to the bit; each episode is then rendered in one call of
``data.synthetic._render_pong`` on ``device`` (the ball through the
Gaussian raster kernel on CUDA) and quantized as JAX does,
``(clip(frames, 0, 1) * 255).astype(uint8)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from keypoints_tpu_torch.data.records import FrameStore, episode_pairs
from keypoints_tpu_torch.data.synthetic import _render_pong, reflect_unit
from keypoints_tpu_torch.training import require_device


def _ale_available(env_name: str) -> bool:
    """True only if ``gym.make(env_name)`` actually succeeds (gym can be
    installed without ale-py or the Atari ROMs)."""
    try:
        import gymnasium as gym
    except ImportError:
        try:
            import gym
        except ImportError:
            return False
    try:
        env = gym.make(env_name, render_mode="rgb_array")
        env.close()
        return True
    except Exception:
        return False


def collect_ale(env_name: str, episodes: int, max_steps: int, size: int,
                seed: int = 0) -> tuple[np.ndarray, list[int]]:
    """Random-policy ALE rollouts → (frames u8 (N,1,size,size), ep lengths)."""
    try:
        import gymnasium as gym
    except ImportError:
        import gym
    import cv2
    env = gym.make(env_name, render_mode="rgb_array")
    frames, lengths = [], []
    for ep in range(episodes):
        env.reset(seed=seed + ep)
        n = 0
        for _ in range(max_steps):
            _, _, term, trunc, _ = env.step(env.action_space.sample())
            img = env.render()
            gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
            gray = cv2.resize(gray, (size, size),
                              interpolation=cv2.INTER_AREA)
            frames.append(gray[None])
            n += 1
            if term or trunc:
                break
        lengths.append(n)
    env.close()
    return np.stack(frames).astype(np.uint8), lengths


def pong_trajectory(steps: int, rng: np.random.RandomState, dt: float = 0.08
                    ) -> tuple[np.ndarray, np.ndarray]:
    """One scripted episode's (ball (T, 2), paddle heights (T, 2)), float32.

    The unfolded position is integrated and folded only for rendering, so
    the ball bounces off the walls (a triangle wave of t)."""
    ball = rng.uniform(-0.7, 0.7, 2)
    vel = rng.uniform(0.5, 1.5, 2) * np.sign(rng.uniform(-1, 1, 2))
    balls = np.empty((steps, 2), np.float32)
    pads = np.empty((steps, 2), np.float32)
    for t in range(steps):
        pos = reflect_unit(ball)
        balls[t] = pos
        pads[t] = np.clip(pos[1] + 0.1 * rng.randn(2), -0.8, 0.8)
        ball = ball + vel * dt
    return balls, pads


def collect_scripted_pong(episodes: int, steps_per_episode: int, size: int,
                          seed: int = 0, device: torch.device | str = "cuda"
                          ) -> tuple[np.ndarray, list[int]]:
    """Scripted Pong rollouts (no gym needed) → (u8 frames (N, 1, size,
    size), episode lengths); each episode rendered in one call on
    ``device``."""
    rng = np.random.RandomState(seed)
    frames, lengths = [], []
    for _ in range(episodes):
        balls, pads = pong_trajectory(steps_per_episode, rng)
        ep = _render_pong(torch.from_numpy(balls).to(device),
                          torch.from_numpy(pads).to(device), size)
        frames.append(ep.cpu().numpy())
        lengths.append(steps_per_episode)
    arr = (np.clip(np.concatenate(frames), 0, 1) * 255).astype(np.uint8)
    return arr, lengths


def collect(out_path: str, env_name: Optional[str] = "ALE/Pong-v5",
            episodes: int = 20, steps_per_episode: int = 200,
            size: int = 64, delta: int = 2, seed: int = 0,
            device: torch.device | str = "cuda") -> str:
    """Collect rollouts and write a FrameStore with a temporal-pair index."""
    if env_name and _ale_available(env_name):
        frames, lengths = collect_ale(env_name, episodes, steps_per_episode,
                                      size, seed)
        # real ALE frames: scripted-Pong ground truth does NOT apply
        meta = {"origin": "ale", "env": env_name, "seed": seed}
    else:
        frames, lengths = collect_scripted_pong(episodes, steps_per_episode,
                                                size, seed, device)
        meta = {"origin": "scripted_pong", "seed": seed}
    pairs = episode_pairs(lengths, delta)
    FrameStore.write(out_path, frames, pairs, meta=meta)
    return out_path


def _cli(argv=None):
    """``python -m keypoints_tpu_torch.data.collect``: build a store ahead
    of training (the trainer also collects on first run when the store is
    absent)."""
    import argparse
    p = argparse.ArgumentParser(
        description="Build a packed FrameStore with a temporal-pair index: "
                    "from Atari rollouts (or the scripted-Pong fallback), "
                    "or from video footage with --video")
    p.add_argument("--out", required=True, help="output store path")
    p.add_argument("--env", default="ALE/Pong-v5",
                   help="gym env id; 'none' forces the scripted fallback")
    p.add_argument("--video", default=None, metavar="PATH",
                   help="ingest a video file or folder of videos instead of "
                        "collecting rollouts (each file = one episode)")
    p.add_argument("--stride", type=int, default=1,
                   help="with --video: keep every stride-th source frame")
    p.add_argument("--channels", type=int, default=3, choices=(1, 3),
                   help="with --video: stored channels (1 = grayscale)")
    p.add_argument("--max-frames", type=int, default=None,
                   help="with --video: cap stored frames per video file")
    p.add_argument("--episodes", type=int, default=20)
    p.add_argument("--steps-per-episode", type=int, default=200)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--delta", type=int, default=2,
                   help="temporal pair offset (frame_t, frame_{t+delta})")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device the scripted frames are rendered on; "
                        "only an explicit --device cpu renders on the CPU")
    args = p.parse_args(argv)

    if args.video is not None:
        from keypoints_tpu_torch.data.records import video_to_store
        path = video_to_store(args.video, args.out, args.size, args.channels,
                              args.stride, args.delta, args.max_frames)
        store = FrameStore(path)
        n_pairs = 0 if store.pairs is None else len(store.pairs)
        print(f"wrote {path}: {store.frames.shape[0]} frames "
              f"{store.frames.shape[1:]}, {n_pairs} pairs")
        return

    env = None if args.env.lower() == "none" else args.env
    using_ale = env is not None and _ale_available(env)
    if not using_ale:
        require_device(args.device, "render")
    print(f"collecting {args.episodes} episodes via "
          f"{'ALE ' + env if using_ale else 'scripted Pong (no ALE)'}",
          flush=True)
    path = collect(args.out, env, args.episodes, args.steps_per_episode,
                   args.size, args.delta, args.seed, args.device)
    store = FrameStore(path)
    print(f"wrote {path}: {store.frames.shape[0]} frames "
          f"{store.frames.shape[1:]}, {len(store.pairs)} pairs")


if __name__ == "__main__":
    _cli()
