"""Synthetic articulated figures — port of ``keypoints_tpu/data/pose.py``.

The pose256 preset's offline stand-in: a 2-D stick figure (torso, head, two
2-segment arms, two 2-segment legs: 10 bones, 16 nameable joints) whose
joint angles random-walk across an episode, rendered as 3-channel frames
with the torso and head, the arms and the legs in separate channels.

The kinematics (:func:`_skeleton`, :func:`joint_positions`,
:func:`generate_episode`) are copies of the JAX package's numpy code, so one
``RandomState`` seed gives both packages the same bones. The renderer
(:func:`_render_episode`, capsule distance fields of the bone segments over
a dense pixel grid) runs in torch on the device it is given, as the JAX
package runs it jitted on its device. :func:`generate_pose_store` writes
the FrameStore the trainer reads, with JAX's sidecar; its frames are
rendered on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from keypoints_tpu_torch.data.records import FrameStore, episode_pairs

# Bone lengths in normalized [-1, 1] units.
_TORSO, _HEAD = 0.45, 0.13
_UPPER_ARM, _FORE_ARM = 0.22, 0.20
_THIGH, _SHIN = 0.26, 0.24
_WIDTH = 0.045            # capsule half-width
# channel per bone: torso+head red-ish, arms green, legs blue
_BONE_CHANNELS = (0, 0, 1, 1, 1, 1, 2, 2, 2, 2)


def _skeleton(root: np.ndarray, ang: np.ndarray) -> np.ndarray:
    """(T, 2) root + (T, 9) joint angles → (T, 10, 2, 2) bone segments.

    Angles (radians, 0 = straight down in image coords, y grows downward):
    [torso_sway, l_shoulder, l_elbow, r_shoulder, r_elbow,
     l_hip, l_knee, r_hip, r_knee].
    """
    def polar(base, theta, length):
        return base + length * np.stack(
            [np.sin(theta), np.cos(theta)], axis=-1)

    pelvis = root
    neck = polar(pelvis, np.pi + ang[:, 0], _TORSO)       # up = angle pi
    head = polar(neck, np.pi + ang[:, 0], _HEAD)
    l_elb = polar(neck, ang[:, 1], _UPPER_ARM)
    l_hand = polar(l_elb, ang[:, 1] + ang[:, 2], _FORE_ARM)
    r_elb = polar(neck, ang[:, 3], _UPPER_ARM)
    r_hand = polar(r_elb, ang[:, 3] + ang[:, 4], _FORE_ARM)
    l_knee = polar(pelvis, ang[:, 5], _THIGH)
    l_foot = polar(l_knee, ang[:, 5] + ang[:, 6], _SHIN)
    r_knee = polar(pelvis, ang[:, 7], _THIGH)
    r_foot = polar(r_knee, ang[:, 7] + ang[:, 8], _SHIN)

    bones = [(pelvis, neck), (neck, head),
             (neck, l_elb), (l_elb, l_hand), (neck, r_elb), (r_elb, r_hand),
             (pelvis, l_knee), (l_knee, l_foot),
             (pelvis, r_knee), (r_knee, r_foot)]
    return np.stack([np.stack(b, axis=1) for b in bones], axis=1)


def joint_positions(segments: np.ndarray) -> np.ndarray:
    """(T, 10, 2, 2) bones → (T, 16, 2) nameable joints (bone endpoints,
    deduplicated): pelvis, neck, head and both endpoints of each limb bone."""
    t = segments.shape[0]
    pts = [segments[:, 0, 0], segments[:, 0, 1], segments[:, 1, 1]]
    for b in (2, 3, 4, 5, 6, 7, 8, 9):                    # limb bones
        pts.append(segments[:, b, 1])
    # pad to 16 with midpoints of torso, thighs and both upper arms
    pts.append((segments[:, 0, 0] + segments[:, 0, 1]) / 2)
    pts.append((segments[:, 6, 0] + segments[:, 6, 1]) / 2)
    pts.append((segments[:, 8, 0] + segments[:, 8, 1]) / 2)
    pts.append((segments[:, 2, 0] + segments[:, 2, 1]) / 2)
    pts.append((segments[:, 4, 0] + segments[:, 4, 1]) / 2)
    return np.stack(pts[:16], axis=1).astype(np.float32)


def _render_episode(segments, size: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """(T, 10, 2, 2) segments → (T, 3, size, size) float32 frames in
    [0, 1] on ``device``."""
    segs = torch.as_tensor(np.asarray(segments, np.float32), device=device)
    c = torch.linspace(-1.0, 1.0, size, device=device)
    gx = c[None, None, None, :]                       # (1,1,1,W)
    gy = c[None, None, :, None]                       # (1,1,H,1)
    a = segs[:, :, 0]                                 # (T, B, 2)
    ab = segs[:, :, 1] - a                            # (T, B, 2)
    denom = torch.clamp_min((ab * ab).sum(-1), 1e-8)
    ax = a[..., 0][:, :, None, None]
    ay = a[..., 1][:, :, None, None]
    abx = ab[..., 0][:, :, None, None]
    aby = ab[..., 1][:, :, None, None]
    # projection parameter of each pixel onto the segment, clamped
    t = ((gx - ax) * abx + (gy - ay) * aby) / denom[:, :, None, None]
    t = t.clamp(0.0, 1.0)
    d2 = (gx - (ax + t * abx)) ** 2 + (gy - (ay + t * aby)) ** 2
    body = torch.exp(-d2 / (2.0 * _WIDTH * _WIDTH))   # (T, B, H, W)
    onehot = torch.nn.functional.one_hot(
        torch.tensor(_BONE_CHANNELS, device=device), 3).to(body.dtype)
    return torch.einsum("tbhw,bc->tchw", body, onehot).clamp(0.0, 1.0)


def generate_episode(steps: int, rng: np.random.RandomState):
    """→ (T, 10, 2, 2) segments for one random-walk motion episode."""
    root = np.empty((steps, 2), np.float32)
    ang = np.empty((steps, 9), np.float32)
    r = rng.uniform(-0.25, 0.25, 2).astype(np.float32)
    r[1] += 0.25                                          # pelvis below center
    a = np.concatenate([
        rng.uniform(-0.2, 0.2, 1),                        # torso sway
        rng.uniform(-1.2, -0.3, 1), rng.uniform(-0.8, 0.8, 1),   # L arm
        rng.uniform(0.3, 1.2, 1), rng.uniform(-0.8, 0.8, 1),     # R arm
        rng.uniform(-0.5, -0.05, 1), rng.uniform(-0.4, 0.4, 1),  # L leg
        rng.uniform(0.05, 0.5, 1), rng.uniform(-0.4, 0.4, 1),    # R leg
    ]).astype(np.float32)
    for t in range(steps):
        root[t], ang[t] = r, a
        r = np.clip(r + rng.normal(0, 0.02, 2), -0.35, 0.4)
        a = np.clip(a + rng.normal(0, 0.06, 9), -1.6, 1.6)
    return _skeleton(root, ang)


def generate_pose_store(out_path: str, episodes: int = 20,
                        steps_per_episode: int = 100, size: int = 256,
                        delta: int = 2, seed: int = 0,
                        device: torch.device | str = "cuda") -> str:
    """Generate the synthetic pose FrameStore (+ temporal-pair index), each
    episode rendered on ``device`` and quantized as JAX does."""
    rng = np.random.RandomState(seed)
    frames, lengths = [], []
    for _ in range(episodes):
        segs = generate_episode(steps_per_episode, rng)
        frames.append(_render_episode(segs, size, device).cpu().numpy())
        lengths.append(steps_per_episode)
    arr = (np.clip(np.concatenate(frames), 0, 1) * 255).astype(np.uint8)
    FrameStore.write(out_path, arr, episode_pairs(lengths, delta),
                     meta={"origin": "synthetic_pose", "seed": seed})
    return out_path
