"""Synthetic temporal pairs on the device — port of ``keypoints_tpu/data/synthetic.py``.

* moving dots: D Gaussian dots at random positions; the (source, target)
  pair shows the same dots displaced.
* scripted Pong: a 1-channel frame of a ball and two paddles; the ball
  moves with a random velocity and reflects off the walls, the paddles
  track its height with noise. The pair (t, t + dt) feeds the Transporter
  as stored Atari rollouts would, through the train step's temporal mode.

Every random function is split in two, as in ``data.augment``: a draw step
that takes a ``torch.Generator`` and draws on its device (``draw_pong``,
``draw_dots``) and a deterministic step that takes the draws
(``pong_from_draws``, ``dots_from_draws``). ``jax.random`` and torch never
give the same numbers, so the tests hand the deterministic steps what JAX
drew (the splits of ``jax.random.split(key, 4)`` and ``split(key)``) and
compare with JAX's frames; the port's own draws get range checks.
``scripted_pong_pair`` and ``moving_dots_pair`` chain the two.

Dots and the ball are rendered by ``kernels.gaussian_maps``: the raster
kernel on CUDA, its plain version on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from keypoints_tpu_torch.kernels import gaussian_maps


def reflect_unit(x):
    """Fold any real x into [-1, 1] by wall reflection (triangle wave):
    identity on [-1, 1]; 1.1 → 0.9, -1.3 → -0.7, 2.5 → -0.5. Python's and
    torch's ``%`` are floor-modulo, as ``jnp``'s is."""
    return 1.0 - abs((x + 1.0) % 4.0 - 2.0)


# --- moving dots ------------------------------------------------------------

class DotsDraws(NamedTuple):
    """The random numbers of one batch of moving-dots pairs."""
    positions: torch.Tensor   # (B, D, 2) U[-0.7, 0.7]
    shift: torch.Tensor       # (B, D, 2) U[-max_shift, max_shift]


def render_dots(positions: torch.Tensor, size: int, channels: int = 3,
                sigma: float = 0.06) -> torch.Tensor:
    """(B, D, 2) dot positions → (B, C, size, size) images in [0, 1]; dot d
    is drawn in channel d % channels."""
    d = positions.shape[1]
    maps = gaussian_maps(positions, size, size, sigma)           # (B, D, H, W)
    onehot = torch.nn.functional.one_hot(
        torch.arange(d, device=positions.device) % channels,
        channels).to(maps.dtype)                                  # (D, C)
    return torch.einsum("bdhw,dc->bchw", maps, onehot).clamp(0.0, 1.0)


def draw_dots(gen: torch.Generator, batch: int, num_dots: int = 4,
              max_shift: float = 0.2) -> DotsDraws:
    dev = gen.device
    pos = torch.rand((batch, num_dots, 2), generator=gen, device=dev)
    shift = torch.rand((batch, num_dots, 2), generator=gen, device=dev)
    return DotsDraws(pos * 1.4 - 0.7, (shift * 2.0 - 1.0) * max_shift)


def dots_from_draws(draws: DotsDraws, size: int = 64, channels: int = 3,
                    sigma: float = 0.06):
    """→ (x_source, x_target, target positions (B, D, 2)), NCHW in [0, 1]."""
    tgt = (draws.positions + draws.shift).clamp(-0.85, 0.85)
    return (render_dots(draws.positions, size, channels, sigma),
            render_dots(tgt, size, channels, sigma), tgt)


def moving_dots_pair(gen: torch.Generator, batch: int, size: int = 64,
                     num_dots: int = 4, channels: int = 3,
                     max_shift: float = 0.2, sigma: float = 0.06):
    """:func:`draw_dots` then :func:`dots_from_draws`, on ``gen``'s device."""
    return dots_from_draws(draw_dots(gen, batch, num_dots, max_shift), size,
                           channels, sigma)


# --- scripted Pong ----------------------------------------------------------

_PADDLE_X = 0.9          # |x| of the two paddles
_PADDLE_HALF_H = 0.15    # half-height in normalized units
_PADDLE_HALF_W = 0.02
_BALL_SIGMA = 0.04


class PongDraws(NamedTuple):
    """The random numbers of one batch of scripted-Pong pairs."""
    ball: torch.Tensor    # (B, 2) U[-0.7, 0.7], the ball at t
    speed: torch.Tensor   # (B, 2) U[0.5, 1.5]
    sign: torch.Tensor    # (B, 2) sign(U[0, 1) - 0.5): the velocity's signs
    noise: torch.Tensor   # (B, 2, 2) 0.1 N(0, 1): the paddles' noise


def _render_pong(ball: torch.Tensor, paddles_y: torch.Tensor,
                 size: int) -> torch.Tensor:
    """ball (B, 2), paddles_y (B, 2) → (B, 1, size, size) frames."""
    ball_img = gaussian_maps(ball[:, None, :].contiguous(), size, size,
                             _BALL_SIGMA)[:, 0]                   # (B, H, W)
    c = torch.linspace(-1.0, 1.0, size, device=ball.device)
    gx = c[None, None, :]                                         # (1, 1, W)
    gy = c[None, :, None]                                         # (1, H, 1)

    def paddle(px, py):
        inx = (gx - px).abs() < _PADDLE_HALF_W + 2.0 / size
        iny = (gy - py[:, None, None]).abs() < _PADDLE_HALF_H
        return (inx & iny).float()

    left = paddle(-_PADDLE_X, paddles_y[:, 0])
    right = paddle(_PADDLE_X, paddles_y[:, 1])
    return (ball_img + left + right).clamp(0.0, 1.0)[:, None]


def draw_pong(gen: torch.Generator, batch: int) -> PongDraws:
    dev = gen.device
    ball = torch.rand((batch, 2), generator=gen, device=dev) * 1.4 - 0.7
    speed = torch.rand((batch, 2), generator=gen, device=dev) + 0.5
    sign = torch.sign(torch.rand((batch, 2), generator=gen, device=dev) - 0.5)
    noise = 0.1 * torch.randn((batch, 2, 2), generator=gen, device=dev)
    return PongDraws(ball, speed, sign, noise)


def pong_from_draws(draws: PongDraws, size: int = 64, dt: float = 0.15):
    """→ (frame_t, frame_{t+dt}, state at t+dt) from one batch's draws.

    The ball moves by ``speed * sign * dt`` and reflects off the [-1, 1]
    walls; each paddle at t is the ball's height plus its noise, at t+dt the
    new height plus 0.05 of the noise, clipped to ±0.8. ``state`` is the
    (ball, left paddle, right paddle) positions at t+dt, ``(B, 3, 2)``.
    """
    ball = draws.ball
    b = ball.shape[0]
    ball2 = reflect_unit(ball + draws.speed * draws.sign * dt)
    noise = draws.noise
    pad_y = (ball[:, 1:2, None] + noise).clamp(-0.8, 0.8)[..., 0]    # (B, 2)
    pad_y2 = (ball2[:, 1:2] + 0.05 * noise[..., 1]).clamp(-0.8, 0.8)
    f1 = _render_pong(ball, pad_y, size)
    f2 = _render_pong(ball2, pad_y2, size)
    xs = torch.full((b,), _PADDLE_X, device=ball.device)
    state = torch.stack([ball2,
                         torch.stack([-xs, pad_y2[:, 0]], -1),
                         torch.stack([xs, pad_y2[:, 1]], -1)], dim=1)
    return f1, f2, state


def scripted_pong_pair(gen: torch.Generator, batch: int, size: int = 64,
                       dt: float = 0.15):
    """:func:`draw_pong` then :func:`pong_from_draws`, on ``gen``'s device."""
    return pong_from_draws(draw_pong(gen, batch), size, dt)
