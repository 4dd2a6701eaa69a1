"""Dense warps: bilinear grid sampling and thin-plate-spline grids.

Port of ``keypoints_tpu/ops/warp.py``:

* :func:`grid_sample` == ``torch.nn.functional.grid_sample`` (2-D, modes
  bilinear and nearest, ``padding_mode`` zeros, border or reflection,
  explicit ``align_corners``), written out with gathers. It is the plain
  version of the CUDA warp (``keypoints_tpu_torch.kernels.warp_cuda``) and
  the path for CPU tensors. Unlike the JAX function, which promotes a bf16
  image to f32 on the CPU, it keeps the image's dtype, as the kernels do:
  the arithmetic is f32 and the result is rounded once to the image dtype.
* :func:`tps_coefficients`, :func:`tps_coefficients_fixed_sites`,
  :func:`tps_evaluate`, :func:`tps_grid`, :func:`tps_grid_fixed`: the
  thin-plate-spline solve and its dense evaluation.
* :func:`upsample_field_aligned`: bilinear blow-up of a coarse field.
* :func:`eval_field_at`, :func:`invert_warp_at`: a coarse field at given
  points, and where a source point lands under the warp (the eval set's
  ground-truth landmarks follow the target warp through them).
"""

from __future__ import annotations

import functools

import torch

from keypoints_tpu_torch.coords import (DEFAULT_ALIGN_CORNERS, coord_grid,
                                        normalized_to_pixel)


def _reflect_coord(x: torch.Tensor, size: int,
                   align_corners: bool) -> torch.Tensor:
    """Torch 'reflection' padding: fold coordinates into the valid range."""
    lo, hi = (0.0, size - 1.0) if align_corners else (-0.5, size - 0.5)
    span = hi - lo
    if span <= 0:                      # size == 1
        return torch.zeros_like(x)
    x = torch.remainder(x - lo, 2.0 * span)
    x = torch.where(x > span, 2.0 * span - x, x) + lo
    return x.clamp(0.0, size - 1)


def grid_sample(image: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "zeros",
                align_corners: bool = DEFAULT_ALIGN_CORNERS,
                mode: str = "bilinear") -> torch.Tensor:
    """Sample ``image`` (B, C, H, W) at ``grid`` (B, Ho, Wo, 2 as (x, y)).

    Returns (B, C, Ho, Wo) in the image's dtype, computed in f32.
    """
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"unsupported padding_mode: {padding_mode!r}")
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode: {mode!r}")
    b, c, h, w = image.shape
    out_hw = grid.shape[1:3]
    img_flat = image.float().reshape(b, c, h * w)
    grid = grid.float()
    ix = normalized_to_pixel(grid[..., 0], w, align_corners)  # (B, Ho, Wo)
    iy = normalized_to_pixel(grid[..., 1], h, align_corners)

    if padding_mode == "border":
        ix = ix.clamp(0.0, w - 1)
        iy = iy.clamp(0.0, h - 1)
    elif padding_mode == "reflection":
        ix = _reflect_coord(ix, w, align_corners)
        iy = _reflect_coord(iy, h, align_corners)

    def gather(yc, xc):
        xi = xc.clamp(0, w - 1).long()
        yi = yc.clamp(0, h - 1).long()
        flat = (yi * w + xi).reshape(b, 1, -1).expand(b, c, -1)
        return torch.gather(img_flat, 2, flat)                # (B, C, Ho*Wo)

    def inside(yc, xc):
        return (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)

    if mode == "nearest":
        xi, yi = torch.round(ix), torch.round(iy)
        vals = gather(yi, xi)
        if padding_mode == "zeros":
            vals = vals * inside(yi, xi).reshape(b, 1, -1)
        return vals.reshape(b, c, *out_hw).to(image.dtype)

    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = ix - x0                       # weight of the x1 corner
    wy1 = iy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    def corner(yc, xc, wy, wx):
        wgt = wy * wx
        if padding_mode == "zeros":
            wgt = torch.where(inside(yc, xc), wgt, torch.zeros_like(wgt))
        return gather(yc, xc) * wgt.reshape(b, 1, -1)

    out = (corner(y0, x0, wy0, wx0) + corner(y0, x1, wy0, wx1)
           + corner(y1, x0, wy1, wx0) + corner(y1, x1, wy1, wx1))
    return out.reshape(b, c, *out_hw).to(image.dtype)


def _tps_u(r2: torch.Tensor) -> torch.Tensor:
    """TPS radial basis U(r) = r^2 log(r^2), with U(0) = 0."""
    return torch.where(r2 == 0.0, torch.zeros_like(r2),
                       r2 * torch.log(r2.clamp_min(1e-30)))


def _system(points: torch.Tensor, reg: float) -> torch.Tensor:
    """The (…, N+3, N+3) TPS system matrix of control sites (…, N, 2)."""
    n = points.shape[-2]
    d2 = ((points[..., :, None, :] - points[..., None, :, :]) ** 2).sum(-1)
    eye = torch.eye(n, dtype=points.dtype, device=points.device)
    k = _tps_u(d2) + reg * eye
    ones = torch.ones((*points.shape[:-1], 1), dtype=points.dtype,
                      device=points.device)
    p = torch.cat([ones, points], dim=-1)                      # (…, N, 3)
    zeros = torch.zeros((*points.shape[:-2], 3, 3), dtype=points.dtype,
                        device=points.device)
    top = torch.cat([k, p], dim=-1)                            # (…, N, N+3)
    bot = torch.cat([p.transpose(-1, -2), zeros], dim=-1)      # (…, 3, N+3)
    return torch.cat([top, bot], dim=-2)


def _rhs(values: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros((values.shape[0], 3, values.shape[-1]),
                        dtype=values.dtype, device=values.device)
    return torch.cat([values, zeros], dim=1)                   # (B, N+3, D)


def tps_coefficients(control_points: torch.Tensor,
                     control_values: torch.Tensor,
                     reg: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve the TPS system for a batch of control sets.

    control_points (B, N, 2), control_values (B, N, D) → (w (B, N, D),
    a (B, 3, D)) with ``f(p) = a_0 + a_1 p_x + a_2 p_y + sum_i w_i
    U(|p - c_i|^2)``. One batched solve, without the error check that would
    make the host wait for the device.
    """
    n = control_points.shape[1]
    sol = torch.linalg.solve_ex(_system(control_points, reg),
                                _rhs(control_values))[0]
    return sol[:, :n, :], sol[:, n:, :]


# The fixed-sites constants below depend only on the sites and the output
# grid. They are computed once on the CPU in f32 and cached on each device
# they are asked for, as XLA folds them to constants in the JAX package.
# ``sites`` comes as a tuple of floats (the cache key).

@functools.lru_cache(maxsize=32)
def _fixed_inverse(sites: tuple, reg: float, device: str) -> torch.Tensor:
    """The inverse of the (N+3, N+3) TPS system of the sites."""
    pts = torch.tensor(sites, dtype=torch.float32).reshape(-1, 2)
    return torch.linalg.inv(_system(pts, reg)).to(device)


@functools.lru_cache(maxsize=32)
def _fixed_basis(sites: tuple, height: int, width: int, align_corners: bool,
                 device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The radial basis (M, N) and the affine rows (M, 3) at the M = H*W
    points of ``coord_grid(height, width)``."""
    pts = torch.tensor(sites, dtype=torch.float32).reshape(-1, 2)
    dense = coord_grid(height, width, align_corners).reshape(-1, 2)
    d2 = ((dense[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    homo = torch.cat([torch.ones((dense.shape[0], 1)), dense], dim=-1)
    return _tps_u(d2).to(device), homo.to(device)


def _sites_key(sites: torch.Tensor) -> tuple:
    if sites.device.type != "cpu":
        raise ValueError("fixed TPS sites are a constant and must be given on "
                         "the CPU (reading them from the device would wait "
                         "for it)")
    return tuple(sites.float().reshape(-1).tolist())


def tps_coefficients_fixed_sites(sites: torch.Tensor,
                                 control_values: torch.Tensor,
                                 reg: float = 0.0
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """TPS solve when every batch element shares the same control sites.

    sites (N, 2) on the CPU (a constant: the system inverse is computed once
    per device and cached); control_values (B, N, D) on any device. The
    batched solve becomes one product with the inverse.
    """
    n = sites.shape[0]
    inv = _fixed_inverse(_sites_key(sites), float(reg),
                         str(control_values.device))
    sol = torch.einsum("ij,bjd->bid", inv, _rhs(control_values))
    return sol[:, :n, :], sol[:, n:, :]


def tps_evaluate(points: torch.Tensor, control_points: torch.Tensor,
                 w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Evaluate a solved TPS at ``points`` (B, M, 2) -> (B, M, D)."""
    d2 = ((points[:, :, None, :] - control_points[:, None, :, :]) ** 2).sum(-1)
    radial = _tps_u(d2) @ w                                     # (B, M, D)
    ones = torch.ones((*points.shape[:2], 1), dtype=points.dtype,
                      device=points.device)
    return radial + torch.cat([ones, points], dim=-1) @ a


def tps_grid(control_points: torch.Tensor, control_targets: torch.Tensor,
             height: int, width: int, reg: float = 0.0,
             align_corners: bool = DEFAULT_ALIGN_CORNERS) -> torch.Tensor:
    """Dense TPS sampling grid (B, H, W, 2) from control correspondences.

    ``control_points`` (B, N, 2) are sites in the output image; the grid maps
    each output pixel to the source location ``control_targets`` (B, N, 2)
    interpolate, ready for :func:`grid_sample` (backward warping).
    """
    w_, a_ = tps_coefficients(control_points, control_targets, reg)
    b = control_points.shape[0]
    dense = coord_grid(height, width, align_corners, control_points.dtype,
                       control_points.device)
    pts = dense.reshape(1, -1, 2).expand(b, height * width, 2)
    return tps_evaluate(pts, control_points, w_, a_).reshape(
        b, height, width, 2)


def tps_grid_fixed(sites: torch.Tensor, control_targets: torch.Tensor,
                   height: int, width: int, reg: float = 0.0,
                   align_corners: bool = DEFAULT_ALIGN_CORNERS) -> torch.Tensor:
    """:func:`tps_grid` for a batch sharing one set of control sites.

    ``sites`` (N, 2) is unbatched and lies on the CPU: the system inverse
    and the (H*W, N) radial basis depend only on it and the grid, so they
    are computed once per device and cached; the dense evaluation is then
    two batched products on ``control_targets``' device.
    """
    w_, a_ = tps_coefficients_fixed_sites(sites, control_targets, reg)
    radial, homo = _fixed_basis(_sites_key(sites), int(height), int(width),
                                bool(align_corners),
                                str(control_targets.device))
    vals = (torch.einsum("mn,bnd->bmd", radial, w_)
            + torch.einsum("mj,bjd->bmd", homo, a_))
    return vals.reshape(-1, height, width, 2)


def upsample_field_aligned(field: torch.Tensor, height: int,
                           width: int) -> torch.Tensor:
    """Bilinear upsample of a smooth field (B, hc, wc, C) → (B, H, W, C).

    align_corners=True on both ends, so a field sampled on
    ``coord_grid(hc, wc)`` lands exactly on ``coord_grid(H, W)`` positions.
    """
    def axis_lerp(x, n_out, axis):
        n_in = x.shape[axis]
        if n_in == n_out:
            return x
        pos = (torch.arange(n_out, dtype=torch.float32, device=x.device)
               * ((n_in - 1) / (n_out - 1)))
        i0 = pos.floor().long().clamp(0, n_in - 2)
        f = (pos - i0).to(x.dtype)
        a = x.index_select(axis, i0)
        b = x.index_select(axis, i0 + 1)
        shape = [1] * x.ndim
        shape[axis] = n_out
        return a * (1.0 - f.reshape(shape)) + b * f.reshape(shape)

    return axis_lerp(axis_lerp(field, height, 1), width, 2)


def eval_field_at(field: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Evaluate a coarse warp field at continuous normalized points.

    ``field`` (B, hc, wc, C) sampled on ``coord_grid(hc, wc)`` with
    align_corners=True (the ``upsample_field_aligned`` convention); ``pts``
    (B, K, 2) in [-1, 1] (x, y) → (B, K, C) bilinear values. At the dense
    grid's positions it gives the upsampled field.
    """
    b, hc, wc, _ = field.shape
    x = (pts[..., 0] + 1.0) * 0.5 * (wc - 1)
    y = (pts[..., 1] + 1.0) * 0.5 * (hc - 1)
    x0 = torch.floor(x).long().clamp(0, wc - 2)
    y0 = torch.floor(y).long().clamp(0, hc - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = field.reshape(b, hc * wc, -1)

    def gather(yi, xi):                              # (B, K) idx → (B, K, C)
        idx = (yi * wc + xi)[..., None].expand(-1, -1, flat.shape[-1])
        return torch.gather(flat, 1, idx)

    top = gather(y0, x0) * (1.0 - fx) + gather(y0, x0 + 1) * fx
    bot = gather(y0 + 1, x0) * (1.0 - fx) + gather(y0 + 1, x0 + 1) * fx
    return top * (1.0 - fy) + bot * fy


def invert_warp_at(field: torch.Tensor, pts: torch.Tensor,
                   iters: int = 20) -> torch.Tensor:
    """Where does source position q land in the warped image?

    A backward sampling field W maps output position p to the source
    position it reads, so a landmark at source position ``q`` appears at the
    p with W(p) = q. With W = id + d and the mild warps of the augmentation
    (|d| ≲ 0.15, |∇d| < 1) the fixed-point iteration p ← p + (q − W(p)) is a
    contraction; ``iters`` = 20 steps reach the f32 floor.
    """
    p = pts
    for _ in range(iters):
        p = p + (pts - eval_field_at(field, p))
    return p
