"""Bilinear remap: the per-frame half of rectification.

cv::remap(INTER_LINEAR, BORDER_CONSTANT 0) equivalent (reference call site
src/StereoMatch.cpp:472-473 and the per-frame video preamble :130-153):
sample the source image at fractional map coordinates; out-of-image taps
contribute 0.

The op keeps the JAX package's term order (ops/remap.py there): floor,
fractions, four clipped taps that read 0 outside the image, the blend as
`top`, `bot`, `out`, each rounded to float32 in turn, and for integer images
round half to even, clamp and cast. So it is bitwise equal to the eager JAX
op. `torch.nn.functional.grid_sample` computes its weights another way and
is not used. The taps and fractions depend on the map alone, so a caller
with a fixed map (calib/rectify.py::Rectifier) computes them once with
`bilinear_taps` and blends each frame with `blend`.
"""

from __future__ import annotations

import torch


def bilinear_taps(map_xy: torch.Tensor, H: int, W: int):
    """The four taps of each output pixel of an (Ho, Wo, 2) map over an
    H x W image, as flat indices y * W + x in the order (y0, x0), (y0, x0+1),
    (y0+1, x0), (y0+1, x0+1), and -1 where a tap lies outside the image:
    (4, Ho, Wo) int64. Also the fractions fx, fy (Ho, Wo) float32."""
    mx = map_xy[..., 0]
    my = map_xy[..., 1]
    x0 = torch.floor(mx)
    y0 = torch.floor(my)
    fx = mx - x0
    fy = my - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    taps = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi, xi = y0i + dy, x0i + dx
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        taps.append(torch.where(inside, yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1), -1))
    return torch.stack(taps), fx, fy


def padded_rows(imgs, C: int) -> torch.Tensor:
    """The images' pixels as float32 rows (sum of H * W + 1, C), one zero
    row last: a tap of -1 reads it."""
    rows = [img.reshape(-1, C) for img in imgs]
    return torch.cat(rows + [rows[0].new_zeros((1, C))]).to(torch.float32)


def blend(v: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
          gx: torch.Tensor | None = None, gy: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX op's blend of the four float32 taps v (4, ..., C) with the
    fractions (..., 1); gx, gy are 1 - fx, 1 - fy where the caller holds
    them."""
    gx = 1.0 - fx if gx is None else gx
    gy = 1.0 - fy if gy is None else gy
    top = v[0] * gx + v[1] * fx
    bot = v[2] * gx + v[3] * fx
    return top * gy + bot * fy


def cast_like(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 result -> the image's dtype; integers round half to even
    (as jnp.rint) and saturate."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        out = torch.round(out).clamp(info.min, info.max)
    return out.to(dtype)


def remap_bilinear(img: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """img: (H, W[, C]); map_xy: (Ho, Wo, 2) float32 source coords (x, y).
    Returns (Ho, Wo[, C]) with the input dtype (rounded for integers)."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    H, W, C = img.shape
    taps, fx, fy = bilinear_taps(map_xy, H, W)
    out = cast_like(blend(padded_rows([img], C)[taps], fx[..., None], fy[..., None]), img.dtype)
    return out[..., 0] if squeeze else out
