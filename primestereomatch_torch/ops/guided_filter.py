"""Fast guided filtering of the cost volume (CVF stage), the plain PyTorch
versions of the low-maps (K1) and upsample+WTA (K2) kernels.

The FastGuidedFilter (src/fastguidedfilter.cpp, arXiv 1505.00996) works at
the nearest-downsampled grid: guide statistics and the inverse colour
covariance, a per-slice (a, b) solve, a box average of each map; then the
maps are bilinearly upsampled and applied to the full-resolution guide.
On the pipeline's path that last step is fused with the winner-takes-all
argmin, so the filtered full-resolution volume never exists; the staged
engine (models/gif_pipeline.py::DispEst) builds it
(`fast_guided_filter_color`), and `guided_filter_color` is the
reference's full-resolution CVF.

Every expression keeps the JAX package's term order (ops/guided_filter.py
there), which the CUDA kernels follow in turn.
"""

from __future__ import annotations

import torch

from primestereomatch_torch.ops.boxfilter import box_mean
from primestereomatch_torch.ops.resize import resize_bilinear, resize_nearest

_FILTER_D_CHUNK = 16  # slices a full-resolution filter upsamples at once


def _color_inverse_cov(ch, k: int, eps: float):
    """Per-pixel inverse of the 3x3 colour covariance (+eps*I), adjugate/det
    (src/fastguidedfilter.cpp:135-166). Returns (means, inv) with
    inv = (rr, rg, rb, gg, gb, bb)."""
    m = [box_mean(c, k) for c in ch]
    v_rr = box_mean(ch[0] * ch[0], k) - m[0] * m[0] + eps
    v_rg = box_mean(ch[0] * ch[1], k) - m[0] * m[1]
    v_rb = box_mean(ch[0] * ch[2], k) - m[0] * m[2]
    v_gg = box_mean(ch[1] * ch[1], k) - m[1] * m[1] + eps
    v_gb = box_mean(ch[1] * ch[2], k) - m[1] * m[2]
    v_bb = box_mean(ch[2] * ch[2], k) - m[2] * m[2] + eps

    inv_rr = v_gg * v_bb - v_gb * v_gb
    inv_rg = v_gb * v_rb - v_rg * v_bb
    inv_rb = v_rg * v_gb - v_gg * v_rb
    inv_gg = v_rr * v_bb - v_rb * v_rb
    inv_gb = v_rb * v_rg - v_rr * v_gb
    inv_bb = v_rr * v_gg - v_rg * v_rg

    det = inv_rr * v_rr + inv_rg * v_rg + inv_rb * v_rb
    inv = tuple(t / det for t in (inv_rr, inv_rg, inv_rb, inv_gg, inv_gb, inv_bb))
    return m, inv


def _solve_ab(p, ch_low, means, inv, k: int):
    """Low-res GIF solve for slices p (..., D, h, w); the guide planes
    broadcast over D."""
    mean_p = box_mean(p, k)
    cov = []
    for c in range(3):
        mean_ip = box_mean(ch_low[c] * p, k)
        cov.append(mean_ip - means[c] * mean_p)
    inv_rr, inv_rg, inv_rb, inv_gg, inv_gb, inv_bb = inv
    a_r = inv_rr * cov[0] + inv_rg * cov[1] + inv_rb * cov[2]
    a_g = inv_rg * cov[0] + inv_gg * cov[1] + inv_gb * cov[2]
    a_b = inv_rb * cov[0] + inv_gb * cov[1] + inv_bb * cov[2]
    b = mean_p - a_r * means[0] - a_g * means[1] - a_b * means[2]
    return (a_r, a_g, a_b), b


def guide_stats(guide: torch.Tensor, low_hw: tuple[int, int], k: int,
                eps: float) -> torch.Tensor:
    """(..., H, W, 3) guide -> (..., 12, h, w) planes: the downsampled
    channels (3), their box means (3) and the inverse covariance (6)."""
    ch_low = tuple(resize_nearest(guide[..., c], low_hw) for c in range(3))
    means, inv = _color_inverse_cov(ch_low, k, eps)
    return torch.stack([*ch_low, *means, *inv], dim=-3)


def low_maps_from_stats(p_low: torch.Tensor, stats: torch.Tensor,
                        k: int) -> torch.Tensor:
    """(..., D, h, w) costs + (..., 12, h, w) guide stats ->
    (..., 4, D, h, w) box-averaged maps [a_r, a_g, a_b, b]."""
    planes = stats.unsqueeze(-3).unbind(-4)          # 12 x (..., 1, h, w)
    (a_r, a_g, a_b), b = _solve_ab(p_low, planes[0:3], planes[3:6], planes[6:12], k)
    return torch.stack([box_mean(t, k) for t in (a_r, a_g, a_b, b)], dim=-4)


def fgf_low_maps(
    guide: torch.Tensor,       # (H, W, 3) float32 full-res guide
    p_low: torch.Tensor,       # (D, H//s, W//s) subsampled cost volume
    radius: int = 8,
    eps: float = 1e-4,
    subsample: int = 4,
):
    """Low-resolution half of the FastGuidedFilter. Returns (mean_a
    3-tuple, mean_b), each (D, h, w), as the JAX op does."""
    k = 2 * (radius // subsample) + 1
    stats = guide_stats(guide, tuple(p_low.shape[-2:]), k, eps)
    maps = low_maps_from_stats(p_low, stats, k)
    return tuple(maps[..., i, :, :, :] for i in range(3)), maps[..., 3, :, :, :]


def fgf_wta_low_maps(
    guide: torch.Tensor,       # (H, W, 3) full-res guide
    mean_a: tuple,             # 3 x (D, h, w) box-averaged a maps
    mean_b: torch.Tensor,      # (D, h, w)
    out_hw: tuple[int, int],
    d_chunk: int | None = None,
) -> torch.Tensor:
    """Fused upsample + WTA: q = up(a_r)*I0 + up(a_g)*I1 + up(a_b)*I2 +
    up(b) per disparity (each map lerped rows then columns), first minimum
    over d >= 1, folded over chunks of `d_chunk` disparities with a strict
    `<` so earlier disparities win ties. Returns (H, W) uint8."""
    stack = torch.stack([*mean_a, mean_b])           # (4, D, h, w)
    D = stack.shape[1]
    dc = D if d_chunk is None else d_chunk
    ch = [guide[..., c] for c in range(3)]
    best = arg = None
    for d0 in range(1, D, dc):
        up = resize_bilinear(stack[:, d0:d0 + dc], out_hw)
        q = up[0] * ch[0] + up[1] * ch[1] + up[2] * ch[2] + up[3]
        c_min, c_arg = q.min(dim=0)                  # first minimum on ties
        c_arg = c_arg + d0
        if best is None:
            best, arg = c_min, c_arg
        else:
            take = c_min < best
            best = torch.where(take, c_min, best)
            arg = torch.where(take, c_arg, arg)
    return arg.to(torch.uint8)


def fast_guided_filter_color_low(
    guide: torch.Tensor,       # (H, W, 3) float32 full-res guide
    p_low: torch.Tensor,       # (D, H//s, W//s) nearest-downsampled volume
    radius: int = 8,
    eps: float = 1e-4,
    subsample: int = 4,
) -> torch.Tensor:
    """The FastGuidedFilter's output on every slice, d = 0 included: the
    low-resolution chain, each map bilinearly upsampled, then
    up(a_r)*I0 + up(a_g)*I1 + up(a_b)*I2 + up(b). Returns (D, H, W).
    Plain torch, as the JAX package computes it (the low-maps kernel
    leaves d = 0 out); _FILTER_D_CHUNK slices at a time bound the upsampled
    temporaries."""
    H, W, _ = guide.shape
    mean_a, mean_b = fgf_low_maps(guide, p_low, radius, eps, subsample)
    ch = [guide[..., c] for c in range(3)]
    out = []
    for d0 in range(0, p_low.shape[0], _FILTER_D_CHUNK):
        up = [resize_bilinear(t[d0:d0 + _FILTER_D_CHUNK], (H, W)) for t in (*mean_a, mean_b)]
        out.append(up[0] * ch[0] + up[1] * ch[1] + up[2] * ch[2] + up[3])
    return torch.cat(out)


def fast_guided_filter_color(
    guide: torch.Tensor,       # (H, W, 3) float32 full-res guide
    p: torch.Tensor,           # (D, H, W) float32 cost volume
    radius: int = 8,
    eps: float = 1e-4,
    subsample: int = 4,
) -> torch.Tensor:
    """FastGuidedFilter(I, r, eps, s).filter(p) for every slice of p
    (src/fastguidedfilter.cpp:121-198; the reference calls it with r = 8,
    eps = 1e-4, src/DispEst.cpp:281-295): each slice nearest-downsampled by
    s, then `fast_guided_filter_color_low`. Returns (D, H, W)."""
    H, W, _ = guide.shape
    p_low = resize_nearest(p, (H // subsample, W // subsample))
    return fast_guided_filter_color_low(guide, p_low, radius, eps, subsample)


def guided_filter_color(
    guide: torch.Tensor,       # (H, W, 3)
    p: torch.Tensor,           # (D, H, W)
    ksize: int = 8,
    eps: float = 1e-4,
) -> torch.Tensor:
    """Full-resolution colour guided filter (the reference's CVF stage,
    src/CVF.cpp:72-165): a ksize x ksize box (GIF_R_WIN used as the box
    size; an even size spans [i - k/2, i + k/2 - 1], OpenCV's anchor)."""
    ch = tuple(guide[..., c] for c in range(3))
    means, inv = _color_inverse_cov(ch, ksize, eps)
    (a_r, a_g, a_b), b = _solve_ab(p, ch, means, inv, ksize)
    return (box_mean(a_r, ksize) * ch[0] + box_mean(a_g, ksize) * ch[1]
            + box_mean(a_b, ksize) * ch[2] + box_mean(b, ksize))
