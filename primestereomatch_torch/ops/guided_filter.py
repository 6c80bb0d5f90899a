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

The row-tile ops (`fgf_tile_halo`, `fast_guided_filter_color_tile(_low)`,
`fgf_wta_tile_low`) filter one row tile of a row-sharded image, extended
by a halo each side (parallel/sharded.py); their interior rows equal the
whole image's. The JAX ops' `global_h` is not needed: the edge flags and
the tile's own rows place the global borders.

Every expression keeps the JAX package's term order (ops/guided_filter.py
there), which the CUDA kernels follow in turn.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from primestereomatch_torch.ops.boxfilter import box_mean
from primestereomatch_torch.ops.resize import linear_tables, resize_bilinear, resize_nearest
from primestereomatch_torch.utils.device import device_table

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


# --- row tiles of a row-sharded image (parallel/sharded.py) ----------------


@functools.lru_cache(maxsize=None)
def tile_row_coeffs(hl: int, He: int, s: int, halo: int, is_top: bool,
                    is_bot: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV INTER_LINEAR row taps of an extended tile of He rows over its
    hl low-res rows, clamped at the GLOBAL borders: at the tile's local
    rows halo/s (global low-res row 0) where `is_top` and hl-1-halo/s
    (the last global one) where `is_bot`. The coordinates are float32, as
    the JAX op computes them. Returns (low row, high row, f32 fraction)."""
    hs = halo // s
    Y = np.arange(He, dtype=np.float32)
    fy = (Y + np.float32(0.5)) * np.float32(1.0 / s) - np.float32(0.5)
    sy = np.floor(fy).astype(np.int64)
    fr = fy - sy.astype(np.float32)
    if is_top:
        top = sy < hs
        sy[top], fr[top] = hs, 0.0
    last_local = hl - 1 - hs
    if is_bot:
        bot = sy >= last_local
        sy[bot], fr[bot] = last_local, 0.0
    sy = np.clip(sy, 0, hl - 1)
    return sy, np.minimum(sy + 1, hl - 1), fr.astype(np.float32)


def _upsample_tile(
    t: torch.Tensor,         # (..., hl, wl) low-res rows of an EXTENDED tile
    out_hw: tuple[int, int],
    s: int,
    halo: int,               # full-res halo rows on each side of the tile
    is_top: bool,            # this tile touches the global top
    is_bot: bool,            # this tile touches the global bottom
    rows: tuple[int, int] | None = None,   # (first, count) of the output rows kept
) -> torch.Tensor:
    """Bilinear upsample of a row tile with OpenCV's INTER_LINEAR clamp at
    the GLOBAL image borders, not the tile's (`tile_row_coeffs`). The
    tile's low-res rows lie on the global grid (halo and the tile's offset
    are multiples of s). Columns are not sharded: the global
    coefficients. `rows` keeps only those output rows,
    each as the whole tile computes it. Returns (..., n rows, W)."""
    hl, wl = t.shape[-2:]
    He, W = out_hw
    r0, nr = rows if rows is not None else (0, He)
    coeffs = tile_row_coeffs(hl, He, s, halo, bool(is_top), bool(is_bot))
    key = ("tile_rows", hl, He, s, halo, bool(is_top), bool(is_bot), r0, nr)
    sy, sy1, fr = (device_table(key + (i,), lambda i=i: coeffs[i][r0:r0 + nr], t.device,
                                torch.float32 if i == 2 else torch.long) for i in range(3))
    fr = fr[:, None]
    ry = t.index_select(-2, sy) * (1.0 - fr) + t.index_select(-2, sy1) * fr
    x0, x1, xf = linear_tables(wl, W, t.device)
    return ry.index_select(-1, x0) * (1.0 - xf) + ry.index_select(-1, x1) * xf


def fgf_tile_halo(radius: int, subsample: int) -> int:
    """Full-res halo rows each side that an exact FGF on a row tile needs:
    two box passes of radius k//2 at low res and one low row of bilinear
    support, in whole multiples of s."""
    k = 2 * (radius // subsample) + 1
    return subsample * (2 * (k // 2) + 2)


def tile_low_maps(guide_ext: torch.Tensor, p_low: torch.Tensor, k: int,
                  eps: float) -> torch.Tensor:
    """The low-res chain of an extended tile: (..., He, W, 3) guide +
    (..., D, He/s, W/s) costs -> (..., 4, D, h, w) box-averaged [a_r, a_g,
    a_b, b]. The guide statistics of the tile (`guide_stats`), then the
    low-maps kernel K1, which takes `low_maps_from_stats` for CPU tensors;
    the box borders are the tile's reflect-101, which the halo keeps out of
    its interior."""
    from primestereomatch_torch.kernels.lowmaps import low_maps   # kernels import this module

    lead = p_low.shape[:-3]
    D, h, w = p_low.shape[-3:]
    stats = guide_stats(guide_ext, (h, w), k, eps).reshape(-1, 12, h, w).contiguous()
    maps = low_maps(p_low.reshape(-1, D, h, w).contiguous(), stats, k)
    return maps.reshape(*lead, 4, D, h, w)


def _check_tile(He: int, W: int, s: int, halo: int) -> None:
    if He % s or W % s or halo % s:
        raise ValueError(f"tile dims must be multiples of s={s}: {He}x{W}, halo={halo}")


def fast_guided_filter_color_tile(
    guide_ext: torch.Tensor,   # (..., He, W, 3) row tile EXTENDED by halo each side
    p_ext: torch.Tensor,       # (..., D, He, W) cost block on the extended tile
    radius: int,
    eps: float,
    subsample: int,
    halo: int,                 # = fgf_tile_halo(radius, subsample)
    is_top: bool,
    is_bot: bool,
) -> torch.Tensor:
    """FGF on one row tile of a row-sharded image; returns the filtered
    EXTENDED tile, whose rows [halo, halo + tile rows) equal the
    unsharded `fast_guided_filter_color`'s. With the tile's offset, halo,
    H and W multiples of s the tile's nearest grid is the global one,
    s-row block-reflect-101 halos at the global edges downsample to the
    global low-res reflect-101, and `_upsample_tile` clamps at the global
    borders."""
    s = subsample
    He, W = p_ext.shape[-2:]
    _check_tile(He, W, s, halo)
    p_low = resize_nearest(p_ext, (He // s, W // s))
    return fast_guided_filter_color_tile_low(guide_ext, p_low, radius, eps, subsample, halo,
                                             is_top, is_bot)


def fast_guided_filter_color_tile_low(
    guide_ext: torch.Tensor,   # (..., He, W, 3) extended row tile
    p_low: torch.Tensor,       # (..., D, He/s, W/s) cost block at the sample grid
    radius: int,
    eps: float,
    subsample: int,
    halo: int,
    is_top: bool,
    is_bot: bool,
) -> torch.Tensor:
    """Tile FGF from the already-subsampled cost block (the tile analog
    of `fast_guided_filter_color_low`, paired with
    ops/cost_volume.py::build_cost_volume_block_sampled). Returns
    (..., D, He, W)."""
    He, W = guide_ext.shape[-3:-1]
    s = subsample
    _check_tile(He, W, s, halo)
    k = 2 * (radius // s) + 1
    maps = tile_low_maps(guide_ext, p_low, k, eps)
    up = [_upsample_tile(maps[..., i, :, :, :], (He, W), s, halo, is_top, is_bot)
          for i in range(4)]
    ch = [guide_ext[..., c].unsqueeze(-3) for c in range(3)]
    return up[0] * ch[0] + up[1] * ch[1] + up[2] * ch[2] + up[3]


def fgf_wta_tile_low(
    guide_ext: torch.Tensor,   # (..., He, W, 3) extended row tile
    p_low: torch.Tensor,       # (..., Db, He/s, W/s) LOCAL d block at the sample grid
    radius: int,
    eps: float,
    subsample: int,
    halo: int,
    is_top: bool,
    is_bot: bool,
    d0: int,                   # global disparity of p_low's first slice
    interior: tuple[int, int], # (first row, rows) of the extended tile kept
    d_chunk: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused tile FGF + upsample + local WTA over a d block (the tile
    analog of `fgf_wta_low_maps`): q = up(a_r)*I0 + up(a_g)*I1 +
    up(a_b)*I2 + up(b) on the interior rows, folded over chunks of
    `d_chunk` disparities into a running (min, argmin) with a strict `<`,
    so ties keep the lowest disparity; global d = 0 never wins (the
    reference's WTA starts at 1). The filtered tile never exists. Plain
    torch after the chain (K1). Returns (min f32, global argmin int32),
    each (..., interior rows, W)."""
    He, W = guide_ext.shape[-3:-1]
    s = subsample
    _check_tile(He, W, s, halo)
    maps = tile_low_maps(guide_ext, p_low, 2 * (radius // s) + 1, eps)
    Db = maps.shape[-3]
    if Db % d_chunk:
        d_chunk = Db
    r0, nr = interior
    lead = maps.shape[:-4]
    ch = [guide_ext[..., r0:r0 + nr, :, c].unsqueeze(-3) for c in range(3)]

    def up(t):
        return _upsample_tile(t, (He, W), s, halo, is_top, is_bot, (r0, nr))

    best = torch.full((*lead, nr, W), float("inf"), device=maps.device)
    arg = torch.zeros((*lead, nr, W), dtype=torch.int32, device=maps.device)
    for dl in range(0, Db, d_chunk):
        blk = maps[..., dl:dl + d_chunk, :, :]
        q = up(blk[..., 0, :, :, :]) * ch[0]
        q = q + up(blk[..., 1, :, :, :]) * ch[1]
        q = q + up(blk[..., 2, :, :, :]) * ch[2]
        q = q + up(blk[..., 3, :, :, :])
        if d0 + dl == 0:
            q[..., 0, :, :] = float("inf")
        c_min, c_arg = q.min(dim=-3)                 # first minimum on ties
        take = c_min < best
        best = torch.where(take, c_min, best)
        arg = torch.where(take, (c_arg + (d0 + dl)).to(torch.int32), arg)
    return best, arg
