"""Disparity post-processing tools: LR consistency, invalid fill and the
bilateral weighted median (port of the JAX package's ops/postproc.py; the
reference's PP toolbox, src/PP.cpp). `GIFConfig(pp_toolchain=True)` runs
them ahead of JointWMF, as the reference's commented-out toolchain does
(src/PP.cpp:405-413).

Reference quirks kept: lrCheck wraps its lookups with `% wid`
(src/PP.cpp:32,41); wgtMedian wraps its window (`% wid`, `% hei`,
src/PP.cpp:165,169), here a roll; the left map's wgtMedian puts squared
distances in the exponent and the right map's their square roots
(src/PP.cpp:172-177 vs 218-225), selected by `use_sqrt`.

`lr_check` and `fill_invalid` are integer and bitwise. `weighted_median`
sums each bin over the window offsets in row-major order and the bins
cumulatively one after the other, in float32.
"""

from __future__ import annotations

import torch

from primestereomatch_torch.ops.jointwmf import median_from_hist


def lr_check(l_disp: torch.Tensor, r_disp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Left-right consistency (src/PP.cpp:17-50) over the last two axes:

    valid_left(x)  = lDis(x) == rDis((x - lDis(x)) mod W) and lDis(x) >= 2
    valid_right(x) = rDis(x) == lDis((x + rDis(x)) mod W) and rDis(x) >= 2

    Returns uint8 0/1 maps."""
    W = l_disp.shape[-1]
    x = torch.arange(W, device=l_disp.device)
    ld = l_disp.to(torch.int64)
    rd = r_disp.to(torch.int64)
    l_valid = (ld == rd.gather(-1, (x - ld) % W)) & (ld >= 2)
    r_valid = (rd == ld.gather(-1, (x + rd) % W)) & (rd >= 2)
    return l_valid.to(torch.uint8), r_valid.to(torch.uint8)


def fill_invalid(disp: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fill each invalid pixel with min(nearest valid to the left, nearest
    valid to the right) along its row, or the one that exists; a row with
    none keeps its values (src/PP.cpp:52-143). The reference's while-scans
    are a running max of the valid column index forward and a running min
    backward."""
    W = disp.shape[-1]
    v = valid.to(torch.bool)
    x = torch.arange(W, device=disp.device)
    left_idx = torch.where(v, x, -1).cummax(-1).values
    right_idx = torch.where(v, x, W).flip(-1).cummin(-1).values.flip(-1)
    l_find = left_idx >= 0
    r_find = right_idx < W
    d = disp.to(torch.int64)
    l_val = d.gather(-1, left_idx.clamp(0, W - 1))
    r_val = d.gather(-1, right_idx.clamp(0, W - 1))
    fill = torch.where(l_find & r_find, torch.minimum(l_val, r_val),
                       torch.where(l_find, l_val, torch.where(r_find, r_val, d)))
    return torch.where(v, d, fill).to(disp.dtype)


def weighted_median(
    img: torch.Tensor,       # (H, W, 3) float32 in [0,1]
    disp: torch.Tensor,      # (H, W) uint8
    valid: torch.Tensor,     # (H, W) uint8; only invalid pixels are filtered
    max_dis: int,
    med_sz: int = 19,
    sig_clr: float = 0.1,
    sig_dis: float = 9.0,
    use_sqrt: bool = False,
) -> torch.Tensor:
    """Bilateral-weighted median over a (med_sz x med_sz) wrapped window of
    the pixels with nonzero disparity; replaces only invalid pixels
    (src/PP.cpp:145-247). biWgt = exp(-disTerm / SIG_DIS^2 - clrTerm /
    SIG_CLR^2), the terms squared distances or (use_sqrt) their roots.
    Output at an invalid p: the smallest d whose cumulative weight reaches
    half the total.

    Each window offset adds its weight to one bin per pixel
    (`scatter_add_`), offset after offset: the per-bin sums of the JAX
    package's compare-and-add over every bin, without its max_dis-fold
    work. The weights of a window row's 2r+1 offsets are computed at once,
    element by element as one offset at a time would."""
    H, W = disp.shape
    r = med_sz // 2
    dev = disp.device
    # the image wrapped by r on every side: [y + r + wy, x + r + wx] is
    # pixel ((y + wy) % H, (x + wx) % W)
    rows = torch.arange(-r, H + r, device=dev) % H
    cols = torch.arange(-r, W + r, device=dev) % W
    chan = img.movedim(-1, 0)                        # (3, H, W)
    d_pad = disp.to(torch.int64).index_select(0, rows).index_select(1, cols)
    c_pad = chan.index_select(1, rows).index_select(2, cols)
    inv_sig_dis2 = 1.0 / (sig_dis * sig_dis)
    inv_sig_clr2 = 1.0 / (sig_clr * sig_clr)
    hist = torch.zeros((max_dis, H, W), dtype=torch.float32, device=dev)
    for wy in range(-r, r + 1):
        # [y, k, x]: the neighbour (y + wy, x + k - r) for every k at once
        d_q = d_pad[r + wy:r + wy + H].unfold(-1, W, 1)                 # (H, 2r+1, W)
        diff = chan[:, :, None, :] - c_pad[:, r + wy:r + wy + H].unfold(-1, W, 1)
        clr_term = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
        # float32 squared distances, as the JAX op casts its integer ones
        dis_term = torch.tensor([wy * wy + wx * wx for wx in range(-r, r + 1)],
                                dtype=torch.float32, device=dev)
        if use_sqrt:
            dis_term = dis_term.sqrt()
            clr_term = clr_term.sqrt()
        w = torch.exp((-dis_term * inv_sig_dis2)[:, None] - clr_term * inv_sig_clr2)
        # d_q == 0 and d_q >= max_dis add an exact +0.0
        w = w * ((d_q != 0) & (d_q < max_dis))
        bins = d_q.clamp(max=max_dis - 1)
        for k in range(2 * r + 1):
            hist.scatter_add_(0, bins[None, :, k], w[None, :, k])
    med = median_from_hist(hist).to(disp.dtype)
    return torch.where(valid.to(torch.bool), disp, med)
