"""Cost volume construction (CVC) at the FGF sample grid.

Reference semantics (CPU float golden path, src/CVC.cpp:18-39,122-179):

  cost(d, y, x) = ALPHA * (|dB| + |dG| + |dR|) + (1-ALPHA) * |dGradX|

  left volume : matches L(y, x) against R(y, x-d);  x < d     -> border cost
  right volume: matches R(y, x) against L(y, x+d);  x >= W-d  -> border cost
  border cost : every operand of the other view replaced by BC = 1.0

`tau1`/`tau2` expose the OpenCL kernel's clamps (assets/cvc.cl). One
gather-based construction serves every geometry: the JAX package's
strided branch for exact-stride columns is bitwise-equal to its gather
branch and exists only to avoid gathers on the TPU.
"""

from __future__ import annotations

import torch

_D_CHUNK = 32  # disparities gathered at once; bounds the (D, h, w, 3) temporaries


def _pair_cost(a_img, b_img, a_grd, b_grd, alpha, tau1, tau2):
    d = (a_img - b_img).abs()
    clr = d[..., 0] + d[..., 1] + d[..., 2]
    grd = (a_grd - b_grd).abs()
    if tau1 is not None:
        clr = clr.clamp(max=tau1)
    if tau2 is not None:
        grd = grd.clamp(max=tau2)
    return alpha * clr + (1.0 - alpha) * grd


def build_cost_volumes_sampled(
    l_img: torch.Tensor,     # (H, W, 3) float32 in [0,1]
    r_img: torch.Tensor,
    l_grd: torch.Tensor,     # (H, W)
    r_grd: torch.Tensor,
    max_dis: int,
    yi,                      # (h,) row sample indices (int64 tensor or numpy)
    xi,                      # (w,) column sample indices
    alpha: float = 0.9,
    border_cost: float = 1.0,
    tau1: float | None = None,
    tau2: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cost volumes evaluated only at the (yi, xi) sample grid, the
    nearest-downsampled volumes the FastGuidedFilter consumes. The shifted
    column indices are made on the device, so indices already there cost
    no host-to-device copy. Returns ((D, h, w), (D, h, w)) float32."""
    H, W, _ = l_img.shape
    dev = l_img.device
    yi = torch.as_tensor(yi, dtype=torch.long, device=dev)
    xi = torch.as_tensor(xi, dtype=torch.long, device=dev)

    def pcost(a_img, b_img, a_grd, b_grd):
        return _pair_cost(a_img, b_img, a_grd, b_grd, alpha, tau1, tau2)

    l_rows, r_rows = l_img[yi], r_img[yi]        # (h, W, 3)
    lg_rows, rg_rows = l_grd[yi], r_grd[yi]      # (h, W)
    l_s, r_s = l_rows[:, xi], r_rows[:, xi]      # (h, w, 3)
    lg_s, rg_s = lg_rows[:, xi], rg_rows[:, xi]

    l_border = pcost(l_s, torch.full_like(l_s, border_cost),
                     lg_s, torch.full_like(lg_s, border_cost))
    r_border = pcost(r_s, torch.full_like(r_s, border_cost),
                     rg_s, torch.full_like(rg_s, border_cost))

    def shifted(rows, grd_rows, cols):
        # cols (dc, w) -> other view sampled there, as (dc, h, w, 3), (dc, h, w)
        return rows[:, cols].movedim(1, 0), grd_rows[:, cols].movedim(1, 0)

    l_parts, r_parts = [], []
    xs = xi[None, None, :]                                       # (1, 1, w)
    for d0 in range(0, max_dis, _D_CHUNK):
        d = torch.arange(d0, min(d0 + _D_CHUNK, max_dis), device=dev)[:, None]  # (dc, 1)
        dt = d[:, :, None]                                       # (dc, 1, 1)
        xb = (xi[None] - d).clamp(0, W - 1)
        rb, rgb = shifted(r_rows, rg_rows, xb)
        cl = pcost(l_s[None], rb, lg_s[None], rgb)
        l_parts.append(torch.where(xs >= dt, cl, l_border[None]))
        xf = (xi[None] + d).clamp(0, W - 1)
        lb, lgb = shifted(l_rows, lg_rows, xf)
        cr = pcost(r_s[None], lb, rg_s[None], lgb)
        r_parts.append(torch.where(xs < W - dt, cr, r_border[None]))
    return torch.cat(l_parts), torch.cat(r_parts)
