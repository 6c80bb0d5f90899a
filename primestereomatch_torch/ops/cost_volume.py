"""Cost volume construction (CVC), at the FGF sample grid or in full.

Reference semantics (CPU float golden path, src/CVC.cpp:18-39,122-179):

  cost(d, y, x) = ALPHA * (|dB| + |dG| + |dR|) + (1-ALPHA) * |dGradX|

  left volume : matches L(y, x) against R(y, x-d);  x < d     -> border cost
  right volume: matches R(y, x) against L(y, x+d);  x >= W-d  -> border cost
  border cost : every operand of the other view replaced by BC = 1.0

`tau1`/`tau2` expose the OpenCL kernel's clamps (assets/cvc.cl). One
gather-based construction serves every geometry: the JAX package's
strided branch for exact-stride columns is bitwise-equal to its gather
branch and exists only to avoid gathers on the TPU. The full volume is the
same construction on the grid of every pixel.

The uint8 variant (`cvc_dtype='u8'`) is the reference's uchar OpenCL cost
(assets/cvc.cl:42-126, cvc_uchar_vx): integer colour sum / 3, the TAU_US
clamps, a float multiply truncated to uint8, and 255 for every operand of
the other view out of range. It is integer and bitwise.
"""

from __future__ import annotations

import torch

from primestereomatch_torch.ops.resize import nearest_table
from primestereomatch_torch.utils.device import device_table

_D_CHUNK = 32  # disparities gathered at once; bounds the (D, h, w, 3) temporaries
TAU1_US, TAU2_US = 1835, 524  # assets/cvc.cl:26-27 (0.028 and 0.008 of USHRT_MAX)


def _pair_cost(a_img, b_img, a_grd, b_grd, alpha, tau1, tau2):
    d = (a_img - b_img).abs()
    clr = d[..., 0] + d[..., 1] + d[..., 2]
    grd = (a_grd - b_grd).abs()
    if tau1 is not None:
        clr = clr.clamp(max=tau1)
    if tau2 is not None:
        grd = grd.clamp(max=tau2)
    return alpha * clr + (1.0 - alpha) * grd


def _pair_cost_u8(a_img, b_img, a_grd, b_grd, alpha, tau1_us, tau2_us):
    # integer operands; float multiply, then the C cast's truncation (costs >= 0)
    d = (a_img - b_img).abs()
    clr = ((d[..., 0] + d[..., 1] + d[..., 2]) // 3).clamp(max=tau1_us)
    grd = (a_grd - b_grd).abs().clamp(max=tau2_us)
    return (alpha * clr.to(torch.float32)
            + (1.0 - alpha) * grd.to(torch.float32)).to(torch.uint8)


def _sampled(l_img, r_img, l_grd, r_grd, max_dis, yi, xi, pcost, border):
    """Both volumes at the (yi, xi) grid: `pcost(a_img, b_img, a_grd,
    b_grd)` per disparity, `border` for the other view's operands out of
    range. Returns ((D, h, w), (D, h, w))."""
    H, W, _ = l_img.shape
    dev = l_img.device
    yi = torch.as_tensor(yi, dtype=torch.long, device=dev)
    xi = torch.as_tensor(xi, dtype=torch.long, device=dev)

    l_rows, r_rows = l_img[yi], r_img[yi]        # (h, W, 3)
    lg_rows, rg_rows = l_grd[yi], r_grd[yi]      # (h, W)
    l_s, r_s = l_rows[:, xi], r_rows[:, xi]      # (h, w, 3)
    lg_s, rg_s = lg_rows[:, xi], rg_rows[:, xi]

    l_border = pcost(l_s, torch.full_like(l_s, border), lg_s, torch.full_like(lg_s, border))
    r_border = pcost(r_s, torch.full_like(r_s, border), rg_s, torch.full_like(rg_s, border))

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
    def pcost(a_img, b_img, a_grd, b_grd):
        return _pair_cost(a_img, b_img, a_grd, b_grd, alpha, tau1, tau2)

    return _sampled(l_img, r_img, l_grd, r_grd, max_dis, yi, xi, pcost, border_cost)


def build_cost_volumes(
    l_img: torch.Tensor,     # (H, W, 3) float32 in [0,1]
    r_img: torch.Tensor,
    l_grd: torch.Tensor,     # (H, W) Sobel-x of gray
    r_grd: torch.Tensor,
    max_dis: int,
    alpha: float = 0.9,
    border_cost: float = 1.0,
    tau1: float | None = None,
    tau2: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-resolution volumes ((D, H, W), (D, H, W)) float32, d = 0
    included as the reference builds it (src/DispEst.cpp:209-218)."""
    H, W, _ = l_img.shape
    dev = l_img.device
    return build_cost_volumes_sampled(
        l_img, r_img, l_grd, r_grd, max_dis, torch.arange(H, device=dev),
        torch.arange(W, device=dev), alpha, border_cost, tau1, tau2)


def build_cost_volumes_u8_sampled(
    l_bgr_u8: torch.Tensor,  # (H, W, 3) uint8 (BGR as loaded)
    r_bgr_u8: torch.Tensor,
    l_grd_u8: torch.Tensor,  # (H, W) uint8 saturated Sobel (ops/color.py)
    r_grd_u8: torch.Tensor,
    max_dis: int,
    yi,
    xi,
    alpha: float = 0.9,
    tau1_us: int = TAU1_US,
    tau2_us: int = TAU2_US,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The uint8 volumes at the (yi, xi) grid, bitwise equal to the full
    ones sampled there. Returns ((D, h, w), (D, h, w)) uint8."""
    def pcost(a_img, b_img, a_grd, b_grd):
        return _pair_cost_u8(a_img, b_img, a_grd, b_grd, alpha, tau1_us, tau2_us)

    # int16 holds every intermediate: |a - b| <= 255, a colour sum <= 765
    i16 = [t.to(torch.int16) for t in (l_bgr_u8, r_bgr_u8, l_grd_u8, r_grd_u8)]
    return _sampled(*i16, max_dis, yi, xi, pcost, 255)


def build_cost_volumes_u8(
    l_bgr_u8: torch.Tensor,
    r_bgr_u8: torch.Tensor,
    l_grd_u8: torch.Tensor,
    r_grd_u8: torch.Tensor,
    max_dis: int,
    alpha: float = 0.9,
    tau1_us: int = TAU1_US,
    tau2_us: int = TAU2_US,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-resolution uint8 volumes ((D, H, W), (D, H, W))."""
    H, W, _ = l_bgr_u8.shape
    dev = l_bgr_u8.device
    return build_cost_volumes_u8_sampled(
        l_bgr_u8, r_bgr_u8, l_grd_u8, r_grd_u8, max_dis, torch.arange(H, device=dev),
        torch.arange(W, device=dev), alpha, tau1_us, tau2_us)


def _stacked(views, grds, max_dis, low_hw, build):
    """Fold the B pairs of the stacked views (2B, H, W, ...) into the row
    axis, build both volumes at the nearest-downsample grid with `build`,
    and unfold: (2B, D, h, w), view v < B matched against view v + B."""
    B2, H, W = views.shape[:3]
    B = B2 // 2
    h, w = low_hw
    dev = views.device
    yi = nearest_table(H, h, dev)
    yi_b = (yi[None, :] + H * torch.arange(B, device=dev)[:, None]).reshape(-1)
    lcv, rcv = build(
        views[:B].reshape(B * H, W, 3), views[B:].reshape(B * H, W, 3),
        grds[:B].reshape(B * H, W), grds[B:].reshape(B * H, W),
        max_dis, yi_b, nearest_table(W, w, dev),
    )
    return torch.cat([
        cv.reshape(max_dis, B, h, w).movedim(1, 0) for cv in (lcv, rcv)
    ])


def sampled_cost_volumes(
    views: torch.Tensor,     # (2B, H, W, 3): the B left views, then the B right ones
    grds: torch.Tensor,      # (2B, H, W) their Sobel-x gradients
    max_dis: int,
    low_hw: tuple[int, int],
    alpha: float = 0.9,
    border_cost: float = 1.0,
    tau1: float | None = None,
    tau2: float | None = None,
) -> torch.Tensor:
    """The stacked views' cost volumes at the FGF's nearest-downsample
    grid: (2B, D, h, w), view v < B matched against view v + B and back.
    The cost is row-local, so the B pairs fold into the row axis and one
    gather-based construction serves them all, bitwise equal to pair by
    pair."""
    def build(*args):
        return build_cost_volumes_sampled(*args, alpha=alpha, border_cost=border_cost,
                                          tau1=tau1, tau2=tau2)

    return _stacked(views, grds, max_dis, low_hw, build)


def sampled_cost_volumes_u8(
    views_u8: torch.Tensor,  # (2B, H, W, 3) uint8, lefts first
    grds_u8: torch.Tensor,   # (2B, H, W) uint8 saturated Sobel-x
    max_dis: int,
    low_hw: tuple[int, int],
    alpha: float = 0.9,
) -> torch.Tensor:
    """The stacked views' uint8 volumes at the FGF's nearest-downsample
    grid, (2B, D, h, w): bitwise the full volumes (0.7 GB a view at 2K,
    D = 256) nearest-downsampled, which are never built."""
    def build(*args):
        return build_cost_volumes_u8_sampled(*args, alpha=alpha)

    return _stacked(views_u8, grds_u8, max_dis, low_hw, build)


def unit_cost(cost_u8: torch.Tensor) -> torch.Tensor:
    """uint8 costs / 255 as float32, IEEE-rounded quotients like the JAX
    package's `astype(float32) / 255.0`. The divisor is a 0-d tensor on
    the device: CUDA torch turns a division by a Python number into a
    multiply by its reciprocal, which rounds some quotients differently."""
    den = device_table(("u8_cost_scale",), lambda: 255.0, cost_u8.device, torch.float32)
    return cost_u8.to(torch.float32) / den
