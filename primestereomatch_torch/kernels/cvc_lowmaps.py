"""K4: the sampled matching cost built inside the low-maps kernel (CUDA,
csrc/cvc_lowmaps.cu).

Replaces primestereomatch_tpu/kernels/cvc_lowmaps_pallas.py::
_cvc_lowmaps_kernel. The function reads the views, their gradients and the
guide statistics and writes the four coefficient maps per disparity, so on
the H100 the map writes bound it (bytes); the (D, h, w) cost volume never
exists in device memory. The TPU's polyphase planes, lane rotate and
in-kernel margin rebuild are gone: each entry of a block's shared-memory
band is the cost at the reflected in-image sample, read through the FGF's
sample tables.

Views come stacked, the B left views first and then the B right ones: view
v < B is matched against view v + B at x - d (border where x < d), view
v >= B against view v - B at x + d (border where x >= W - d).
"""

from __future__ import annotations

import ctypes
import math

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.kernels.lowmaps import MAX_K, low_maps_plain
from primestereomatch_torch.ops.cost_volume import sampled_cost_volumes
from primestereomatch_torch.ops.resize import nearest_table

MAX_GRID_Z = 65535   # CUDA's limit on the grid's z extent


def cvc_low_maps_plain(views: torch.Tensor, grds: torch.Tensor, stats: torch.Tensor,
                       max_dis: int, k: int, alpha: float = 0.9,
                       border_cost: float = 1.0, tau1: float | None = None,
                       tau2: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the sampled cost volumes, then
    K1's plain version."""
    p = sampled_cost_volumes(views, grds, max_dis, tuple(stats.shape[-2:]), alpha,
                             border_cost, tau1, tau2)
    return low_maps_plain(p, stats, k)


def check_views(views: torch.Tensor, grds: torch.Tensor, stats: torch.Tensor,
                max_dis: int, k: int) -> None:
    """Raise on what K4 and K10 do not take."""
    if views.dim() != 4 or views.shape[-1] != 3 or views.shape[0] % 2:
        raise ValueError(f"expected (2B, H, W, 3) stacked views, got {tuple(views.shape)}")
    B2, H, W, _ = views.shape
    if grds.shape != (B2, H, W):
        raise ValueError(f"gradients {tuple(grds.shape)} != {(B2, H, W)}")
    if stats.dim() != 4 or stats.shape[:2] != (B2, 12):
        raise ValueError(f"expected (2B, 12, h, w) stats, got {tuple(stats.shape)}")
    h, w = stats.shape[-2:]
    if not (1 <= h <= H and 1 <= w <= W):
        raise ValueError(f"low-res grid {h}x{w} does not fit the {H}x{W} image")
    if any(t.dtype != torch.float32 for t in (views, grds, stats)):
        raise TypeError("views, gradients and stats must be float32")
    if not 2 <= max_dis <= 256:
        raise ValueError(f"max_dis={max_dis} must be in [2, 256]")
    if k % 2 == 0 or not 1 <= k <= MAX_K:
        raise ValueError(f"box size k={k} must be odd and at most {MAX_K}")
    if min(h, w) <= 2 * (k // 2):
        raise ValueError(f"low-res grid {h}x{w} too small for a {k}x{k} box")
    if not (views.device == grds.device == stats.device):
        raise ValueError("views, gradients and stats must be on one device")
    if views.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {views.device}")
    if views.device.type == "cuda" and not (
            views.is_contiguous() and grds.is_contiguous() and stats.is_contiguous()):
        raise ValueError("views, gradients and stats must be contiguous")


def cost_args(alpha: float, border_cost: float, tau1: float | None,
              tau2: float | None) -> list:
    """The kernels' cost parameters as C floats. `1.0 - alpha` is rounded
    to float here, as the plain version's Python double is when it meets a
    float32 tensor; an absent clamp is +inf."""
    return [ctypes.c_float(v) for v in (
        alpha, 1.0 - alpha, border_cost,
        math.inf if tau1 is None else tau1, math.inf if tau2 is None else tau2)]


def cvc_low_maps(views: torch.Tensor, grds: torch.Tensor, stats: torch.Tensor,
                 max_dis: int, k: int, alpha: float = 0.9, border_cost: float = 1.0,
                 tau1: float | None = None, tau2: float | None = None) -> torch.Tensor:
    """(2B, H, W, 3) f32 stacked views + (2B, H, W) f32 Sobel-x gradients +
    (2B, 12, h, w) f32 guide stats -> (2B, 4, D, h, w) f32 box-averaged
    [a_r, a_g, a_b, b] of the cost sampled at the FGF grid. Launches the
    CUDA kernel for CUDA tensors; CPU tensors take the plain version."""
    check_views(views, grds, stats, max_dis, k)
    if views.device.type == "cpu":
        return cvc_low_maps_plain(views, grds, stats, max_dis, k, alpha, border_cost,
                                  tau1, tau2)
    B2, H, W, _ = views.shape
    h, w = stats.shape[-2:]
    if B2 * max_dis > MAX_GRID_Z:
        raise ValueError(f"{B2} views x {max_dis} disparities exceed one launch's grid")
    dev = views.device
    out = torch.empty((B2, 4, max_dis, h, w), dtype=torch.float32, device=dev)
    fn = _build.load("cvc_lowmaps")
    rc = fn(views.data_ptr(), grds.data_ptr(), stats.data_ptr(),
            nearest_table(H, h, dev, torch.int32).data_ptr(),
            nearest_table(W, w, dev, torch.int32).data_ptr(), out.data_ptr(),
            B2 // 2, max_dis, H, W, h, w, k, ctypes.c_float(1.0 / (k * k)),
            *cost_args(alpha, border_cost, tau1, tau2),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check("cvc_lowmaps", rc)
    _build.LAUNCHES["cvc_lowmaps"] += 1
    return out
