"""K4: the sampled matching cost built inside the low-maps kernel (CUDA,
csrc/cvc_lowmaps.cu).

Replaces primestereomatch_tpu/kernels/cvc_lowmaps_pallas.py::
_cvc_lowmaps_kernel. The function reads the views, their gradients and the
guide statistics and writes the four coefficient maps per disparity, so on
the H100 the map writes bound the function (bytes); the (D, h, w) cost
volume never exists in device memory. The TPU's polyphase planes, lane
rotate and in-kernel margin rebuild are gone: each entry of a block's
shared-memory band is the cost at the reflected in-image sample, read
through the FGF's sample tables. A block takes a 32 x 32 tile of one view
and a chunk of disparities (`plan_chunks`): it stages the tile's local-view
samples once and runs cost band, chain (csrc/fgf_chain.cuh) and map writes
for each d of the chunk.

Views come stacked, the B left views first and then the B right ones: view
v < B is matched against view v + B at x - d (border where x < d), view
v >= B against view v - B at x + d (border where x >= W - d).
"""

from __future__ import annotations

import ctypes
import math

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.kernels.lowmaps import (
    MAX_K,
    TILE,
    chain_smem_bytes,
    low_maps_plain,
)
from primestereomatch_torch.ops.cost_volume import sampled_cost_volumes
from primestereomatch_torch.ops.resize import nearest_table

MAX_GRID_Z = 65535   # CUDA's limit on the grid's z extent
MAX_CHUNK = 16       # disparities a block takes at most


def smem_bytes(k: int) -> int:
    """Shared memory of a K4 block (csrc/cvc_lowmaps.cu::smem_floats): the
    chain's and, where they fit beside it, the staged samples of the band
    (a float4 of the local view and a packed position each)."""
    chain = chain_smem_bytes(TILE, TILE, k)
    staged = chain + 20 * (TILE + 4 * (k // 2)) ** 2
    return staged if staged <= _build.MAX_SMEM_BYTES else chain


def plan_chunks(n_views: int, max_dis: int, h: int, w: int, k: int,
                sm_count: int) -> tuple[int, tuple[int, int, int]]:
    """(disparities per block, grid) of a K4 launch. A longer chunk shares
    the staged samples among more disparities; it is cut, down to 1, until
    the launch holds two blocks for every block the card runs at once, so
    that a small image still fills it. Raises where views x chunks exceed
    the grid's z extent."""
    tiles = -(-h // TILE) * -(-w // TILE)
    resident = sm_count * max(1, _build.SM_SMEM_BYTES // (smem_bytes(k) + 1024))
    chunk = max(1, min(MAX_CHUNK, max_dis, tiles * n_views * max_dis // (2 * resident)))
    grid = (-(-w // TILE), -(-h // TILE), n_views * -(-max_dis // chunk))
    if grid[2] > MAX_GRID_Z:
        raise ValueError(f"{n_views} views x {-(-max_dis // chunk)} chunks of disparities "
                         f"exceed one launch's grid")
    return chunk, grid


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
    if max(H, W) >= 2**16:
        raise ValueError(f"image {H}x{W}: K4 takes sides below 65536")
    dev = views.device
    chunk, _ = plan_chunks(B2, max_dis, h, w, k,
                           torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((B2, 4, max_dis, h, w), dtype=torch.float32, device=dev)
    fn = _build.load("cvc_lowmaps")
    rc = fn(views.data_ptr(), grds.data_ptr(), stats.data_ptr(),
            nearest_table(H, h, dev, torch.int32).data_ptr(),
            nearest_table(W, w, dev, torch.int32).data_ptr(), out.data_ptr(),
            B2 // 2, max_dis, H, W, h, w, k, ctypes.c_float(1.0 / (k * k)), chunk,
            *cost_args(alpha, border_cost, tau1, tau2),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check("cvc_lowmaps", rc)
    _build.LAUNCHES["cvc_lowmaps"] += 1
    return out
