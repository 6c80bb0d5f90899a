"""K10: cost, coefficient chain, upsample, guide combine and WTA in one
kernel (CUDA, csrc/cvc_wta.cu): the `tail_fusion='full'` tail.

Replaces primestereomatch_tpu/kernels/cvc_wta_pallas.py::_cvc_wta_kernel
and ::_cvc_wta_kernel_fori (two schedules of one function there). It reads
the views, their gradients and the guide statistics and writes uint8
disparities; neither the cost volume nor the (4, D, h, w) maps exist in
device memory, so arithmetic bounds it on the H100. One block per 64 x 64
output tile loops over d, rebuilding the tile's map window in shared
memory (the chain of csrc/fgf_chain.cuh, its box size a template argument
for k = 3, 5, 9, 17) and folding the argmin in registers. Its result
equals K4 followed by K2 bit for bit; d = 0 is skipped and the tables are
clamped at every column, so the TPU kernel's d = 0 poison and left-edge
fix-up are gone.
"""

from __future__ import annotations

import ctypes

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.kernels.cvc_lowmaps import (
    MAX_GRID_Z,
    check_views,
    cost_args,
    cvc_low_maps_plain,
)
from primestereomatch_torch.kernels.lowmaps import chain_smem_bytes
from primestereomatch_torch.kernels.wta import upsample_wta_plain
from primestereomatch_torch.ops.resize import linear_tables, low_window, nearest_table

TILE = 64   # output pixels per block edge (csrc/cvc_wta.cu::OT)


def smem_bytes(lth: int, ltw: int, k: int) -> int:
    """Shared memory of a K10 block whose tile spans lth x ltw low-res
    pixels (csrc/cvc_wta.cu::smem_floats): the chain's, the four finished
    map tiles, the staged local view and positions of the band (6 words an
    entry), and the output rows' tap tables."""
    band = (lth + 4 * (k // 2)) * (ltw + 4 * (k // 2))
    return chain_smem_bytes(lth, ltw, k) + 4 * (4 * lth * ltw + 6 * band) + 3 * 4 * TILE


def cvc_wta_plain(views: torch.Tensor, grds: torch.Tensor, stats: torch.Tensor,
                  max_dis: int, k: int, alpha: float = 0.9, border_cost: float = 1.0,
                  tau1: float | None = None, tau2: float | None = None,
                  d_chunk: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: K4's plain version, then K2's;
    `d_chunk` bounds the upsampled temporaries."""
    maps = cvc_low_maps_plain(views, grds, stats, max_dis, k, alpha, border_cost,
                              tau1, tau2)
    return upsample_wta_plain(views, maps, d_chunk=d_chunk)


def cvc_wta(views: torch.Tensor, grds: torch.Tensor, stats: torch.Tensor,
            max_dis: int, k: int, alpha: float = 0.9, border_cost: float = 1.0,
            tau1: float | None = None, tau2: float | None = None) -> torch.Tensor:
    """(2B, H, W, 3) f32 stacked views (the B left ones first) + (2B, H, W)
    f32 Sobel-x gradients + (2B, 12, h, w) f32 guide stats -> (2B, H, W)
    uint8 disparities in [1, D). Launches the CUDA kernel for CUDA tensors;
    CPU tensors take the plain version."""
    check_views(views, grds, stats, max_dis, k)
    if views.device.type == "cpu":
        return cvc_wta_plain(views, grds, stats, max_dis, k, alpha, border_cost,
                             tau1, tau2)
    B2, H, W, _ = views.shape
    h, w = stats.shape[-2:]
    if B2 > MAX_GRID_Z:
        raise ValueError(f"{B2} views exceed one launch's grid")
    dev = views.device
    ly0, _, lyf = linear_tables(h, H, dev, torch.int32)
    lx0, _, lxf = linear_tables(w, W, dev, torch.int32)
    lth, ltw = low_window(h, H, TILE), low_window(w, W, TILE)
    if smem_bytes(lth, ltw, k) > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"a {TILE}x{TILE} output tile spans {lth}x{ltw} low-res pixels; with a "
            f"{k}x{k} box that needs more shared memory than the card gives a block"
        )
    out = torch.empty((B2, H, W), dtype=torch.uint8, device=dev)
    fn = _build.load("cvc_wta")
    rc = fn(views.data_ptr(), grds.data_ptr(), stats.data_ptr(),
            nearest_table(H, h, dev, torch.int32).data_ptr(),
            nearest_table(W, w, dev, torch.int32).data_ptr(),
            ly0.data_ptr(), lyf.data_ptr(), lx0.data_ptr(), lxf.data_ptr(),
            out.data_ptr(), B2 // 2, max_dis, H, W, h, w, k,
            ctypes.c_float(1.0 / (k * k)), lth, ltw,
            *cost_args(alpha, border_cost, tau1, tau2),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check("cvc_wta", rc)
    _build.LAUNCHES["cvc_wta"] += 1
    return out
