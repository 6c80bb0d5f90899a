"""K10: cost, coefficient chain, upsample, guide combine and WTA in one
kernel (CUDA, csrc/cvc_wta.cu): the `tail_fusion='full'` tail.

Replaces primestereomatch_tpu/kernels/cvc_wta_pallas.py::_cvc_wta_kernel
and ::_cvc_wta_kernel_fori (two schedules of one function there). It reads
the views, their gradients and the guide statistics and writes uint8
disparities; neither the cost volume nor the (4, D, h, w) maps exist in
device memory, so arithmetic bounds it on the H100. A block of 512 threads
owns an output tile of `rows` x 128 pixels (`plan_tile`) and loops over d,
two disparities at a time where they fit: each half of the block runs
K4's staged samples and chain (csrc/fgf_chain.cuh, its box size a template
argument for k = 3, 5, 9, 17) for its own d into its own map planes in
shared memory, then the block row-lerps them once per (output row, window
column) as K2 does, and each thread folds the column lerp, guide combine
and argmin of its pixels in registers. Its result
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

# csrc/cvc_wta.cu's shape (PSM_K10_OTX, PSM_K10_NT, MAX_OTY); change both together
TILE_X = 128                 # output columns a tile
THREADS = 512
TILE_ROWS = (64, 32, 16)     # output rows a tile, the largest first
MAX_ROWS = 64                # the row-lerp rows a group keeps (MAX_OTY)
GROUPS = (2, 1)              # chains a block runs at once, the most first
TABLES = 4 * (4 * MAX_ROWS + 2)   # the output rows' tables (static shared memory)


def smem_bytes(lth: int, ltw: int, k: int, groups: int) -> int:
    """Shared memory of a K10 block whose tile's taps span lth x ltw
    low-res pixels (csrc/cvc_wta.cu::smem_floats): per group of warps the
    chain's, the four finished map planes and the row-lerped float4 of
    MAX_ROWS output rows; the staged samples of the band (a float4 and a
    packed position each) and the rows' tables."""
    band = (lth + 4 * (k // 2)) * (ltw + 4 * (k // 2))
    return (groups * (chain_smem_bytes(lth, ltw, k) + 16 * lth * ltw + 16 * MAX_ROWS * ltw)
            + 20 * band + TABLES)


def plan_tile(h: int, w: int, H: int, W: int, k: int, n_views: int,
              sm_count: int) -> tuple[int, int, int, int]:
    """(output rows a tile, groups, lth, ltw) of a K10 launch at maps
    h x w -> image H x W. Of the tile heights whose block fits a block's
    shared memory, the one that takes the fewest waves of blocks (one block
    an SM) times a block's work per disparity: its band entries, plus its
    pixels at a twentieth of an entry each (the column lerp against the
    chain); two chains at once where they fit. Raises where no tile fits."""
    best = None
    for rows in TILE_ROWS:
        lth, ltw = low_window(h, H, rows), low_window(w, W, TILE_X)
        fits = [g for g in GROUPS if smem_bytes(lth, ltw, k, g) <= _build.MAX_SMEM_BYTES]
        if not fits:
            continue
        blocks = -(-W // TILE_X) * -(-H // rows) * n_views
        band = (lth + 4 * (k // 2)) * (ltw + 4 * (k // 2))
        cost = -(-blocks // sm_count) * (band + rows * TILE_X / 20)
        if best is None or cost < best[0]:
            best = (cost, rows, fits[0], lth, ltw)
    if best is None:
        raise ValueError(
            f"every {TILE_X}-column tile from {H}x{W} spans more low-res pixels of the "
            f"{h}x{w} maps than a {k}x{k} box's chain fits in the shared memory the card "
            f"gives a block")
    return best[1:]


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
    if max(H, W) >= 2**16:
        raise ValueError(f"image {H}x{W}: K10 takes sides below 65536")
    rows, groups, _, _ = plan_tile(
        h, w, H, W, k, B2, torch.cuda.get_device_properties(views.device).multi_processor_count)
    return launch(_build.load("cvc_wta"), views, grds, stats, max_dis, k, rows, groups, alpha,
                  border_cost, tau1, tau2)


def launch(fn, views: torch.Tensor, grds: torch.Tensor, stats: torch.Tensor, max_dis: int,
           k: int, rows: int, groups: int, alpha: float = 0.9, border_cost: float = 1.0,
           tau1: float | None = None, tau2: float | None = None,
           tile_x: int = TILE_X) -> torch.Tensor:
    """K10 through the C entry `fn` with tiles of `rows` x `tile_x` output
    pixels (`tile_x` is the library's PSM_K10_OTX) and `groups` chains at
    once."""
    B2, H, W, _ = views.shape
    h, w = stats.shape[-2:]
    dev = views.device
    ly0, _, lyf = linear_tables(h, H, dev, torch.int32)
    lx0, _, lxf = linear_tables(w, W, dev, torch.int32)
    lth, ltw = low_window(h, H, rows), low_window(w, W, tile_x)
    out = torch.empty((B2, H, W), dtype=torch.uint8, device=dev)
    rc = fn(views.data_ptr(), grds.data_ptr(), stats.data_ptr(),
            nearest_table(H, h, dev, torch.int32).data_ptr(),
            nearest_table(W, w, dev, torch.int32).data_ptr(),
            ly0.data_ptr(), lyf.data_ptr(), lx0.data_ptr(), lxf.data_ptr(),
            out.data_ptr(), B2 // 2, max_dis, H, W, h, w, k,
            ctypes.c_float(1.0 / (k * k)), lth, ltw, rows, groups,
            *cost_args(alpha, border_cost, tau1, tau2),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check("cvc_wta", rc)
    _build.LAUNCHES["cvc_wta"] += 1
    return out
