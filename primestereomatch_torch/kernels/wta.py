"""K2: bilinear upsample of the maps + guide combine + first-minimum WTA
over d >= 1 (CUDA, csrc/wta.cu).

Replaces primestereomatch_tpu/kernels/wta_pallas.py::_wta_kernel_poly and
::_wta_kernel (the TPU's generic kernel for the column ratios its polyphase
layout rejects: below 2, above 8, or 1 at subsample=1). Bound on the H100
about equally by reading the maps and by the lerp and combine arithmetic
(bytes at Teddy's shape, operations at 2K); the filtered full-resolution
volume never exists. The OpenCV INTER_LINEAR tables serve every ratio, so
the TPU's quasi/exact polyphase modes and its banded-matmul generic kernel
collapse into two kernels of one file, chosen from the tables
(`staged_window`): where the low-res window of a 64 x 16 output tile is
small (ratios above 2) a block stages it in shared memory, row-lerps it
once per chunk of 8 disparities and lets each thread column-lerp and fold
4 pixels from it; at the other ratios (1 at subsample=1) one thread per
output pixel lerps its own 2x2 taps.
"""

from __future__ import annotations

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.ops.guided_filter import fgf_wta_low_maps
from primestereomatch_torch.ops.resize import linear_tables, low_window

# the staged kernel's shape (csrc/wta.cu: PSM_WTA_TX, _TY, _DC, _STAGES and
# its 256 threads); change both together
TILE_X, TILE_Y = 64, 16     # output pixels per block
D_CHUNK = 8                 # disparities staged at a time
STAGES = 1                  # raw windows in shared memory
THREADS = 256
BLOCKS_PER_SM = 3           # what the kernel's registers are bounded for (PSM_WTA_MINB)
WINDOW_PER_THREAD = 2       # window entries a thread copies per map plane


def staged_smem_bytes(lth: int, ltw: int) -> int:
    """Shared memory of a staged block whose window is lth x ltw: the raw
    windows (4 maps x D_CHUNK disparities, STAGES of them), the row-lerped
    float4 entries of its TILE_Y rows, and the rows' tap tables."""
    return (4 * STAGES * 4 * D_CHUNK * lth * ltw + 16 * D_CHUNK * TILE_Y * ltw
            + 3 * 4 * TILE_Y)


def staged_window(h: int, w: int, H: int, W: int) -> tuple[int, int] | None:
    """The low-res window (rows, columns) of the staged kernel's tiles at
    maps h x w -> image H x W, or None where the per-pixel kernel serves:
    where the window is so large (ratios of about 2 and below) that an SM's
    shared memory holds fewer blocks than its registers do, or that it
    holds more entries than a block's threads copy at a time."""
    lth, ltw = low_window(h, H, TILE_Y), low_window(w, W, TILE_X)
    if lth * ltw > WINDOW_PER_THREAD * THREADS:
        return None
    if BLOCKS_PER_SM * (staged_smem_bytes(lth, ltw) + 1024) > _build.SM_SMEM_BYTES:
        return None
    return lth, ltw


def upsample_wta_plain(guide: torch.Tensor, maps: torch.Tensor,
                       d_chunk: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, view by view; `d_chunk` bounds
    the upsampled temporaries."""
    H, W = guide.shape[1:3]
    return torch.stack([
        fgf_wta_low_maps(g, tuple(m[:3]), m[3], (H, W), d_chunk=d_chunk)
        for g, m in zip(guide, maps)
    ])


def upsample_wta(guide: torch.Tensor, maps: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) f32 guide + (B, 4, D, h, w) f32 maps -> (B, H, W)
    uint8 disparities in [1, D). Launches one of the two CUDA kernels
    (`staged_window`) for CUDA tensors; CPU tensors take the plain version."""
    if guide.dim() != 4 or guide.shape[-1] != 3 or maps.dim() != 5 or maps.shape[1] != 4:
        raise ValueError(f"expected (B,H,W,3) guide and (B,4,D,h,w) maps, got "
                         f"{tuple(guide.shape)}, {tuple(maps.shape)}")
    B, H, W, _ = guide.shape
    _, _, D, h, w = maps.shape
    if maps.shape[0] != B:
        raise ValueError("guide and maps batch sizes differ")
    if guide.dtype != torch.float32 or maps.dtype != torch.float32:
        raise TypeError("guide and maps must be float32")
    if not 2 <= D <= 256:
        raise ValueError(f"D={D} must be in [2, 256] for uint8 disparities")
    if guide.device != maps.device:
        raise ValueError("guide and maps must be on one device")
    if guide.device.type == "cpu":
        return upsample_wta_plain(guide, maps)
    if guide.device.type != "cuda":
        raise ValueError(f"unsupported device {guide.device}")
    if not (guide.is_contiguous() and maps.is_contiguous()):
        raise ValueError("guide and maps must be contiguous")
    yi, _, yf = linear_tables(h, H, guide.device, torch.int32)
    xi, _, xf = linear_tables(w, W, guide.device, torch.int32)
    out = torch.empty((B, H, W), dtype=torch.uint8, device=guide.device)
    lth, ltw = staged_window(h, w, H, W) or (0, 0)
    fn = _build.load("wta")
    rc = fn(maps.data_ptr(), guide.data_ptr(), yi.data_ptr(), yf.data_ptr(),
            xi.data_ptr(), xf.data_ptr(), out.data_ptr(), B, D, h, w, H, W, lth, ltw,
            torch.cuda.current_stream(guide.device).cuda_stream)
    _build.check("wta", rc)
    _build.LAUNCHES["wta"] += 1
    return out
