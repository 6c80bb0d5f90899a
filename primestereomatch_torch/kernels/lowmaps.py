"""K1: the low-resolution FGF coefficient chain (CUDA, csrc/lowmaps.cu).

Replaces primestereomatch_tpu/kernels/lowmaps_pallas.py::_lowmaps_kernel.
The function is bound on the H100 by device memory traffic (one cost read,
four maps written per value); the kernel keeps the whole box/solve/box
chain of a 32 x 32 tile in shared memory (csrc/fgf_chain.cuh, shared with
K4 and K10: one float4 of the four planes per entry, taps at constant
offsets, the box size a template argument for k = 3, 5, 9, 17 and a
run-time value otherwise). K1 sums several outputs a thread from taps in
registers in the horizontal passes too (`block_shape`), which halves the
chain's shared-memory loads at k = 17. The TPU layout artefacts (128-lane
margins, row tiles, the d=0 poison) are gone: the maps come out in the
plain (B, 4, D, h, w) layout and the WTA kernel simply starts at d=1.
"""

from __future__ import annotations

import ctypes

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.ops.guided_filter import guide_stats, low_maps_from_stats

MAX_K = 17  # largest box the kernel's shared-memory tile is sized for
TILE = 32   # low-res pixels per block edge (csrc/lowmaps.cu, cvc_lowmaps.cu: TH, TW)
RUN = 4     # outputs a thread sums along the box axis (csrc/fgf_chain.cuh: RV)
# K1's block by box size as csrc/lowmaps.cu ships it: (threads, outputs a
# thread in the horizontal passes, blocks an SM the registers are bounded
# for); k = 17 has its own knobs, 3, 5 and 9 share theirs, and the run-time
# k takes those threads with one output a thread
BLOCK_K17 = (256, 4, 2)
BLOCK_SMALL = (128, 4, 2)


def block_shape(k: int) -> tuple[int, int, int]:
    """(threads, horizontal outputs a thread, blocks an SM) of K1 at box k."""
    if k == 17:
        return BLOCK_K17
    if k in (3, 5, 9):
        return BLOCK_SMALL
    return BLOCK_SMALL[0], 1, BLOCK_SMALL[2]


def chain_smem_bytes(th: int, tw: int, k: int, rh: int = 1) -> int:
    """Shared memory of the chain for th x tw tiles and k x k boxes
    (csrc/fgf_chain.cuh::chain_floats), one float4 per entry. rh = 1: the
    band, the row sums and the first-level maps with the RUN - 1 rows the
    last run reads past. rh > 1 (outputs a thread in the horizontal
    passes): the band's region and a second one, the larger of the row
    sums, the maps and the final sums (odd row pitches where the
    horizontal passes write), and rh entries a run reads past."""
    m = 2 * (k // 2)
    bh, bw, mh, mw = th + 2 * m, tw + 2 * m, th + m, tw + m
    if rh == 1:
        return 16 * (bh * bw + mh * bw + (mh + RUN - 1) * mw)
    return 16 * (bh * bw + max(mh * (bw | 1), (mh + RUN - 1) * mw, th * (tw | 1)) + rh)


def low_maps_plain(p_low: torch.Tensor, stats: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, D, h, w) costs + (B, 12,
    h, w) guide stats -> (B, 4, D, h, w) maps."""
    return low_maps_from_stats(p_low, stats, k)


def low_maps(p_low: torch.Tensor, stats: torch.Tensor, k: int) -> torch.Tensor:
    """(B, D, h, w) f32 costs + (B, 12, h, w) f32 stats -> (B, 4, D, h, w)
    f32 box-averaged [a_r, a_g, a_b, b]. Launches the CUDA kernel for CUDA
    tensors; CPU tensors take the plain version."""
    if p_low.dim() != 4 or stats.dim() != 4:
        raise ValueError(f"expected 4-d p_low and stats, got {p_low.shape}, {stats.shape}")
    B, D, h, w = p_low.shape
    if stats.shape != (B, 12, h, w):
        raise ValueError(f"stats shape {tuple(stats.shape)} != {(B, 12, h, w)}")
    if p_low.dtype != torch.float32 or stats.dtype != torch.float32:
        raise TypeError("p_low and stats must be float32")
    if k % 2 == 0 or not 1 <= k <= MAX_K:
        raise ValueError(f"box size k={k} must be odd and at most {MAX_K}")
    if min(h, w) <= 2 * (k // 2):
        raise ValueError(f"low-res grid {h}x{w} too small for a {k}x{k} box")
    if p_low.device != stats.device:
        raise ValueError("p_low and stats must be on one device")
    if p_low.device.type == "cpu":
        return low_maps_plain(p_low, stats, k)
    if p_low.device.type != "cuda":
        raise ValueError(f"unsupported device {p_low.device}")
    if not (p_low.is_contiguous() and stats.is_contiguous()):
        raise ValueError("p_low and stats must be contiguous")
    out = torch.empty((B, 4, D, h, w), dtype=torch.float32, device=p_low.device)
    fn = _build.load("lowmaps")
    rc = fn(p_low.data_ptr(), stats.data_ptr(), out.data_ptr(), B, D, h, w, k,
            ctypes.c_float(1.0 / (k * k)),
            torch.cuda.current_stream(p_low.device).cuda_stream)
    _build.check("lowmaps", rc)
    _build.LAUNCHES["lowmaps"] += 1
    return out


def fgf_low_maps_batched(
    guide: torch.Tensor,       # (B, H, W, 3) float32 full-res guides
    p_low: torch.Tensor,       # (B, D, h, w) subsampled cost volumes
    radius: int = 8,
    eps: float = 1e-4,
    subsample: int = 4,
) -> torch.Tensor:
    """Guide statistics in plain PyTorch (12 small planes per view, as the
    JAX package computes them outside its kernel too), then the chain:
    returns (B, 4, D, h, w)."""
    k = 2 * (radius // subsample) + 1
    stats = guide_stats(guide, tuple(p_low.shape[-2:]), k, eps).contiguous()
    return low_maps(p_low.contiguous(), stats, k)
