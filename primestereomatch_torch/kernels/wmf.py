"""K3: joint weighted median, exact mode (CUDA, csrc/wmf.cu).

Replaces primestereomatch_tpu/kernels/wmf_pallas.py::_wmf_kernel. Bound
on the H100 by arithmetic (an expf and ~11 flops per pixel and window
offset). A block takes a 32 x 8 tile of pixels, stages the haloed region
in shared memory as one packed word per pixel, takes the weights from a
table of the integer colour distances, and sums each pixel's bins a window
of NB bins at a time, in the plain version's order: the medians are the
plain version's, bit for bit. The windows run from the least disparity of
the haloed tile where its range fits one window, else over the disparities
the tile holds, ranked (`bin_window_passes`; `range_window_passes` counts
the windows over the whole range). With a participation plane (`valid`,
the TPU kernel's has_valid mode) the second entry of the same source
multiplies every window weight by it and writes 0 where a pixel's total
weight is 0 (`LAUNCHES["wmf_valid"]`); a block whose haloed plane is all 0
or 1 (`unit_plane_blocks`) skips the multiply, a choice the kernel makes on
the card.
"""

from __future__ import annotations

import ctypes

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.kernels.cvc_lowmaps import MAX_GRID_Z
from primestereomatch_torch.ops.jointwmf import joint_wmf

# the kernel's tile of output pixels and its bin window (csrc/wmf.cu: TW, TH, NB)
TILE_W, TILE_H, NB = 32, 8, 64
N_DIST2 = 3 * 63 * 63 + 1      # squared distances of 6-bit colours: the weight table


def weighted_median_plain(disp: torch.Tensor, guide_u8: torch.Tensor, radius: int,
                          n_bins: int, sigma: float,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, view by view."""
    return torch.stack([
        joint_wmf(d, g, radius=radius, n_bins=n_bins, sigma=sigma,
                  valid=None if valid is None else valid[i])
        for i, (d, g) in enumerate(zip(disp, guide_u8))
    ])


def _haloed_tiles(t: torch.Tensor, radius: int, fill) -> torch.Tensor:
    """The values of (B, H, W) `t` in each kernel block's haloed tile,
    positions outside the image taken as `fill`: (B, tiles_y, tiles_x,
    (TILE_H + 2 radius) * (TILE_W + 2 radius))."""
    H, W = t.shape[1:]
    pad = (radius, radius + -W % TILE_W, radius, radius + -H % TILE_H)
    t = torch.nn.functional.pad(t, pad, value=fill)
    tiles = t.unfold(1, TILE_H + 2 * radius, TILE_H).unfold(2, TILE_W + 2 * radius, TILE_W)
    return tiles.reshape(*tiles.shape[:3], -1)


def _binned(disp: torch.Tensor, n_bins: int, valid: torch.Tensor | None) -> torch.Tensor:
    """`disp` as int64, n_bins where a pixel lies in no bin window (d >=
    n_bins, or participation weight 0), as the kernel stages it."""
    d = disp.to(torch.int64)
    ok = d < n_bins
    if valid is not None:
        ok &= valid != 0
    return torch.where(ok, d, n_bins)


def range_window_passes(disp: torch.Tensor, radius: int, n_bins: int,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """Passes over the window offsets that each block would make with bin
    windows over the whole range of its haloed tile: one per window of NB
    bins between the least and the greatest disparity below `n_bins`, one
    more (the window of the median, summed again) where there are several.
    The kernel's own count where that range fits one window. A pixel whose
    participation weight `valid` is 0 counts as outside every bin window,
    as the kernel stages it. Returns (B, tiles_y, tiles_x) int64; plain
    PyTorch, any device."""
    tiles = _haloed_tiles(_binned(disp, n_bins, valid), radius, n_bins)
    dmin = tiles.amin(-1)
    dmax = torch.where(tiles < n_bins, tiles, -1).amax(-1)
    nwin = torch.where(dmax >= 0, (dmax - dmin) // NB + 1, 0)
    return nwin + (nwin > 1)


def bin_window_passes(disp: torch.Tensor, radius: int, n_bins: int,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """Passes over the window offsets that each block of the kernel makes on
    `disp` (B, H, W): one per window of NB of the distinct disparities below
    `n_bins` that its haloed tile holds, and one more (the window of the
    median, summed again) where there are several. Where the tile's range
    fits one window this is `range_window_passes`, 1. A pixel whose
    participation weight `valid` is 0 counts as outside every bin window.
    Returns (B, tiles_y, tiles_x) int64; plain PyTorch, any device. For
    reports and tests: the wrapper never calls it."""
    tiles = _haloed_tiles(_binned(disp, n_bins, valid), radius, n_bins)
    held = torch.zeros((*tiles.shape[:3], n_bins + 1), dtype=torch.bool, device=disp.device)
    held.scatter_(3, tiles, True)
    nwin = (held[..., :n_bins].sum(-1) + NB - 1) // NB
    return nwin + (nwin > 1)


def unit_plane_blocks(valid: torch.Tensor, radius: int) -> torch.Tensor:
    """Whether each block of the kernel's valid mode takes the unit path:
    every value of (B, H, W) `valid` in its haloed tile, inside the image,
    is exactly 0 or 1 (-0 too; not NaN). Returns (B, tiles_y, tiles_x)
    bool; plain PyTorch, any device. For reports and tests: the kernel
    makes the choice itself."""
    other = ~((valid == 0) | (valid == 1))
    return ~_haloed_tiles(other, radius, False).any(-1)


def blocks_per_sm(valid: bool, radius: int = 9) -> int:
    """Blocks of the kernel (`valid`: of its participation-weight mode) that
    one SM of the card holds at `radius`, by the CUDA runtime's occupancy
    calculator under the launch's shared-memory attributes."""
    fn = ctypes.CDLL(str(_build.library("wmf"))).psm_joint_wmf_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    n = fn(int(valid), radius)
    if n < 0:
        raise RuntimeError(f"no occupancy for K3 (valid={valid}) at radius {radius}")
    return n


def weighted_median(disp: torch.Tensor, guide_u8: torch.Tensor, radius: int = 9,
                    n_bins: int = 64, sigma: float = 25.5,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, W) uint8 disparities + (B, H, W, 3) uint8 guide [+ (B, H, W)
    float32 participation weights, nonnegative] -> (B, H, W) uint8 medians
    (0 where a pixel's total weight is 0). Launches the CUDA kernel for
    CUDA tensors; CPU tensors take the plain version. A radius whose haloed
    tile does not fit a block's shared memory raises."""
    if disp.dim() != 3 or guide_u8.shape != (*disp.shape, 3):
        raise ValueError(f"expected (B,H,W) disp and (B,H,W,3) guide, got "
                         f"{tuple(disp.shape)}, {tuple(guide_u8.shape)}")
    if disp.dtype != torch.uint8 or guide_u8.dtype != torch.uint8:
        raise TypeError("disp and guide must be uint8")
    if not 1 <= n_bins <= 256 or radius < 0:
        raise ValueError(f"need 1 <= n_bins <= 256 and radius >= 0, got {n_bins}, {radius}")
    if disp.device != guide_u8.device:
        raise ValueError("disp and guide must be on one device")
    if valid is not None:
        if valid.shape != disp.shape or valid.dtype != torch.float32:
            raise ValueError(f"valid must be float32 {tuple(disp.shape)}, got "
                             f"{valid.dtype} {tuple(valid.shape)}")
        if valid.device != disp.device:
            raise ValueError("valid must be on the device of disp")
    if disp.device.type == "cpu":
        return weighted_median_plain(disp, guide_u8, radius, n_bins, sigma, valid)
    if disp.device.type != "cuda":
        raise ValueError(f"unsupported device {disp.device}")
    if not (disp.is_contiguous() and guide_u8.is_contiguous()
            and (valid is None or valid.is_contiguous())):
        raise ValueError("disp, guide and valid must be contiguous")
    B, H, W = disp.shape
    sig_q = sigma / 256.0 * 64.0
    inv_two_sig2 = 1.0 / (2.0 * sig_q * sig_q)
    if B > MAX_GRID_Z:
        raise ValueError(f"{B} views exceed one launch's grid")
    out = torch.empty_like(disp)
    # the flushed weight table; the valid mode's unflushed one after it
    wtab = torch.empty(N_DIST2 * (1 if valid is None else 2), dtype=torch.float32,
                       device=disp.device)
    stream = torch.cuda.current_stream(disp.device).cuda_stream
    name = "wmf" if valid is None else "wmf_valid"
    fn = _build.load(name)
    planes = (disp.data_ptr(), guide_u8.data_ptr()) + (
        () if valid is None else (valid.data_ptr(),))
    rc = fn(*planes, out.data_ptr(), wtab.data_ptr(), B, H, W, radius, n_bins,
            ctypes.c_float(inv_two_sig2), stream)
    if rc == -1:
        raise ValueError(f"the haloed {TILE_W}x{TILE_H} tile of radius {radius} needs more "
                         f"shared memory than the card gives a block")
    _build.check(name, rc)
    _build.LAUNCHES[name] += 1
    return out
