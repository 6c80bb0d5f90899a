"""K3: joint weighted median, exact mode (CUDA, csrc/wmf.cu).

Replaces primestereomatch_tpu/kernels/wmf_pallas.py::_wmf_kernel. Bound
on the H100 by arithmetic (an expf and ~11 flops per pixel and window
offset); one thread per pixel keeps its histogram in shared memory and
sums it in the plain version's order.
"""

from __future__ import annotations

import ctypes

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.ops.jointwmf import joint_wmf


def weighted_median_plain(disp: torch.Tensor, guide_u8: torch.Tensor, radius: int,
                          n_bins: int, sigma: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, view by view."""
    return torch.stack([
        joint_wmf(d, g, radius=radius, n_bins=n_bins, sigma=sigma)
        for d, g in zip(disp, guide_u8)
    ])


def weighted_median(disp: torch.Tensor, guide_u8: torch.Tensor, radius: int = 9,
                    n_bins: int = 64, sigma: float = 25.5) -> torch.Tensor:
    """(B, H, W) uint8 disparities + (B, H, W, 3) uint8 guide -> (B, H, W)
    uint8 medians. Launches the CUDA kernel for CUDA tensors; CPU tensors
    take the plain version."""
    if disp.dim() != 3 or guide_u8.shape != (*disp.shape, 3):
        raise ValueError(f"expected (B,H,W) disp and (B,H,W,3) guide, got "
                         f"{tuple(disp.shape)}, {tuple(guide_u8.shape)}")
    if disp.dtype != torch.uint8 or guide_u8.dtype != torch.uint8:
        raise TypeError("disp and guide must be uint8")
    if not 1 <= n_bins <= 256 or radius < 0:
        raise ValueError(f"need 1 <= n_bins <= 256 and radius >= 0, got {n_bins}, {radius}")
    if disp.device != guide_u8.device:
        raise ValueError("disp and guide must be on one device")
    if disp.device.type == "cpu":
        return weighted_median_plain(disp, guide_u8, radius, n_bins, sigma)
    if disp.device.type != "cuda":
        raise ValueError(f"unsupported device {disp.device}")
    if not (disp.is_contiguous() and guide_u8.is_contiguous()):
        raise ValueError("disp and guide must be contiguous")
    B, H, W = disp.shape
    sig_q = sigma / 256.0 * 64.0
    inv_two_sig2 = 1.0 / (2.0 * sig_q * sig_q)
    out = torch.empty_like(disp)
    fn = _build.load("wmf")
    rc = fn(disp.data_ptr(), guide_u8.data_ptr(), out.data_ptr(), B, H, W, radius,
            n_bins, ctypes.c_float(inv_two_sig2),
            torch.cuda.current_stream(disp.device).cuda_stream)
    _build.check("wmf", rc)
    _build.LAUNCHES["wmf"] += 1
    return out
