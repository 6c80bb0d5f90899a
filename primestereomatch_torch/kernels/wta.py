"""K2: bilinear upsample of the maps + guide combine + first-minimum WTA
over d >= 1 (CUDA, csrc/wta.cu).

Replaces primestereomatch_tpu/kernels/wta_pallas.py::_wta_kernel_poly.
Bound on the H100 about equally by reading the maps and by the lerp and
combine arithmetic (bytes at Teddy's shape, operations at 2K); one thread
per output pixel folds the argmin over d, so
the filtered full-resolution volume never exists. The OpenCV INTER_LINEAR
tables serve every column ratio, so the TPU's quasi/exact polyphase modes
collapse into this one kernel.
"""

from __future__ import annotations

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.ops.guided_filter import fgf_wta_low_maps
from primestereomatch_torch.ops.resize import linear_tables


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
    uint8 disparities in [1, D). Launches the CUDA kernel for CUDA tensors;
    CPU tensors take the plain version."""
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
    fn = _build.load("wta")
    rc = fn(maps.data_ptr(), guide.data_ptr(), yi.data_ptr(), yf.data_ptr(),
            xi.data_ptr(), xf.data_ptr(), out.data_ptr(), B, D, h, w, H, W,
            torch.cuda.current_stream(guide.device).cuda_stream)
    _build.check("wta", rc)
    _build.LAUNCHES["wta"] += 1
    return out
