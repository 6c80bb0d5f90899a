"""K8: SGBM disparity selection (CUDA, csrc/select.cu).

Replaces primestereomatch_tpu/kernels/select_pallas.py::_select_kernel_1p
and ::_select_kernel. Bound on the H100 by bytes (S is read once, 4 bytes
per pixel and d); one block per row, one warp per pixel, the right-view
scatter as a 64-bit atomicMin in shared memory.
"""

from __future__ import annotations

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.ops.sgbm import select_disparity_hdw

_SMEM_LIMIT = 227 * 1024     # opt-in shared memory per block on the H100
_SMEM_PER_COLUMN = 12        # 64-bit scatter key + int32 disparity


def select_disparity_plain(S: torch.Tensor, uniqueness_ratio: int, disp12_max_diff: int,
                           min_disparity: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel on the same (H, W, D) costs."""
    return select_disparity_hdw(S.transpose(1, 2), uniqueness_ratio, disp12_max_diff,
                                min_disparity)


def select_disparity(S: torch.Tensor, uniqueness_ratio: int, disp12_max_diff: int,
                     min_disparity: int = 0) -> torch.Tensor:
    """(H, W, D) int32 aggregated costs -> (H, W) int16 disparity x 16
    (invalid: (min_disparity - 1) * 16). Launches the CUDA kernel for CUDA
    tensors; CPU tensors take the plain version."""
    if S.dim() != 3:
        raise ValueError(f"expected (H, W, D) costs, got {tuple(S.shape)}")
    if S.dtype != torch.int32:
        raise TypeError(f"S must be int32, got {S.dtype}")
    if S.device.type == "cpu":
        return select_disparity_plain(S, uniqueness_ratio, disp12_max_diff, min_disparity)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    if not S.is_contiguous():
        raise ValueError("S must be contiguous")
    H, W, D = S.shape
    if W * _SMEM_PER_COLUMN > _SMEM_LIMIT:
        raise ValueError(f"the select kernel takes rows of at most "
                         f"{_SMEM_LIMIT // _SMEM_PER_COLUMN} pixels, got W={W}")
    out = torch.empty((H, W), dtype=torch.int16, device=S.device)
    fn = _build.load("select")
    rc = fn(S.data_ptr(), out.data_ptr(), H, W, D, uniqueness_ratio, disp12_max_diff,
            min_disparity, torch.cuda.current_stream(S.device).cuda_stream)
    _build.check("select", rc)
    _build.LAUNCHES["select"] += 1
    return out
