"""K6: BT pixel cost + k x k window sum of SGBM (CUDA, csrc/bt_cost.cu).

Replaces primestereomatch_tpu/kernels/sgbm_pallas.py::_bt_cost_kernel.
Bound on the H100 by integer operations (~10 per channel and (y, x, d));
the window sum is separable: a row pass computes each pixel cost once per
window row from shared memory, a column pass keeps a running sum down a
strip of rows. Two launches per call.
"""

from __future__ import annotations

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.ops.sgbm import bt_block_cost, cost_dtype


def bt_cost_plain(l_ftr: torch.Tensor, r_ftr: torch.Tensor, max_dis: int, block_size: int,
                  cost_bound: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, (H, W, D) out."""
    return bt_block_cost(l_ftr, r_ftr, max_dis, block_size, cost_bound, out_layout="hwd")


def bt_cost(l_ftr: torch.Tensor, r_ftr: torch.Tensor, max_dis: int, block_size: int,
            cost_bound: int | None = None) -> torch.Tensor:
    """(H, W, C) int32 features of both views -> (H, W, D) window cost,
    int16 when `cost_bound` < 2**15 else int32. Launches the CUDA kernel
    for CUDA tensors; CPU tensors take the plain version."""
    if l_ftr.dim() != 3 or r_ftr.shape != l_ftr.shape:
        raise ValueError(f"expected matching (H, W, C) features, got {tuple(l_ftr.shape)}, "
                         f"{tuple(r_ftr.shape)}")
    if l_ftr.dtype != torch.int32 or r_ftr.dtype != torch.int32:
        raise TypeError("features must be int32")
    if max_dis < 1 or block_size < 1:
        raise ValueError(f"need max_dis >= 1 and block_size >= 1, got {max_dis}, {block_size}")
    if l_ftr.device != r_ftr.device:
        raise ValueError("features must be on one device")
    if l_ftr.device.type == "cpu":
        return bt_cost_plain(l_ftr, r_ftr, max_dis, block_size, cost_bound)
    if l_ftr.device.type != "cuda":
        raise ValueError(f"unsupported device {l_ftr.device}")
    if not (l_ftr.is_contiguous() and r_ftr.is_contiguous()):
        raise ValueError("features must be contiguous")
    H, W, C = l_ftr.shape
    dt = cost_dtype(cost_bound)
    scratch = torch.empty((H, W, max_dis), dtype=dt, device=l_ftr.device)
    out = torch.empty_like(scratch)
    fn = _build.load("bt_cost")
    rc = fn(l_ftr.data_ptr(), r_ftr.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            int(dt == torch.int16), H, W, C, max_dis, block_size,
            torch.cuda.current_stream(l_ftr.device).cuda_stream)
    _build.check("bt_cost", rc)
    _build.LAUNCHES["bt_cost"] += 2      # the row pass and the column pass
    return out
