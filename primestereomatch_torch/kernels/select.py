"""K8: SGBM disparity selection (CUDA, csrc/select.cu).

Replaces primestereomatch_tpu/kernels/select_pallas.py::_select_kernel_1p
and ::_select_kernel. Bound on the H100 by bytes (S is read once, 4 bytes
per pixel and d); one block per row, one warp per pixel, the right-view
scatter as a 64-bit atomicMin in shared memory. The kernel reads the int32
S (`select_disparity`) or the scan kernel's uint16 group partials, which
it adds in registers (`select_disparity_partials`, the main path).
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


def _launch(costs: tuple[torch.Tensor, ...], n_partials: int, uniq: int, d12: int,
            min_d: int) -> torch.Tensor:
    """The kernel on the int32 S (n_partials = 0) or on 1-2 uint16 partials."""
    first = costs[0]
    if first.device.type != "cuda":
        raise ValueError(f"unsupported device {first.device}")
    if not all(c.is_contiguous() for c in costs):
        raise ValueError("the costs must be contiguous")
    H, W, D = first.shape
    if W * _SMEM_PER_COLUMN > _SMEM_LIMIT:
        raise ValueError(f"the select kernel takes rows of at most "
                         f"{_SMEM_LIMIT // _SMEM_PER_COLUMN} pixels, got W={W}")
    out = torch.empty((H, W), dtype=torch.int16, device=first.device)
    fn = _build.load("select")
    rc = fn(first.data_ptr(), costs[1].data_ptr() if len(costs) > 1 else None, n_partials,
            out.data_ptr(), H, W, D, uniq, d12, min_d,
            torch.cuda.current_stream(first.device).cuda_stream)
    _build.check("select", rc)
    _build.LAUNCHES["select"] += 1
    return out


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
    return _launch((S,), 0, uniqueness_ratio, disp12_max_diff, min_disparity)


def select_disparity_partials_plain(partials, uniqueness_ratio: int, disp12_max_diff: int,
                                    min_disparity: int = 0) -> torch.Tensor:
    """Plain PyTorch version: the selection on the int32 sum of the partials."""
    S = partials[0].to(torch.int32)
    for q in partials[1:]:
        S = S + q.to(torch.int32)
    return select_disparity_plain(S, uniqueness_ratio, disp12_max_diff, min_disparity)


def select_disparity_partials(partials, uniqueness_ratio: int, disp12_max_diff: int,
                              min_disparity: int = 0) -> torch.Tensor:
    """The selection on `sgbm_aggregate_partials`'s tuple: one int32 (H, W,
    D) tensor, or one or two uint16 ones whose sum is the aggregated cost
    -> (H, W) int16 disparity x 16. Launches the CUDA kernel, which adds the
    partials as it reads them, for CUDA tensors; CPU tensors take the plain
    version."""
    partials = tuple(partials)
    if not 1 <= len(partials) <= 2:
        raise ValueError(f"expected one or two partials, got {len(partials)}")
    first = partials[0]
    if first.dim() != 3 or any(q.shape != first.shape or q.device != first.device
                               for q in partials):
        raise ValueError(f"expected (H, W, D) partials of one shape on one device, got "
                         f"{[tuple(q.shape) for q in partials]}")
    if len(partials) == 1 and first.dtype == torch.int32:
        return select_disparity(first, uniqueness_ratio, disp12_max_diff, min_disparity)
    if any(q.dtype != torch.uint16 for q in partials):
        raise TypeError(f"partials must be one int32 tensor or uint16 tensors, got "
                        f"{[q.dtype for q in partials]}")
    if first.device.type == "cpu":
        return select_disparity_partials_plain(partials, uniqueness_ratio, disp12_max_diff,
                                               min_disparity)
    return _launch(partials, len(partials), uniqueness_ratio, disp12_max_diff, min_disparity)
