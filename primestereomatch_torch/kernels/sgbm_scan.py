"""K7: SGM aggregation over 3, 5 or 8 directions (CUDA, csrc/sgbm_scan.cu).

Replaces primestereomatch_tpu/kernels/sgbm_pallas.py::_sgbm_scan_kernel.
Bound on the H100 by integer operations (~8 per direction, pixel and d);
one warp walks each path with its state in registers, one launch per path
family (rows, columns, diagonals, anti-diagonals) covering both of its
directions where the mode has both.
"""

from __future__ import annotations

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.ops.sgbm import aggregate

# 32 lanes x 64 disparities per lane; (D - 1) * 16 must fit the int16
# disparity output anyway
MAX_D = 2048

# per mode: the path families (dy, dx) and whether both directions run
_FAMILIES = {
    8: (((0, 1), True), ((1, 0), True), ((1, 1), True), ((1, -1), True)),
    5: (((0, 1), True), ((1, 0), False), ((1, 1), False), ((1, -1), False)),
    3: (((0, 1), True), ((1, 0), False)),
}


# the plain PyTorch version of the kernel (a scan per direction)
sgbm_aggregate_plain = aggregate


def sgbm_aggregate(cost: torch.Tensor, p1: int, p2: int,
                   num_directions: int = 8) -> torch.Tensor:
    """(H, W, D) int16/int32 window cost -> (H, W, D) int32 S, the sum of
    the directional DP over the mode's directions. Launches the CUDA kernel
    (one launch per path family) for CUDA tensors; CPU tensors take the
    plain version."""
    if num_directions not in _FAMILIES:
        raise ValueError(f"num_directions must be 3, 5 or 8, got {num_directions}")
    if cost.dim() != 3:
        raise ValueError(f"expected (H, W, D) cost, got {tuple(cost.shape)}")
    if cost.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"cost must be int16 or int32, got {cost.dtype}")
    if cost.device.type == "cpu":
        return sgbm_aggregate_plain(cost, p1, p2, num_directions)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    if not cost.is_contiguous():
        raise ValueError("cost must be contiguous")
    H, W, D = cost.shape
    if D > MAX_D:
        raise ValueError(f"the scan kernel takes at most {MAX_D} disparities, got {D}")
    S = torch.empty((H, W, D), dtype=torch.int32, device=cost.device)
    fn = _build.load("sgbm_scan")
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    for i, ((dy, dx), both) in enumerate(_FAMILIES[num_directions]):
        rc = fn(cost.data_ptr(), int(cost.dtype == torch.int16), S.data_ptr(), H, W, D,
                p1, p2, dy, dx, int(both), int(i == 0), stream)
        _build.check("sgbm_scan", rc)
        _build.LAUNCHES["sgbm_scan"] += 1
    return S
