"""The least time each SGBM kernel of a frame needs on one H100, from its shapes.

Frozen copies of `chip_smoke.py`'s `bound_bt_cost` (K6), `bound_scan` (K7),
`bound_select` (K8) and `bound_sweep` (K9, one sweep), with the int32 peak
they use: the larger of the bytes over the HBM rate and the integer operations
over the int32 peak, in ms. Each input byte is counted read once and each
output byte written once. The functions read only shapes and dtypes, so they
take `meta` tensors; `frame_*_ms` build those from a frame's geometry (H, W,
D) and the configuration's `sgbm` block.

Peaks: NVIDIA's H100 SXM data sheet (HBM3 at 3.35 TB/s, `bounds.py`) and its
int32 ALU rate, 64 lanes an SM (Hopper white paper) x 132 SMs x the 1.98 GHz
boost clock, at the full 700 W power limit.
"""

from __future__ import annotations

import torch

from portbench.bounds import bound

INT32_OPS_PER_S = 64 * 132 * 1.98e9
# the matched views' channels and the prefilter's cap, as the configuration
# runs them: the window cost is int16 where block_size**2 * 3 * 2 * 63 fits
CHANNELS, CAP = 3, 63
DIRECTIONS = {"hh": 8, "sgbm": 5, "3way": 3}


def bound_bt_cost(lf: torch.Tensor, cost: torch.Tensor):
    """K6: (H, W, C) int32 features -> (H, W, D) window costs."""
    H, W, C = lf.shape
    n = cost.numel()
    # read both feature images once, write the cost once; per (y, x, d):
    # 10 integer ops per channel for the BT cost, 4 for the running sums
    return bound(2 * 4 * lf.numel() + cost.element_size() * n, n * (10 * C + 4),
                 INT32_OPS_PER_S)


def bound_scan(cost: torch.Tensor, n_dirs: int):
    """K7: the (H, W, D) costs -> the aggregated cost over `n_dirs` directions."""
    n = cost.numel()
    # read C once, write the int32 S once; ~8 ops per (direction, pixel, d)
    return bound(n * (cost.element_size() + 4), 8 * n_dirs * n, INT32_OPS_PER_S)


def bound_select(shape):
    """K8: the (H, W, D) aggregated cost -> int16 disparities."""
    H, W, D = shape
    # read the aggregated cost once (4 bytes per value: the int32 S, or two
    # uint16 partials), write int16 disparities; per value 2 ops for the
    # argmin and 3 for the far-set min
    return bound(4 * H * W * D + 2 * H * W, 5 * H * W * D, INT32_OPS_PER_S)


def bound_sweep(m: torch.Tensor):
    """K9: one sweep (hook, row scan, column scan) of the (H, W) labels."""
    # the labels and the uint8 link mask read once, the labels written once,
    # the 4-byte flag; per pixel 8 ops for the hook (4 link tests, 4 mins), 5
    # a scan axis (a forward and a backward segmented step of 2, the final
    # min) and 1 for the flag
    return bound(9 * m.numel() + 4, 19 * m.numel(), INT32_OPS_PER_S)


# -- a frame's bounds from its geometry and the configuration -----------------


def _meta(*shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, device="meta", dtype=dtype)


def cost_dtype(block_size: int) -> torch.dtype:
    return torch.int16 if block_size**2 * CHANNELS * 2 * CAP < 2**15 else torch.int32


def frame_k6_ms(H: int, W: int, D: int, block_size: int) -> float:
    return bound_bt_cost(_meta(H, W, CHANNELS), _meta(H, W, D, dtype=cost_dtype(block_size)))[0]


def frame_k7_ms(H: int, W: int, D: int, block_size: int, mode: str) -> float:
    return bound_scan(_meta(H, W, D, dtype=cost_dtype(block_size)), DIRECTIONS[mode])[0]


def frame_k8_ms(H: int, W: int, D: int) -> float:
    return bound_select((H, W, D))[0]


def sweep_ms(H: int, W: int) -> float:
    return bound_sweep(_meta(H, W))[0]
