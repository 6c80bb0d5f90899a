"""The least time each GIF kernel of a frame needs on one H100, from its shapes.

Frozen copies of `chip_smoke.py`'s `bound`, `bound_lowmaps`, `bound_wta`,
`bound_cvc_lowmaps` and `bound_wmf`, with the peaks they use: the larger of
the bytes over the HBM rate and the operations over the fp32 peak, in ms.
Each input byte is counted read once and each output byte written once; K3
(JointWMF) also counts its scan up to each pixel's median, so its bound takes
the frame's own output. The functions read only shapes (and K3's output), so
they take `meta` tensors; `frame_*_ms` build those from a frame's geometry.

Peaks: NVIDIA's H100 SXM data sheet (80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s
fp32 outside the tensor cores), at the full 700 W power limit.
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _chain_ops(n: int, k: int) -> int:
    # per cost value: 3 guide products, 8 separable k-boxes (2k-1 each), 27
    # for the solve
    return n * (22 + 16 * k)


def _wta_ops(B: int, D: int, H: int, W: int, w: int) -> int:
    # per d >= 1, the separable lerp as the plain version computes it: each
    # of the 4 maps row-lerped once per (output row, low-res column), 3 ops;
    # then per output pixel 4 column lerps (3 each), 6 combine, 1 compare
    return B * (D - 1) * (12 * H * w + 19 * H * W)


def bound_lowmaps(p: torch.Tensor, k: int):
    """K1: (B, D, h, w) costs -> 4 maps."""
    B, D, h, w = p.shape
    n = B * D * h * w
    # read p and the 12 stat planes once, write 4 maps
    return bound(4 * (n + B * 12 * h * w + 4 * n), _chain_ops(n, k))


def bound_wta(guide: torch.Tensor, maps: torch.Tensor):
    """K2: (B, H, W, 3) guide and (B, 4, D, h, w) maps -> uint8 disparities."""
    B, H, W, _ = guide.shape
    D, h, w = maps.shape[2:]
    nbytes = 4 * maps.numel() + 4 * guide.numel() + B * H * W + 8 * (H + W)
    return bound(nbytes, _wta_ops(B, D, H, W, w))


def bound_cvc_lowmaps(views: torch.Tensor, grds: torch.Tensor, stats: torch.Tensor, D: int,
                      k: int):
    """K4: views, gradients and guide stats -> 4 maps, the cost made inside."""
    B2, _, h, w = stats.shape
    n = B2 * D * h * w
    # read the views, gradients and stat planes once, write 4 maps; per cost
    # value ~12 ops for the cost (4 sub, 4 abs, 2 add, 2 clamps or the blend)
    # and the chain's
    return bound(4 * (views.numel() + grds.numel() + stats.numel() + 4 * n),
                 12 * n + _chain_ops(n, k))


def bound_wmf(disp: torch.Tensor, out: torch.Tensor, radius: int, n_bins: int):
    """K3: (B, H, W) disparities -> their weighted medians `out`."""
    B, H, W = disp.shape

    def span(n):  # in-image window positions along one axis, summed
        i = np.arange(n)
        return int((np.minimum(i + radius, n - 1) - np.maximum(i - radius, 0) + 1).sum())

    pairs = B * span(H) * span(W)
    # per in-window pair: 3 sub, 3 mul, 2 add, 1 scale, 1 exp, 1 add; then
    # n_bins adds for the total and 2 ops per bin up to each pixel's median
    scan = B * H * W * n_bins + 2 * int(out.to(torch.int64).add(1).sum())
    return bound(5 * B * H * W, 11 * pairs + scan)


# -- a frame's bounds from its geometry (both views of one pair) -------------


def _meta(*shape) -> torch.Tensor:
    return torch.empty(shape, device="meta")


def frame_k4_ms(H: int, W: int, D: int, s: int, k: int) -> float:
    h, w = H // s, W // s
    return bound_cvc_lowmaps(_meta(2, H, W, 3), _meta(2, H, W), _meta(2, 12, h, w), D, k)[0]


def frame_k2_ms(H: int, W: int, D: int, s: int) -> float:
    return bound_wta(_meta(2, H, W, 3), _meta(2, 4, D, H // s, W // s))[0]


def frame_k3_ms(out: np.ndarray, radius: int, D: int) -> float:
    """`out`: the frame's (2, H, W) uint8 JointWMF output, both views."""
    out = torch.from_numpy(np.ascontiguousarray(out))
    return bound_wmf(_meta(*out.shape), out, radius, D)[0]
