"""Normalized box (mean) filter with OpenCV `cv::blur` semantics: a k x k
mean with the anchor at the window centre and BORDER_REFLECT_101 padding.

The sums are exact k-term sums taken tap by tap, rows first and then
columns, the order the CUDA low-maps kernel (kernels/lowmaps.py) follows.
"""

from __future__ import annotations

import numpy as np
import torch

from primestereomatch_torch.utils.device import device_table


def reflect101_indices(n: int, lo: int, hi: int) -> np.ndarray:
    """Source index of each position of a length-n axis padded by lo/hi
    with reflect-101 (gfedcb|abcdefgh|gfedcba)."""
    if max(lo, hi) >= n:
        raise ValueError(f"reflect-101 pad {max(lo, hi)} needs an axis longer than {n}")
    i = np.abs(np.arange(-lo, n + hi))
    return np.where(i >= n, 2 * (n - 1) - i, i)


def window_sum(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Length-k sliding-window sum along `dim` (valid mode), tap by tap."""
    n = x.shape[dim] - k + 1
    s = x.narrow(dim, 0, n)
    for i in range(1, k):
        s = s + x.narrow(dim, i, n)
    return s


def window_sum_1d(x: torch.Tensor, k: int, axis: int, engine: str = "window") -> torch.Tensor:
    """Length-k sliding-window sum along `axis` (valid mode): output length
    x.shape[axis] - k + 1. engine='window' sums the k terms tap by tap;
    'scan' differences a running sum (the JAX op's integral-image engine:
    exact for integers, rounded otherwise)."""
    if k == 1:
        return x
    if engine == "scan":
        c = torch.cumsum(x, dim=axis, dtype=x.dtype)
        n = x.shape[axis] - k + 1
        hi = c.narrow(axis, k - 1, n)
        lo = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c.narrow(axis, 0, n - 1)], axis)
        return hi - lo
    return window_sum(x, k, axis)


def box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k windowed sum over the last two axes, reflect-101 borders,
    output shape == input shape. For even k the window spans
    [i - k//2, i + k - 1 - k//2], OpenCV's default anchor."""
    lo = k // 2
    hi = k - 1 - lo
    h, w = x.shape[-2:]
    ry = device_table(("reflect101", h, lo, hi), lambda: reflect101_indices(h, lo, hi),
                      x.device, torch.long)
    rx = device_table(("reflect101", w, lo, hi), lambda: reflect101_indices(w, lo, hi),
                      x.device, torch.long)
    p = x.index_select(-2, ry).index_select(-1, rx)
    return window_sum(window_sum(p, k, -2), k, -1)


def box_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    """OpenCV `cv::blur(x, (k, k))` equivalent (normalized, reflect-101)."""
    return box_sum(x, k) * (1.0 / (k * k))
