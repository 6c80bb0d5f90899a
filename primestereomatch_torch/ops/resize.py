"""Image resize with OpenCV-exact index semantics.

  INTER_NEAREST : sx = floor(dx * src/dst)           (no half-pixel shift)
  INTER_LINEAR  : fx = (dx + 0.5) * src/dst - 0.5; sx = floor(fx);
                  clamp: fx<0 -> (sx=0, f=0); sx >= src-1 -> (sx=src-1, f=0)

The index and weight tables are computed on the host in float64, as
OpenCV's coordinate maths is, uploaded once per geometry and gathered on
the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from primestereomatch_torch.utils.device import device_table


@functools.lru_cache(maxsize=None)
def nearest_indices(src: int, dst: int) -> np.ndarray:
    """OpenCV INTER_NEAREST source index per destination index."""
    scale = src / dst
    idx = np.floor(np.arange(dst, dtype=np.float64) * scale).astype(np.int64)
    return np.minimum(idx, src - 1)


@functools.lru_cache(maxsize=None)
def linear_coeffs(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV INTER_LINEAR (float path): (low index, frac weight) per dst index."""
    scale = src / dst
    fx = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    f = fx - sx
    f = np.where(sx < 0, 0.0, f)
    sx = np.maximum(sx, 0)
    f = np.where(sx >= src - 1, 0.0, f)
    sx = np.minimum(sx, src - 1)
    return sx, f.astype(np.float32)


def nearest_table(src: int, dst: int, device) -> torch.Tensor:
    """`nearest_indices` as an int64 tensor on `device`, uploaded once."""
    return device_table(("nearest", src, dst), lambda: nearest_indices(src, dst),
                        device, torch.long)


def linear_tables(src: int, dst: int, device,
                  index_dtype: torch.dtype = torch.long) -> tuple[torch.Tensor, ...]:
    """`linear_coeffs` on `device`, uploaded once: (low index, high index
    = min(low + 1, src - 1), f32 fraction)."""
    sx, f = linear_coeffs(src, dst)
    return (
        device_table(("linear_lo", src, dst), lambda: sx, device, index_dtype),
        device_table(("linear_hi", src, dst), lambda: np.minimum(sx + 1, src - 1),
                     device, index_dtype),
        device_table(("linear_frac", src, dst), lambda: f, device, torch.float32),
    )


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """INTER_NEAREST resize over the last two axes (any leading dims)."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    return (x.index_select(-2, nearest_table(h, oh, x.device))
             .index_select(-1, nearest_table(w, ow, x.device)))


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """INTER_LINEAR resize over the last two axes: gather lerp, rows then
    columns."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    y0, y1, yf = linear_tables(h, oh, x.device)
    x0, x1, xf = linear_tables(w, ow, x.device)
    yf = yf[:, None]                                        # (oh, 1)
    ry = x.index_select(-2, y0) * (1.0 - yf) + x.index_select(-2, y1) * yf  # (..., oh, w)
    return ry.index_select(-1, x0) * (1.0 - xf) + ry.index_select(-1, x1) * xf
