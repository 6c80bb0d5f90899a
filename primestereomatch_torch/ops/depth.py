"""Disparity -> depth / 3D reprojection via the rectification Q matrix.

The reference carries Q through StereoCameraProperties
(include/StereoCalib.h:50-57, produced by stereoRectify at
src/StereoMatch.cpp:456-458). cv::reprojectImageTo3D semantics:

  [X Y Z W]^T = Q @ [x y disp 1]^T ;  point = (X/W, Y/W, Z/W)

Elementwise float32 math in the JAX package's term order (ops/depth.py
there), so bitwise equal to its eager op: Q's float64 entries enter as
float32 scalars, as they do in JAX with 64-bit types off, and the divisions
are tensor by tensor (a Python-scalar divisor is a multiply by its
reciprocal on CUDA).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-12   # |W| below this is a point at infinity


def _f32(v) -> float:
    """A float64 value as the float32 scalar the JAX op computes with."""
    return float(np.float32(v))


def reproject_disparity(
    disp: torch.Tensor,         # (H, W) float32 disparities (pixels)
    Q: np.ndarray,              # (4, 4) from stereo_rectify
    invalid_value: float = 0.0,
    max_depth: float = math.inf,
) -> torch.Tensor:
    """(H, W, 3) XYZ in calibration units; invalid/infinite disparities map
    to `invalid_value` (disp <= 0 or |W| <= 1e-12, or |Z| >= max_depth)."""
    H, W = disp.shape
    q = np.asarray(Q, np.float64)
    dev = disp.device
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    d = disp.to(torch.float32)

    def row(i):
        return (_f32(q[i, 0]) * x + _f32(q[i, 1]) * y + _f32(q[i, 2]) * d + _f32(q[i, 3]))

    X, Y, Z, Wt = (row(i) for i in range(4))
    valid = (d > 0) & (Wt.abs() > _f32(_EPS))
    inv_w = torch.where(valid, torch.reciprocal(Wt), 0.0)
    pts = torch.stack([X * inv_w, Y * inv_w, Z * inv_w], dim=-1)
    depth_ok = valid & (pts[..., 2].abs() < _f32(max_depth))
    return torch.where(depth_ok[..., None], pts, _f32(invalid_value))


def disparity_to_depth(
    disp: torch.Tensor, Q: np.ndarray, invalid_value: float = 0.0
) -> torch.Tensor:
    """(H, W) metric depth Z = fx * baseline / disparity, via Q's terms
    (Z/W with Q[2,3] = f, Q[3,2] = -1/Tx)."""
    q = np.asarray(Q, np.float64)
    d = disp.to(torch.float32)
    w = _f32(q[3, 2]) * d + _f32(q[3, 3])
    valid = (d > 0) & (w.abs() > _f32(_EPS))
    f = torch.full((), _f32(q[2, 3]), dtype=torch.float32, device=d.device)
    return torch.where(valid, f / torch.where(valid, w, 1.0), _f32(invalid_value))
