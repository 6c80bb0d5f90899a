"""Lens distortion model (rational + tangential + thin-prism), NumPy f64.

The reference calibrates with CALIB_RATIONAL_MODEL (+ thin-prism/tilted
flags, src/StereoCalib.cpp:162-171) and its shipped ZED calibration
(data/intrinsics.yml) uses 14-coefficient vectors
(k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, taux, tauy) with the
rational radial terms populated. Tilted-sensor (tau) coefficients are not
supported (always zero in the repo's data) and raise if nonzero.

Host-side double precision: this is offline map construction, not the
per-frame hot path (the hot path is the device remap, ops/remap.py).
"""

from __future__ import annotations

import numpy as np


def _coeffs(dist: np.ndarray) -> np.ndarray:
    d = np.zeros(14)
    dist = np.asarray(dist, np.float64).reshape(-1)
    d[: dist.size] = dist
    if d[12] != 0 or d[13] != 0:
        raise NotImplementedError("tilted-sensor (tau) distortion not supported")
    return d


def distort_points(xy: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Forward model: ideal normalized coords (..., 2) -> distorted
    normalized coords (..., 2).

    x' = x*cdist + 2 p1 x y + p2 (r2 + 2 x^2) + s1 r2 + s2 r4
    y' = y*cdist + p1 (r2 + 2 y^2) + 2 p2 x y + s3 r2 + s4 r4
    cdist = (1 + k1 r2 + k2 r4 + k3 r6) / (1 + k4 r2 + k5 r4 + k6 r6)
    """
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, _, _ = _coeffs(dist)
    x = xy[..., 0]
    y = xy[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    cdist = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
    xd = x * cdist + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) + s1 * r2 + s2 * r4
    yd = y * cdist + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y + s3 * r2 + s4 * r4
    return np.stack([xd, yd], axis=-1)


def undistort_points(
    uv: np.ndarray,                 # (..., 2) pixel coords
    camera_matrix: np.ndarray,      # (3, 3)
    dist: np.ndarray,
    R: np.ndarray | None = None,    # optional rectifying rotation
    P: np.ndarray | None = None,    # optional new projection (3,3) or (3,4)
    iterations: int = 5,
) -> np.ndarray:
    """Inverse model via fixed-point iteration (the classic 5-step scheme):
    starting from the distorted normalized coords, repeatedly divide out
    the radial factor and subtract the tangential/prism deltas. Returns
    normalized coords, or pixel coords if P is given."""
    A = np.asarray(camera_matrix, np.float64)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, _, _ = _coeffs(dist)
    x0 = (uv[..., 0] - A[0, 2]) / A[0, 0]
    y0 = (uv[..., 1] - A[1, 2]) / A[1, 1]
    x, y = x0.copy(), y0.copy()
    for _ in range(iterations):
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        icdist = (1 + k4 * r2 + k5 * r4 + k6 * r6) / (1 + k1 * r2 + k2 * r4 + k3 * r6)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x) + s1 * r2 + s2 * r4
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y + s3 * r2 + s4 * r4
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    pts = np.stack([x, y, np.ones_like(x)], axis=-1)
    if R is not None:
        pts = pts @ np.asarray(R, np.float64).T
    pts = pts[..., :2] / pts[..., 2:3]
    if P is not None:
        P = np.asarray(P, np.float64)
        u = P[0, 0] * pts[..., 0] + P[0, 1] * pts[..., 1] + P[0, 2]
        v = P[1, 0] * pts[..., 0] + P[1, 1] * pts[..., 1] + P[1, 2]
        pts = np.stack([u, v], axis=-1)
    return pts


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Rotation vector <-> matrix (both directions by shape)."""
    r = np.asarray(r, np.float64)
    if r.shape == (3, 3):
        # matrix -> vector
        R = r
        cos_t = np.clip((np.trace(R) - 1) * 0.5, -1.0, 1.0)
        theta = np.arccos(cos_t)
        if theta < 1e-12:
            return np.zeros(3)
        if abs(np.pi - theta) < 1e-6:
            # near pi: extract axis from R + I
            M = (R + np.eye(3)) * 0.5
            axis = np.sqrt(np.maximum(np.diagonal(M), 0))
            # fix signs from off-diagonals
            if axis[0] > 0:
                axis[1] = np.copysign(axis[1], M[0, 1])
                axis[2] = np.copysign(axis[2], M[0, 2])
            elif axis[1] > 0:
                axis[2] = np.copysign(axis[2], M[1, 2])
            return axis / np.linalg.norm(axis) * theta
        v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        return v * (theta / (2 * np.sin(theta)))
    # vector -> matrix
    v = r.reshape(3)
    theta = np.linalg.norm(v)
    if theta < 1e-12:
        return np.eye(3)
    a = v / theta
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
