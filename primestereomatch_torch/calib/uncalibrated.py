"""Uncalibrated (Hartley) rectification — the reference's fallback preview
path (src/StereoCalib.cpp:269-288): findFundamentalMat(FM_8POINT) +
stereoRectifyUncalibrated, with R1/R2 recovered as K^-1 H K.

Implements the published algorithms directly:

  fundamental_8point — normalized 8-point: Hartley-normalize both point
      sets, DLT for F, enforce rank 2 via SVD, denormalize.
  stereo_rectify_uncalibrated — Hartley's projective rectification: move
      the right epipole to infinity with H2 = T' G R T (shear-free
      variant), then choose H1 = matching homography minimizing the
      disparity range (the classic least-squares x-alignment).
"""

from __future__ import annotations

import numpy as np


def _normalize(pts: np.ndarray):
    c = pts.mean(axis=0)
    scale = np.sqrt(2.0) / max(np.mean(np.linalg.norm(pts - c, axis=1)), 1e-12)
    T = np.array([[scale, 0, -scale * c[0]],
                  [0, scale, -scale * c[1]],
                  [0, 0, 1.0]])
    ph = np.hstack([pts, np.ones((len(pts), 1))]) @ T.T
    return ph[:, :2], T


def fundamental_8point(pts1: np.ndarray, pts2: np.ndarray) -> np.ndarray:
    """Normalized 8-point fundamental matrix (x2^T F x1 = 0), rank-2
    enforced, f33-normalized when nonzero."""
    p1, T1 = _normalize(np.asarray(pts1, np.float64))
    p2, T2 = _normalize(np.asarray(pts2, np.float64))
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    A = np.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, np.ones_like(x1)],
        axis=1,
    )
    _, _, Vt = np.linalg.svd(A)
    F = Vt[-1].reshape(3, 3)
    U, S, Vt2 = np.linalg.svd(F)
    F = U @ np.diag([S[0], S[1], 0.0]) @ Vt2
    F = T2.T @ F @ T1
    if abs(F[2, 2]) > 1e-12:
        F = F / F[2, 2]
    return F


def _epipole(F: np.ndarray) -> np.ndarray:
    """Right nullspace of F^T: the epipole in image 2 (F^T e2 = 0)."""
    _, _, Vt = np.linalg.svd(F.T)
    e = Vt[-1]
    return e / (e[2] if abs(e[2]) > 1e-12 else np.linalg.norm(e))


def stereo_rectify_uncalibrated(
    pts1: np.ndarray,
    pts2: np.ndarray,
    F: np.ndarray,
    img_size: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray]:
    """Hartley rectifying homographies (H1, H2) such that corresponding
    points map to equal rows. H2 sends the image-2 epipole to infinity
    about the image center; H1 = matching homography (H_A * H0) with the
    affine part solved in least squares over the matches."""
    w, h = img_size
    F = np.asarray(F, np.float64)
    pts1 = np.asarray(pts1, np.float64)
    pts2 = np.asarray(pts2, np.float64)

    # --- H2: translate center to origin, rotate epipole onto +x, project
    # it to infinity
    e = _epipole(F)
    Tc = np.array([[1, 0, -w / 2], [0, 1, -h / 2], [0, 0, 1.0]])
    ex, ey = (e[:2] - np.array([w / 2, h / 2])) if abs(e[2]) > 1e-12 else e[:2]
    r = np.hypot(ex, ey)
    cos_a, sin_a = ex / r, ey / r
    Rr = np.array([[cos_a, sin_a, 0], [-sin_a, cos_a, 0], [0, 0, 1.0]])
    f = r if abs(e[2]) > 1e-12 else np.inf
    G = np.eye(3)
    if np.isfinite(f):
        G[2, 0] = -1.0 / f
    H2 = np.linalg.inv(Tc) @ G @ Rr @ Tc

    # --- H1: H2 * M (a compatible projective map), then an affine row
    # correction minimizing sum (x1' - x2')^2
    # M = [e']_x F + e' a^T is a valid "M" for any a; use a = (1,1,1)
    e2 = _epipole(F)
    ex_m = np.array([
        [0, -e2[2], e2[1]],
        [e2[2], 0, -e2[0]],
        [-e2[1], e2[0], 0],
    ])
    M = ex_m @ F + np.outer(e2, np.ones(3))
    H0 = H2 @ M

    def apply(H, p):
        ph = np.hstack([p, np.ones((len(p), 1))]) @ H.T
        return ph[:, :2] / ph[:, 2:3]

    p1h = apply(H0, pts1)
    p2h = apply(H2, pts2)
    # solve a,b,c: a*x + b*y + c ~= x2'
    A = np.column_stack([p1h[:, 0], p1h[:, 1], np.ones(len(p1h))])
    abc, *_ = np.linalg.lstsq(A, p2h[:, 0], rcond=None)
    HA = np.array([[abc[0], abc[1], abc[2]], [0, 1, 0], [0, 0, 1.0]])
    H1 = HA @ H0
    return H1 / H1[2, 2], H2 / H2[2, 2]


def rectify_rotations_from_homographies(
    H1: np.ndarray, H2: np.ndarray, K1: np.ndarray, K2: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The reference converts Hartley homographies into rectification
    'rotations' for initUndistortRectifyMap: R = K^-1 H K
    (src/StereoCalib.cpp:284-287)."""
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)
    return (
        np.linalg.inv(K1) @ np.asarray(H1, np.float64) @ K1,
        np.linalg.inv(K2) @ np.asarray(H2, np.float64) @ K2,
    )
