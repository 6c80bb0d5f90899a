"""Camera + stereo calibration from chessboard corners (first principles).

The reference's StereoCalib (src/StereoCalib.cpp:49-237) chains OpenCV's
stereoCalibrate (RATIONAL_MODEL flags), an epipolar RMS quality check, and
YML persistence. This module implements the same capability natively:

  calibrate_camera  — Zhang's method: per-view DLT homographies ->
      closed-form intrinsics from the absolute-conic constraints ->
      per-view extrinsics -> joint Gauss-Newton refinement of
      (fx, fy, cx, cy, k1, k2[, p1, p2, k3]) + per-view poses over the
      reprojection error.
  stereo_calibrate  — per-view relative poses averaged (quaternion mean)
      then jointly refined with both cameras' reprojection residuals
      (optionally with fixed intrinsics, the stereoCalibrate default
      shape).
  epipolar_rms      — the reference's calibration quality check
      (src/StereoCalib.cpp:179-202): average |x2^T F x1| epiline distance
      over all corner pairs.

NumPy float64 throughout; numeric Jacobians (the problem is tiny:
~10 intrinsic + 6/view parameters over a few hundred points).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from primestereomatch_torch.calib.distortion import distort_points, rodrigues
from primestereomatch_torch.calib.chessboard import _apply_h, _homography


def chessboard_object_points(
    pattern_size: tuple[int, int] = (9, 6), square_size: float = 1.0
) -> np.ndarray:
    """(N, 3) planar lattice, row-major, Z = 0 (StereoCalib.cpp objectPoints)."""
    cols, rows = pattern_size
    pts = np.array(
        [[j * square_size, i * square_size, 0.0] for i in range(rows) for j in range(cols)]
    )
    return pts


def _project(obj: np.ndarray, rvec, tvec, K, dist) -> np.ndarray:
    R = rodrigues(np.asarray(rvec, np.float64))
    X = obj @ R.T + np.asarray(tvec, np.float64)[None, :]
    xy = X[:, :2] / X[:, 2:3]
    d = distort_points(xy, dist)
    return np.stack(
        [K[0, 0] * d[:, 0] + K[0, 2], K[1, 1] * d[:, 1] + K[1, 2]], axis=1
    )


def _zhang_intrinsics(Hs: list[np.ndarray]) -> np.ndarray:
    """Closed-form K from homographies via the image of the absolute conic
    (zero-skew, as the reference's CALIB flags effectively assume)."""
    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    A = []
    for H in Hs:
        A.append(v(H, 0, 1))
        A.append(v(H, 0, 0) - v(H, 1, 1))
    _, _, Vt = np.linalg.svd(np.asarray(A))
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def _extrinsics_from_h(H: np.ndarray, K: np.ndarray):
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / np.linalg.norm(Kinv @ h1)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    # orthonormalize (closest rotation)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = -R
    t = lam * (Kinv @ h3)
    if t[2] < 0:
        R[:, :2] *= -1
        t = -t
    return rodrigues(R), t


def _gauss_newton(residual_fn, x0: np.ndarray, iters: int = 30,
                  eps: float = 1e-6, damping: float = 1e-3) -> np.ndarray:
    """Levenberg-style damped Gauss-Newton with forward-difference Jacobian."""
    x = x0.astype(np.float64).copy()
    r = residual_fn(x)
    cost = r @ r
    lam = damping
    for _ in range(iters):
        J = np.empty((len(r), len(x)))
        for k in range(len(x)):
            h = max(1e-7, 1e-7 * abs(x[k]))
            xp = x.copy()
            xp[k] += h
            J[:, k] = (residual_fn(xp) - r) / h
        JtJ = J.T @ J
        g = J.T @ r
        improved = False
        for _ in range(8):
            try:
                dx = np.linalg.solve(JtJ + lam * np.diag(np.diag(JtJ) + 1e-12), -g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            xn = x + dx
            rn = residual_fn(xn)
            cn = rn @ rn
            if cn < cost:
                x, r, cost = xn, rn, cn
                lam = max(lam * 0.3, 1e-9)
                improved = True
                break
            lam *= 10
        if not improved or np.linalg.norm(dx) < eps:
            break
    return x


@dataclasses.dataclass
class MonoCalibration:
    K: np.ndarray                 # (3, 3)
    dist: np.ndarray              # (1, 14) rational-model layout
    rvecs: list[np.ndarray]
    tvecs: list[np.ndarray]
    rms: float


def _pack_dist(d: np.ndarray) -> np.ndarray:
    """First len(d) coefficients of the 14-term OpenCV layout
    (k1, k2, p1, p2, k3, k4, k5, k6, ...)."""
    out = np.zeros((1, 14))
    out[0, : len(d)] = d
    return out


def _unpack_dist_seg(seg: np.ndarray, n_dist: int) -> np.ndarray:
    d = np.zeros(max(n_dist, 5))
    d[:n_dist] = seg
    return _pack_dist(d)


def calibrate_camera(
    object_points: list[np.ndarray],   # per-view (N, 3), Z=0
    image_points: list[np.ndarray],    # per-view (N, 2)
    image_size: tuple[int, int],
    n_dist: int = 2,                   # terms refined: 2 -> k1,k2; 5 -> +p1,p2,k3;
                                       # 8 -> +k4,k5,k6 (CALIB_RATIONAL_MODEL,
                                       # the reference's flag set src/StereoCalib.cpp:162-171)
) -> MonoCalibration:
    Hs = [
        _homography(o[:, :2], i) for o, i in zip(object_points, image_points)
    ]
    K = _zhang_intrinsics(Hs)
    poses = [_extrinsics_from_h(H, K) for H in Hs]

    nv = len(object_points)
    x0 = np.concatenate(
        [[K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.zeros(n_dist)]
        + [np.concatenate([rv, tv]) for rv, tv in poses]
    )

    def unpack(x):
        Km = np.array([[x[0], 0, x[2]], [0, x[1], x[3]], [0, 0, 1.0]])
        dist = _unpack_dist_seg(x[4 : 4 + n_dist], n_dist)
        poses_ = []
        off = 4 + n_dist
        for v in range(nv):
            poses_.append((x[off + 6 * v : off + 6 * v + 3],
                           x[off + 6 * v + 3 : off + 6 * v + 6]))
        return Km, dist, poses_

    def residuals(x):
        Km, dist, poses_ = unpack(x)
        rs = []
        for (o, i, (rv, tv)) in zip(object_points, image_points, poses_):
            rs.append((_project(o, rv, tv, Km, dist) - i).ravel())
        return np.concatenate(rs)

    x = _gauss_newton(residuals, x0)
    Km, dist, poses_ = unpack(x)
    r = residuals(x)
    rms = float(np.sqrt(np.mean(r * r)))
    return MonoCalibration(
        K=Km, dist=dist,
        rvecs=[p[0] for p in poses_], tvecs=[p[1] for p in poses_],
        rms=rms,
    )


def _quat_from_r(R: np.ndarray) -> np.ndarray:
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    if w < 1e-9:
        v = rodrigues(R)
        th = np.linalg.norm(v)
        a = v / max(th, 1e-12)
        return np.array([np.cos(th / 2), *(np.sin(th / 2) * a)])
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    return np.array([w, x, y, z])


@dataclasses.dataclass
class StereoCalibration:
    K1: np.ndarray
    D1: np.ndarray
    K2: np.ndarray
    D2: np.ndarray
    R: np.ndarray                 # x_right = R @ x_left + T
    T: np.ndarray
    rms: float


def stereo_calibrate(
    object_points: list[np.ndarray],
    left_points: list[np.ndarray],
    right_points: list[np.ndarray],
    image_size: tuple[int, int],
    n_dist: int = 2,
    fix_intrinsics: bool = False,
    mono1: MonoCalibration | None = None,
    mono2: MonoCalibration | None = None,
) -> StereoCalibration:
    """Joint stereo solve (the reference's stereoCalibrate role,
    src/StereoCalib.cpp:162-171)."""
    m1 = mono1 or calibrate_camera(object_points, left_points, image_size, n_dist)
    m2 = mono2 or calibrate_camera(object_points, right_points, image_size, n_dist)

    # initial relative pose: quaternion-averaged over views
    quats = []
    ts = []
    for rv1, tv1, rv2, tv2 in zip(m1.rvecs, m1.tvecs, m2.rvecs, m2.tvecs):
        R1, R2 = rodrigues(rv1), rodrigues(rv2)
        Rrel = R2 @ R1.T
        quats.append(_quat_from_r(Rrel))
        ts.append(tv2 - Rrel @ tv1)
    Q = np.asarray(quats)
    Q[Q @ Q[0] < 0] *= -1
    _, _, Vt = np.linalg.svd(Q)
    q = Vt[0] if (Vt[0] @ Q[0]) > 0 else -Vt[0]
    th = 2 * np.arccos(np.clip(q[0], -1, 1))
    axis = q[1:] / max(np.linalg.norm(q[1:]), 1e-12)
    rrel0 = axis * th
    trel0 = np.mean(ts, axis=0)

    nv = len(object_points)
    intr = np.array([
        m1.K[0, 0], m1.K[1, 1], m1.K[0, 2], m1.K[1, 2],
        *m1.dist[0, :n_dist],
        m2.K[0, 0], m2.K[1, 1], m2.K[0, 2], m2.K[1, 2],
        *m2.dist[0, :n_dist],
    ])
    x0 = np.concatenate(
        [([] if fix_intrinsics else intr), rrel0, trel0]
        + [np.concatenate([rv, tv]) for rv, tv in zip(m1.rvecs, m1.tvecs)]
    )

    ni = 4 + n_dist

    def unpack(x):
        if fix_intrinsics:
            K1, D1, K2, D2 = m1.K, m1.dist, m2.K, m2.dist
            off = 0
        else:
            def kd(seg):
                Km = np.array([[seg[0], 0, seg[2]], [0, seg[1], seg[3]], [0, 0, 1.0]])
                return Km, _unpack_dist_seg(seg[4:ni], n_dist)

            K1, D1 = kd(x[:ni])
            K2, D2 = kd(x[ni : 2 * ni])
            off = 2 * ni
        rrel = x[off : off + 3]
        trel = x[off + 3 : off + 6]
        poses = []
        off += 6
        for v in range(nv):
            poses.append((x[off + 6 * v : off + 6 * v + 3],
                          x[off + 6 * v + 3 : off + 6 * v + 6]))
        return K1, D1, K2, D2, rrel, trel, poses

    def residuals(x):
        K1, D1, K2, D2, rrel, trel, poses = unpack(x)
        Rrel = rodrigues(rrel)
        rs = []
        for (o, il, ir, (rv, tv)) in zip(
            object_points, left_points, right_points, poses
        ):
            rs.append((_project(o, rv, tv, K1, D1) - il).ravel())
            R1 = rodrigues(rv)
            R2 = Rrel @ R1
            t2 = Rrel @ tv + trel
            rs.append((_project(o, rodrigues(R2), t2, K2, D2) - ir).ravel())
        return np.concatenate(rs)

    x = _gauss_newton(residuals, x0, iters=40)
    K1, D1, K2, D2, rrel, trel, _ = unpack(x)
    r = residuals(x)
    rms = float(np.sqrt(np.mean(r * r)))
    return StereoCalibration(
        K1=K1, D1=D1, K2=K2, D2=D2,
        R=rodrigues(np.asarray(rrel)), T=np.asarray(trel).reshape(3, 1),
        rms=rms,
    )


def fundamental_from_stereo(calib: StereoCalibration) -> np.ndarray:
    T = calib.T.reshape(3)
    Tx = np.array([[0, -T[2], T[1]], [T[2], 0, -T[0]], [-T[1], T[0], 0]])
    E = Tx @ calib.R
    return np.linalg.inv(calib.K2).T @ E @ np.linalg.inv(calib.K1)


def epipolar_rms(
    calib: StereoCalibration,
    left_points: list[np.ndarray],
    right_points: list[np.ndarray],
) -> float:
    """The reference's calibration quality check (src/StereoCalib.cpp:179-202):
    mean |x2^T l1| + |x1^T l2| epiline distance over all corners (using the
    distortion-free pinhole model on refined points)."""
    from primestereomatch_torch.calib.distortion import undistort_points

    F = fundamental_from_stereo(calib)
    total, n = 0.0, 0
    for il, ir in zip(left_points, right_points):
        u1 = undistort_points(il, calib.K1, calib.D1, P=calib.K1, iterations=40)
        u2 = undistort_points(ir, calib.K2, calib.D2, P=calib.K2, iterations=40)
        p1 = np.hstack([u1, np.ones((len(u1), 1))])
        p2 = np.hstack([u2, np.ones((len(u2), 1))])
        l2 = p1 @ F.T              # epiline of left point in right image
        l1 = p2 @ F                # epiline of right point in left image
        d2 = np.abs(np.sum(p2 * l2, axis=1)) / np.hypot(l2[:, 0], l2[:, 1])
        d1 = np.abs(np.sum(p1 * l1, axis=1)) / np.hypot(l1[:, 0], l1[:, 1])
        total += d1.sum() + d2.sum()
        n += 2 * len(u1)
    return total / max(n, 1)
