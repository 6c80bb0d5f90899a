"""Plain rectification: the reference that judges the port's rectified crops.

Frozen copies, in NumPy float64, of the published algorithms the reference
binary calls once per geometry (src/StereoMatch.cpp:394-487): the OpenCV YML
reader, the rational + tangential + thin-prism distortion model and its
fixed-point inverse, Bouguet's `stereoRectify` (CALIB_ZERO_DISPARITY,
alpha = 1) with its valid-pixel ROIs and their intersection as the crop
box, and `initUndistortRectifyMap`; then the per-frame bilinear remap
(INTER_LINEAR, BORDER_CONSTANT 0) of the crop in torch, in float32 with the
blend's terms in the port's order. Imports nothing of the program.

The traffic generator uses `undistort_points` to place each raw pixel in
the rectified frame, so the raw frames see a known rectified scene.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def read_opencv_yml(path) -> dict:
    """The `!!opencv-matrix` entries of an OpenCV FileStorage YML."""
    with open(path) as f:
        text = f.read()
    out = {}
    mat_re = re.compile(r"^(\w+): !!opencv-matrix\s*\n\s*rows:\s*(\d+)\s*\n\s*cols:\s*(\d+)"
                        r"\s*\n\s*dt:\s*(\w+)\s*\n\s*data:\s*\[([^\]]*)\]", re.MULTILINE)
    for m in mat_re.finditer(text):
        name, rows, cols, _, data = m.groups()
        vals = [float(v) for v in data.replace("\n", " ").split(",") if v.strip()]
        out[name] = np.asarray(vals, np.float64).reshape(int(rows), int(cols))
    return out


def load_calibration(calib_dir) -> dict:
    return {**read_opencv_yml(f"{calib_dir}/intrinsics.yml"),
            **read_opencv_yml(f"{calib_dir}/extrinsics.yml")}


def _coeffs(dist) -> np.ndarray:
    d = np.zeros(14)
    dist = np.asarray(dist, np.float64).reshape(-1)
    d[: dist.size] = dist
    if d[12] != 0 or d[13] != 0:
        raise NotImplementedError("tilted-sensor (tau) distortion")
    return d


def distort_points(xy: np.ndarray, dist) -> np.ndarray:
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


def undistort_points(uv: np.ndarray, A, dist, R=None, P=None, iterations: int = 5):
    """Pixel coords -> ideal normalized coords (or pixel coords of P),
    rotated by R: the classic 5-step fixed-point inverse."""
    A = np.asarray(A, np.float64)
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
    """Rotation vector <-> matrix, by shape."""
    r = np.asarray(r, np.float64)
    if r.shape == (3, 3):
        cos_t = np.clip((np.trace(r) - 1) * 0.5, -1.0, 1.0)
        theta = np.arccos(cos_t)
        if theta < 1e-12:
            return np.zeros(3)
        if abs(np.pi - theta) < 1e-6:
            M = (r + np.eye(3)) * 0.5
            axis = np.sqrt(np.maximum(np.diagonal(M), 0))
            if axis[0] > 0:
                axis[1] = np.copysign(axis[1], M[0, 1])
                axis[2] = np.copysign(axis[2], M[0, 2])
            elif axis[1] > 0:
                axis[2] = np.copysign(axis[2], M[1, 2])
            return axis / np.linalg.norm(axis) * theta
        v = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
        return v * (theta / (2 * np.sin(theta)))
    v = r.reshape(3)
    theta = np.linalg.norm(v)
    if theta < 1e-12:
        return np.eye(3)
    a = v / theta
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _rectangles(A, dist, R, P, img_size, n: int = 9):
    """Inner and outer rectangles (x0, y0, w, h) of the undistorted footprint."""
    w, h = img_size
    gx, gy = np.meshgrid(np.linspace(0, w - 1, n), np.linspace(0, h - 1, n))
    und = undistort_points(np.stack([gx, gy], axis=-1).reshape(-1, 2), A, dist,
                           R=R, P=P).reshape(n, n, 2)
    ox0, oy0 = und[..., 0].min(), und[..., 1].min()
    ox1, oy1 = und[..., 0].max(), und[..., 1].max()
    ix0, ix1 = und[:, 0, 0].max(), und[:, -1, 0].min()
    iy0, iy1 = und[0, :, 1].max(), und[-1, :, 1].min()
    return (ix0, iy0, ix1 - ix0, iy1 - iy0), (ox0, oy0, ox1 - ox0, oy1 - oy0)


def stereo_rectify(M1, D1, M2, D2, img_size, R, T, alpha: float = 1.0) -> dict:
    """Bouguet's rectification with CALIB_ZERO_DISPARITY: R1, R2, P1, P2, Q
    and the crop box (x0, y0, x1, y1), the intersection of both valid ROIs."""
    w, h = img_size
    T = np.asarray(T, np.float64).reshape(3)
    om = rodrigues(np.asarray(R, np.float64))
    r_half = rodrigues(-0.5 * om)
    t = r_half @ T
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c = t[idx]
    nt = np.linalg.norm(t)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0:
        ww *= np.arccos(min(abs(c) / nt, 1.0)) / nw
    wR = rodrigues(ww)
    R1 = wR @ r_half.T
    R2 = wR @ r_half
    t_new = R2 @ T

    fcs = []
    for A, Dk in ((M1, D1), (M2, D2)):
        fc = np.asarray(A, np.float64)[idx ^ 1, idx ^ 1]
        dk1 = np.asarray(Dk, np.float64).reshape(-1)[0]
        if dk1 < 0:
            fc *= 1 + dk1 * (w * w + h * h) / (4 * fc * fc)
        fcs.append(fc)
    fc_new = min(fcs)

    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float64)
    cc = []
    for A, Dk, Rk in ((M1, D1, R1), (M2, D2, R2)):
        avg = undistort_points(corners, A, Dk, R=Rk).mean(axis=0)
        cc.append(np.array([(w - 1) / 2 - avg[0] * fc_new, (h - 1) / 2 - avg[1] * fc_new]))
    m = (cc[0] + cc[1]) * 0.5
    cc = [m.copy(), m.copy()]

    def proj(ck):
        P = np.zeros((3, 4))
        P[0, 0] = P[1, 1] = fc_new
        P[0, 2], P[1, 2] = ck
        P[2, 2] = 1.0
        return P

    P1, P2 = proj(cc[0]), proj(cc[1])
    (in1, out1), (in2, out2) = (_rectangles(A, Dk, Rk, Pk, img_size) for A, Dk, Rk, Pk in
                                ((M1, D1, R1, P1), (M2, D2, R2, P2)))

    def ratios(ckx, cky, rect):
        x0, y0, rw, rh = rect
        return [ckx / (ckx - x0), (w - ckx) / (x0 + rw - ckx),
                cky / (cky - y0), (h - cky) / (y0 + rh - cky)]

    alpha = min(max(alpha, 0.0), 1.0)
    s0 = max(ratios(*cc[0], in1) + ratios(*cc[1], in2))
    s1 = min(ratios(*cc[0], out1) + ratios(*cc[1], out2))
    s = s0 * (1 - alpha) + s1 * alpha
    fc_new *= s
    P1[0, 0] = P1[1, 1] = fc_new
    P2[0, 0] = P2[1, 1] = fc_new
    P2[idx, 3] = t_new[idx] * fc_new
    Q = np.zeros((4, 4))
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3], Q[1, 3], Q[2, 3] = -cc[0][0], -cc[0][1], fc_new
    Q[3, 2] = -1.0 / t_new[idx]
    Q[3, 3] = (cc[0][0] - cc[1][0]) / t_new[idx] if idx == 0 else 0.0

    def valid_roi(ck0, rect):
        x0, y0, rw, rh = rect
        rx0 = int(np.ceil((x0 - ck0[0]) * s + ck0[0]))
        ry0 = int(np.ceil((y0 - ck0[1]) * s + ck0[1]))
        rx1 = int(np.floor(rw * s)) + rx0
        ry1 = int(np.floor(rh * s)) + ry0
        rx0, ry0 = max(rx0, 0), max(ry0, 0)
        rx1, ry1 = min(rx1, w), min(ry1, h)
        return rx0, ry0, max(rx1 - rx0, 0), max(ry1 - ry0, 0)

    r1, r2 = valid_roi(cc[0], in1), valid_roi(cc[1], in2)
    crop = (max(r1[0], r2[0]), max(r1[1], r2[1]),
            min(r1[0] + r1[2], r2[0] + r2[2]), min(r1[1] + r1[3], r2[1] + r2[3]))
    return {"R1": R1, "R2": R2, "P1": P1, "P2": P2, "Q": Q, "crop": crop}


def init_undistort_rectify_map(A, dist, R, P, img_size) -> np.ndarray:
    """(H, W, 2) float32 raw-image coordinates of each rectified pixel."""
    w, h = img_size
    iR = np.linalg.inv(np.asarray(P, np.float64)[:3, :3] @ np.asarray(R, np.float64))
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    xyz = np.stack([u, v, np.ones_like(u)], axis=-1) @ iR.T
    d = distort_points(xyz[..., :2] / xyz[..., 2:3], dist)
    A = np.asarray(A, np.float64)
    return np.stack([A[0, 0] * d[..., 0] + A[0, 2], A[1, 1] * d[..., 1] + A[1, 2]],
                    axis=-1).astype(np.float32)


def scaled_cameras(calib: dict, img_size, calib_size) -> tuple[np.ndarray, np.ndarray]:
    """The camera matrices rescaled from the calibration's size to the frames'."""
    M1, M2 = (np.asarray(calib[k], np.float64) for k in ("M1", "M2"))
    if calib_size is not None and tuple(calib_size) != tuple(img_size):
        S = np.diag([img_size[0] / calib_size[0], img_size[1] / calib_size[1], 1.0])
        M1, M2 = S @ M1, S @ M2
    return M1, M2


def rectification(calib: dict, img_size, calib_size) -> dict:
    """The rectification of frames of `img_size` (width, height) an eye:
    `stereo_rectify`'s output and both eyes' maps."""
    M1, M2 = scaled_cameras(calib, img_size, calib_size)
    rect = stereo_rectify(M1, calib["D1"], M2, calib["D2"], img_size, calib["R"], calib["T"])
    rect["maps"] = [init_undistort_rectify_map(M, calib[Dk], rect[Rk], rect[Pk], img_size)
                    for M, Dk, Rk, Pk in ((M1, "D1", "R1", "P1"), (M2, "D2", "R2", "P2"))]
    return rect


def remap_crop(raw_u8: torch.Tensor, map_xy: np.ndarray, crop, dtype=torch.float32):
    """cv::remap(INTER_LINEAR, BORDER_CONSTANT 0) of an (H, W, 3) uint8 image
    over the crop box of its map, rounded half to even: (h, w, 3) uint8."""
    x0, y0, x1, y1 = crop
    H, W, C = raw_u8.shape
    dev = raw_u8.device
    m = torch.as_tensor(np.ascontiguousarray(map_xy[y0:y1, x0:x1]), device=dev).to(dtype)
    mx, my = m[..., 0], m[..., 1]
    fx0, fy0 = torch.floor(mx), torch.floor(my)
    fx, fy = mx - fx0, my - fy0
    xi, yi = fx0.to(torch.int64), fy0.to(torch.int64)
    img = raw_u8.reshape(-1, C).to(dtype)
    taps = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        ty, tx = yi + dy, xi + dx
        inside = (ty >= 0) & (ty < H) & (tx >= 0) & (tx < W)
        v = img[(ty.clamp(0, H - 1) * W + tx.clamp(0, W - 1)).reshape(-1)].reshape(*ty.shape, C)
        taps.append(torch.where(inside[..., None], v, torch.zeros_like(v)))
    fx, fy = fx[..., None], fy[..., None]
    gx, gy = 1.0 - fx, 1.0 - fy
    top = taps[0] * gx + taps[1] * fx
    bot = taps[2] * gx + taps[3] * fx
    out = top * gy + bot * fy
    return torch.round(out.float()).clamp(0, 255).to(torch.uint8)
