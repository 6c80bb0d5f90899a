"""Chessboard corner detection + sub-pixel refinement.

The reference detects 9x6 inner corners with cv::findChessboardCorners +
cornerSubPix during interactive calibration (src/StereoCalib.cpp:129-160,
captureChessboards src/StereoMatch.cpp:489-526). This module implements the
same capability from first principles:

  detect   — checkerboard inner corners are saddle points of the intensity
             surface: strong negative Hessian determinant. Response =
             -(Ixx*Iyy - Ixy^2) after Gaussian smoothing, non-max
             suppressed, thresholded.
  organize — fit a homography from the unit lattice to the 4 extreme
             detected corners (max-area quadrilateral on the convex hull),
             predict all lattice positions, greedily match and re-fit.
  refine   — classic cornerSubPix iteration: the gradient at any window
             point is orthogonal to its offset from the true corner, so
             the corner solves (sum g g^T) q = sum (g g^T) p.

Returns corners in OpenCV's row-major order (pattern_size = (cols, rows),
first corner = lattice (0,0)), canonicalized so the first corner is the
one nearest the image top-left.
"""

from __future__ import annotations

import itertools

import numpy as np


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    r = max(1, int(3 * sigma))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k /= k.sum()
    out = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 0, img)
    return np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 1, out)


def saddle_response(gray: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    """-det(Hessian) of the smoothed image: >> 0 at checkerboard corners."""
    g = _gaussian_blur(np.asarray(gray, np.float64), sigma)
    gy, gx = np.gradient(g)
    gyy, gyx = np.gradient(gy)
    gxy, gxx = np.gradient(gx)
    return -(gxx * gyy - gxy * gyx)


def _shift(img: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """img sampled at (y+dy, x+dx) with edge clamping."""
    H, W = img.shape
    ys = np.clip(np.arange(H) + dy, 0, H - 1)
    xs = np.clip(np.arange(W) + dx, 0, W - 1)
    return img[np.ix_(ys, xs)]


def ring_score(
    gray: np.ndarray,
    radii: tuple[int, ...] = (3, 5),
    n_samples: int = 16,
    sigma: float = 1.0,
) -> np.ndarray:
    """Normalized checkerboard-corner response on a sampling circle.

    A chessboard inner corner is point-symmetric (same color across the
    center: f(t+pi) = f(t)) and quarter-anti-symmetric (opposite color a
    quarter turn away: f(t+pi/2) = -f(t)) in the center-subtracted
    intensities f sampled on a small circle. Score:

        S = sum_i f_i f_{i+N/2}  -  sum_i f_i f_{i+N/4},
        normalized by the ring energy 2 * sum_i f_i^2  ->  [-1, 1].

    Corners -> ~+1; straight edges (f(t+pi) = -f(t)) -> negative; blobs
    and flat/noise regions -> ~0. The normalization cancels local
    contrast, so vignetting / lighting gradients do not reorder peaks —
    the property the -det(Hessian) response lacks on real photographs.
    Multi-scale: max over `radii` (board squares from ~2*r_min px up).
    """
    g = _gaussian_blur(np.asarray(gray, np.float64), sigma)
    best = None
    for r in radii:
        fs = []
        for i in range(n_samples):
            t = 2.0 * np.pi * i / n_samples
            dy = int(round(r * np.sin(t)))
            dx = int(round(r * np.cos(t)))
            fs.append(_shift(g, dy, dx) - g)
        fs = np.stack(fs)
        half = np.einsum("iyx,iyx->yx", fs, np.roll(fs, n_samples // 2, axis=0))
        quart = np.einsum("iyx,iyx->yx", fs, np.roll(fs, n_samples // 4, axis=0))
        energy = np.einsum("iyx,iyx->yx", fs, fs)
        # the energy floor keeps flat/noise regions at ~0 without letting
        # genuinely low-contrast corners vanish: 1% of the mean ring energy
        s = (half - quart) / (2.0 * energy + 0.01 * energy.mean() + 1e-12)
        best = s if best is None else np.maximum(best, s)
    return best


def _nms_peaks(resp: np.ndarray, n_peaks: int, radius: int = 5,
               return_values: bool = False, threshold: float | None = None):
    """Greedy non-max suppression: top responses with exclusion radius."""
    r = resp.copy()
    H, W = r.shape
    pts = []
    vals = []
    thresh = r.max() * 0.05 if threshold is None else threshold
    for _ in range(n_peaks):
        idx = np.argmax(r)
        y, x = divmod(int(idx), W)
        if r[y, x] < thresh:
            break
        pts.append((x, y))
        vals.append(resp[y, x])
        y0, y1 = max(0, y - radius), min(H, y + radius + 1)
        x0, x1 = max(0, x - radius), min(W, x + radius + 1)
        r[y0:y1, x0:x1] = -np.inf
    pts = np.asarray(pts, np.float64)
    if return_values:
        return pts, np.asarray(vals)
    return pts


def _gap_select(pts: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """Keep the strongest peaks up to the largest response gap at or past
    rank n: inner chessboard corners respond ~2x stronger than the
    spurious saddles at the board's outer boundary."""
    if len(pts) <= n:
        return pts
    ratios = vals[n - 1 : -1] / np.maximum(vals[n:], 1e-12)
    k = n + int(np.argmax(ratios))
    if ratios.max() > 1.5:
        return pts[:k]
    return pts


def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """DLT homography with Hartley normalization. src, dst: (N, 2)."""
    def normalize(p):
        c = p.mean(axis=0)
        s = np.sqrt(2) / max(np.mean(np.linalg.norm(p - c, axis=1)), 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
        ph = np.hstack([p, np.ones((len(p), 1))]) @ T.T
        return ph[:, :2], T

    sp, Ts = normalize(src)
    dp, Td = normalize(dst)
    A = []
    for (x, y), (u, v) in zip(sp, dp):
        A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ H @ Ts
    return H / H[2, 2]


def _apply_h(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    ph = np.hstack([pts, np.ones((len(pts), 1))]) @ H.T
    return ph[:, :2] / ph[:, 2:3]


def _cross2(a: np.ndarray, b: np.ndarray) -> float:
    return float(a[0] * b[1] - a[1] * b[0])


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; returns hull vertices CCW."""
    p = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out = []
        for q in seq:
            while len(out) >= 2 and _cross2(out[-1] - out[-2], q - out[-2]) <= 0:
                out.pop()
            out.append(q)
        return out

    lower = half(p)
    upper = half(p[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def _extreme_quad(pts: np.ndarray) -> np.ndarray:
    """4 hull vertices forming the maximum-area quadrilateral, CCW."""
    hull = _convex_hull(pts)
    n = len(hull)
    if n <= 4:
        quad = hull
    else:
        best, quad = -1.0, hull[:4]
        for comb in itertools.combinations(range(n), 4):
            q = hull[list(comb)]
            a = 0.5 * abs(
                _cross2(q[1] - q[0], q[2] - q[0])
            ) + 0.5 * abs(_cross2(q[2] - q[0], q[3] - q[0]))
            if a > best:
                best, quad = a, q
    # CCW order starting from the vertex nearest the centroid's top-left
    c = quad.mean(axis=0)
    ang = np.arctan2(quad[:, 1] - c[1], quad[:, 0] - c[0])
    return quad[np.argsort(ang)]


def organize_grid(
    pts: np.ndarray, pattern_size: tuple[int, int]
) -> np.ndarray | None:
    """Order detected corners into the (cols*rows, 2) row-major lattice by
    iterative homography fitting. Returns None if matching fails."""
    cols, rows = pattern_size
    n = cols * rows
    if len(pts) < n:
        return None
    lattice = np.array(
        [[j, i] for i in range(rows) for j in range(cols)], np.float64
    )
    corners_l = np.array(
        [[0, 0], [cols - 1, 0], [cols - 1, rows - 1], [0, rows - 1]], np.float64
    )
    quad = _extreme_quad(pts)

    best = None
    best_err = np.inf
    for k in range(4):
        for flip in (False, True):
            q = quad[[(i + k) % 4 for i in range(4)]]
            if flip:
                q = q[::-1]
            H = _homography(corners_l, q)
            pred = _apply_h(H, lattice)
            # greedy nearest matching
            d = np.linalg.norm(pred[:, None, :] - pts[None, :, :], axis=-1)
            match = np.full(n, -1, np.int64)
            used = np.zeros(len(pts), bool)
            order = np.argsort(d.min(axis=1))
            ok = True
            for i in order:
                cand = np.argsort(d[i])
                for c in cand:
                    if not used[c]:
                        match[i] = c
                        used[c] = True
                        break
                else:
                    ok = False
                    break
            if not ok:
                continue
            matched = pts[match]
            # refine H on all matches and score
            H2 = _homography(lattice, matched)
            err = np.linalg.norm(_apply_h(H2, lattice) - matched, axis=1).mean()
            if err < best_err:
                best_err = err
                best = matched
    if best is None or best_err > 5.0:
        return None
    # canonicalize: a homography fits mirrored assignments equally well,
    # so fix the handedness (x-step x y-step positive in image coords),
    # then resolve the remaining 180-degree ambiguity by putting the first
    # corner nearest the image origin. Cameras of a stereo rig share an
    # approximate orientation, so both views canonicalize to the SAME
    # physical corner ordering.
    g = best.reshape(rows, cols, 2)
    xs = g[0, 1] - g[0, 0]
    ys = g[1, 0] - g[0, 0]
    if _cross2(xs, ys) < 0:
        g = g[:, ::-1]
    if np.linalg.norm(g[0, 0]) > np.linalg.norm(g[-1, -1]):
        g = g[::-1, ::-1]
    return g.reshape(-1, 2)


def corner_subpix(
    gray: np.ndarray, corners: np.ndarray, win: int = 5,
    iters: int = 30, eps: float = 1e-3,
) -> np.ndarray:
    """cv::cornerSubPix iteration: solve (sum w g g^T) q = sum w (g g^T) p
    over a (2*win+1)^2 window with a Gaussian-ish weight."""
    img = np.asarray(gray, np.float64)
    H, W = img.shape
    gy, gx = np.gradient(img)
    ys, xs = np.mgrid[-win : win + 1, -win : win + 1]
    wgt = np.exp(-(xs * xs + ys * ys) / (2.0 * (win / 2.0) ** 2))

    out = corners.astype(np.float64).copy()
    for i, (cx, cy) in enumerate(out):
        for _ in range(iters):
            x0, y0 = int(round(cx)), int(round(cy))
            if not (win <= x0 < W - win and win <= y0 < H - win):
                break
            gxx = gx[y0 - win : y0 + win + 1, x0 - win : x0 + win + 1]
            gyy = gy[y0 - win : y0 + win + 1, x0 - win : x0 + win + 1]
            a = np.sum(wgt * gxx * gxx)
            b = np.sum(wgt * gxx * gyy)
            c = np.sum(wgt * gyy * gyy)
            px = x0 + xs
            py = y0 + ys
            bx = np.sum(wgt * (gxx * gxx * px + gxx * gyy * py))
            by = np.sum(wgt * (gxx * gyy * px + gyy * gyy * py))
            det = a * c - b * b
            if abs(det) < 1e-12:
                break
            nx = (c * bx - b * by) / det
            ny = (a * by - b * bx) / det
            if (nx - cx) ** 2 + (ny - cy) ** 2 < eps * eps:
                cx, cy = nx, ny
                break
            cx, cy = nx, ny
        out[i] = (cx, cy)
    return out


def find_chessboard_corners(
    gray: np.ndarray,
    pattern_size: tuple[int, int] = (9, 6),
    sigma: float = 2.0,
    subpix: bool = True,
) -> np.ndarray | None:
    """Full detection pipeline; (cols*rows, 2) float64 corners or None.

    Primary detector: the illumination-invariant `ring_score` (robust on
    photographs: vignetting, clutter, defocus). Candidates are organized
    strongest-n first, widening to the full candidate set if the lattice
    fit fails; the legacy -det(Hessian) response is the last fallback
    (it is slightly sharper on clean, clutter-free renders).
    """
    n = pattern_size[0] * pattern_size[1]
    resp = ring_score(gray)
    pts, vals = _nms_peaks(
        resp, n_peaks=n + 20, return_values=True, threshold=0.35,
    )
    attempts = [pts[:n], pts] if len(pts) > n else [pts]
    # fallback: the saddle response with its gap heuristic
    spts, svals = _nms_peaks(saddle_response(gray, sigma), n_peaks=n + 12,
                             return_values=True)
    attempts.append(_gap_select(spts, svals, n))
    for cand in attempts:
        grid = organize_grid(cand, pattern_size)
        if grid is not None:
            return corner_subpix(gray, grid) if subpix else grid
    return None
