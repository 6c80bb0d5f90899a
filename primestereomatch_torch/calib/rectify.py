"""Stereo rectification: Bouguet's algorithm + undistort-rectify maps.

Mirrors the reference's camera-setup path (src/StereoMatch.cpp:394-487):
load M/D/R/T from YML, stereoRectify(CALIB_ZERO_DISPARITY, alpha=1) with
valid-pixel ROIs, initUndistortRectifyMap per eye, bilinear remap, and the
ROI-intersection crop box. The rectify solve is host-side NumPy float64
(offline, once per geometry; a copy of the JAX package's calib/rectify.py);
the per-frame remap is a torch gather on the device (ops/remap.py).

The implementation reproduces the algorithm's published behaviour; it is
validated against the golden R1/R2/P1/P2/Q in data/extrinsics.yml (which
the upstream toolchain computed from the same M/D/R/T inputs) in
tests/test_torch_calib.py, which also holds it to the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from primestereomatch_torch.calib.distortion import (
    distort_points,
    rodrigues,
    undistort_points,
)
from primestereomatch_torch.calib.ymlio import read_opencv_yml
from primestereomatch_torch.ops.remap import bilinear_taps, blend, cast_like, padded_rows
from primestereomatch_torch.utils.device import resolve_device
from primestereomatch_torch.utils.profiling import span

SPAN = "psm.rectify"     # a frame's rectification (utils/profiling.py::span)


def _rectangles(
    A: np.ndarray, dist: np.ndarray, R: np.ndarray, P: np.ndarray,
    img_size: tuple[int, int], n: int = 9,
) -> tuple[tuple, tuple]:
    """Inner/outer rectangles of the undistorted image footprint, sampled
    on an n x n grid (in the NEW projection's pixel coords).

    outer = bounding box of all sampled points; inner = the largest
    axis-aligned box using border-row/column extrema (leftmost column's
    max x, etc.). Returns ((x0, y0, w, h), (x0, y0, w, h))."""
    w, h = img_size
    xs = np.linspace(0, w - 1, n)
    ys = np.linspace(0, h - 1, n)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx, gy], axis=-1).reshape(-1, 2)
    und = undistort_points(pts, A, dist, R=R, P=P).reshape(n, n, 2)

    ox0, oy0 = und[..., 0].min(), und[..., 1].min()
    ox1, oy1 = und[..., 0].max(), und[..., 1].max()
    ix0 = und[:, 0, 0].max()
    ix1 = und[:, -1, 0].min()
    iy0 = und[0, :, 1].max()
    iy1 = und[-1, :, 1].min()
    inner = (ix0, iy0, ix1 - ix0, iy1 - iy0)
    outer = (ox0, oy0, ox1 - ox0, oy1 - oy0)
    return inner, outer


@dataclasses.dataclass
class StereoRectification:
    R1: np.ndarray
    R2: np.ndarray
    P1: np.ndarray
    P2: np.ndarray
    Q: np.ndarray
    roi1: tuple[int, int, int, int]   # (x, y, w, h) valid pixels, left
    roi2: tuple[int, int, int, int]

    @property
    def crop_box(self) -> tuple[int, int, int, int]:
        """Intersection of the two valid ROIs (x0, y0, x1, y1) — the
        reference's cropBox (src/StereoMatch.cpp:474-481)."""
        tl_x = max(self.roi1[0], self.roi2[0])
        tl_y = max(self.roi1[1], self.roi2[1])
        br_x = min(self.roi1[0] + self.roi1[2], self.roi2[0] + self.roi2[2])
        br_y = min(self.roi1[1] + self.roi1[3], self.roi2[1] + self.roi2[3])
        return tl_x, tl_y, br_x, br_y


def stereo_rectify(
    M1: np.ndarray, D1: np.ndarray, M2: np.ndarray, D2: np.ndarray,
    img_size: tuple[int, int],        # (width, height)
    R: np.ndarray, T: np.ndarray,
    alpha: float = 1.0,
    zero_disparity: bool = True,
) -> StereoRectification:
    """Bouguet stereo rectification.

    Both cameras are rotated halfway toward a common orientation, then
    about the axis that aligns the baseline with the horizontal epipolar
    direction. A shared focal length and (with zero_disparity) shared
    principal point are chosen from the undistorted corner footprints;
    alpha in [0, 1] blends between the all-valid zoom (0) and the
    all-pixels zoom (1). The reference always calls with alpha=1 and
    CALIB_ZERO_DISPARITY (src/StereoMatch.cpp:456-458).
    """
    w, h = img_size
    T = np.asarray(T, np.float64).reshape(3)

    # split the inter-camera rotation between the two views
    om = rodrigues(np.asarray(R, np.float64))
    r_half = rodrigues(-0.5 * om)
    t = r_half @ T

    # rotate so the baseline becomes the dominant image axis
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

    # shared focal length: min over cameras, first-order shrink for k1 < 0
    fcs = []
    for A, D in ((M1, D1), (M2, D2)):
        fc = np.asarray(A, np.float64)[idx ^ 1, idx ^ 1]
        dk1 = np.asarray(D, np.float64).reshape(-1)[0]
        if dk1 < 0:
            fc *= 1 + dk1 * (w * w + h * h) / (4 * fc * fc)
        fcs.append(fc)
    fc_new = min(fcs)

    # principal points from the undistorted, rotated image corners
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float64)
    cc = []
    for A, D, Rk in ((M1, D1, R1), (M2, D2, R2)):
        und = undistort_points(corners, A, D, R=Rk)
        avg = und.mean(axis=0)
        cc.append(np.array([(w - 1) / 2 - avg[0] * fc_new,
                            (h - 1) / 2 - avg[1] * fc_new]))
    if zero_disparity:
        m = (cc[0] + cc[1]) * 0.5
        cc = [m.copy(), m.copy()]
    else:
        # only the coordinate orthogonal to the baseline must agree
        mean_ortho = (cc[0][idx ^ 1] + cc[1][idx ^ 1]) * 0.5
        cc[0][idx ^ 1] = mean_ortho
        cc[1][idx ^ 1] = mean_ortho

    def proj(ck):
        P = np.zeros((3, 4))
        P[0, 0] = P[1, 1] = fc_new
        P[0, 2], P[1, 2] = ck
        P[2, 2] = 1.0
        return P

    P1 = proj(cc[0])
    P2 = proj(cc[1])

    # alpha zoom: inner rect (fully valid) vs outer rect (all source pixels)
    rects = []
    for A, D, Rk, Pk in ((M1, D1, R1, P1), (M2, D2, R2, P2)):
        rects.append(_rectangles(A, D, Rk, Pk, img_size))
    (in1, out1), (in2, out2) = rects

    def ratios(ckx, cky, rect):
        x0, y0, rw, rh = rect
        return [
            ckx / (ckx - x0),
            (w - ckx) / (x0 + rw - ckx),
            cky / (cky - y0),
            (h - cky) / (y0 + rh - cky),
        ]

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
    Q[0, 3] = -cc[0][0]
    Q[1, 3] = -cc[0][1]
    Q[2, 3] = fc_new
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
        return (rx0, ry0, max(rx1 - rx0, 0), max(ry1 - ry0, 0))

    roi1 = valid_roi(cc[0], in1)
    roi2 = valid_roi(cc[1], in2)
    return StereoRectification(R1=R1, R2=R2, P1=P1, P2=P2, Q=Q, roi1=roi1, roi2=roi2)


def init_undistort_rectify_map(
    A: np.ndarray, dist: np.ndarray, R: np.ndarray, P: np.ndarray,
    img_size: tuple[int, int],
) -> np.ndarray:
    """Float32 (H, W, 2) map of source pixel coordinates per rectified
    destination pixel: invert the new projection, un-rotate, apply the
    forward distortion, project with the original camera matrix.
    (The reference requests the CV_16SC2 fixed-point variant of the same
    map, src/StereoMatch.cpp:466-469 — we keep float for exact gather.)"""
    w, h = img_size
    P = np.asarray(P, np.float64)
    iR = np.linalg.inv(P[:3, :3] @ np.asarray(R, np.float64))
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    ones = np.ones_like(u)
    xyz = np.stack([u, v, ones], axis=-1) @ iR.T
    xy = xyz[..., :2] / xyz[..., 2:3]
    d = distort_points(xy, dist)
    A = np.asarray(A, np.float64)
    mx = A[0, 0] * d[..., 0] + A[0, 2]
    my = A[1, 1] * d[..., 1] + A[1, 2]
    return np.stack([mx, my], axis=-1).astype(np.float32)


def load_stereo_calibration(
    intrinsics_path: str, extrinsics_path: str
) -> dict[str, np.ndarray]:
    """Load the reference's YML pair (paths: include/StereoCalib.h:43-45)."""
    intr = read_opencv_yml(intrinsics_path)
    extr = read_opencv_yml(extrinsics_path)
    return {**intr, **extr}


class Rectifier:
    """Per-frame rectification engine: the two maps on the device, remap
    and crop there.

    Mirrors the reference's per-frame video preamble
    (src/StereoMatch.cpp:130-153): remap both eyes, crop to the shared
    valid box. `device=None` means the CUDA card. The maps go to the device
    once, here, and so do their taps and fractions over the crop box
    (`ops/remap.py::bilinear_taps`): each output pixel reads its own map
    entry, so remapping the crop alone equals remap-then-crop bit for bit.
    A call gathers both eyes at once and returns contiguous
    (y1 - y0, x1 - x0[, C]) tensors, bitwise `remap_bilinear`'s.
    """

    def __init__(
        self,
        calib: dict[str, np.ndarray],
        img_size: tuple[int, int],     # (width, height) of one eye
        alpha: float = 1.0,
        calib_size: tuple[int, int] | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        M1, M2 = calib["M1"], calib["M2"]
        if calib_size is not None and tuple(calib_size) != tuple(img_size):
            # the shipped YMLs are HD720-per-eye calibrations; when frames
            # arrive at a different resolution, rescale the camera matrices
            # (distortion coefficients act on normalized coords — invariant)
            sx = img_size[0] / calib_size[0]
            sy = img_size[1] / calib_size[1]
            S = np.diag([sx, sy, 1.0])
            M1 = S @ np.asarray(M1, np.float64)
            M2 = S @ np.asarray(M2, np.float64)

        self.rect = stereo_rectify(
            M1, calib["D1"], M2, calib["D2"],
            img_size, calib["R"], calib["T"], alpha=alpha,
        )
        calib = {**calib, "M1": M1, "M2": M2}
        self.map_l = torch.as_tensor(init_undistort_rectify_map(
            calib["M1"], calib["D1"], self.rect.R1, self.rect.P1, img_size
        ), device=self.device)
        self.map_r = torch.as_tensor(init_undistort_rectify_map(
            calib["M2"], calib["D2"], self.rect.R2, self.rect.P2, img_size
        ), device=self.device)
        x0, y0, x1, y1 = self.rect.crop_box
        self.crop = (x0, y0, x1, y1)
        # both eyes' taps into one table of pixels: the right eye's rows
        # follow the left's, and -1 reads the zero row after both
        W, H = img_size
        (tl, fl, gl), (tr, fr, gr) = (bilinear_taps(m[y0:y1, x0:x1], H, W)
                                      for m in (self.map_l, self.map_r))
        self._size = (H, W)
        self._taps = torch.stack([tl, torch.where(tr >= 0, tr + H * W, -1)], dim=1)
        self._fx, self._fy = (torch.stack(f)[..., None] for f in ((fl, fr), (gl, gr)))
        self._gx, self._gy = 1.0 - self._fx, 1.0 - self._fy

    def __call__(self, l_img, r_img) -> tuple[torch.Tensor, torch.Tensor]:
        """(H, W[, C]) images of `img_size` (tensors, or numpy arrays
        uploaded once) -> the rectified and cropped pair on the device."""
        with span(SPAN):
            l, r = (torch.as_tensor(img, device=self.device) for img in (l_img, r_img))
            if l.shape[:2] != self._size or r.shape != l.shape or r.dtype != l.dtype:
                raise ValueError(f"expected two {self._size} images of one dtype, got "
                                 f"{tuple(l.shape)} {l.dtype} and {tuple(r.shape)} {r.dtype}")
            C = l.shape[2] if l.dim() == 3 else 1
            v = padded_rows((l, r), C)[self._taps]                # (4, 2, h, w, C)
            out = cast_like(blend(v, self._fx, self._fy, self._gx, self._gy), l.dtype)
            if l.dim() == 2:
                out = out[..., 0]
            return out[0], out[1]
