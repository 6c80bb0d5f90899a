"""Seeded layered stereo scenes, made on the device, handed over as uint8.

A scene is a textured left view over the rectified frame and a disparity
field of fronto-parallel rectangles: a background at the low end of
`disp_range`, then `regions` rectangles painted back to front (the farthest,
smallest disparity, first). The right view is the left one sampled at
x + d(x, y), d in right-view coordinates, and fresh noise where x + d leaves
the frame. The texture is the one of `chip_smoke.synthetic_pair`: a coarse
random grid bilinearly upsampled by 8, times 0.7, plus 0.3 of per-pixel noise.

Every seed gets the same work: the pool's `frames * regions` disparities and
side lengths are evenly spaced over their ranges, and only their assignment
to rectangles, the rectangles' places and the textures come from the seed.

A configuration that rectifies (`calib_dir`) sees the scene through its
calibration: each raw pixel of an eye samples the rectified view at the
point where rectification takes it (`reference.calib.undistort_points` with
the eye's R and P), so the raw frames are what a camera with that
calibration would record of the scene. Raw frames are handed side by side,
as the ZED does.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from portbench.reference import calib as ref_calib


def generator(seed: int, dev) -> torch.Generator:
    """A generator on `dev` for any whole-number seed: the seed is hashed to
    60 bits, so that seeds equal in their low 32 bits (all the CPU's
    Mersenne Twister keeps) still differ."""
    g = torch.Generator(device=dev)
    g.manual_seed(int(hashlib.sha256(str(int(seed)).encode()).hexdigest()[:15], 16))
    return g


def _span(text: str) -> tuple[int, int]:
    lo, hi = (int(v) for v in str(text).split("-"))
    if not 0 <= lo <= hi:
        raise ValueError(f"bad range {text!r}")
    return lo, hi


def _spread(lo: int, hi: int, n: int, g: torch.Generator, dev) -> torch.Tensor:
    """`n` integers evenly spaced over [lo, hi], in a seeded order."""
    vals = torch.from_numpy(np.rint(np.linspace(lo, hi, n)).astype(np.int64)).to(dev)
    return vals[torch.randperm(n, generator=g, device=dev)]


def texture(H: int, W: int, g: torch.Generator, dev) -> torch.Tensor:
    """(H, W, 3) float32 in [0, 1]."""
    coarse = torch.rand((H // 8 + 2, W // 8 + 2, 3), generator=g, device=dev)
    yy = torch.arange(H, device=dev, dtype=torch.float32) / 8.0
    xx = torch.arange(W, device=dev, dtype=torch.float32) / 8.0
    y0, x0 = yy.long(), xx.long()
    fy, fx = (yy - y0)[:, None, None], (xx - x0)[None, :, None]
    c00, c10 = coarse[y0][:, x0], coarse[y0 + 1][:, x0]
    c01, c11 = coarse[y0][:, x0 + 1], coarse[y0 + 1][:, x0 + 1]
    tex = (c00 * (1 - fy) * (1 - fx) + c10 * fy * (1 - fx)
           + c01 * (1 - fy) * fx + c11 * fy * fx)
    return (0.7 * tex + 0.3 * torch.rand((H, W, 3), generator=g, device=dev)).clamp(0, 1)


def disparity_field(H: int, W: int, disps, heights, widths, background: int,
                    g: torch.Generator, dev) -> torch.Tensor:
    """(H, W) int64: the background, then each rectangle back to front."""
    d = torch.full((H, W), background, dtype=torch.int64, device=dev)
    order = torch.argsort(disps, stable=True).tolist()
    ys = torch.rand(len(order), generator=g, device=dev).tolist()
    xs = torch.rand(len(order), generator=g, device=dev).tolist()
    disps, heights, widths = disps.tolist(), heights.tolist(), widths.tolist()
    for i in order:
        h, w = min(heights[i], H), min(widths[i], W)
        y0, x0 = int(ys[i] * (H - h + 1)), int(xs[i] * (W - w + 1))
        d[y0:y0 + h, x0:x0 + w] = disps[i]
    return d


def scene_pairs(H: int, W: int, frames: int, scene: dict, seed: int, dev):
    """`frames` scenes of (H, W): a list of ((H, W, 3) left, right) float32
    pairs on `dev` and their (H, W) disparity fields."""
    g = generator(seed, dev)
    n = frames * scene["regions"]
    lo, hi = _span(scene["disp_range"])
    s_lo, s_hi = _span(scene["side_px"])
    disps = _spread(lo, hi, n, g, dev).view(frames, -1)
    heights = _spread(s_lo, s_hi, n, g, dev).view(frames, -1)
    widths = _spread(s_lo, s_hi, n, g, dev).view(frames, -1)
    rows = torch.arange(H, device=dev)[:, None]
    out = []
    for f in range(frames):
        left = texture(H, W, g, dev)
        d = disparity_field(H, W, disps[f], heights[f], widths[f], lo, g, dev)
        src = torch.arange(W, device=dev)[None, :] + d
        noise = torch.rand((H, W, 3), generator=g, device=dev)
        right = torch.where((src < W)[..., None], left[rows, src.clamp(max=W - 1)], noise)
        out.append(((left, right), d))
    return out


def to_u8(img: torch.Tensor) -> torch.Tensor:
    return torch.round(img * 255).clamp(0, 255).to(torch.uint8)


def _bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(H, W, C) sampled at xy (..., 2) = (x, y), clamped to the edge."""
    H, W = img.shape[:2]
    x = xy[..., 0].clamp(0, W - 1)
    y = xy[..., 1].clamp(0, H - 1)
    xi = torch.floor(x).long().clamp(max=W - 2)
    yi = torch.floor(y).long().clamp(max=H - 2)
    fx, fy = (x - xi)[..., None], (y - yi)[..., None]
    return ((img[yi, xi] * (1 - fx) + img[yi, xi + 1] * fx) * (1 - fy)
            + (img[yi + 1, xi] * (1 - fx) + img[yi + 1, xi + 1] * fx) * fy)


def raw_coords(calib: dict, rect: dict, img_size, calib_size, dev) -> list[torch.Tensor]:
    """Each eye's raw pixels' (x, y) in the rectified frame, (H, W, 2) float32."""
    w, h = img_size
    M1, M2 = ref_calib.scaled_cameras(calib, img_size, calib_size)
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    uv = np.stack([gx, gy], axis=-1)
    return [torch.as_tensor(ref_calib.undistort_points(uv, M, calib[Dk], R=rect[Rk], P=rect[Pk]),
                            dtype=torch.float32, device=dev)
            for M, Dk, Rk, Pk in ((M1, "D1", "R1", "P1"), (M2, "D2", "R2", "P2"))]


def make_pool(cfg: dict, traffic: dict, seed: int, dev, rect: dict | None = None,
              calib: dict | None = None) -> list:
    """The cell's pool of distinct frames as the camera hands them, on the host:
    (2, H, W, 3) uint8 pairs, or (H, 2 W, 3) uint8 side-by-side raw frames
    where the configuration rectifies (`rect`, `calib` given)."""
    W, H = cfg["camera"]["eye_size"]
    pool = []
    coords = None if rect is None else raw_coords(calib, rect, (W, H), cfg["calib_size"], dev)
    for (left, right), _ in scene_pairs(H, W, traffic["pool"], traffic["scene"], seed, dev):
        if coords is None:
            frame = torch.stack([to_u8(left), to_u8(right)])
        else:
            frame = torch.cat([to_u8(_bilinear(v, xy)) for v, xy in zip((left, right), coords)],
                              dim=1)
        pool.append(frame.cpu().numpy())
    return pool


def eyes(frame: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A pool frame as the camera's (left, right) uint8 images."""
    if frame.ndim == 4:
        return frame[0], frame[1]
    w = frame.shape[1] // 2
    return frame[:, :w], frame[:, w:]
