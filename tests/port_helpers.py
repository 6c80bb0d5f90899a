"""Helpers that the port's tests share (no test_*.py file, so pytest
collects nothing here):

  * a known scene seen by a calibrated camera, for the calibrated-slice
    tests: the synthetic pair of `chip_smoke.synthetic_pair` laid out in
    the rectified frame, the raw camera frames that see it (each raw pixel
    samples the scene at its rectified coordinates), and the checks that a
    disparity map and its depth recover the scene's two levels;
  * VARIANT_CONFIGS, the STEREO_GIF variants that the card tests and the
    JAX package's %BP test both run;
  * `counted_launcher_rank`, one rank of the launcher's worker with the
    sharded step's kernel launches counted."""

import json
import pathlib

import numpy as np

from chip_smoke import synthetic_pair
from primestereomatch_torch.calib import undistort_points

# the STEREO_GIF variants: the uint8 cost, the post-processing toolchain and
# JointWMF's table mode
VARIANT_CONFIGS = {
    "u8": dict(cvc_dtype="u8"),
    "toolchain": dict(pp_toolchain=True),
    "table": dict(wmf_mode="table"),
}


def calibrated_scene(crop, img_size, levels, seed: int):
    """A known scene in the rectified frame (img_size, one eye): the
    synthetic pair over the whole frame, the foreground rectangle in the
    middle half of the crop box. Returns the pair (float32 BGR in [0, 1])
    and the rectangle in crop coordinates (rows, right-view columns)."""
    x0, y0, x1, y1 = crop
    h, w = y1 - y0, x1 - x0
    rect = (h // 4, 3 * h // 4, w // 3, 2 * w // 3)
    full = (rect[0] + y0, rect[1] + y0, rect[2] + x0, rect[3] + x0)
    return (*synthetic_pair(img_size[1], img_size[0], seed, full, *levels), rect)


def _bilinear(img: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """img (H, W, C) sampled at xy (..., 2) = (x, y), clamped to the edge."""
    H, W = img.shape[:2]
    x = np.clip(xy[..., 0], 0, W - 1)
    y = np.clip(xy[..., 1], 0, H - 1)
    xi = np.minimum(np.floor(x).astype(np.int64), W - 2)
    yi = np.minimum(np.floor(y).astype(np.int64), H - 2)
    fx, fy = (x - xi)[..., None], (y - yi)[..., None]
    return ((img[yi, xi] * (1 - fx) + img[yi, xi + 1] * fx) * (1 - fy)
            + (img[yi + 1, xi] * (1 - fx) + img[yi + 1, xi + 1] * fx) * fy)


def raw_coords(calib: dict, rect, img_size, calib_size) -> list:
    """Each eye's raw pixels' coordinates in the rectified frame of `rect`
    (the Rectifier's StereoRectification): undistort_points with the eye's
    R and P and its default iterations. The camera matrices are rescaled
    to img_size as the Rectifier rescales them."""
    w, h = img_size
    M = [np.asarray(calib[k], np.float64) for k in ("M1", "M2")]
    if calib_size is not None and tuple(calib_size) != tuple(img_size):
        S = np.diag([w / calib_size[0], h / calib_size[1], 1.0])
        M = [S @ m for m in M]
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    uv = np.stack([gx, gy], axis=-1)
    return [undistort_points(uv, m, dist, R=R, P=P)
            for m, dist, R, P in zip(M, (calib["D1"], calib["D2"]), (rect.R1, rect.R2),
                                     (rect.P1, rect.P2))]


def raw_frames(calib: dict, rect, img_size, calib_size, scene, coords=None) -> list:
    """The raw camera frames (uint8 BGR) that see `scene`, a pair in the
    rectified frame of `rect`: each raw pixel of an eye takes the scene's
    bilinear sample at its rectified coordinates (`raw_coords`, or
    `coords` computed by it once for many scenes)."""
    coords = coords or raw_coords(calib, rect, img_size, calib_size)
    return [np.clip(np.rint(_bilinear(view, xy) * 255), 0, 255).astype(np.uint8)
            for view, xy in zip(scene, coords)]


def field_regions(rect, levels, D: int, m: int = 16) -> dict:
    """Interior regions of the known field in the left view (crop
    coordinates), each with its level: the foreground rectangle shifted by
    its disparity, and the background band above it, right of the columns
    without a match."""
    y0, y1, x0, x1 = rect
    d_fg, d_bg = levels
    return {"fg": ((slice(y0 + m, y1 - m), slice(x0 + d_fg + m, x1 + d_fg - m)), d_fg),
            "bg": ((slice(m, y0 - m), slice(D + m, x1 + d_fg)), d_bg)}


def check_field(label: str, disp: np.ndarray, depth: np.ndarray, regions: dict, Q) -> dict:
    """Median disparity of each region within 1 of its level (NaN marks
    invalid pixels), and the median depth of its valid pixels within 2% of
    f * B / d (f = Q[2, 3], B = 1 / |Q[3, 2]|)."""
    out = {}
    for key, (box, want) in regions.items():
        med = float(np.nanmedian(disp[box]))
        dep = depth[box]
        dep_med = float(np.median(dep[dep > 0]))
        want_z = Q[2, 3] / abs(Q[3, 2]) / want
        out[key] = {"median_disparity": med, "level": want, "median_depth": dep_med,
                    "depth_rel_err": abs(dep_med - want_z) / want_z}
        if not abs(med - want) <= 1 or out[key]["depth_rel_err"] > 0.02:
            raise AssertionError(f"{label} {key}: {out[key]} (disparity within 1, depth 2%)")
    return out


def counted_launcher_rank(rank: int, port: int, argv: list, postprocess: bool,
                          out: str) -> None:
    """One of four ranks of the launcher's worker (`launch.main(["worker",
    ...] + argv)`: its seeded global batch, its sharded STEREO_GIF step and
    its bitwise check of the block against the single-device pipeline),
    run as the target of a spawned process. The sharded step's kernel
    launches are counted (set to 0 just before the step, read just after
    it). With `postprocess` False the step and the pipeline it is held to
    both skip JointWMF. Writes {"rc", "launches"} as JSON to `out`."""
    import functools

    from primestereomatch_torch import kernels as K
    from primestereomatch_torch.models import gif_pipeline
    from primestereomatch_torch.parallel import launch, sharded

    launches: dict = {}
    make = sharded.make_sharded_gif

    def counted(mesh, cfg):
        step = make(mesh, cfg, postprocess)

        def run(*views):
            K.reset_launches()
            res = step(*views)
            launches.update({k: v for k, v in K.LAUNCHES.items() if v})
            return res
        return run

    # the worker imports both names from their modules when it runs
    sharded.make_sharded_gif = counted
    if not postprocess:
        gif_pipeline.stereo_gif_forward = functools.partial(gif_pipeline.stereo_gif_forward,
                                                            run_postprocess=False)
    rc = launch.main(["worker", "--coordinator", f"localhost:{port}", "--num-processes", "4",
                      "--process-id", str(rank), *argv])
    pathlib.Path(out).write_text(json.dumps({"rc": rc, "launches": launches}))
