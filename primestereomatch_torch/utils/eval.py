"""Ground-truth bad-pixel evaluation (own numpy copy of the JAX package's
utils/eval.py; the reference's online %BP oracle, src/StereoMatch.cpp:275-311):

  1. scale the disparities by the dataset's factor (convertTo CV_8U)
  2. err = absdiff(scaled, gt), left band [0, maxDis] zeroed
  3. THRESH_TOZERO at error_threshold*(CHAR_MAX/maxDis) (integer division)
  4. optional mask multiply saturate(round(err * mask / 255)); a
     discontinuity mask is first thresholded at >254
  5. %BP = 100 * countNonZero(err) / (H*W), avgErr = mean(err)/(CHAR_MAX/maxDis)
"""

from __future__ import annotations

import dataclasses

import numpy as np

CHAR_MAX = 127


@dataclasses.dataclass(frozen=True)
class BPResult:
    percent_bad_pixels: float
    avg_err: float
    num_bad_pixels: int
    err_map: np.ndarray  # uint8, post-threshold/mask


def bad_pixel_metrics(
    disp: np.ndarray,                  # (H, W) uint8 raw disparities
    gt: np.ndarray,                    # (H, W) uint8 scaled GT
    scale_factor: int,
    max_dis: int = 64,
    error_threshold: int = 4,
    mask: np.ndarray | None = None,    # (H, W) uint8 0/255 (nonocc or disc)
    mask_is_disc: bool = False,
) -> BPResult:
    disp = np.asarray(disp, np.uint8)
    gt = np.asarray(gt, np.uint8)

    scaled = np.clip(
        np.rint(disp.astype(np.float64) * scale_factor), 0, 255
    ).astype(np.uint8)
    err = np.abs(scaled.astype(np.int16) - gt.astype(np.int16)).astype(np.uint8)
    err[:, : max_dis + 1] = 0

    thresh = error_threshold * (CHAR_MAX // max_dis)
    err = np.where(err > thresh, err, 0).astype(np.uint8)

    if mask is not None:
        m = np.asarray(mask, np.uint8)
        if mask_is_disc:
            m = np.where(m > 254, m, 0).astype(np.uint8)
        prod = err.astype(np.float64) * m.astype(np.float64) * np.float32(1.0 / 255.0)
        err = np.clip(np.rint(prod), 0, 255).astype(np.uint8)

    nbp = int(np.count_nonzero(err))
    denom = CHAR_MAX // max_dis
    return BPResult(
        percent_bad_pixels=nbp * 100.0 / float(err.size),
        avg_err=float(err.mean()) / denom,
        num_bad_pixels=nbp,
        err_map=err,
    )
