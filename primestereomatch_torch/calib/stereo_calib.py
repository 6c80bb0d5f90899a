"""End-to-end stereo calibration from chessboard image pairs.

The reference flow (StereoCalib, src/StereoCalib.cpp:49-237 +
captureChessboards src/StereoMatch.cpp:489-526): detect 9x6 corners in
captured pairs, stereoCalibrate, check epipolar RMS, write
intrinsics.yml/extrinsics.yml (including the stereoRectify outputs).
Here the capture step is a directory of saved pairs (headless) and
everything downstream is native: calib/chessboard.py detection,
calib/calibrate.py solvers, calib/rectify.py Bouguet rectification,
calib/ymlio.py persistence.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from primestereomatch_torch.calib.calibrate import (
    StereoCalibration,
    calibrate_camera,
    chessboard_object_points,
    epipolar_rms,
    stereo_calibrate,
)
from primestereomatch_torch.calib.chessboard import find_chessboard_corners
from primestereomatch_torch.calib.rectify import stereo_rectify
from primestereomatch_torch.calib.ymlio import write_opencv_yml


@dataclasses.dataclass
class StereoCalibResult:
    calib: StereoCalibration
    epipolar_rms: float
    n_views_used: int
    intrinsics_path: str | None
    extrinsics_path: str | None


def _to_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return np.asarray(img, np.float64)
    # BGR weights (cv::imread order)
    return (
        0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
    ).astype(np.float64)


def calibrate_stereo_from_images(
    left_images: list[np.ndarray],
    right_images: list[np.ndarray],
    image_size: tuple[int, int],
    pattern_size: tuple[int, int] = (9, 6),  # reference: calibrateCamera(9, 6, ...)
    square_size: float = 1.0,
    n_dist: int = 2,
    out_dir: str | None = None,
    rms_warn_threshold: float = 1.0,
) -> StereoCalibResult:
    """Detect corners in every pair, solve, optionally persist YMLs.

    Pairs where detection fails in either view are skipped (the reference
    skips invalid captures the same way, src/StereoCalib.cpp:129-160).
    """
    obj = chessboard_object_points(pattern_size, square_size)
    objs, lpts, rpts = [], [], []
    for li, ri in zip(left_images, right_images):
        cl = find_chessboard_corners(_to_gray(li), pattern_size)
        cr = find_chessboard_corners(_to_gray(ri), pattern_size)
        if cl is None or cr is None:
            continue
        objs.append(obj)
        lpts.append(cl)
        rpts.append(cr)
    if len(objs) < 3:
        raise ValueError(
            f"only {len(objs)} usable pairs; need >= 3 for calibration"
        )

    cal = stereo_calibrate(objs, lpts, rpts, image_size, n_dist=n_dist)
    rms_e = epipolar_rms(cal, lpts, rpts)

    intr_path = extr_path = None
    if out_dir is not None:
        d = pathlib.Path(out_dir)
        d.mkdir(parents=True, exist_ok=True)
        intr_path = str(d / "intrinsics.yml")
        extr_path = str(d / "extrinsics.yml")
        # same entry set the reference writes (src/StereoCalib.cpp:205-237)
        write_opencv_yml(intr_path, {
            "M1": cal.K1, "D1": cal.D1, "M2": cal.K2, "D2": cal.D2,
        })
        rect = stereo_rectify(
            cal.K1, cal.D1, cal.K2, cal.D2, image_size, cal.R, cal.T
        )
        write_opencv_yml(extr_path, {
            "R": cal.R, "T": cal.T,
            "R1": rect.R1, "R2": rect.R2,
            "P1": rect.P1, "P2": rect.P2, "Q": rect.Q,
        })

    return StereoCalibResult(
        calib=cal, epipolar_rms=rms_e, n_views_used=len(objs),
        intrinsics_path=intr_path, extrinsics_path=extr_path,
    )
