"""Calibration and rectification: host NumPy solvers (own copies of the JAX
package's calib/) and the device-side `Rectifier`."""

from primestereomatch_torch.calib.ymlio import read_opencv_yml, write_opencv_yml  # noqa: F401
from primestereomatch_torch.calib.distortion import (  # noqa: F401
    distort_points,
    undistort_points,
)
from primestereomatch_torch.calib.rectify import (  # noqa: F401
    Rectifier,
    StereoRectification,
    init_undistort_rectify_map,
    load_stereo_calibration,
    stereo_rectify,
)
from primestereomatch_torch.calib.chessboard import (  # noqa: F401
    corner_subpix,
    find_chessboard_corners,
)
from primestereomatch_torch.calib.calibrate import (  # noqa: F401
    MonoCalibration,
    StereoCalibration,
    calibrate_camera,
    chessboard_object_points,
    epipolar_rms,
    stereo_calibrate,
)
from primestereomatch_torch.calib.stereo_calib import (  # noqa: F401
    StereoCalibResult,
    calibrate_stereo_from_images,
)
from primestereomatch_torch.calib.uncalibrated import (  # noqa: F401
    fundamental_8point,
    rectify_rotations_from_homographies,
    stereo_rectify_uncalibrated,
)
