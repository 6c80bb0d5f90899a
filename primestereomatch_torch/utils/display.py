"""Headless display mosaic + image writing (own copy of the JAX package's
utils/display.py).

Mirrors the reference's InputOutput window layout
(StereoMatch::update_display, src/StereoMatch.cpp:611-634):

  2x2 (no GT):   [ left      | right      ]
                 [ left disp | right disp ]
  2x3 (with GT): [ left      | right      | ground truth ]
                 [ left disp | right disp | error map    ]

Disparity panes are scaled uint8 grayscale converted to 3 channels
(convertTo(CV_8U, scale_factor) + GRAY2RGB, src/StereoMatch.cpp:248-252).
Since there is no GUI, the mosaic is a uint8 array the CLI writes to PNG
through the zlib/numpy writer (no Pillow needed).
"""

from __future__ import annotations

import numpy as np

from primestereomatch_torch.utils.png import write_png


def disp_to_u8(disp: np.ndarray, scale_factor: int) -> np.ndarray:
    """convertTo(CV_8U, scale_factor): saturating round (src/StereoMatch.cpp:248)."""
    return np.clip(
        np.rint(disp.astype(np.float64) * scale_factor), 0, 255
    ).astype(np.uint8)


def _gray3(img: np.ndarray) -> np.ndarray:
    return np.repeat(img[..., None], 3, axis=-1)


def build_mosaic(
    left_bgr: np.ndarray,
    right_bgr: np.ndarray,
    l_disp_u8: np.ndarray,
    r_disp_u8: np.ndarray,
    gt: np.ndarray | None = None,
    err_map: np.ndarray | None = None,
) -> np.ndarray:
    """(2H, 2W or 3W, 3) uint8 BGR mosaic."""
    H, W, _ = left_bgr.shape
    cols = 3 if gt is not None else 2
    out = np.zeros((2 * H, cols * W, 3), np.uint8)
    out[:H, :W] = left_bgr
    out[:H, W : 2 * W] = right_bgr
    out[H:, :W] = _gray3(l_disp_u8)
    out[H:, W : 2 * W] = _gray3(r_disp_u8)
    if gt is not None:
        out[:H, 2 * W :] = _gray3(gt)
        if err_map is not None:
            out[H:, 2 * W :] = _gray3(err_map)
    return out


def save_png(path: str, img: np.ndarray) -> None:
    """Write a BGR (or grayscale) uint8 array as PNG."""
    write_png(path, img)
