"""The plain reference of the port's timed path: rectification (`calib`) and
STEREO_GIF (`gif`), in plain torch and NumPy, importing nothing of the
program. `outputs` works out again, from the camera's raw uint8 frames and
the configuration alone, what the app hands back: the rectified crops where
the configuration rectifies, and both views' disparities."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import calib, gif


def outputs(cfg: dict, left_u8: np.ndarray, right_u8: np.ndarray, dev, rect: dict | None = None,
            dtype=torch.float32) -> dict:
    """The camera's (H, W, 3) uint8 eyes -> {"crops": (2, h, w, 3) uint8 or
    None, "disp": (2, h, w) uint8}, as NumPy arrays. `rect` is
    `calib.rectification(...)` where the configuration rectifies."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eyes = [torch.as_tensor(np.ascontiguousarray(e), device=dev) for e in (left_u8, right_u8)]
    crops = None
    if rect is not None:
        eyes = [calib.remap_crop(e, m, rect["crop"], dtype) for e, m in zip(eyes, rect["maps"])]
        crops = torch.stack(eyes).cpu().numpy()
    disp = gif.disparities(eyes[0], eyes[1], cfg["gif"], dtype).cpu().numpy()
    return {"crops": crops, "disp": disp}
