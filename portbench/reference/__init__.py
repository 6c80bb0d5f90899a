"""The plain reference of the port's timed path, in plain torch and NumPy,
importing nothing of the program: rectification (`calib`) and one module for
each algorithm a configuration runs, found by the algorithm's name.

A configuration names its `algorithm` and holds that algorithm's parameters
in one block, keyed by `block_key(algorithm)`: STEREO_GIF's in "gif",
STEREO_SGBM's in "sgbm", each key a field of the app's `<key>_cfg`. Its
reference is `portbench/reference/<key>.py`, which has

    disparities(left_u8, right_u8, block, dtype) -> (2, h, w) tensor

taking the two (h, w, 3) uint8 views the app matches, on a device, and the
configuration's block, and giving both views' disparities as the app hands
them back: the right view all zeros where the app's algorithm is left-only
(STEREO_SGBM). The disparities lie in [0, D - 1] for the block's D
disparities and come in `disparity_dtype(D)`, the smallest unsigned type
that holds them: uint8 up to D = 256, uint16 above (SGBM goes to 2048).
`dtype` is the precision of its floating-point stages.

`outputs` works out again, from the camera's raw uint8 frames and the
configuration alone, what the app hands back: the rectified crops where the
configuration rectifies, and both views' disparities."""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import torch

from portbench.reference import calib

ROOT = pathlib.Path(__file__).resolve().parents[2]


def disparity_dtype(num_disparities: int) -> torch.dtype:
    """The smallest unsigned type that holds the disparities [0, D - 1]."""
    if not 1 <= num_disparities <= 1 << 16:
        raise ValueError(f"no unsigned disparity type for D = {num_disparities}")
    return torch.uint8 if num_disparities <= 1 << 8 else torch.uint16


def block_key(algorithm: str) -> str:
    """The key of an algorithm's parameter block: STEREO_GIF -> gif."""
    return algorithm.removeprefix("STEREO_").lower()


def algorithm(cfg: dict, root: pathlib.Path = ROOT):
    """The configuration's algorithm's reference module, loaded from `root`'s
    checkout; raises naming the file where it is missing."""
    path = root / "portbench" / "reference" / f"{block_key(cfg['algorithm'])}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference for {cfg['algorithm']}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_reference_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def outputs(cfg: dict, left_u8: np.ndarray, right_u8: np.ndarray, dev, rect: dict | None = None,
            dtype=torch.float32, root: pathlib.Path = ROOT) -> dict:
    """The camera's (H, W, 3) uint8 eyes -> {"crops": (2, h, w, 3) uint8 or
    None, "disp": (2, h, w) in `disparity_dtype(D)`}, as NumPy arrays. `rect` is
    `calib.rectification(...)` where the configuration rectifies; the
    algorithm's module is loaded from checkout `root`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eyes = [torch.as_tensor(np.ascontiguousarray(e), device=dev) for e in (left_u8, right_u8)]
    crops = None
    if rect is not None:
        eyes = [calib.remap_crop(e, m, rect["crop"], dtype) for e, m in zip(eyes, rect["maps"])]
        crops = torch.stack(eyes).cpu().numpy()
    block = cfg[block_key(cfg["algorithm"])]
    disp = algorithm(cfg, root).disparities(eyes[0], eyes[1], block, dtype).cpu().numpy()
    return {"crops": crops, "disp": disp}
