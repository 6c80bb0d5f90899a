"""Middlebury dataset table and loader (own copy of the JAX package's).

Teddy/Cones use im2/im6 with GT disp2 (x4 disparity scale) plus occlusion
and occ+discontinuity masks; the 2005 sets use view1/view5 with GT disp1
(x3 scale) and no masks. Images come back in BGR uint8 order, the memory
order the reference sees from cv::imread. PNGs are decoded by
`utils/png.py`, so the loader needs neither Pillow nor OpenCV.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import numpy as np

from primestereomatch_torch.utils.png import read_png

_DEF_ROOTS = (
    os.environ.get("PSM_DATA_DIR", ""),
    str(pathlib.Path(__file__).resolve().parents[2] / "data"),
    "data",
)

MASK_NONE, MASK_NONOCC, MASK_DISC = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    left: str
    right: str
    gt: str
    scale_factor: int
    occl: str | None = None
    disc: str | None = None
    default_mask: int = MASK_NONE


_2003 = dict(left="im2.png", right="im6.png", gt="disp2.png",
             occl="occl.png", disc="occ_and_discont.png",
             scale_factor=4, default_mask=MASK_NONOCC)
_2005 = dict(left="view1.png", right="view5.png", gt="disp1.png", scale_factor=3)

DATASETS: dict[str, DatasetSpec] = {
    "Teddy": DatasetSpec(**_2003),
    "Cones": DatasetSpec(**_2003),
    "Art": DatasetSpec(**_2005),
    "Books": DatasetSpec(**_2005),
    "Dolls": DatasetSpec(**_2005),
    "Laundry": DatasetSpec(**_2005),
    "Moebius": DatasetSpec(**_2005),
    "Reindeer": DatasetSpec(**_2005),
}


@dataclasses.dataclass
class StereoSample:
    name: str
    left_bgr: np.ndarray            # (H, W, 3) uint8
    right_bgr: np.ndarray
    gt: np.ndarray | None           # (H, W) uint8 scaled disparity
    mask_nonocc: np.ndarray | None  # (H, W) uint8 (0/255)
    mask_disc: np.ndarray | None
    scale_factor: int
    default_mask: int

    @property
    def left_f32(self) -> np.ndarray:
        # convertTo(CV_32F, 1/255.0f): v * (float)(1/255.0f)
        return self.left_bgr.astype(np.float32) * np.float32(1.0 / 255.0)

    @property
    def right_f32(self) -> np.ndarray:
        return self.right_bgr.astype(np.float32) * np.float32(1.0 / 255.0)


def data_root() -> pathlib.Path:
    for r in _DEF_ROOTS:
        if r and pathlib.Path(r).is_dir():
            return pathlib.Path(r)
    raise FileNotFoundError("No dataset root found; set PSM_DATA_DIR")


def load_dataset(name: str, root: str | os.PathLike | None = None) -> StereoSample:
    spec = DATASETS[name]
    d = (pathlib.Path(root) if root else data_root()) / name

    def gray(fname):
        return read_png(str(d / fname), 1) if fname and (d / fname).exists() else None

    return StereoSample(
        name=name,
        left_bgr=read_png(str(d / spec.left), 3),
        right_bgr=read_png(str(d / spec.right), 3),
        gt=gray(spec.gt), mask_nonocc=gray(spec.occl), mask_disc=gray(spec.disc),
        scale_factor=spec.scale_factor, default_mask=spec.default_mask,
    )
