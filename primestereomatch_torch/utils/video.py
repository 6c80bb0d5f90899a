"""Frame sources: the video-mode capture abstraction (own copy of the JAX
package's utils/video.py).

The reference captures ZED side-by-side frames (1344x376@30, one image
containing both eyes; split at half width, src/StereoMatch.cpp:48-67,
326-355) from a V4L camera. No camera exists here, so the capability is
modeled as a FrameSource protocol with three implementations:

  SideBySideFileSource: a directory of side-by-side PNG/JPG frames,
      played in name order (optionally looped): the offline equivalent
      of the ZED stream.
  PairFileSource: a directory with <stem>_left/<stem>_right pairs.
  SyntheticZEDSource: procedurally generated stereo frames with a known
      disparity (a textured plane stepping through depth), for testing
      and benchmarking the streaming path without data.

Every source yields (left_bgr, right_bgr) uint8 arrays. Files are decoded
by `read_image`: the native libpng runtime where it is built, else the
zlib/numpy PNG reader; other formats need Pillow.
"""

from __future__ import annotations

import pathlib

import numpy as np

from primestereomatch_torch import native
from primestereomatch_torch.utils.png import read_png


def read_image(path: str, channels: int = 3) -> np.ndarray:
    """Decode `path` to (H, W, 3) BGR uint8 (channels=3) or (H, W) grey
    (channels=1). A PNG goes through the native runtime where it is live,
    else `utils/png.py::read_png` (both give libpng's values); another
    format needs Pillow, and raises where Pillow is not installed."""
    if path.lower().endswith(".png"):
        if native.native_available():
            return native.imread(path, channels)
        return read_png(path, channels)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: only PNG frames can be read without Pillow"
        ) from None
    with Image.open(path) as im:
        if channels == 1:
            return np.asarray(im.convert("L"))
        return np.ascontiguousarray(np.asarray(im.convert("RGB"))[..., ::-1])


class FrameSource:
    """Protocol: iterate (left_bgr, right_bgr) uint8 frames."""

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class SideBySideFileSource(FrameSource):
    """When the native runtime is available and every frame is a PNG, the
    libpng decode threads prefetch ahead of the consumer
    (primestereomatch_torch/native); otherwise decode synchronously."""

    def __init__(self, directory: str, loop: bool = False):
        self.files = sorted(
            p for p in pathlib.Path(directory).iterdir()
            if p.suffix.lower() in (".png", ".jpg", ".jpeg", ".bmp")
        )
        if not self.files:
            raise FileNotFoundError(f"no frames in {directory}")
        self.loop = loop
        self._i = 0
        self._native = None
        if (all(p.suffix.lower() == ".png" for p in self.files)
                and native.native_available()):
            self._native = native.PrefetchSource(
                [str(p) for p in self.files], side_by_side=True, loop=loop,
            )

    def __next__(self):
        if self._native is not None:
            return next(self._native)
        if self._i >= len(self.files):
            if not self.loop:
                raise StopIteration
            self._i = 0
        frame = read_image(str(self.files[self._i]))
        self._i += 1
        w = frame.shape[1] // 2
        return frame[:, :w], frame[:, w : 2 * w]


class PairFileSource(FrameSource):
    def __init__(self, directory: str, loop: bool = False):
        d = pathlib.Path(directory)
        lefts = sorted(d.glob("*_left.*"))
        self.pairs = []
        for lp in lefts:
            rp = lp.with_name(lp.name.replace("_left", "_right"))
            if rp.exists():
                self.pairs.append((lp, rp))
        if not self.pairs:
            raise FileNotFoundError(f"no *_left/*_right pairs in {directory}")
        self.loop = loop
        self._i = 0

    def __next__(self):
        if self._i >= len(self.pairs):
            if not self.loop:
                raise StopIteration
            self._i = 0
        lp, rp = self.pairs[self._i]
        self._i += 1
        return read_image(str(lp)), read_image(str(rp))


class SyntheticZEDSource(FrameSource):
    """Textured fronto-parallel plane sweeping through disparities: each
    frame's true disparity is (frame_index % max_disparity), so the
    streaming pipeline can be smoke-checked quantitatively."""

    def __init__(
        self,
        width: int = 672,
        height: int = 376,
        n_frames: int = 30,
        max_disparity: int = 48,
        seed: int = 0,
        smoothing: int = 1,
    ):
        self.w, self.h = width, height
        self.n = n_frames
        self.max_d = max_disparity
        rng = np.random.default_rng(seed)
        # random texture; `smoothing` box-blur passes trade gradient strength
        # (matchability for the DP/prior-based algorithms) for realism
        tex = rng.integers(0, 256, (height, width + max_disparity, 3)).astype(np.float32)
        for _ in range(smoothing):
            tex = (np.roll(tex, 1, 1) + tex + np.roll(tex, -1, 1)) / 3
            tex = (np.roll(tex, 1, 0) + tex + np.roll(tex, -1, 0)) / 3
        self.tex = np.clip(tex, 0, 255).astype(np.uint8)
        self._i = 0

    @property
    def true_disparity(self) -> int:
        return ((self._i - 1) % self.max_d) if self._i else 0

    def __next__(self):
        if self._i >= self.n:
            raise StopIteration
        d = self._i % self.max_d
        self._i += 1
        # left(x) images the scene point the right camera sees at x - d:
        # right(x) = left(x + d)
        left = self.tex[:, : self.w]
        right = self.tex[:, d : d + self.w]
        return left.copy(), right.copy()


def open_source(spec: str, **kw) -> FrameSource:
    """'synthetic' | '<dir of side-by-side frames>' | '<dir>:pairs'."""
    if spec == "synthetic":
        return SyntheticZEDSource(**kw)
    if spec.endswith(":pairs"):
        return PairFileSource(spec[: -len(":pairs")], **kw)
    return SideBySideFileSource(spec, **kw)
