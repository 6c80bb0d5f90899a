"""ctypes bindings for the native host runtime (native/psm_runtime.cpp at the
repo root): libpng decode straight into numpy buffers, PNG encode, a
multithreaded prefetching stereo frame source and a monotonic clock (own
copy of the JAX package's bindings).

The shared library is built with g++ on first use from the repo's own
source into `build/native/` (git-ignored), under a name that hashes the
source and the flags; the build writes a temporary file and renames it,
so processes that build at once do not race. Where the source, g++ or
libpng is missing, `native_available()` is false and callers take the
pure-Python path (`utils/png.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "psm_runtime.cpp"
_BUILD_DIR = _ROOT / "build" / "native"
# the flags of native/Makefile
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
_LIBS = ["-lpng", "-lpthread"]
_lib = None
_tried = False


class _PsmImage(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("height", ctypes.c_int32),
        ("width", ctypes.c_int32),
        ("channels", ctypes.c_int32),
    ]


def _build() -> pathlib.Path | None:
    """Compile the library unless a build of this source and these flags
    exists; None where it cannot be built."""
    try:
        src = _SOURCE.read_bytes()
    except OSError:
        return None
    tag = hashlib.sha256(src + " ".join(_FLAGS + _LIBS).encode()).hexdigest()[:12]
    lib = _BUILD_DIR / f"libpsm_runtime-{tag}.so"
    if lib.exists():
        return lib
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SOURCE), *_LIBS],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except (OSError, subprocess.SubprocessError):
        return None
    return lib


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.psm_now_us.restype = ctypes.c_int64
    lib.psm_imread.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_PsmImage)]
    lib.psm_imread.restype = ctypes.c_int
    lib.psm_imwrite_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.psm_imwrite_png.restype = ctypes.c_int
    lib.psm_free.argtypes = [ctypes.c_void_p]
    lib.psm_source_open_sbs.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.psm_source_open_sbs.restype = ctypes.c_void_p
    lib.psm_source_open_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.psm_source_open_pairs.restype = ctypes.c_void_p
    lib.psm_source_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_PsmImage), ctypes.POINTER(_PsmImage)
    ]
    lib.psm_source_next.restype = ctypes.c_int
    lib.psm_source_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    """True when the library is built and loaded (the libpng path is live)."""
    return _load() is not None


def now_us() -> int:
    """CLOCK_MONOTONIC microseconds (reference get_rt, ComFunc.h:67-71)."""
    lib = _load()
    if lib is None:
        import time

        return time.monotonic_ns() // 1000
    return int(lib.psm_now_us())


def _take(img: _PsmImage, lib) -> np.ndarray:
    shape = (img.height, img.width, img.channels)
    n = img.height * img.width * img.channels
    arr = np.ctypeslib.as_array(img.data, shape=(n,)).reshape(shape).copy()
    lib.psm_free(ctypes.cast(img.data, ctypes.c_void_p))
    if img.channels == 1:
        arr = arr[..., 0]
    return arr


def imread(path: str, channels: int = 3) -> np.ndarray:
    """PNG decode: (H, W, 3) BGR uint8 (channels=3) or (H, W) grey."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    img = _PsmImage()
    rc = lib.psm_imread(path.encode(), channels, ctypes.byref(img))
    if rc != 0:
        raise IOError(f"psm_imread({path!r}) failed: {rc}")
    return _take(img, lib)


def imwrite_png(path: str, arr: np.ndarray, bgr: bool = True) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    ch = 1 if a.ndim == 2 else a.shape[2]
    rc = lib.psm_imwrite_png(
        path.encode(), a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        a.shape[0], a.shape[1], ch, int(bgr),
    )
    if rc != 0:
        raise IOError(f"psm_imwrite_png({path!r}) failed: {rc}")


class PrefetchSource:
    """Stereo frame source with native decode threads prefetching ahead.

    side_by_side: paths are single frames holding both eyes (split at half
    width, the ZED layout src/StereoMatch.cpp:66-67); otherwise pass pairs.
    """

    def __init__(
        self,
        paths: list[str] | list[tuple[str, str]],
        side_by_side: bool = True,
        loop: bool = False,
        threads: int = 2,
        depth: int = 4,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._h = None
        if side_by_side:
            arr = (ctypes.c_char_p * len(paths))(
                *[str(p).encode() for p in paths]
            )
            self._h = lib.psm_source_open_sbs(
                arr, len(paths), int(loop), threads, depth
            )
        else:
            lefts = (ctypes.c_char_p * len(paths))(
                *[str(l).encode() for l, _ in paths]
            )
            rights = (ctypes.c_char_p * len(paths))(
                *[str(r).encode() for _, r in paths]
            )
            self._h = lib.psm_source_open_pairs(
                lefts, rights, len(paths), int(loop), threads, depth
            )
        if not self._h:
            raise RuntimeError("failed to open native frame source")

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        l = _PsmImage()
        r = _PsmImage()
        rc = self._lib.psm_source_next(self._h, ctypes.byref(l), ctypes.byref(r))
        if rc == 1:
            raise StopIteration
        if rc != 0:
            raise IOError(f"frame decode failed: {rc}")
        return _take(l, self._lib), _take(r, self._lib)

    def close(self):
        if self._h:
            self._lib.psm_source_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):    # __init__ may have raised before the handle
            self.close()
