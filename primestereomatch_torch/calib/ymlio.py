"""Minimal OpenCV FileStorage YAML reader/writer.

The reference persists calibration as cv::FileStorage YML
(src/StereoCalib.cpp:205-237, loaded at src/StereoMatch.cpp:424-452;
files data/intrinsics.yml + data/extrinsics.yml). The format is YAML 1.0
with `!!opencv-matrix` tagged mappings {rows, cols, dt, data}. This module
parses exactly that subset without a YAML dependency.
"""

from __future__ import annotations

import re

import numpy as np

_DT = {"d": np.float64, "f": np.float32, "i": np.int32, "u": np.uint8, "s": np.int16}
_DT_INV = {np.dtype(np.float64): "d", np.dtype(np.float32): "f",
           np.dtype(np.int32): "i", np.dtype(np.uint8): "u", np.dtype(np.int16): "s"}


def read_opencv_yml(path: str) -> dict[str, np.ndarray | float | int | str]:
    """Parse an OpenCV YML file into {name: ndarray | scalar}."""
    with open(path) as f:
        text = f.read()
    out: dict = {}
    # matrices: NAME: !!opencv-matrix\n  rows: R\n  cols: C\n  dt: d\n  data: [ ... ]
    mat_re = re.compile(
        r"^(\w+): !!opencv-matrix\s*\n"
        r"\s*rows:\s*(\d+)\s*\n"
        r"\s*cols:\s*(\d+)\s*\n"
        r"\s*dt:\s*(\w+)\s*\n"
        r"\s*data:\s*\[([^\]]*)\]",
        re.MULTILINE,
    )
    for m in mat_re.finditer(text):
        name, rows, cols, dt, data = m.groups()
        vals = [float(v) for v in data.replace("\n", " ").split(",") if v.strip()]
        arr = np.asarray(vals, dtype=_DT.get(dt, np.float64)).reshape(int(rows), int(cols))
        out[name] = arr
    # top-level scalars: NAME: value
    scal_re = re.compile(r"^(\w+):\s*([^\s!][^\n]*)$", re.MULTILINE)
    for m in scal_re.finditer(text):
        name, val = m.groups()
        if name in out or name in ("rows", "cols", "dt", "data"):
            continue
        val = val.strip()
        try:
            out[name] = int(val)
        except ValueError:
            try:
                out[name] = float(val)
            except ValueError:
                out[name] = val.strip('"')
    return out


def read_imagelist(path: str) -> list[str]:
    """Read a cv::FileStorage string-list (the reference's chessboard
    imagelist, ``readStringList`` src/StereoCalib.cpp:349-361; file
    data/stereo_calib.xml). The list is the first top-level sequence node;
    entries are interleaved left/right filenames. Supports the XML storage
    form (whitespace-separated tokens inside the node) and the YML form
    (``- "name"`` items or a bracketed flow list)."""
    with open(path) as f:
        text = f.read()
    if text.lstrip().startswith("<?xml") or "<opencv_storage>" in text:
        m = re.search(r"<(\w+)>([\s\S]*?)</\1>",
                      re.sub(r"</?opencv_storage>", "", text))
        if not m:
            return []
        body = m.group(2)
        # strip any nested tags (e.g. per-item <_> wrappers), keep text
        body = re.sub(r"<[^>]+>", " ", body)
        return [t.strip('"') for t in body.split()]
    # YML: first top-level "name:" node followed by "- item" lines or [ ... ]
    m = re.search(r"^\w+:\s*(\[[^\]]*\])", text, re.MULTILINE)
    if m:
        return [t.strip().strip('"') for t in m.group(1)[1:-1].split(",")
                if t.strip()]
    items = re.findall(r"^\s*-\s*(?!-)(\S+)\s*$", text, re.MULTILINE)
    return [t.strip('"') for t in items]


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e16:
        return f"{int(v)}." if isinstance(v, float) else str(int(v))
    return f"{v:.16e}"


def write_opencv_yml(path: str, entries: dict[str, np.ndarray | float | int]) -> None:
    """Write matrices/scalars in cv::FileStorage YML form (round-trips with
    read_opencv_yml and with OpenCV itself)."""
    lines = ["%YAML:1.0", "---"]
    for name, v in entries.items():
        if isinstance(v, np.ndarray):
            a = np.atleast_2d(v)
            dt = _DT_INV.get(a.dtype, "d")
            data = ", ".join(_fmt(float(x)) for x in a.reshape(-1))
            lines += [
                f"{name}: !!opencv-matrix",
                f"   rows: {a.shape[0]}",
                f"   cols: {a.shape[1]}",
                f"   dt: {dt}",
                f"   data: [ {data} ]",
            ]
        else:
            lines.append(f"{name}: {v}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
