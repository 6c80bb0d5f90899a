"""A small PNG decoder and encoder built on zlib and numpy only.

It reads what the bundled Middlebury sets hold: 8-bit RGB (colour type 2),
8-bit or packed grey (type 0) and packed palette images (type 3), none of
them interlaced. The results match libpng's, as the JAX package's loader
uses it (native/psm_runtime.cpp): colour reads come back in BGR order, and
grey reads of a palette image take the palette entry, which must be grey
(R = G = B) so that libpng's rgb-to-grey conversion leaves it unchanged.
`write_png` writes 8-bit grey or BGR images (colour types 0 and 2, no
filter), which `read_png` reads back unchanged.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters. A byte depends only on its left, upper
    and upper-left neighbours, so every anti-diagonal of pixels is
    reconstructed at once, whatever filter each row uses."""
    rows = raw.reshape(h, stride + 1)
    ftype = rows[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {ftype.max()}")
    n = stride // bpp
    filt = rows[:, 1:].reshape(h, n, bpp).astype(np.int32)
    out = np.zeros((h + 1, n + 1, bpp), np.int32)  # zero row/column = outside
    ys = np.arange(h)
    for t in range(h + n - 1):
        y = ys[max(0, t - n + 1):min(h, t + 1)]
        x = t - y
        a = out[y + 1, x]          # left
        b = out[y, x + 1]          # up
        c = out[y, x]              # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(
            ftype[y][:, None], [np.zeros_like(a), a, b, (a + b) >> 1, paeth]
        )
        out[y + 1, x + 1] = (filt[y, x] + pred) & 0xFF
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def _unpack(rows: np.ndarray, depth: int, count: int) -> np.ndarray:
    """Split packed 1/2/4-bit samples, most significant bits first."""
    if depth == 8:
        return rows[:, :count]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :count].astype(np.uint8)


def read_png(path: str, channels: int) -> np.ndarray:
    """Decode `path` to (H, W, 3) BGR uint8 (channels=3) or (H, W) grey
    uint8 (channels=1)."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    idat, palette = [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: colour type {ctype}, interlace {interlace} unsupported")
    if depth != 8 and (ctype == 2 or depth not in (1, 2, 4)):
        raise ValueError(f"{path}: bit depth {depth} unsupported for colour type {ctype}")
    nch = _CHANNELS[ctype]
    stride = (w * nch * depth + 7) // 8
    bpp = max(1, nch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(raw[: h * (stride + 1)], h, stride, bpp)

    if ctype == 2:
        rgb = rows.reshape(h, w, 3)
        if channels == 1:
            raise ValueError(f"{path}: grey read of an RGB image unsupported")
        return np.ascontiguousarray(rgb[..., ::-1])
    vals = _unpack(rows, depth, w)
    if ctype == 0:
        if depth < 8:  # libpng's expand_gray_1_2_4_to_8 scales to 0..255
            vals = (vals.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return np.repeat(vals[..., None], 3, axis=-1) if channels == 3 else vals
    if palette is None:
        raise ValueError(f"{path}: palette image without PLTE")
    rgb = palette[vals]
    if channels == 3:
        return np.ascontiguousarray(rgb[..., ::-1])
    if not (np.array_equal(palette[:, 0], palette[:, 1])
            and np.array_equal(palette[:, 0], palette[:, 2])):
        raise ValueError(f"{path}: grey read of a non-grey palette unsupported")
    return np.ascontiguousarray(rgb[..., 0])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Encode (H, W) grey or (H, W, 3) BGR uint8 `img` to `path`."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    rows = img if ctype == 0 else img[..., ::-1]      # BGR -> RGB
    raw = np.zeros((h, 1 + w * (1 if ctype == 0 else 3)), np.uint8)  # filter 0 per row
    raw[:, 1:] = rows.reshape(h, -1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
