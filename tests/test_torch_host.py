"""The port's host utilities (`utils/video.py`, `utils/display.py`,
`utils/profiling.py`, `native/`) against the JAX package's on the CPU, on
the same inputs made from a seed with numpy. Frame sources, mosaics and
`disp_to_u8` must be bitwise equal; the native
bindings are held to the JAX package's `tests/test_native.py` and skip
where the native runtime cannot be built."""

import json
import threading

import numpy as np
import pytest
import torch

from primestereomatch_tpu import native as jax_native
from primestereomatch_tpu.utils import display as jdisplay
from primestereomatch_tpu.utils import video as jvideo
from primestereomatch_torch import native
from primestereomatch_torch.utils import display, profiling, video
from primestereomatch_torch.utils.datasets import data_root
from primestereomatch_torch.utils.png import read_png, write_png


def _frames(src, n=100):
    return [f for _, f in zip(range(n), src)]


def _assert_frames_equal(got, want):
    assert len(got) == len(want)
    for (gl, gr), (wl, wr) in zip(got, want):
        assert gl.dtype == np.uint8 and gl.shape == wl.shape
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gr, wr)


# ---- frame sources -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(width=64, height=32, n_frames=5, max_disparity=8),
    dict(width=96, height=48, n_frames=3, max_disparity=4, seed=3, smoothing=0),
    dict(width=40, height=24, n_frames=4, max_disparity=2, seed=1, smoothing=2),
])
def test_synthetic_source_bitwise_jax(kw):
    src, ref = video.SyntheticZEDSource(**kw), jvideo.SyntheticZEDSource(**kw)
    got, want = _frames(src), _frames(ref)
    _assert_frames_equal(got, want)
    assert src.true_disparity == ref.true_disparity
    # frame 1: true disparity 1 -> left pixel x matches right pixel x - 1
    np.testing.assert_array_equal(got[1][0][:, 1:], got[1][1][:, :-1])


def test_file_sources_bitwise_jax(tmp_path, monkeypatch):
    """Side-by-side frames and _left/_right pairs written by the port's PNG
    writer: the port's sources (native prefetch and the Python reader both)
    give the JAX sources' frames."""
    rng = np.random.default_rng(7)
    sbs = tmp_path / "sbs"
    pairs = tmp_path / "pairs"
    sbs.mkdir()
    pairs.mkdir()
    for i in range(3):
        f = rng.integers(0, 256, (16, 40, 3), dtype=np.uint8)
        write_png(str(sbs / f"f{i}.png"), f)
        write_png(str(pairs / f"{i}_left.png"), f[:, :20])
        write_png(str(pairs / f"{i}_right.png"), f[:, 20:])
    want = _frames(jvideo.SideBySideFileSource(str(sbs)))
    _assert_frames_equal(_frames(video.SideBySideFileSource(str(sbs))), want)
    _assert_frames_equal(_frames(video.open_source(f"{pairs}:pairs")),
                         _frames(jvideo.open_source(f"{pairs}:pairs")))
    # looping sources wrap around
    looped = _frames(video.open_source(f"{pairs}:pairs", loop=True), 5)
    _assert_frames_equal(looped[3:], looped[:2])
    # the Python path: the zlib/numpy reader, frames split at half width
    monkeypatch.setattr(native, "native_available", lambda: False)
    src = video.open_source(str(sbs))
    assert isinstance(src, video.SideBySideFileSource) and src._native is None
    _assert_frames_equal(_frames(src), want)
    assert isinstance(video.open_source("synthetic", n_frames=1), video.SyntheticZEDSource)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        video.open_source(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        video.open_source(f"{sbs}:pairs")


def test_read_image_formats(tmp_path, monkeypatch):
    """PNG through either reader; another format through Pillow where it
    imports (equal to the JAX reader), else a clear error."""
    import sys

    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    gray = img[..., 0].copy()
    g = str(tmp_path / "g.png")
    write_png(g, gray)
    for live in {native.native_available(), False}:
        monkeypatch.setattr(native, "native_available", lambda live=live: live)
        np.testing.assert_array_equal(video.read_image(p), img)
        np.testing.assert_array_equal(video.read_image(g, 1), gray)
    monkeypatch.undo()
    from primestereomatch_tpu.utils.datasets import _imread_color

    pytest.importorskip("PIL")
    from PIL import Image

    b = str(tmp_path / "x.bmp")
    Image.fromarray(img[..., ::-1]).save(b)
    np.testing.assert_array_equal(video.read_image(b), _imread_color(b))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="only PNG"):
        video.read_image(b)


# ---- display ---------------------------------------------------------------------

def test_disp_to_u8_bitwise_jax():
    rng = np.random.default_rng(4)
    for d in (np.array([[10, 100]], np.uint8), rng.integers(0, 256, (17, 23)).astype(np.uint8),
              rng.random((8, 9)).astype(np.float32) * 80):
        for sf in (1, 3, 4):
            got = display.disp_to_u8(d, sf)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, jdisplay.disp_to_u8(d, sf))
    np.testing.assert_array_equal(display.disp_to_u8(np.array([[10, 100]], np.uint8), 4),
                                  [[40, 255]])


@pytest.mark.parametrize("with_gt,with_err", [(False, False), (True, False), (True, True)],
                         ids=["2x2", "2x3", "2x3_err"])
def test_mosaic_bitwise_jax(with_gt, with_err):
    rng = np.random.default_rng(5)
    H, W = 8, 10
    l, r = (rng.integers(0, 255, (H, W, 3), dtype=np.uint8) for _ in range(2))
    ld, rd, gt, err = (rng.integers(0, 255, (H, W)).astype(np.uint8) for _ in range(4))
    kw = dict(gt=gt if with_gt else None, err_map=err if with_err else None)
    got = display.build_mosaic(l, r, ld, rd, **kw)
    assert got.shape == (2 * H, (3 if with_gt else 2) * W, 3)
    np.testing.assert_array_equal(got, jdisplay.build_mosaic(l, r, ld, rd, **kw))


def test_save_png_roundtrip(tmp_path):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (12, 18, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (12, 18), dtype=np.uint8)
    display.save_png(str(tmp_path / "c.png"), img)
    display.save_png(str(tmp_path / "g.png"), gray)
    np.testing.assert_array_equal(read_png(str(tmp_path / "c.png"), 3), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "g.png"), 1), gray)


# ---- profiling ---------------------------------------------------------------------

@pytest.mark.parametrize("device", [None, "cpu"])
def test_stage_timers(device):
    t = profiling.StageTimers(device)
    for _ in range(2):
        with t.stage("CVC"):
            torch.ones(4).sum()
    with t.stage("PP"):
        pass
    assert t.stages["CVC"].count == 2 and t.stages["PP"].count == 1
    assert t.stages["CVC"].total_ms >= t.stages["CVC"].last_ms >= 0
    assert "CVC" in t.report() and "PP" in t.report()


def test_trace_and_kernel_stats_on_cpu(tmp_path):
    """trace() writes a Chrome trace that holds the program's spans beside
    the ops (on a card, the kernels too); no span is recorded outside it."""
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("psm.test.outer"):
            with profiling.span("psm.test.inner"):
                torch.ones(64).cumsum(0)
    assert profiling.span("psm.test.after") is profiling._NO_SPAN
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    assert "psm.test.outer" in names and "psm.test.inner" in names
    assert "psm.test.after" not in names


# ---- native runtime (tests/test_native.py against the port's bindings) ---------------

@pytest.fixture
def lib():
    if not native.native_available():
        pytest.skip("native runtime not built (needs g++ and libpng)")
    return native


def test_imread_matches_writer(lib, tmp_path):
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    np.testing.assert_array_equal(lib.imread(p, 3), img)       # BGR order


def test_imread_dataset_images(lib):
    p = str(data_root() / "Teddy" / "im2.png")
    got = lib.imread(p, 3)
    np.testing.assert_array_equal(got, read_png(p, 3))
    if jax_native.native_available():
        np.testing.assert_array_equal(got, jax_native.imread(p, 3))
    gray = lib.imread(str(data_root() / "Teddy" / "disp2.png"), 1)
    assert gray.ndim == 2 and gray.shape == got.shape[:2]
    np.testing.assert_array_equal(gray, read_png(str(data_root() / "Teddy" / "disp2.png"), 1))


def test_imwrite_roundtrip(lib, tmp_path):
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    p = str(tmp_path / "w.png")
    lib.imwrite_png(p, img, bgr=True)
    np.testing.assert_array_equal(lib.imread(p, 3), img)
    np.testing.assert_array_equal(read_png(p, 3), img)
    gray = rng.integers(0, 256, (20, 30), dtype=np.uint8)
    lib.imwrite_png(str(tmp_path / "g.png"), gray)
    np.testing.assert_array_equal(lib.imread(str(tmp_path / "g.png"), 1), gray)


def test_prefetch_source_in_order(lib, tmp_path):
    rng = np.random.default_rng(10)
    frames = []
    for i in range(8):
        f = rng.integers(0, 256, (12, 40, 3), dtype=np.uint8)
        f[0, 0] = i  # frame fingerprint
        frames.append(f)
        write_png(str(tmp_path / f"f{i:03d}.png"), f)
    src = lib.PrefetchSource(
        sorted(str(p) for p in tmp_path.glob("*.png")),
        side_by_side=True, threads=3, depth=2,
    )
    got = list(src)
    assert len(got) == 8
    for i, (l, r) in enumerate(got):
        np.testing.assert_array_equal(l, frames[i][:, :20])
        np.testing.assert_array_equal(r, frames[i][:, 20:])
    with pytest.raises(StopIteration):
        next(src)
    src.close()


def test_prefetch_pairs_and_loop(lib, tmp_path):
    rng = np.random.default_rng(11)
    pairs = []
    for i in range(3):
        lp, rp = tmp_path / f"{i}_l.png", tmp_path / f"{i}_r.png"
        write_png(str(lp), rng.integers(0, 256, (10, 14, 3), dtype=np.uint8))
        write_png(str(rp), rng.integers(0, 256, (10, 14, 3), dtype=np.uint8))
        pairs.append((str(lp), str(rp)))
    src = lib.PrefetchSource(pairs, side_by_side=False, loop=True, threads=2)
    for _ in range(7):  # loops past the end
        l, r = next(src)
        assert l.shape == (10, 14, 3) and r.shape == (10, 14, 3)
    src.close()


def test_prefetch_stress_no_deadlock(lib, tmp_path):
    """Many decode workers on a capacity of one, frames of very different
    decode cost: every frame arrives, in order, within a bounded time."""
    rng = np.random.default_rng(12)
    n = 48
    for i in range(n):
        h, w = (6, 12) if i % 3 else (96, 160)
        f = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        f[0, 0, 0] = i % 251
        write_png(str(tmp_path / f"p{i:03d}_l.png"), f)
        write_png(str(tmp_path / f"p{i:03d}_r.png"), f)
    pairs = [(str(tmp_path / f"p{i:03d}_l.png"), str(tmp_path / f"p{i:03d}_r.png"))
             for i in range(n)]
    got = []

    def run():
        src = lib.PrefetchSource(pairs, side_by_side=False, threads=6, depth=1)
        for l, _ in src:
            got.append(int(l[0, 0, 0]))
        src.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "prefetch source deadlocked"
    assert got == [i % 251 for i in range(n)]


def test_now_us_monotonic():
    a = native.now_us()
    b = native.now_us()
    assert b >= a > 0
