"""The port's app layer (`app.py`, `hci.py`, `cli.py`, `__main__.py`)
against the JAX package's on the CPU, at small sizes: the same frames, made
from a seed with numpy, through both apps (the port's with device="cpu").
SGBM frames bitwise, GIF frames within the WTA tie class (2e-3 of pixels,
the bound of tests/test_torch_pipeline.py), the calibrated crops bitwise,
and stream() equal to compute() frame by frame."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import port_helpers
from primestereomatch_tpu import app as japp
from primestereomatch_tpu import cli as jcli
from primestereomatch_torch import app, cli, hci
from primestereomatch_torch.calib import Rectifier, load_stereo_calibration
from primestereomatch_torch.utils.png import read_png, write_png
from primestereomatch_torch.utils.video import SyntheticZEDSource

ROOT = pathlib.Path(__file__).resolve().parents[1]
HD720 = (1280, 720)


def _apps(**kw):
    """The JAX app and the port's (on the CPU) from one JAX AppConfig."""
    jcfg = japp.AppConfig(**kw)
    cfg = app.from_jax_app_config(dataclasses.asdict(jcfg))
    return japp.StereoMatchApp(jcfg), app.StereoMatchApp(dataclasses.replace(cfg, device="cpu"))


def _mismatch(a, b) -> float:
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return float((a != b).mean())


def _synthetic(n=5, w=64, h=32, d=8):
    return SyntheticZEDSource(width=w, height=h, n_frames=n, max_disparity=d, smoothing=0)


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    """The 32x64 synthetic pair of true disparity 2 (frame 2 of the JAX
    app test's stream) and a ground truth at scale 4, as PNG files."""
    d = tmp_path_factory.mktemp("pair")
    src = _synthetic(n=4)
    next(src)
    next(src)
    l, r = next(src)
    write_png(str(d / "l.png"), l)
    write_png(str(d / "r.png"), r)
    write_png(str(d / "gt.png"), np.full(l.shape[:2], 8, np.uint8))
    return {k: str(d / f"{k}.png") for k in ("l", "r", "gt")}


# ---- config and construction -------------------------------------------------------

def test_from_jax_app_config_roundtrip_and_unknown_keys():
    for jcfg in (japp.AppConfig(), japp.AppConfig(
            alg="STEREO_SGBM", media_mode="video", max_dis=32, subsample=2, med_sz=7,
            mask_mode="disc", calib_dir="data", calib_size=(672, 376), timed=True)):
        d = dataclasses.asdict(jcfg)
        cfg = app.from_jax_app_config(d)
        assert cfg.device is None
        assert {k: v for k, v in dataclasses.asdict(cfg).items() if k != "device"} == d
    with pytest.raises(ValueError, match="unknown AppConfig keys"):
        app.from_jax_app_config({"alg": "STEREO_GIF", "wta_impl": "xla"})
    with pytest.raises(ValueError, match="device"):
        app.from_jax_app_config({"device": "cpu"})


def test_app_default_device_is_the_card():
    """AppConfig() means the card: without one the app raises; no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        app.StereoMatchApp(app.AppConfig(media_mode="video"))


# ---- image mode ------------------------------------------------------------------------

def test_app_image_gif_matches_jax(pair_files):
    kw = dict(alg="STEREO_GIF", media_mode="image", left=pair_files["l"],
              right=pair_files["r"], gt=pair_files["gt"], gt_scale=4, max_dis=8, med_sz=7,
              mask_mode="none")
    ja, pa = _apps(**kw)
    want, got = ja.compute(), pa.compute()
    assert _mismatch(got.l_disp, want.l_disp) <= 2e-3
    assert _mismatch(got.r_disp, want.r_disp) <= 2e-3
    np.testing.assert_array_equal(got.left_bgr, want.left_bgr)
    assert np.median(got.l_disp[8:-8, 16:-16]) == 2
    assert got.metrics is not None and got.frame_index == 0
    assert got.metrics.percent_bad_pixels == pytest.approx(
        want.metrics.percent_bad_pixels, abs=0.5)
    mosaic = pa.mosaic(got)
    assert mosaic.shape == (64, 192, 3)             # 2x3: with the ground truth
    np.testing.assert_array_equal(mosaic[:32, :64], got.left_bgr)
    assert "%BP(none)" in pa.report(got) and "frame 0" in pa.report(got)


def test_app_image_gif_timed_stages(pair_files):
    """--timed: DispEst's four stages, each timed to a synchronisation."""
    _, pa = _apps(alg="STEREO_GIF", media_mode="image", left=pair_files["l"],
                  right=pair_files["r"], max_dis=8, med_sz=7, timed=True, mask_mode="none")
    res = pa.compute()
    assert set(res.times_ms) == {"CVC", "CVF", "DispSel", "PP", "total"}
    assert np.median(res.l_disp[8:-8, 16:-16]) == 2
    assert pa.mosaic(res).shape == (64, 128, 3)     # 2x2: no ground truth


# ---- video mode ------------------------------------------------------------------------

def test_app_video_sgbm_bitwise_jax():
    ja, pa = _apps(alg="STEREO_SGBM", media_mode="video", max_dis=16, mask_mode="none")
    for a in (ja, pa):
        a._source = _synthetic(n=2, w=96, h=48)
    for _ in range(2):
        want, got = ja.compute(), pa.compute()
        np.testing.assert_array_equal(got.l_disp, want.l_disp)
        np.testing.assert_array_equal(got.r_disp, want.r_disp)
        np.testing.assert_array_equal(got.left_bgr, want.left_bgr)
    assert got.frame_index == 1 and "total" in got.times_ms
    assert np.median(got.l_disp[8:-8, 16:-16]) == 1   # frame 1: true disparity 1


def test_app_stream_equals_compute():
    """stream(n) yields compute()'s frames bit for bit (and the JAX app's
    within the tie class), its results stay unchanged after later frames,
    and it drains a short source."""
    ja, pa = _apps(alg="STEREO_GIF", media_mode="video", max_dis=8, med_sz=7,
                   mask_mode="none")
    _, ref = _apps(alg="STEREO_GIF", media_mode="video", max_dis=8, med_sz=7,
                   mask_mode="none")
    for a in (ja, pa, ref):
        a._source = _synthetic(n=5)
    streamed = list(pa.stream(4))
    assert [r.frame_index for r in streamed] == [0, 1, 2, 3]
    for got, want, jax_res in zip(streamed, (ref.compute() for _ in range(4)), ja.stream(4)):
        np.testing.assert_array_equal(got.l_disp, want.l_disp)
        np.testing.assert_array_equal(got.r_disp, want.r_disp)
        np.testing.assert_array_equal(got.left_bgr, want.left_bgr)
        assert _mismatch(got.l_disp, jax_res.l_disp) <= 2e-3
        assert set(got.times_ms) == {"total"}
    assert np.median(streamed[2].l_disp[8:-8, 16:-16]) == 2
    rest = list(pa.stream(10))
    assert len(rest) == 1 and rest[0].frame_index == 4   # only frame 4 was left
    np.testing.assert_array_equal(rest[0].l_disp, ref.compute().l_disp)


@pytest.fixture(scope="module")
def calibrated_dir(tmp_path_factory):
    """Two side-by-side raw frames (2 x 384x216) of the known scene of port_helpers.py
    through the shipped HD720 calibration at calib_size 1280x720."""
    cal = load_stereo_calibration(str(ROOT / "data" / "intrinsics.yml"),
                                  str(ROOT / "data" / "extrinsics.yml"))
    size = (384, 216)
    rec = Rectifier(cal, size, calib_size=HD720, device="cpu")
    d = tmp_path_factory.mktemp("hd720_small")
    for i, seed in enumerate((5, 6)):
        scene_l, scene_r, _ = port_helpers.calibrated_scene(rec.crop, size, (10, 5), seed)
        raw = port_helpers.raw_frames(cal, rec.rect, size, HD720, (scene_l, scene_r))
        write_png(str(d / f"f{i}.png"), np.concatenate(raw, axis=1))
    return str(d)


@pytest.mark.parametrize("alg", ["STEREO_GIF", "STEREO_SGBM"])
def test_app_calibrated_video_matches_jax(calibrated_dir, alg):
    """Rectified crops bitwise the JAX app's; GIF disparities within the tie
    class, SGBM bitwise; the calibrated stream equals compute()."""
    kw = dict(alg=alg, media_mode="video", video_source=calibrated_dir,
              calib_dir=str(ROOT / "data"), calib_size=HD720, max_dis=16, mask_mode="none")
    ja, pa = _apps(**kw)
    results = [pa.compute() for _ in range(2)]
    for got in results:
        want = ja.compute()
        assert got.left_bgr.shape == (156, 304, 3)
        np.testing.assert_array_equal(got.left_bgr, want.left_bgr)
        np.testing.assert_array_equal(got.right_bgr, want.right_bgr)
        if alg == "STEREO_SGBM":
            np.testing.assert_array_equal(got.l_disp, want.l_disp)
        else:
            assert _mismatch(got.l_disp, want.l_disp) <= 2e-3
            assert _mismatch(got.r_disp, want.r_disp) <= 2e-3
    if alg == "STEREO_GIF":
        _, sa = _apps(**kw)
        for got, want in zip(sa.stream(2), results):
            np.testing.assert_array_equal(got.l_disp, want.l_disp)
            np.testing.assert_array_equal(got.r_disp, want.r_disp)
            np.testing.assert_array_equal(got.left_bgr, want.left_bgr)
            np.testing.assert_array_equal(got.right_bgr, want.right_bgr)


def test_sgbm_stream_ends_with_its_source():
    """The stream's compute() fallback ends where the source ends, as the GIF
    ring does: no RuntimeError from the source's StopIteration."""
    _, pa = _apps(alg="STEREO_SGBM", media_mode="video", max_dis=16, mask_mode="none")
    pa._source = _synthetic(n=3, w=96, h=48)
    assert [r.frame_index for r in pa.stream(10)] == [0, 1, 2]


# ---- setters and keys --------------------------------------------------------------------

@pytest.fixture()
def small_video_app():
    _, pa = _apps(alg="STEREO_SGBM", media_mode="video", max_dis=16, mask_mode="none")
    pa._source = _synthetic(n=2, w=96, h=48)
    return pa


def test_app_setters(small_video_app):
    a = small_video_app
    a.set_algorithm("STEREO_GIF")
    assert a.cfg.alg == "STEREO_GIF"
    a.set_subsample(2)
    assert a.gif_cfg.subsample == 2 and a._dispest.cfg.subsample == 2
    a.set_mask_mode("disc")
    assert a.cfg.mask_mode == "disc"
    assert a.toggle_sgbm_mode() == "sgbm" and a.sgbm_cfg.mode == "sgbm"
    with pytest.raises(ValueError):
        a.set_algorithm("NOPE")
    with pytest.raises(ValueError):
        a.set_mask_mode("everything")
    with pytest.raises(ValueError):
        a.update_dataset("NotADataset")
    with pytest.raises(ValueError):
        a.set_parallelism(9)


def test_keyloop_dispatch(small_video_app):
    """Every reference HCI key (src/main.cpp:80-198) drives its setter."""
    a = small_video_app
    msgs = []
    feed = ["a", "m", "m", "o", "s", "=", "=", "-", "h", "d", "x", "q"]
    kl = hci.KeyLoop(a, reader=lambda: feed.pop(0) if feed else "", echo=msgs.append)
    assert kl.pump()                       # 'a': SGBM -> GIF
    assert a.cfg.alg == "STEREO_GIF"
    assert kl.pump()                       # 'm' on GIF from the CPU
    if torch.cuda.is_available():
        assert a.gif_device.type == "cuda"
        a.toggle_gif_device()
    else:                                  # no card: refuses, naming CUDA
        assert "CUDA" in msgs[-1] and a.gif_device.type == "cpu"
    a.set_algorithm("STEREO_SGBM")
    assert kl.pump()                       # 'm' on SGBM: hh -> sgbm
    assert a.sgbm_cfg.mode == "sgbm" and "MODE_SGBM" in msgs[-1]
    assert kl.pump()                       # 'o': none -> nonocc
    assert a.cfg.mask_mode == "nonocc"
    assert kl.pump()                       # 's': 4 -> 8
    assert a.cfg.subsample == 8
    assert a.sgbm_cfg.mode == "sgbm"       # mode survives the engine rebuild
    thr = a.cfg.error_threshold
    assert kl.pump() and a.cfg.error_threshold == thr + 1   # '='
    assert kl.pump() and a.cfg.error_threshold == thr + 2
    assert kl.pump() and a.cfg.error_threshold == thr + 1   # '-'
    assert kl.pump()                       # 'h': help text
    assert "current:" in msgs[-1] and "sgbm_mode=sgbm" in msgs[-1] and "threads=" in msgs[-1]
    a.set_algorithm("STEREO_GIF")
    kl.handle("h")
    assert "device=cpu" in msgs[-1]
    assert kl.pump()                       # 'd' in video mode: refused
    assert "image mode" in msgs[-1]
    assert kl.pump()                       # unknown key ignored
    assert not kl.pump()                   # 'q' stops the run


def test_keyloop_dataset_cycle():
    _, pa = _apps(alg="STEREO_GIF", media_mode="image", dataset="Cones", max_dis=16)
    kl = hci.KeyLoop(pa, reader=lambda: "", echo=lambda s: None)
    start = pa.cfg.dataset
    assert kl.handle("d")
    assert pa.cfg.dataset != start and pa._sample.name == pa.cfg.dataset


def test_keyloop_digits_set_threads_results_unchanged(pair_files):
    """'1'-'8' set torch's CPU thread count (the reference's thread keys);
    the disparities do not change with it."""
    _, pa = _apps(alg="STEREO_GIF", media_mode="image", left=pair_files["l"],
                  right=pair_files["r"], max_dis=8, med_sz=7, mask_mode="none")
    msgs = []
    kl = hci.KeyLoop(pa, reader=lambda: "", echo=msgs.append)
    before = torch.get_num_threads()
    try:
        outs = []
        for key in "13":
            assert kl.handle(key)
            assert torch.get_num_threads() == int(key)
            assert f"changed to {key}" in msgs[-1] and "card" in msgs[-1]
            outs.append(pa.compute())
        np.testing.assert_array_equal(outs[0].l_disp, outs[1].l_disp)
        np.testing.assert_array_equal(outs[0].r_disp, outs[1].r_disp)
        kl.handle("h")
        assert "threads=3" in msgs[-1] and "1-8" in msgs[-1]
    finally:
        torch.set_num_threads(before)


def test_keyloop_resolves_stdin_reader_at_construction(monkeypatch, small_video_app):
    monkeypatch.setattr(hci, "_stdin_reader", lambda: "q")
    assert not hci.KeyLoop(small_video_app, echo=lambda s: None).pump()


# ---- CLI ---------------------------------------------------------------------------------------

def _surface(parser):
    """{subcommand or '': option strings} of an argparse parser."""
    import argparse

    out = {"": set()}
    for act in parser._actions:
        if isinstance(act, argparse._SubParsersAction):
            for name, sub in act.choices.items():
                out[name] = {s for a in sub._actions for s in a.option_strings}
        else:
            out[""] |= set(act.option_strings)
    return out


def test_cli_parser_is_jax_surface_plus_device():
    got, want = _surface(cli.build_parser()), _surface(jcli.build_parser())
    assert set(got) == set(want) == {"", "image", "video"}
    assert got[""] == want[""] | {"--device", "--trace"}
    assert got["image"] == want["image"] and got["video"] == want["video"]
    p = cli.build_parser()
    a = p.parse_args(["-a", "STEREO_GIF", "--device", "cpu", "image", "--dataset", "Teddy"])
    assert a.alg == "STEREO_GIF" and a.device == "cpu" and a.dataset == "Teddy"
    assert p.parse_args(["-a", "STEREO_SGBM", "video"]).device is None
    assert p.prog == "psm-torch"
    with pytest.raises(SystemExit):
        p.parse_args(["image"])                   # -a is required, like the reference
    with pytest.raises(SystemExit):
        p.parse_args(["-a", "BOGUS", "image"])


def _feed(monkeypatch, keys):
    feed = list(keys)
    monkeypatch.setattr(hci, "_stdin_reader", lambda: feed.pop(0) if feed else "")


def test_cli_main_video_and_quit_key(capsys, monkeypatch):
    _feed(monkeypatch, [])
    argv = ["-a", "STEREO_SGBM", "--max-dis", "8", "--mask", "none", "--device", "cpu"]
    assert cli.main(argv + ["--frames", "1", "video", "--source", "synthetic"]) == 0
    out = capsys.readouterr().out
    assert "STEREO_SGBM" in out and "frame 0" in out
    _feed(monkeypatch, ["q"])                     # 'q' after the first frame
    assert cli.main(argv + ["--frames", "5", "video", "--source", "synthetic"]) == 0
    out = capsys.readouterr().out
    assert "frame 0" in out and "frame 1" not in out


def test_cli_image_keys_and_mosaic(capsys, monkeypatch, pair_files, tmp_path):
    """Image mode runs the key loop on user files: 'd' is refused for them,
    a digit sets the CPU threads, 'q' (read after frame 2) stops a 4-frame
    run; --out writes each frame's mosaic."""
    before = torch.get_num_threads()
    _feed(monkeypatch, ["d", "3", "q"])
    try:
        rc = cli.main(["-a", "STEREO_GIF", "--max-dis", "8", "--med-sz", "7", "--frames", "4",
                       "--mask", "none", "--device", "cpu", "--out", str(tmp_path),
                       "image", "-l", pair_files["l"], "-r", pair_files["r"]])
    finally:
        torch.set_num_threads(before)
    assert rc == 0
    out = capsys.readouterr().out
    assert "User dataset has been specified" in out
    assert "CPU threads of the plain path changed to 3" in out
    assert "frame 2" in out and "frame 3" not in out
    m = read_png(str(tmp_path / "frame_0000.png"), 3)
    assert m.shape == (64, 128, 3)
    np.testing.assert_array_equal(m[:32, :64], read_png(pair_files["l"], 3))


def test_cli_recalibrate_without_inputs(capsys):
    assert cli.main(["-a", "STEREO_GIF", "--device", "cpu", "video", "--RECALIBRATE"]) == 1
    assert cli.main(["-a", "STEREO_GIF", "--device", "cpu", "video", "--RECAPTURE"]) == 1


def test_cli_recalibrate_imagelist_without_calib_dir(tmp_path, capsys):
    """--RECALIBRATE --imagelist without --calib-dir: the JAX CLI raises
    NameError (`d` is bound only on the --chessboard-dir branch); the port
    writes beside the list and reports the failed calibration (no
    chessboards here) with rc 1."""
    rng = np.random.default_rng(3)
    for n in ("l0.png", "r0.png"):
        write_png(str(tmp_path / n), rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    lst = tmp_path / "list.xml"
    lst.write_text('<?xml version="1.0"?>\n<opencv_storage>\n<imagelist>\n'
                   '"l0.png"\n"r0.png"\n</imagelist>\n</opencv_storage>\n')
    argv = ["video", "--RECALIBRATE", "--imagelist", str(lst)]
    with pytest.raises(NameError):
        jcli.main(["-a", "STEREO_GIF"] + argv)
    assert cli.main(["-a", "STEREO_GIF", "--device", "cpu"] + argv) == 1
    assert "calibration failed" in capsys.readouterr().err


def test_python_m_runs_the_cli():
    """`python -m primestereomatch_torch` runs the CLI; importing
    `primestereomatch_torch.__main__` runs nothing."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "primestereomatch_torch", "--device", "cpu", "-a", "STEREO_SGBM",
         "--max-dis", "8", "--frames", "1", "--mask", "none", "video", "--source", "synthetic"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120, stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr
    assert "frame 0 | alg STEREO_SGBM" in out.stdout
    quiet = subprocess.run([sys.executable, "-c", "import primestereomatch_torch.__main__"],
                           cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert quiet.returncode == 0 and quiet.stdout == "" and quiet.stderr == ""
