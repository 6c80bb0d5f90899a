"""The port's host spans (`utils/profiling.py::span`) and the stream's
counter on the CPU, at tiny sizes: a span is recorded only while a profiler
runs, nests as the program opens it, is never open across a yield of
`StereoMatchApp.stream`, and changes no output."""

import pathlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from primestereomatch_torch import GIFConfig, app, cli, hci, stereo_gif_forward
from primestereomatch_torch.models import gif_pipeline, sgbm_pipeline
from primestereomatch_torch.ops import sgbm as sgbm_ops
from primestereomatch_torch.utils import profiling
from primestereomatch_torch.utils.png import write_png
from primestereomatch_torch.utils.video import SyntheticZEDSource

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 3                       # frames a stream
NEXT = "test.next"          # the consumer's span around each next()
STREAM = ("psm.stream.read", "psm.stream.dispatch", "psm.stream.wait", "psm.stream.fetch")
GIF_STAGES = ("psm.gif.prep", "psm.gif.cost_maps", "psm.gif.wta", "psm.gif.wmf")
SGBM_STAGES = ("psm.sgbm.prefilter", "psm.sgbm.cost", "psm.sgbm.aggregate", "psm.sgbm.select",
               "psm.sgbm.speckle")
# compute()'s spans of a frame, in order, around the SGBM entry
COMPUTE = ("psm.stream.read", "psm.compute.upload", "psm.sgbm.forward", "psm.compute.fetch")


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _psm(prof) -> list:
    """(name, parent's name, start, end) of each `psm.*` event."""
    return [(e.name, e.cpu_parent.name if e.cpu_parent else None,
             e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("psm.")]


def _names(rows) -> list:
    return [r[0] for r in rows]


def _video_app(calib: bool, n=N):
    """A GIF video app on the CPU over `n` tiny synthetic frames; with
    `calib`, raw 128x72 eyes rectified by the shipped calibration."""
    w, h = (128, 72) if calib else (64, 32)
    a = app.StereoMatchApp(app.AppConfig(
        alg="STEREO_GIF", media_mode="video", max_dis=8, med_sz=7, mask_mode="none",
        calib_dir=str(ROOT / "data") if calib else None, device="cpu"))
    a._source = SyntheticZEDSource(width=w, height=h, n_frames=n, max_disparity=8,
                                   smoothing=0)
    return a


def _consume(gen) -> list:
    """Every result of `gen`, each next() inside the consumer's span."""
    out = []
    while True:
        with record_function(NEXT):
            res = next(gen, None)
        if res is None:
            return out
        out.append(res)


def test_span_without_a_profiler_is_the_shared_noop():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("psm.a"), profiling.span("psm.b")
    assert a is b is profiling._NO_SPAN
    with a:
        with b:                     # reentrant: one object serves every span
            pass


def test_span_under_the_profiler_nests_and_has_no_device_mirror():
    """Spans nest by the profiler's stack, and are plain CPU ops (not user
    annotations, which the profiler mirrors among the device's events)."""
    with _profiled() as prof:
        assert profiling.span("psm.x") is not profiling._NO_SPAN
        with profiling.span("psm.outer"):
            with profiling.span("psm.inner"):
                torch.ones(4).sum()
    rows = {r[0]: r for r in _psm(prof)}
    assert rows["psm.inner"][1] == "psm.outer" and rows["psm.outer"][1] is None
    user_scope = 7      # at::RecordScope::USER_SCOPE, record_function's
    for e in prof.events():
        if e.name.startswith("psm."):
            assert e.scope != user_scope and e.device_type == torch.autograd.DeviceType.CPU


@pytest.mark.parametrize("calib", [False, True], ids=["gif", "calibrated"])
def test_stream_spans_nest_per_frame_and_close_before_each_yield(calib):
    a = _video_app(calib)
    with _profiled() as prof:
        results = _consume(a.stream(N))
    assert len(results) == N
    rows = _psm(prof)
    names = _names(rows)
    for name in STREAM + ("psm.gif.forward",) + GIF_STAGES:
        assert names.count(name) == N, name
    assert names.count("psm.rectify") == (N if calib else 0)
    parent = {}
    for name, up, _, _ in rows:
        parent.setdefault(name, set()).add(up)
    for name in STREAM:
        assert parent[name] == {NEXT}, name
    assert parent["psm.gif.forward"] == {"psm.stream.dispatch"}
    for name in GIF_STAGES:
        assert parent[name] == {"psm.gif.forward"}, name
    if calib:
        assert parent["psm.rectify"] == {"psm.stream.dispatch"}
    # no span open across a yield: each lies inside one next() of the consumer
    nexts = [(e.time_range.start, e.time_range.end) for e in prof.events() if e.name == NEXT]
    for name, _, s, e in rows:
        assert any(lo <= s and e <= hi for lo, hi in nexts), name
    # the k-th dispatch, wait and fetch are frame k's: dispatch k precedes wait k
    starts = {n: [s for m, _, s, _ in rows if m == n] for n in STREAM}
    assert all(d < w < f for d, w, f in zip(starts["psm.stream.dispatch"],
                                            starts["psm.stream.wait"],
                                            starts["psm.stream.fetch"]))


@pytest.mark.parametrize("calib", [False, True], ids=["gif", "calibrated"])
def test_stream_outputs_are_bitwise_equal_under_the_profiler(calib):
    plain = list(_video_app(calib).stream(N))
    with _profiled():
        traced = list(_video_app(calib).stream(N))
    for got, want in zip(traced, plain, strict=True):
        for key in ("l_disp", "r_disp", "left_bgr", "right_bgr"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
        assert got.frame_index == want.frame_index


def test_stream_counts_every_cpu_frame_ready():
    a = _video_app(False, n=N + 2)
    assert a.stream_counts == {"frames": 0, "ready_at_wait": 0, "speckle_sweeps": 0}
    assert len(list(a.stream(N))) == N
    assert a.stream_counts == {"frames": N, "ready_at_wait": N, "speckle_sweeps": 0}
    assert len(list(a.stream(10))) == 2            # the counter lives as long as the app
    assert a.stream_counts == {"frames": N + 2, "ready_at_wait": N + 2, "speckle_sweeps": 0}


def test_compute_records_the_rectifier_and_the_gif_entry():
    a = _video_app(True)
    with _profiled() as prof:
        a.compute()
    rows = _psm(prof)
    for name in ("psm.rectify", "psm.gif.forward", "psm.stream.read", "psm.compute.upload",
                 "psm.compute.fetch"):
        assert _names(rows).count(name) == 1, name
    assert not set(_names(rows)) & set(STREAM[1:])  # the GIF ring alone opens those
    assert a.stream_counts["frames"] == 0


def _sgbm_app(n=N):
    """An SGBM video app on the CPU over `n` tiny synthetic frames."""
    a = app.StereoMatchApp(app.AppConfig(alg="STEREO_SGBM", media_mode="video", max_dis=16,
                                         mask_mode="none", device="cpu"))
    a._source = SyntheticZEDSource(width=96, height=48, n_frames=n, max_disparity=8,
                                   smoothing=0)
    return a


def test_sgbm_stream_records_compute_and_the_sgbm_entry():
    """Each SGBM frame of the stream (its compute() fallback): the read, the
    upload, the SGBM entry with its five stages in order, the fetch, all inside
    one next() of the consumer."""
    a = _sgbm_app()
    with _profiled() as prof:
        results = _consume(a.stream(N))
    assert len(results) == N
    rows = _psm(prof)
    top = [(n, up) for n, up, _, _ in rows if not n.startswith("psm.sgbm.") or
           n == "psm.sgbm.forward"]
    assert top == [(n, NEXT) for n in COMPUTE] * N
    assert [n for n, up, _, _ in rows if up == "psm.sgbm.forward"] == list(SGBM_STAGES) * N
    assert sgbm_pipeline.SPAN_FORWARD == "psm.sgbm.forward"


def test_speckle_sweeps_count_the_sweeps_k9_ran(monkeypatch):
    sweeps = []
    plain = sgbm_ops.speckle_sweep

    def counted(*args, **kw):
        sweeps.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(sgbm_ops, "speckle_sweep", counted)
    a = _sgbm_app()
    before = dict(a.stream_counts)
    assert len(list(a.stream(N))) == N
    assert len(sweeps) >= 2 * N
    assert a.stream_counts == {**before, "speckle_sweeps": before["speckle_sweeps"] + len(sweeps)}
    a._source = _sgbm_app(1)._source              # compute() alone counts too
    n = len(sweeps)
    a.compute()
    assert len(sweeps) > n
    assert a.stream_counts["speckle_sweeps"] == before["speckle_sweeps"] + len(sweeps)


@pytest.mark.parametrize("over, stages", [
    ({}, GIF_STAGES),                                            # K4 -> K2
    ({"cvc_dtype": "u8"}, GIF_STAGES),                           # u8 cost -> K1 -> K2
    ({"tail_fusion": "full"}, ("psm.gif.prep", "psm.gif.cost_maps", "psm.gif.wmf")),  # K10
    ({"pp_toolchain": True}, GIF_STAGES),                        # toolchain inside wmf
], ids=["maps", "u8", "full", "toolchain"])
def test_gif_entry_opens_its_stages_on_every_tail(over, stages):
    """The GIF entry's children follow the tail the configuration takes;
    160 = 4 * 40 is an exact stride, so `tail_fusion='full'` takes K10."""
    rng = np.random.default_rng(3)
    l, r = (rng.random((32, 160, 3), dtype=np.float32) for _ in range(2))
    cfg = GIFConfig(max_dis=8, med_sz=7, **over)
    want = stereo_gif_forward(l, r, cfg, device="cpu")
    with _profiled() as prof:
        got = stereo_gif_forward(l, r, cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    rows = _psm(prof)
    assert _names(rows)[0] == "psm.gif.forward"
    assert [n for n, up, _, _ in rows if up == "psm.gif.forward"] == list(stages)
    assert gif_pipeline.SPAN_FORWARD == "psm.gif.forward"


def test_cli_trace_writes_the_spans(tmp_path, monkeypatch):
    monkeypatch.setattr(hci, "_stdin_reader", lambda: "")
    rng = np.random.default_rng(4)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(2):
        write_png(str(frames / f"f{i}.png"), rng.integers(0, 256, (32, 128, 3), dtype=np.uint8))
    out = tmp_path / "trace"
    argv = ["-a", "STEREO_GIF", "--max-dis", "8", "--med-sz", "7", "--mask", "none",
            "--device", "cpu", "--frames", "2", "--pipeline", "--trace", str(out),
            "video", "--source", str(frames)]
    assert cli.main(argv) == 0
    text = (out / "trace.json").read_text()
    for name in ("psm.stream.dispatch", "psm.stream.fetch", "psm.gif.forward", "psm.gif.wmf"):
        assert f'"{name}"' in text, name


def test_span_cost_without_a_profiler_is_reported():
    """A micro-timing of span() with no profiler running: reported, not asserted."""
    n = 20000
    t = time.perf_counter()
    for _ in range(n):
        with profiling.span("psm.timing"):
            pass
    us = (time.perf_counter() - t) / n * 1e6
    print(f"span() with no profiler: {us:.3f} us a call (enter and exit)")


# ---- trace_stream.py: the spans read back from a traced window ------------------------

def test_trace_stream_summary_of_a_hand_made_window():
    """Self time less nested children, host ms a frame, readiness, and each
    idle gap by the innermost program span, else by the benchmark's."""
    from portbench import trace as tr

    import trace_stream

    app_next = "portbench.app_next"
    w = tr.Window(frames=2, window_s=1e-4, lo_us=0.0, hi_us=100.0,
                  device=[("k", 10.0, 20.0), ("k", 60.0, 70.0)],
                  host=[(app_next, 0.0, 50.0), (app_next, 50.0, 100.0)],
                  geometry={}, port_kernels=(), k3_outputs=[], source_blocked_ms=[])
    rows = [("psm.stream.dispatch", 0.0, 30.0), ("psm.gif.forward", 5.0, 25.0),
            ("psm.gif.wmf", 10.0, 20.0), ("psm.stream.fetch", 30.0, 40.0),
            ("psm.stream.dispatch", 50.0, 80.0), ("psm.rectify", 52.0, 55.0),
            ("psm.gif.forward", 55.0, 75.0), ("psm.stream.fetch", 80.0, 90.0)]
    out = trace_stream.summarize(w, rows, {"frames": 2, "ready_at_wait": 1})
    assert out["stream_host_ms"] == pytest.approx((10 + 7 + 10 + 10) / 2e3)
    assert out["gif_dispatch_ms"] == pytest.approx(20 / 1e3)
    assert out["rectify_host_ms"] == pytest.approx(1.5 / 1e3)
    assert out["spans"]["psm.gif.forward"]["self_ms"] == pytest.approx((10 + 20) / 2e3)
    assert out["frames_ready_at_wait_pct"] == 50.0
    assert out["device_ops_per_frame"] == 1.0 and out["program_rows_on_device"] == 0
    assert out["idle_by_program_span"] == pytest.approx(
        {"psm.gif.forward": 10e-6, "app: dispatch, wait, fetch": 40e-6,
         "psm.stream.fetch": 30e-6})
    assert out["idle_by_benchmark_span"] == pytest.approx({"app: dispatch, wait, fetch": 80e-6})
    none = trace_stream.summarize(w, [], None)
    assert none["stream_host_ms"] is none["gif_dispatch_ms"] is None
    assert none["frames_ready_at_wait_pct"] is None


def test_trace_stream_on_a_small_cpu_cell(tmp_path):
    from portbench.tests.tiny import tiny_root

    import trace_stream

    out = trace_stream.measure("tiny_vga.max", 2**31 + 5, 0.3, device="cpu",
                               root=tiny_root(tmp_path))
    n, spans = out["frames"], out["spans"]
    assert n > 0
    for name in ("psm.stream.dispatch", "psm.stream.wait", "psm.stream.fetch", "psm.rectify",
                 "psm.gif.forward") + GIF_STAGES:
        assert spans[name]["count"] == n, name
    assert spans["psm.stream.read"]["count"] == n + 1       # the read that ends the window
    assert out["stream_host_ms"] > 0 and out["gif_dispatch_ms"] > out["rectify_host_ms"] > 0
    assert out["stream_counts"] == {"frames": n, "ready_at_wait": n, "speckle_sweeps": 0}
    assert out["frames_ready_at_wait_pct"] == 100.0 and out["program_rows_on_device"] == 0
