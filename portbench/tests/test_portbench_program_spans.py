"""The program's `psm.*` spans: the program records them as plain CPU ops
with no mirror among the device's events, so `trace.from_profiler` keeps
their host side and leaves the device rows as they are without them; every
reader of the device rows and the benchmark's spans reads what it read
without them, and the readers of the program's spans and counter read the
arithmetic of `trace_stream.py::summarize`."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from portbench import run, trace
from portbench.tests.tiny import ROOT
from primestereomatch_torch.utils import profiling

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def event(name, start, end, device=DeviceType.CPU):
    return types.SimpleNamespace(name=name, device_type=device,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_program_spans_are_cpu_ops_without_a_device_mirror():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("psm.stream.dispatch"):
            torch.ones(4).sum()
    (e,) = [e for e in prof.events() if e.name == "psm.stream.dispatch"]
    # user annotations (record_function, scope 7) get a device mirror on a card
    assert e.device_type == DeviceType.CPU and e.scope != 7


# each algorithm's traced frame: its cell, its device ops (name, start, end
# from the frame's start) and the program's spans; its counters' change
# over two frames
FRAMES = {
    "STEREO_GIF": ("gif_zed2k.max",
                   [("Memcpy HtoD (Pinned -> Device)", 20.0, 40.0),
                    ("void cvc_lowmaps_kernel<5>(float*)", 40.0, 140.0),
                    ("void upsample_wta_staged_kernel(float*)", 140.0, 250.0),
                    ("void joint_wmf_kernel(float*)", 250.0, 390.0),
                    ("void elementwise_kernel(float*)", 390.0, 395.0)],
                   [("psm.stream.read", 1.0, 2.0), ("psm.stream.dispatch", 2.0, 30.0),
                    ("psm.rectify", 3.0, 7.0), ("psm.gif.forward", 8.0, 28.0),
                    ("psm.stream.wait", 31.0, 420.0), ("psm.stream.fetch", 420.0, 440.0)],
                   {"frames": 2, "ready_at_wait": 1}),
    "STEREO_SGBM": ("sgbm_zed2k.max",
                    [("Memcpy HtoD (Pageable -> Device)", 20.0, 40.0),
                     ("void bt_cost_kernel<short, 32>(int const*)", 40.0, 100.0),
                     ("void sgm_scan_kernel<short, unsigned short, 8>(short const*)",
                      100.0, 300.0),
                     ("void select_kernel<2, 8, 8, 32>(void const*)", 300.0, 330.0),
                     ("speckle_rows_kernel(int const*)", 330.0, 335.0),
                     ("speckle_cols_kernel(int const*)", 336.0, 342.0),
                     ("void elementwise_kernel(float*)", 390.0, 395.0)],
                    [("psm.stream.read", 1.0, 2.0), ("psm.compute.upload", 2.0, 38.0),
                     ("psm.sgbm.forward", 39.0, 400.0), ("psm.sgbm.cost", 40.0, 45.0),
                     ("psm.sgbm.speckle", 300.0, 390.0), ("psm.compute.fetch", 400.0, 440.0)],
                    {"frames": 0, "ready_at_wait": 0, "speckle_sweeps": 6}),
}


def _windows(algorithm):
    """Two frames of `algorithm`'s cell traced without and with the
    program's spans, as `trace.Window`s."""
    cell, ops, spans, counts = FRAMES[algorithm]
    base = [event(trace.WINDOW_SPAN, 0.0, 1000.0), event(trace.WINDOW_SPAN, 0.0, 1000.0,
                                                         DeviceType.CUDA)]
    program = []
    for f in range(2):
        t = 500.0 * f
        base += [event("portbench.app_next", t, t + 450.0),
                 event("portbench.app_next", t + 5.0, t + 400.0, DeviceType.CUDA),
                 event("aten::add", t + 10.0, t + 12.0)]
        base += [event(n, t + s, t + e, DeviceType.CUDA) for n, s, e in ops]
        program += [event(n, t + s, t + e) for n, s, e in spans]
    (plain_dev, plain_host), (device, host) = (trace.from_profiler(base),
                                               trace.from_profiler(base + program))
    # the program's spans leave the device rows and the benchmark's spans as they were
    assert device == plain_dev
    assert not [r for r in device + plain_host if r[0].startswith("psm.")]
    rows = [r for r in host if r[0].startswith("psm.")]
    assert [r for r in host if r not in rows] == plain_host
    assert rows == [(e.name, e.time_range.start, e.time_range.end) for e in program]
    rng = np.random.default_rng(0)
    geometry = {"H": 16, "W": 32, "D": 16, "s": 4, "k": 5, "radius": 9}
    window = dict(frames=2, window_s=1e-3, lo_us=0.0, hi_us=1000.0, geometry=geometry,
                  port_kernels=trace.port_kernel_names(ROOT / "primestereomatch_torch"),
                  k3_outputs=[rng.integers(0, 16, (2, 16, 32), dtype=np.uint8)] * 2,
                  source_blocked_ms=[0.0, 0.0], config=run.load_cell(cell)["config"],
                  latency_ms=[20.0, 22.0])
    without = trace.Window(device=plain_dev, host=plain_host, **window)
    spanned = trace.Window(device=device, host=host, program=rows, counts=counts, **window)
    return without, spanned


def test_every_reader_reads_the_same_with_and_without_program_spans():
    """Each reader on a window of its own cells' algorithm: STEREO_GIF's
    readers on GIF frames, STEREO_SGBM's on SGBM frames."""
    algorithms = {}
    for m in BENCH["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
        for cell in cells:
            algorithms.setdefault(run.load_cell(cell)["config"]["algorithm"], []).append(m)
    assert set(algorithms) == set(FRAMES)
    for algorithm, metrics in algorithms.items():
        without, spanned = _windows(algorithm)
        for m in metrics:
            reader = run.load_metric(m["name"])
            want = reader.read(without)
            if want is not None:
                assert reader.read(spanned) == want, (algorithm, m["name"])
            else:   # a reader of the program's spans or counter
                assert reader.read(spanned) is not None, (algorithm, m["name"])
        assert spanned.breakdown() == without.breakdown()


def test_the_program_readers_read_trace_streams_arithmetic():
    """The hand-made window of `trace_stream.py`'s own test: self time less
    nested children, host ms a frame, readiness; none without the rows."""
    rows = [("psm.stream.dispatch", 0.0, 30.0), ("psm.gif.forward", 5.0, 25.0),
            ("psm.gif.wmf", 10.0, 20.0), ("psm.stream.fetch", 30.0, 40.0),
            ("psm.stream.dispatch", 50.0, 80.0), ("psm.rectify", 52.0, 55.0),
            ("psm.gif.forward", 55.0, 75.0), ("psm.stream.fetch", 80.0, 90.0)]
    window = dict(frames=2, window_s=1e-4, lo_us=0.0, hi_us=100.0, device=[], host=[],
                  geometry={}, port_kernels=(), k3_outputs=[], source_blocked_ms=[])
    w = trace.Window(program=rows, counts={"frames": 2, "ready_at_wait": 1}, **window)
    want = {"stream_host_ms": (10 + 7 + 10 + 10) / 2e3, "gif_dispatch_ms": 20 / 1e3,
            "rectify_host_ms": 1.5 / 1e3, "frames_ready_at_wait_pct": 50.0}
    for name, value in want.items():
        assert run.load_metric(name).read(w) == pytest.approx(value), name
        assert run.load_metric(name).read(trace.Window(**window)) is None, name
    assert w.program_ms("psm.gif.forward", own=True) == pytest.approx((10 + 20) / 2e3)
    no_frames = trace.Window(program=rows, counts={"frames": 0, "ready_at_wait": 0},
                             **dict(window, frames=0))
    assert all(run.load_metric(n).read(no_frames) is None for n in want)
