"""The program's `psm.*` spans change nothing the benchmark reads: the
program records them as plain CPU ops with no mirror among the device's
events, so `trace.from_profiler` leaves them out of the device rows and out
of the benchmark's spans, and every per-layer reader reads what it read
without them."""

from __future__ import annotations

import json
import types

import numpy as np
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


def test_every_reader_reads_the_same_with_and_without_program_spans():
    k2, k3, k4 = "upsample_wta_staged_kernel", "joint_wmf_kernel", "cvc_lowmaps_kernel"
    base = [event(trace.WINDOW_SPAN, 0.0, 1000.0), event(trace.WINDOW_SPAN, 0.0, 1000.0,
                                                         DeviceType.CUDA)]
    for f in range(2):
        t = 500.0 * f
        base += [event("portbench.app_next", t, t + 450.0),
                 event("portbench.app_next", t + 5.0, t + 400.0, DeviceType.CUDA),
                 event("Memcpy HtoD (Pinned -> Device)", t + 20.0, t + 40.0, DeviceType.CUDA),
                 event(f"void {k4}<5>(float*)", t + 40.0, t + 140.0, DeviceType.CUDA),
                 event(f"void {k2}(float*)", t + 140.0, t + 250.0, DeviceType.CUDA),
                 event(f"void {k3}(float*)", t + 250.0, t + 390.0, DeviceType.CUDA),
                 event("aten::add", t + 10.0, t + 12.0),
                 event("void elementwise_kernel(float*)", t + 390.0, t + 395.0,
                       DeviceType.CUDA)]
    program = []
    for f in range(2):
        t = 500.0 * f
        program += [event("psm.stream.read", t + 1.0, t + 2.0),
                    event("psm.stream.dispatch", t + 2.0, t + 30.0),
                    event("psm.gif.forward", t + 8.0, t + 28.0),
                    event("psm.stream.wait", t + 31.0, t + 420.0),
                    event("psm.stream.fetch", t + 420.0, t + 440.0)]
    plain, spanned = trace.from_profiler(base), trace.from_profiler(base + program)
    assert spanned == plain
    device, host = spanned
    assert not [r for r in device + host if r[0].startswith("psm.")]
    rng = np.random.default_rng(0)
    geometry = {"H": 16, "W": 32, "D": 16, "s": 4, "k": 5, "radius": 9}
    window = dict(frames=2, window_s=1e-3, lo_us=0.0, hi_us=1000.0, host=host, geometry=geometry,
                  port_kernels=(k2, k3, k4),
                  k3_outputs=[rng.integers(0, 16, (2, 16, 32), dtype=np.uint8)] * 2,
                  source_blocked_ms=[0.0, 0.0])
    for m in BENCH["per_layer"]:
        reader = run.load_metric(m["name"])
        want = reader.read(trace.Window(device=plain[0], **window))
        got = reader.read(trace.Window(device=device, **window))
        assert got == want, m["name"]
    assert trace.Window(device=device, **window).breakdown() == \
        trace.Window(device=plain[0], **window).breakdown()
