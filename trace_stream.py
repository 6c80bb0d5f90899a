"""Where the host's time goes in one cell of the port's benchmark, by the
program's `psm.*` spans.

    python3 trace_stream.py --workload gif_zed2k.max --seed 7 [--seconds 2]

Runs the cell's warm-up and a profiled window of `StereoMatchApp.stream`
as `python -m portbench --trace 1` does (portbench/run.py's pool, app,
sources and benchmark spans), then prints one JSON line:

  * `frames`, `window_s`: the frames the window completed, its length;
  * `spans`: for each program span, its count and host ms a frame, whole
    (`ms`) and less its program children (`self_ms`);
  * `stream_host_ms`, `gif_dispatch_ms`, `rectify_host_ms`: host ms a frame
    of the stream's own work (`psm.stream.dispatch` + `psm.stream.fetch`
    less the Rectifier and the GIF entry inside them), of the GIF entry,
    and of the Rectifier;
  * `frames_ready_at_wait_pct`: the share of frames whose event had
    completed when the host came to wait (`StereoMatchApp.stream_counts`);
  * `device_ops_per_frame`, `device_idle_pct`, `program_rows_on_device`:
    the benchmark's readers of the device rows, and how many of those rows
    carry a program span's name (0: the spans have no device mirror);
  * `idle_by_benchmark_span`, `idle_by_program_span`: the device's idle
    seconds by the benchmark's span around each gap (portbench's
    breakdown), and by the innermost program span around it, else by the
    benchmark's span.

The k-th `psm.stream.dispatch`, `psm.stream.wait` and `psm.stream.fetch`
of a window are frame k's: the stream opens no span across a yield.
Needs a CUDA card; `measure(..., device="cpu")` runs a small cell on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

PREFIX = "psm."
DISPATCH, FETCH = "psm.stream.dispatch", "psm.stream.fetch"
FORWARD, RECTIFY = "psm.gif.forward", "psm.rectify"


def program_rows(events) -> list:
    """(name, start_us, end_us) of the host side of each program span."""
    from torch.autograd import DeviceType

    return [(e.name, float(e.time_range.start), float(e.time_range.end))
            for e in events if e.name.startswith(PREFIX) and e.device_type == DeviceType.CPU]


def self_us(rows) -> list:
    """Each row's length less its direct children's (rows of one thread
    nest: a child starts and ends inside its parent)."""
    order = sorted(range(len(rows)), key=lambda i: (rows[i][1], -rows[i][2]))
    own = [e - s for _, s, e in rows]
    stack: list[int] = []
    for i in order:
        while stack and rows[stack[-1]][2] <= rows[i][1]:
            stack.pop()
        if stack:
            own[stack[-1]] -= rows[i][2] - rows[i][1]
        stack.append(i)
    return own


def innermost(rows, points) -> list:
    """For each point, the name of the innermost row around it (of nested
    rows, the one that started last), or None."""
    if not rows:
        return [None] * len(points)
    iv = np.array([(s, e) for _, s, e in rows], dtype=np.float64)
    out = []
    for p in points:
        inside = np.flatnonzero((iv[:, 0] <= p) & (p < iv[:, 1]))
        out.append(rows[inside[np.argmax(iv[inside, 0])]][0] if len(inside) else None)
    return out


def summarize(w, rows, counts) -> dict:
    """The JSON line's numbers from a portbench `Window`, the program's rows
    and the change of `stream_counts` over the window (None: not kept)."""
    from portbench import trace as tr
    from portbench.metrics import device_idle_pct, device_ops_per_frame

    per = max(w.frames, 1)
    rows = [r for r in rows if w.lo_us <= r[1] and r[2] <= w.hi_us]
    own = self_us(rows)
    spans: dict = {}
    for (name, s, e), o in zip(rows, own):
        d = spans.setdefault(name, {"count": 0, "ms": 0.0, "self_ms": 0.0})
        d["count"] += 1
        d["ms"] += (e - s) / 1e3 / per
        d["self_ms"] += o / 1e3 / per

    def ms(name, key="ms"):
        return spans[name][key] if name in spans else None

    stream = [ms(DISPATCH, "self_ms"), ms(FETCH)]
    gaps = tr.idle_gaps(w._arr(w.device), w.lo_us, w.hi_us)
    mids = gaps.mean(axis=1)
    texts = dict(tr.HOST_SPANS)
    bench = [r for r in w.host if r[0] in texts]
    by_span: dict = {}
    for (s, e), mine, theirs in zip(gaps, innermost(rows, mids), innermost(bench, mids)):
        label = mine or texts.get(theirs, "harness: no span")
        by_span[label] = by_span.get(label, 0.0) + (e - s) / 1e6
    ready = (100.0 * counts["ready_at_wait"] / counts["frames"]
             if counts and counts["frames"] else None)
    return {
        "frames": w.frames, "window_s": w.window_s, "spans": spans,
        "stream_host_ms": sum(stream) if None not in stream else None,
        "gif_dispatch_ms": ms(FORWARD), "rectify_host_ms": ms(RECTIFY),
        "frames_ready_at_wait_pct": ready, "stream_counts": counts,
        "device_ops_per_frame": device_ops_per_frame.read(w),
        "device_idle_pct": device_idle_pct.read(w),
        "program_rows_on_device": sum(n.startswith(PREFIX) for n, _, _ in w.device),
        "idle_by_benchmark_span": dict(w.breakdown()["idle_gaps"]),
        "idle_by_program_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
    }


def measure(name: str, seed: int, seconds: float = 2.0, device: str = "cuda",
            root=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import run
    from portbench import trace as tr
    from portbench.traffic import sources

    cell = run.load_cell(name, root or run.ROOT)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    pool = run.make_pool(cell, seed, dev)
    app = run.build_app(cell, device)
    run.drive(app, sources.ClosedSource(pool, limit=run.WARMUP_FRAMES), sources._no_span,
              lambda k, r: None)
    sync()
    before = dict(getattr(app, "stream_counts", {}))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        source = sources.make_source(cell["workload"], pool, time.perf_counter(), seconds,
                                     record_function)
        with record_function(tr.WINDOW_SPAN):
            yields = run.drive(app, source, record_function, lambda k, r: None)
            sync()
    after = getattr(app, "stream_counts", {})
    counts = {k: after[k] - before.get(k, 0) for k in after} or None
    events = prof.events()
    device_rows, host_rows = tr.from_profiler(events)
    win = next(r for r in host_rows if r[0] == tr.WINDOW_SPAN)
    w = tr.Window(frames=len(yields), window_s=(win[2] - win[1]) / 1e6, lo_us=win[1],
                  hi_us=win[2], device=device_rows, host=host_rows, geometry={},
                  port_kernels=(), k3_outputs=[],
                  source_blocked_ms=run.blocked_ms(source, yields))
    out = summarize(w, program_rows(events), counts)
    blocked = w.source_blocked_ms
    out["source_blocked_ms"] = sum(blocked) / len(blocked) if blocked else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import run

    if not torch.cuda.is_available():
        print("trace_stream: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "card": run.card_line(),
                      **measure(args.workload, args.seed, args.seconds)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
