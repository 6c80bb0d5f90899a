"""Profiling / tracing utilities (own copy of the JAX package's
utils/profiling.py, on torch.profiler and CUDA events).

The reference's two mechanisms, wall-clock stage timers with a running
CVC average (src/StereoMatch.cpp:209-268, ComFunc.h get_rt) and per-kernel
device profiling (oclUtil printProfilingInfo), map here to:

  * StageTimers: accumulating per-stage timers with running averages; on a
    CUDA device a stage is timed by CUDA events around it and ends in a
    synchronisation, so its time is the device's, not the enqueue's;
  * trace(): a torch.profiler context that writes a Chrome trace, the
    device's kernels and copies beside the program's spans;
  * span(): a named host span of the program (`psm.*`), recorded only
    while a profiler runs, on the clock of the profiler's device rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import time

import torch

# what span() returns while no profiler runs: one shared context, no allocation
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records the host span `name` while a profiler is
    recording (`torch.profiler`, `trace()`), and the shared no-op otherwise.

    The span is a plain CPU op of the profiler (the FUNCTION scope of
    `_RecordFunctionFast`), nested by the profiler's own stack. Unlike
    `record_function`'s user annotations it has no mirror among the
    device's events, so a reader of the trace never takes a span for
    device work. Off, a call costs one check of the profiler's state."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


@dataclasses.dataclass
class _Stage:
    total_ms: float = 0.0
    count: int = 0
    last_ms: float = 0.0

    @property
    def avg_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0


class StageTimers:
    """Per-stage timers with running averages (the reference prints CVC's
    running average every frame, src/StereoMatch.cpp:209-218). `device=None`
    or a CPU device: the host's wall clock. A CUDA device: CUDA events
    recorded on its current stream before and after the stage, and the
    stage ends in a synchronisation on the second."""

    def __init__(self, device: str | torch.device | None = None):
        self.stages: dict[str, _Stage] = {}
        self.device = torch.device(device) if device is not None else None

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.device is not None and self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
            yield
            end.record(torch.cuda.current_stream(self.device))
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            yield
            ms = (time.perf_counter() - t0) * 1e3
        s = self.stages.setdefault(name, _Stage())
        s.total_ms += ms
        s.count += 1
        s.last_ms = ms

    def report(self) -> str:
        return " | ".join(
            f"{k} {v.last_ms:.1f}ms (avg {v.avg_ms:.1f})"
            for k, v in self.stages.items()
        )


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (host ops, and the device's kernels and
    copies where a card is present); writes `log_dir/trace.json`, a Chrome
    trace (chrome://tracing, Perfetto)."""
    from torch.profiler import profile

    pathlib.Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(str(pathlib.Path(log_dir) / "trace.json"))
