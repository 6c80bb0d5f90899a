"""Profiling / tracing utilities (own copy of the JAX package's
utils/profiling.py, on torch.profiler and CUDA events).

The reference's two mechanisms, wall-clock stage timers with a running
CVC average (src/StereoMatch.cpp:209-268, ComFunc.h get_rt) and per-kernel
device profiling (oclUtil printProfilingInfo), map here to:

  * StageTimers: accumulating per-stage timers with running averages; on a
    CUDA device a stage is timed by CUDA events around it and ends in a
    synchronisation, so its time is the device's, not the enqueue's;
  * trace(): a torch.profiler context that writes a Chrome trace;
  * collect_kernel_stats(): per-kernel device time from torch.profiler's
    averages (the reference's CL_QUEUE_PROFILING_ENABLE event dump);
  * gif_hbm_bytes() / hbm_roofline_fraction(): the memory-bound
    speed-of-light estimate of a STEREO_GIF frame against the H100's HBM.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import time

import torch

H100_HBM_GBPS = 3350.0     # H100 SXM HBM3


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


def collect_kernel_stats(fn, args, steps: int = 5, warmup: int = 2) -> list[dict]:
    """Run `fn(*args)` `steps` times under torch.profiler and return the
    MEASURED device time of each kernel (and copy), sorted by total self
    time: dicts of name, occurrences, total_self_us and avg_self_us (per
    occurrence). Raises RuntimeError without a CUDA card, or where the
    trace holds no device time: a CPU run has no device to report."""
    from torch.profiler import profile

    if not torch.cuda.is_available():
        raise RuntimeError("collect_kernel_stats needs a CUDA card: a CPU run "
                           "has no device time")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=_activities()) as prof:
        for _ in range(steps):
            fn(*args)
        torch.cuda.synchronize()
    recs = []
    for e in prof.key_averages():
        # device rows: device time and no host time of their own
        if e.self_device_time_total <= 0 or e.self_cpu_time_total != 0:
            continue
        occ = max(int(e.count), 1)
        recs.append({
            "name": e.key,
            "occurrences": occ,
            "total_self_us": float(e.self_device_time_total),
            "avg_self_us": float(e.self_device_time_total) / occ,
        })
    if not recs:
        raise RuntimeError("the profiler captured no device time")
    recs.sort(key=lambda r: -r["total_self_us"])
    return recs


def gif_hbm_bytes(height: int, width: int, max_dis: int, subsample: int,
                  wmf_radius: int = 9) -> int:
    """Minimum HBM traffic for one STEREO_GIF frame (both views), assuming
    perfect fusion: inputs once, the low-res volume once each way through
    the filter chain, the filtered full-res volume once into WTA, and the
    WMF tiles once. This is the denominator for a speed-of-light claim."""
    h, w = height // subsample, width // subsample
    f32 = 4
    img = height * width * 3 * f32 * 2                 # both views read
    low_volume = max_dis * h * w * f32 * 2 * 2         # build + filter read
    # upsampled (a, b) maps consumed at full res by q/WTA: 4 maps per view
    q_inputs = 4 * max_dis * h * w * f32 * 2
    q_stream = max_dis * height * width * f32 * 2      # q evaluated into argmin
    disp = height * width * 2                          # uint8 out, both views
    wmf = (height * width * (1 + 3 + 4) + disp) * 2    # tiles in, disp out
    return img + low_volume + q_inputs + q_stream + wmf


def hbm_roofline_fraction(frame_seconds: float, height: int, width: int,
                          max_dis: int, subsample: int,
                          hbm_gbps: float = H100_HBM_GBPS) -> float:
    """Fraction of HBM speed-of-light achieved (default: the H100 SXM's
    3.35 TB/s)."""
    needed = gif_hbm_bytes(height, width, max_dis, subsample)
    sol = needed / (hbm_gbps * 1e9)
    return sol / frame_seconds
