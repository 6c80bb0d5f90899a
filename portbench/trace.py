"""The traced window: the profiler's device events, the benchmark's spans
and the program's.

`Window` holds what a per-layer metric reads: the device's kernels and
copies (name, start, end in microseconds on the profiler's clock), the
benchmark's own annotations and the program's `psm.*` spans on the same
clock, the change of the app's counters over the window, the frames the
window completed, its length, the configuration, the frame's geometry and
the port's kernel names. Each metric file under `portbench/metrics/` reads
it; the harness never needs to know what a metric reads.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re

import numpy as np

# a device event that is not a kernel: a copy or a fill
COPY_PREFIXES = ("Memcpy", "Memset")
# the benchmark's spans, innermost first: what the host was doing
HOST_SPANS = (("portbench.source_next", "app in the source's next"),
              ("portbench.app_next", "app: dispatch, wait, fetch"),
              ("portbench.harness", "harness between frames"))
WINDOW_SPAN = "portbench.window"
# the program's spans (primestereomatch_torch/utils/profiling.py::span)
PROGRAM_PREFIX = "psm."


def port_kernel_names(package_dir: pathlib.Path) -> tuple[str, ...]:
    """The `__global__` functions of the program's CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    names = set()
    for src in sorted((package_dir / "csrc").glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return tuple(sorted(names))


def kernel_pattern(names) -> re.Pattern:
    """Matches a profiler name that holds one of `names` as a whole word."""
    return re.compile(r"\b(?:" + "|".join(re.escape(n) for n in names) + r")\b")


def union_us(intervals: np.ndarray) -> float:
    """Length of the union of (start, end) rows."""
    if not len(intervals):
        return 0.0
    iv = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    # a new run starts where an interval begins after every earlier one ended
    new = np.r_[True, iv[1:, 0] > ends[:-1]]
    starts = iv[new, 0]
    run_ends = np.r_[ends[np.flatnonzero(new)[1:] - 1], ends[-1]]
    return float((run_ends - starts).sum())


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


def idle_gaps(intervals: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """(start, end) rows of the device's idle time within [lo, hi]."""
    if not len(intervals):
        return np.array([[lo, hi]])
    iv = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    gaps = [(lo, iv[0, 0])]
    gaps += list(zip(ends[:-1], iv[1:, 0]))
    gaps.append((ends[-1], hi))
    g = np.array(gaps, dtype=np.float64)
    g[:, 0] = np.clip(g[:, 0], lo, hi)
    g[:, 1] = np.clip(g[:, 1], lo, hi)
    return g[g[:, 1] > g[:, 0]]


@dataclasses.dataclass
class Window:
    frames: int                      # frames the traced window completed
    window_s: float                  # its length
    lo_us: float                     # its bounds on the profiler's clock
    hi_us: float
    device: list                     # (name, start_us, end_us) kernels and copies
    host: list                       # (name, start_us, end_us) the benchmark's spans (and
                                     # the program's, as `from_profiler` gives them)
    geometry: dict                   # H, W (the matched frame), D; GIF's s, k, radius
    port_kernels: tuple              # the program's __global__ names
    k3_outputs: list                 # each traced frame's (2, H, W) disparities, as the app
                                     # hands them (for GIF, K3's JointWMF output)
    source_blocked_ms: list          # each frame's share of its latency spent in the source
    # the configuration as its file holds it
    config: dict = dataclasses.field(default_factory=dict)
    # (name, start_us, end_us) the host side of the program's psm.* spans inside the window
    program: list = dataclasses.field(default_factory=list)
    counts: dict | None = None       # the change of the app's `stream_counts` over the window
    # each frame's latency in ms, as the untraced window's frame_p50_ms and frame_p95_ms take it
    latency_ms: list = dataclasses.field(default_factory=list)

    def _arr(self, rows) -> np.ndarray:
        return np.array([(s, e) for _, s, e in rows], dtype=np.float64).reshape(-1, 2)

    def kernels(self):
        return [r for r in self.device if not r[0].startswith(COPY_PREFIXES)]

    def device_ms(self, names) -> float:
        """Device ms of the kernels that hold one of `names`, summed."""
        pat = kernel_pattern(names)
        return sum(e - s for n, s, e in self.kernels() if pat.search(n)) / 1e3

    def program_ms(self, name: str, own: bool = False) -> float | None:
        """Host ms a frame of the program's span `name` in the window, whole
        or (`own`) less its direct program children; None where the window
        holds none of it or no frame."""
        if not self.frames:
            return None
        lengths = self_us(self.program) if own else [e - s for _, s, e in self.program]
        mine = [t for (n, _, _), t in zip(self.program, lengths) if n == name]
        return sum(mine) / 1e3 / self.frames if mine else None

    def busy_s(self) -> float:
        return union_us(self._arr(self.device)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle time by what the
        host was doing (the innermost benchmark span around the gap's middle)."""
        by_op: dict[str, float] = {}
        for n, s, e in self.device:
            by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
        gaps = idle_gaps(self._arr(self.device), self.lo_us, self.hi_us)
        mids = gaps.mean(axis=1)
        label = np.full(len(gaps), "harness: no span", dtype=object)
        for key, text in reversed(HOST_SPANS):    # innermost last, so it wins
            spans = self._arr([r for r in self.host if r[0] == key])
            if not len(spans):
                continue
            spans = spans[np.argsort(spans[:, 0])]
            j = np.searchsorted(spans[:, 0], mids, side="right") - 1
            inside = (j >= 0) & (mids < spans[np.maximum(j, 0), 1])
            label[inside] = text
        by_gap: dict[str, float] = {}
        for text, (s, e) in zip(label, gaps):
            by_gap[text] = by_gap.get(text, 0.0) + (e - s) / 1e6
        return {"device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]}


def from_profiler(events) -> tuple[list, list]:
    """The device rows, and the host rows of the benchmark's spans (the
    window's among them) and of the program's `psm.*` spans, of a
    `torch.profiler` event list."""
    from torch.autograd import DeviceType

    device, host = [], []
    spans = {key for key, _ in HOST_SPANS} | {WINDOW_SPAN}
    for e in events:
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name in spans:
            # the profiler mirrors each annotation on the device's timeline:
            # only its host side is a span, and neither is device work
            if e.device_type == DeviceType.CPU:
                host.append(row)
        elif e.device_type == DeviceType.CUDA:
            device.append(row)
        elif e.name.startswith(PROGRAM_PREFIX) and e.device_type == DeviceType.CPU:
            # the program's spans are CPU ops with no device mirror
            host.append(row)
    return device, host
