"""One run of one cell of the port's benchmark.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (`portbench/workloads/<cell>.json`) names a configuration
(`portbench/configs/<config>.json`), its loop and its scenes. The
configuration names its `algorithm` and holds its parameters in the block
that the algorithm's name gives (`reference.block_key`: STEREO_GIF's "gif",
STEREO_SGBM's "sgbm"). The run makes the cell's pool of camera frames on the
card from the seed and keeps it on the host as uint8, builds
`primestereomatch_torch.app.StereoMatchApp` for the configuration, warms the
stream up on the pool, and then hands the app its frames for `--seconds`
through `StereoMatchApp.stream`, the port's video path: as fast as the app
asks (closed loop) or at the camera's rate (open loop). It times each frame
from outside, from the moment the source handed it (closed) or it was due
(open) to the moment the stream yielded its result.

After the window the program's state is freed and the plain reference of the
configuration's algorithm (`portbench/reference/<block>.py`) works out
again, from the same raw frames, the outputs of a sample of the window's
frames drawn from the seed; `correct` holds each number compared to its
limit in the configuration's `correct`.

`--trace 0` prints the cell's end-to-end metrics, `--trace 1` its per-layer
metrics, each read by its own file under `portbench/metrics/` from a
profiled window of at most TRACE_SECONDS. The last line of standard output
is the result as one JSON object. Without a CUDA card the run exits 1 and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "primestereomatch_tpu")
WARMUP_FRAMES = 4        # two passes of the stream's ring of two slots
TRACE_SECONDS = 2.0      # the longest profiled window
SAMPLES = 4              # frames drawn from the window for the check, besides its first and last
STREAM_FRAMES = 10**9    # the stream's frame budget: the source ends the window
# the numbers `correct` compares, by the output each reads
COMPARED = {"disp_mismatch": "disp", "crop_mismatch": "crops"}
SETUP_MARKS: dict[str, float] = {}   # seconds from T_START at the end of each set-up phase


def mark(phase: str) -> None:
    SETUP_MARKS[phase] = time.perf_counter() - T_START


def load_cell(name: str, root: pathlib.Path = ROOT) -> dict:
    """The cell's workload, its configuration and the metrics that
    BENCHMARK.json gives it, each found by name; raises where the
    configuration's algorithm has no parameter block or no reference."""
    from portbench import reference

    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = json.loads((root / "portbench" / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((root / "portbench" / "configs" / f"{work['config']}.json").read_text())
    key = reference.block_key(cfg["algorithm"])
    if key not in cfg:
        raise KeyError(f"configuration {work['config']} runs {cfg['algorithm']} but has no "
                       f"{key!r} block of its parameters")
    reference.algorithm(cfg, root)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"name": name, "workload": work, "config": cfg, "root": root,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def load_metric(name: str, root: pathlib.Path = ROOT):
    """The reader of per-layer metric `name`: portbench/metrics/<name>.py,
    or for a name `<base>.<part>` (one quantity split by the end-to-end
    metric it moves) portbench/metrics/<base>.py where it has no file of its own."""
    metrics = root / "portbench" / "metrics"
    path = metrics / f"{name}.py"
    if not path.exists():
        path = metrics / f"{name.partition('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.partition(".")[0] for m in sys.modules} & set(BANNED))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Sampler:
    """The window's first and last frames and `SAMPLES` more drawn uniformly
    from the seed (reservoir sampling), with their results."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.drawn: list = []
        self.first = self.last = None
        self.seen = 0

    def offer(self, k: int, res) -> None:
        if self.first is None:
            self.first = (k, res)
        self.last = (k, res)
        if len(self.drawn) < SAMPLES:
            self.drawn.append((k, res))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < SAMPLES:
                self.drawn[j] = (k, res)
        self.seen += 1

    def picked(self) -> dict:
        out = dict(self.drawn)
        for item in (self.first, self.last):
            if item is not None:
                out[item[0]] = item[1]
        return dict(sorted(out.items()))


def make_pool(cell: dict, seed: int, dev) -> list:
    """The cell's pool of camera frames, made on `dev` from the seed."""
    from portbench.reference import calib
    from portbench.traffic import scene

    cfg = cell["config"]
    calib_data = calib.load_calibration(cell["root"] / cfg["calib_dir"]) if cfg["calib_dir"] else None
    return scene.make_pool(cfg, cell["workload"], seed, dev, rectification(cell), calib_data)


def build_app(cell: dict, device, overrides: dict | None = None):
    """`StereoMatchApp` for the configuration, in video mode, running its
    algorithm; raises where the app's `<block>_cfg` would not hold every
    parameter of the configuration's block. `overrides` replace fields of
    that `<block>_cfg` (the program's own control paths)."""
    import dataclasses

    from portbench import reference
    from primestereomatch_torch.app import AppConfig, StereoMatchApp

    cfg, root = cell["config"], cell["root"]
    key = reference.block_key(cfg["algorithm"])
    block = cfg[key]
    # the app's own settings: the disparity range (SGBM's num_disparities),
    # and GIF's subsample and median size
    sizes = {k: block[k] for k in ("max_dis", "subsample", "med_sz") if k in block}
    if "num_disparities" in block:
        sizes["max_dis"] = block["num_disparities"]
    app = StereoMatchApp(AppConfig(
        alg=cfg["algorithm"], media_mode="video", **sizes,
        calib_dir=str(root / cfg["calib_dir"]) if cfg["calib_dir"] else None,
        calib_size=tuple(cfg["calib_size"] or (1280, 720)), device=device))
    app.set_parallelism(cfg["host_threads"])
    attr = f"{key}_cfg"
    if overrides:
        setattr(app, attr, dataclasses.replace(getattr(app, attr), **overrides))
    ran = dataclasses.asdict(getattr(app, attr))
    differ = {k: (v, ran.get(k, "no such field")) for k, v in block.items()
              if k not in (overrides or {}) and (k not in ran or ran[k] != v)}
    if differ:
        raise RuntimeError(f"the app's {attr} runs {differ} (configuration, app)")
    return app


def drive(app, source, span, on_result) -> list[float]:
    """Run `app.stream` on `source` until the source ends and the stream
    drains; `on_result(k, res)` for the k-th result. Returns each result's
    yield time."""
    base = app.frame_index
    app._source = source
    gen = app.stream(STREAM_FRAMES)
    yields: list[float] = []
    try:
        while True:
            with span("portbench.app_next"):
                res = next(gen, None)
            if res is None:
                break
            with span("portbench.harness"):
                yields.append(time.perf_counter())
                k = res.frame_index - base
                if k != len(yields) - 1:
                    raise RuntimeError(f"the stream yielded frame {k} as result {len(yields) - 1}")
                on_result(k, res)
    finally:
        gen.close()
    return yields


def blocked_ms(source, yields) -> list[float]:
    """For each frame, the ms of its latency during which the app sat in a
    blocked call into the source."""
    if not yields:
        return []
    due = np.asarray(source.due[:len(yields)])[:, None]
    done = np.asarray(yields)[:, None]
    if not source.blocked:
        return [0.0] * len(yields)
    b = np.asarray(source.blocked)
    over = np.minimum(done, b[None, :, 1]) - np.maximum(due, b[None, :, 0])
    return list(np.clip(over, 0, None).sum(axis=1) * 1e3)


def rectification(cell: dict):
    """The reference's rectification for the configuration, or None."""
    from portbench.reference import calib

    cfg = cell["config"]
    if not cfg["calib_dir"]:
        return None
    return calib.rectification(calib.load_calibration(cell["root"] / cfg["calib_dir"]),
                               tuple(cfg["camera"]["eye_size"]), cfg["calib_size"])


def reference_outputs(cell: dict, pool, wanted, dev, dtype=None) -> dict:
    """The reference's outputs for the pool frames `wanted`, by pool index."""
    import torch

    from portbench import reference
    from portbench.traffic.scene import eyes

    rect = rectification(cell)
    return {i: reference.outputs(cell["config"], *eyes(pool[i]), dev, rect,
                                 dtype or torch.float32, cell["root"])
            for i in sorted(set(wanted))}


def compare(limits: dict, got: dict, want: dict) -> dict:
    """Each number compared: the share of the outputs' values that differ
    (1 where the shapes differ). Values are compared as integers, both sides
    taken to int32 whatever their types: a uint8 map that wrapped
    disparities of 256 and more differs from the reference's uint16 one at
    each of those pixels, and equal values in uint8 and uint16 agree."""
    out = {}
    for key in limits:
        a, b = got[COMPARED[key]], want[COMPARED[key]]
        if a is None or a.shape != b.shape:
            out[key] = 1.0
        else:
            out[key] = float((a.astype(np.int32) != b.astype(np.int32)).mean())
    return out


def judge(cell: dict, pool, samples: dict, indices, dev) -> dict:
    """The worst, over the sampled frames, of each number compared against
    the reference, and how many sampled frames broke a limit."""
    limits = cell["config"]["correct"]
    refs = reference_outputs(cell, pool, [indices[k] for k in samples], dev)
    worst = {key: 0.0 for key in limits}
    wrong = 0
    for k, res in samples.items():
        got = {"disp": np.stack([res.l_disp, res.r_disp]),
               "crops": np.stack([res.left_bgr, res.right_bgr])}
        shares = compare(limits, got, refs[indices[k]])
        worst = {key: max(worst[key], shares[key]) for key in limits}
        wrong += any(shares[key] > limits[key] for key in limits)
    return {"worst": worst, "wrong": wrong}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             root: pathlib.Path = ROOT, overrides: dict | None = None,
             log=print) -> dict:
    """One run; returns the result line's object. `device=None` is the
    card; the tests pass "cpu" to drive the rest of a run without one."""
    import torch

    from portbench import reference
    from portbench import trace as tr
    from portbench.traffic import sources

    cell = load_cell(name, root)
    work, cfg = cell["workload"], cell["config"]
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    sync()
    mark("cuda_context")
    # the pool: the camera's frames, made on the device from the seed
    pool = make_pool(cell, seed, dev)
    mark("pool")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    app = build_app(cell, "cuda" if device is None else device, overrides)
    mark("app")
    no_span = sources._no_span
    drive(app, sources.ClosedSource(pool, limit=WARMUP_FRAMES), no_span, lambda k, r: None)
    sync()
    mark("warmup")

    window = min(seconds, TRACE_SECONDS) if trace else seconds
    sampler = Sampler(seed)
    first_out: dict = {}
    prof = None
    span = no_span
    profiling = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        profiling, span = prof, record_function

    counts_before = dict(app.stream_counts)
    with profiling:
        t0 = time.perf_counter()
        setup_s = t0 - T_START
        source = sources.make_source(work, pool, t0, window, span)

        def on_result(k, res):
            sampler.offer(k, res)
            if trace and source.index[k] not in first_out:
                first_out[source.index[k]] = np.stack([res.l_disp, res.r_disp])

        with span(tr.WINDOW_SPAN):
            yields = drive(app, source, span, on_result)
            sync()
    t_end = t0 + window
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    counts = {k: v - counts_before.get(k, 0) for k, v in app.stream_counts.items()}
    key = reference.block_key(cfg["algorithm"])
    ran_cfg, max_dis = getattr(app, f"{key}_cfg"), app.cfg.max_dis
    del app
    sync()
    if cuda:
        torch.cuda.empty_cache()

    attempted, completed = len(source.index), len(yields)
    lat_ms = [(y - d) * 1e3 for y, d in zip(yields, source.due)]
    metrics: dict = {}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": int(work["chips"]), "memory_peak_bytes": int(peak)}
    result: dict = {}
    if not trace:
        values = {"fps": sum(y <= t_end for y in yields) / window,
                  "frame_p50_ms": float(np.percentile(lat_ms, 50)) if lat_ms else None,
                  "frame_p95_ms": float(np.percentile(lat_ms, 95)) if lat_ms else None,
                  "setup_s": setup_s}
        for m in cell["end_to_end"]:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        device_rows, host_rows = tr.from_profiler(prof.events())
        _, lo, hi = next(r for r in host_rows if r[0] == tr.WINDOW_SPAN)
        H, W = first_out[next(iter(first_out))].shape[1:] if first_out else (0, 0)
        geometry = {"H": H, "W": W, "D": max_dis}
        if key == "gif":
            gif = cfg["gif"]
            geometry.update(s=gif["subsample"], k=2 * (gif["gif_radius"] // gif["subsample"]) + 1,
                            radius=gif["med_sz"] // 2)
        w = tr.Window(
            frames=completed, window_s=(hi - lo) / 1e6, lo_us=lo, hi_us=hi,
            device=device_rows, host=host_rows, geometry=geometry,
            port_kernels=tr.port_kernel_names(root / "primestereomatch_torch"),
            k3_outputs=[first_out[source.index[k]] for k in range(completed)],
            source_blocked_ms=blocked_ms(source, yields), config=cfg,
            program=[r for r in host_rows
                     if r[0].startswith(tr.PROGRAM_PREFIX) and lo <= r[1] and r[2] <= hi],
            counts=counts, latency_ms=lat_ms)
        for m in cell["per_layer"]:
            value = load_metric(m["name"], root).read(w)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_info.update(busy_s=w.busy_s(), window_s=w.window_s)
        result["breakdown"] = w.breakdown()
        del w, device_rows, host_rows, prof

    found = banned_modules()
    if found:
        raise SystemExit(f"portbench: loaded {found} in the measuring process")

    samples = sampler.picked()
    check = judge(cell, pool, samples, source.index, dev)
    limits = cfg["correct"]
    failed = (attempted - completed) + check["wrong"]
    correct = bool(completed) and failed == 0 and all(
        check["worst"][k] <= limits[k] for k in limits)
    checks = {k: {"value": check["worst"][k], "limit": limits[k]} for k in limits}
    checks["frames_missing"] = {"value": attempted - completed, "limit": 0}
    log(f"portbench {name} seed {seed}: {completed} of {attempted} frames in "
        f"{window:g} s, setup {setup_s:.3f} s, peak device memory {peak} B, "
        f"{len(samples)} frames checked; app config {ran_cfg}", file=sys.stderr)
    log("setup phases, s from the start: "
        + ", ".join(f"{k} {v:.3f}" for k, v in SETUP_MARKS.items()), file=sys.stderr)
    for k, v in checks.items():
        log(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info, **result, "checks": checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    mark("torch")
    chips = int(load_cell(args.workload)["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    import primestereomatch_torch

    if not pathlib.Path(primestereomatch_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"portbench: the program was loaded from {primestereomatch_torch.__file__}, "
              f"not from this checkout {ROOT}", file=sys.stderr)
        return 1
    mark("program_import")
    print(f"portbench: card {card_line()}", file=sys.stderr)
    mark("card_line")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
