#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of STEREO_GIF on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failed check raises and exits non-zero):

  1. the card's name and power limit, as nvidia-smi prints them;
  2. build the three CUDA kernels from csrc/ (one nvcc per source, in
     parallel) and print the build seconds and ptxas resource lines;
  3. parity on the card, each kernel against its plain PyTorch version on
     the same CUDA tensors, at the Teddy shapes (D=64, 375x450, maps
     93x112) and the 2K shapes (D=256, 1242x2208, maps 310x552);
  4. the main path: Teddy and Cones end to end through the kernels, %BP
     (nonocc) within 0.3 of the reference binary's 17.229 / 9.072, then a
     2K frame (max_dis=256) on a seeded textured pair whose right view is
     the left one shifted by a known disparity field; every kernel's launch
     count is set to 0 just before and read just after;
  5. times with CUDA events (3 warm-up, 20 timed launches) of each kernel
     and its plain version at both shapes, end-to-end frame times (host
     clock, synchronised), and a torch.profiler pass over 5 frames per
     shape for the device time by kernel and the device's idle share;
  6. one JSON line listing the kernels, then the final status JSON line.

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the package
beside this script; it exits non-zero without them. A longer report goes
to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

import primestereomatch_torch as psm
from primestereomatch_torch import kernels as K
from primestereomatch_torch.kernels import _build
from primestereomatch_torch.models.gif_pipeline import _to_u8, sampled_cost_volumes
from primestereomatch_torch.ops.guided_filter import guide_stats
from primestereomatch_torch.utils import bad_pixel_metrics, load_dataset

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN_NONOCC = {"Teddy": 17.229, "Cones": 9.072}   # reference binary, +-0.3
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
ITERS, WARMUP = 20, 3
H2K, W2K = 1242, 2208          # 2K frame of a ZED-class camera
TPU_KERNEL = {
    "lowmaps": "primestereomatch_tpu/kernels/lowmaps_pallas.py:137",
    "wta": "primestereomatch_tpu/kernels/wta_pallas.py:298",
    "wmf": "primestereomatch_tpu/kernels/wmf_pallas.py:69",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = ITERS) -> float:
    """Mean device ms per call over `iters` calls after a warm-up."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_lowmaps(p: torch.Tensor, k: int):
    B, D, h, w = p.shape
    n = B * D * h * w
    # read p and the 12 stat planes once, write 4 maps; per value: 3 guide
    # products, 8 separable k-boxes (2k-1 each), 27 for the solve
    return bound(4 * (n + B * 12 * h * w + 4 * n), n * (22 + 16 * k))


def bound_wta(guide: torch.Tensor, maps: torch.Tensor):
    B, H, W, _ = guide.shape
    D, h, w = maps.shape[2:]
    nbytes = 4 * maps.numel() + 4 * guide.numel() + B * H * W + 8 * (H + W)
    # per d >= 1, the separable lerp as the plain version computes it: each
    # of the 4 maps row-lerped once per (output row, low-res column), 3 ops;
    # then per output pixel 4 column lerps (3 each), 6 combine, 1 compare
    return bound(nbytes, B * (D - 1) * (12 * H * w + 19 * H * W))


def bound_wmf(disp: torch.Tensor, out: torch.Tensor, radius: int, n_bins: int):
    B, H, W = disp.shape

    def span(n):  # in-image window positions along one axis, summed
        i = np.arange(n)
        return int((np.minimum(i + radius, n - 1) - np.maximum(i - radius, 0) + 1).sum())

    pairs = B * span(H) * span(W)
    # per in-window pair: 3 sub, 3 mul, 2 add, 1 scale, 1 exp, 1 add; then
    # n_bins adds for the total and 2 ops per bin up to each pixel's median
    scan = B * H * W * n_bins + 2 * int(out.to(torch.int64).add(1).sum())
    return bound(5 * B * H * W, 11 * pairs + scan)


def synthetic_2k(seed: int = 0):
    """A textured 2208x1242 pair whose right view is the left one sampled at
    x + d(x, y): d = 96 in a central rectangle, 48 elsewhere. Returns the
    pair (float32 BGR in [0,1]) and the rectangle in right-view columns."""
    rng = np.random.default_rng(seed)
    H, W = H2K, W2K
    coarse = rng.random((H // 8 + 2, W // 8 + 2, 3)).astype(np.float32)
    yy = np.arange(H) / 8.0
    xx = np.arange(W) / 8.0
    y0, x0 = yy.astype(int), xx.astype(int)
    fy, fx = (yy - y0)[:, None, None], (xx - x0)[None, :, None]
    tex = (coarse[y0][:, x0] * (1 - fy) * (1 - fx) + coarse[y0 + 1][:, x0] * fy * (1 - fx)
           + coarse[y0][:, x0 + 1] * (1 - fy) * fx + coarse[y0 + 1][:, x0 + 1] * fy * fx)
    left = np.clip(0.7 * tex + 0.3 * rng.random((H, W, 3)), 0, 1).astype(np.float32)
    rect = (300, 900, 700, 1500)                       # rows y0:y1, right-view cols x0:x1
    d = np.full((H, W), 48, np.int64)
    d[rect[0]:rect[1], rect[2]:rect[3]] = 96
    src = np.arange(W)[None, :] + d
    right = np.where((src < W)[..., None],
                     left[np.arange(H)[:, None], np.minimum(src, W - 1)],
                     rng.random((H, W, 3)).astype(np.float32))
    return left, np.ascontiguousarray(right, dtype=np.float32), rect


def parity(name: str, cfg, left, right, dev, report):
    """Each kernel against its plain version on the same CUDA tensors, and
    the times of both (phases 3 and 5 for one shape)."""
    g2, p2 = sampled_cost_volumes(torch.as_tensor(left, device=dev),
                                  torch.as_tensor(right, device=dev), cfg)
    k = cfg.fgf_low_radius
    stats = guide_stats(g2, tuple(p2.shape[-2:]), k, cfg.gif_eps).contiguous()
    B, D, h, w = p2.shape
    H, W = g2.shape[1:3]
    row = {}

    maps_k = K.low_maps(p2, stats, k)
    maps_p = K.low_maps_plain(p2, stats, k)
    err = (maps_k - maps_p).abs()
    tol_ok = torch.allclose(maps_k, maps_p, atol=2e-4, rtol=1e-3)
    row["lowmaps"] = {"max_abs_err": float(err.max()), "n_differ": int((err > 0).sum()),
                      "n": maps_k.numel()}
    log(f"parity {name} lowmaps (B,D,h,w)={(B, D, h, w)} k={k}: max|diff|="
        f"{row['lowmaps']['max_abs_err']:.3e} differing={row['lowmaps']['n_differ']}"
        f"/{maps_k.numel()} (atol 2e-4, rtol 1e-3)")
    if not tol_ok:
        raise AssertionError(f"lowmaps disagrees with its plain version at {name}")

    d_chunk = 16 if D > 64 else None
    disp_k = K.upsample_wta(g2, maps_p)
    disp_p = K.upsample_wta_plain(g2, maps_p, d_chunk=d_chunk)
    diff = (disp_k.int() - disp_p.int()).abs()
    frac = float((diff > 0).float().mean())
    row["wta"] = {"max_abs_err": int(diff.max()), "mismatch": frac,
                  "n_differ": int((diff > 0).sum()), "n": diff.numel()}
    log(f"parity {name} upsample_wta (B,H,W,D)={(B, H, W, D)}: mismatch={frac:.3e} "
        f"({row['wta']['n_differ']} px) max|diff|={row['wta']['max_abs_err']} (bound 2e-3)")
    if frac > 2e-3 or int(disp_k.min()) < 1:
        raise AssertionError(f"upsample_wta disagrees with its plain version at {name}")

    g_u8 = _to_u8(g2).contiguous()
    med_k = K.weighted_median(disp_p, g_u8, cfg.wmf_radius, D, cfg.wmf_sigma)
    med_p = K.weighted_median_plain(disp_p, g_u8, cfg.wmf_radius, D, cfg.wmf_sigma)
    diff = (med_k.int() - med_p.int()).abs()
    frac = float((diff > 0).float().mean())
    row["wmf"] = {"max_abs_err": int(diff.max()), "mismatch": frac,
                  "n_differ": int((diff > 0).sum()), "n": diff.numel()}
    log(f"parity {name} weighted_median (B,H,W) r={cfg.wmf_radius} bins={D}: "
        f"mismatch={frac:.3e} ({row['wmf']['n_differ']} px) "
        f"max|diff|={row['wmf']['max_abs_err']} (bounds 1e-3, 1)")
    if frac > 1e-3 or int(diff.max()) > 1:
        raise AssertionError(f"weighted_median disagrees with its plain version at {name}")

    timing = {
        "lowmaps": (lambda: K.low_maps(p2, stats, k),
                    lambda: K.low_maps_plain(p2, stats, k), bound_lowmaps(p2, k)),
        "wta": (lambda: K.upsample_wta(g2, maps_p),
                lambda: K.upsample_wta_plain(g2, maps_p, d_chunk=d_chunk),
                bound_wta(g2, maps_p)),
        "wmf": (lambda: K.weighted_median(disp_p, g_u8, cfg.wmf_radius, D, cfg.wmf_sigma),
                lambda: K.weighted_median_plain(disp_p, g_u8, cfg.wmf_radius, D,
                                                cfg.wmf_sigma),
                bound_wmf(disp_p, med_p, cfg.wmf_radius, D)),
    }
    for kname, (fk, fp, (b_ms, b_by)) in timing.items():
        row[kname].update(ms=cuda_ms(fk), plain_ms=cuda_ms(fp), bound_ms=b_ms,
                          bound_by=b_by)
        r = row[kname]
        log(f"time {name} {kname}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({b_by}), {b_ms / r['ms']:.1%} of bound")
    report[name] = row


def frame_ms(l_t, r_t, cfg, dev, iters: int = ITERS) -> float:
    """Host-clock ms per end-to-end frame (device tensors in, synchronised)."""
    for _ in range(WARMUP):
        psm.stereo_gif_forward(l_t, r_t, cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        psm.stereo_gif_forward(l_t, r_t, cfg, device=dev)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_frames(l_t, r_t, cfg, dev, frames: int = 5) -> dict:
    """Device time per frame by kernel, from torch.profiler over `frames`
    end-to-end frames. Device rows are those with device time and no host
    time (kernels and copies); the idle share is 1 - device time / wall."""
    from torch.profiler import ProfilerActivity, profile

    psm.stereo_gif_forward(l_t, r_t, cfg, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            psm.stereo_gif_forward(l_t, r_t, cfg, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    rows = [e for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    per = {"lowmaps": 0.0, "wta": 0.0, "wmf": 0.0, "other": 0.0}
    tags = {"lowmaps_kernel": "lowmaps", "upsample_wta_kernel": "wta",
            "joint_wmf_kernel": "wmf"}
    launches = 0
    for e in rows:
        tag = next((t for key, t in tags.items() if key in e.key), "other")
        per[tag] += e.self_device_time_total / 1e3 / frames
        launches += e.count
    busy = sum(per.values())
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1 - busy / wall_ms,
            "device_ms_by_kernel": per, "device_ops_per_frame": launches / frames}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    secs = K.build()
    log(f"build: {secs:.1f} s for {len(_build.NAMES)} kernels (nvcc in parallel)")
    for n, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"ptxas {n}: {line.strip()}")

    cfg = psm.GIFConfig()
    cfg2k = psm.GIFConfig(max_dis=256)
    teddy = load_dataset("Teddy")
    left2k, right2k, rect = synthetic_2k(0)
    report: dict = {}
    parity("teddy", cfg, teddy.left_f32, teddy.right_f32, dev, report)
    parity("2k", cfg2k, left2k, right2k, dev, report)

    # ---- main path: counts at 0 just before, read just after --------------
    samples = {n: (teddy if n == "Teddy" else load_dataset(n)) for n in GOLDEN_NONOCC}
    frames = {n: (torch.as_tensor(s.left_f32, device=dev),
                  torch.as_tensor(s.right_f32, device=dev)) for n, s in samples.items()}
    frames["2k"] = (torch.as_tensor(left2k, device=dev), torch.as_tensor(right2k, device=dev))
    torch.cuda.synchronize()
    K.reset_launches()
    outs, per_frame = {}, {}
    for n, (l_t, r_t) in frames.items():
        before = dict(_build.LAUNCHES)
        outs[n] = psm.stereo_gif_forward(l_t, r_t, cfg2k if n == "2k" else cfg, device=dev)
        per_frame[n] = {k: _build.LAUNCHES[k] - before[k] for k in before}
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"main path launches: {launches}; per frame: {per_frame}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    bp = {}
    for n, s in samples.items():
        ld, rd = (t.cpu().numpy() for t in outs[n])
        res = bad_pixel_metrics(ld, s.gt, s.scale_factor, cfg.max_dis, mask=s.mask_nonocc)
        bp[n] = res.percent_bad_pixels
        log(f"{n}: %BP(nonocc) {bp[n]:.3f} (reference {GOLDEN_NONOCC[n]}, +-0.3)")
        if abs(bp[n] - GOLDEN_NONOCC[n]) > 0.3 or ld.shape != s.gt.shape:
            raise AssertionError(f"{n} %BP {bp[n]} outside the golden band")
        if int(rd.max()) >= cfg.max_dis or int(ld.min()) < 1:
            raise AssertionError(f"{n} disparities out of range")

    ld, rd = (t.cpu().numpy() for t in outs["2k"])
    y0, y1, x0, x1 = rect
    m = 40   # interior margin away from region edges and occlusions
    checks = {
        "left fg": (ld[y0 + m:y1 - m, x0 + 96 + m:x1 + 96 - m], 96),
        "left bg": (ld[y0 + m:y1 - m, 200:x0 + 48 - m], 48),
        "right fg": (rd[y0 + m:y1 - m, x0 + m:x1 - m], 96),
        "right bg": (rd[y1 + m:H2K - m, 200:W2K - 400], 48),
    }
    if ld.shape != (H2K, W2K) or ld.dtype != np.uint8 or min(ld.min(), rd.min()) < 1:
        raise AssertionError(f"2K output {ld.shape} {ld.dtype} min {ld.min()}")
    med2k = {}
    for key, (region, want) in checks.items():
        med2k[key] = float(np.median(region))
        if abs(med2k[key] - want) > 1:
            raise AssertionError(f"2K {key} median {med2k[key]} != {want}")
    log(f"2k (1242x2208, max_dis=256): interior medians {med2k} match the field")

    e2e = {}
    for n, c in (("teddy", cfg), ("2k", cfg2k)):
        l_t, r_t = frames["Teddy" if n == "teddy" else "2k"]
        ms = frame_ms(l_t, r_t, c, dev)
        e2e[n] = {"ms_per_frame": ms, "fps": 1e3 / ms, "profile": profile_frames(l_t, r_t, c, dev)}
        log(f"end to end {n}: {ms:.3f} ms/frame, {1e3 / ms:.2f} fps (both views + JointWMF)")
        prof = e2e[n]["profile"]
        by = ", ".join(f"{k} {v:.3f}" for k, v in prof["device_ms_by_kernel"].items())
        log(f"profile {n}: wall {prof['wall_ms']:.3f} ms/frame under the profiler, device "
            f"{prof['device_ms']:.3f} ms ({by}), idle share {prof['idle_share']:.1%}, "
            f"{prof['device_ops_per_frame']:.0f} device ops/frame")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    rows = []
    for kname, src in (("lowmaps", "lowmaps.cu"), ("wta", "wta.cu"), ("wmf", "wmf.cu")):
        t, k2 = report["teddy"][kname], report["2k"][kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"primestereomatch_torch/csrc/{src}",
            "replaces": TPU_KERNEL[kname], "launches": launches[kname],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "at": "teddy 375x450 D=64",
            "at_2k": {key: k2[key] for key in
                      ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
            "mismatch": {"teddy": t.get("mismatch", t["n_differ"] / t["n"]),
                         "2k": k2.get("mismatch", k2["n_differ"] / k2["n"])},
        })
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "kernels": rows, "parity": report, "bp_nonocc": bp,
        "per_frame_launches": per_frame, "e2e": e2e, "medians_2k": med2k,
        "build_logs": _build.BUILD_LOGS, "seconds": time.perf_counter() - t_start,
    }, indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
