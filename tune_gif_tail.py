#!/usr/bin/env python3
"""Time the kernels of the STEREO_GIF tails and their variants on one
NVIDIA card: K1 (csrc/lowmaps.cu), K2 (csrc/wta.cu), K4
(csrc/cvc_lowmaps.cu) and K10 (csrc/cvc_wta.cu); K1, K4 and K10 run the
same chain header (csrc/fgf_chain.cuh).

    python3 tune_gif_tail.py          # everything, ~1-2 min
    python3 tune_gif_tail.py k10      # K10's variants alone (K4 as shipped beside them)

Builds the four libraries as shipped, and lowmaps.cu / wta.cu /
cvc_lowmaps.cu once per variant of their -D knobs (K1: threads a block,
outputs a thread in the chain's horizontal passes, blocks an SM the
registers are bounded for, disparities a block walks, outputs a thread in
the vertical passes; K2: tile height, disparities per chunk, pixels
per thread and the columns they tap, raw windows in flight, blocks an SM
the registers are bounded for; K4: outputs per thread along the box axis,
samples staged or gathered per disparity, threads a block, outputs a
thread in the horizontal passes) and cvc_wta.cu
once per variant of its (threads a block, output columns a tile, blocks an
SM the registers are bounded for, the chain's outputs a thread), and times
K4 at several chunk lengths and K10 at other tile heights and chain counts
(run-time arguments). Every variant's output must equal the shipped
kernel's bit for bit, and the shipped kernels their plain versions at the
small shapes; prints CUDA-event times at chip_smoke.py's shapes (Teddy,
ZED-VGA, 2K, Teddy at subsample=1).
Needs one CUDA card and nvcc, like chip_smoke.py; writes nothing.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys

import torch

import chip_smoke as cs
from primestereomatch_torch import kernels as K
from primestereomatch_torch.kernels import _build
from primestereomatch_torch.kernels.cvc_lowmaps import cost_args, plan_chunks
from primestereomatch_torch.kernels.cvc_wta import launch as cvc_wta_launch
from primestereomatch_torch.kernels.wta import TILE_X
from primestereomatch_torch.ops.resize import linear_tables, low_window, nearest_table

# K2: (TY, DC, PX, NC, STAGES, blocks an SM the registers are bounded for);
# the shipped shape first
WTA_VARIANTS = [(16, 8, 1, 2, 1, 3), (16, 8, 1, 2, 2, 3), (16, 8, 1, 2, 1, 4), (16, 4, 1, 2, 1, 3),
                (16, 16, 1, 2, 1, 3), (32, 4, 1, 2, 1, 3), (32, 8, 1, 2, 1, 3), (32, 2, 1, 2, 1, 3),
                (16, 8, 4, 3, 1, 3), (32, 4, 4, 3, 1, 2), (16, 8, 2, 3, 1, 3),
                (16, 8, 2, 2, 1, 3), (16, 8, 2, 2, 1, 4)]
# K1: (threads a block, outputs a thread in the horizontal passes, blocks an
# SM the registers are bounded for, disparities a block walks, outputs a
# thread in the vertical passes), the same at every box size; the shipped
# shapes of k = 17 and of the smaller boxes first, then the unblocked chain
# in 256-thread blocks
K1_VARIANTS = [(256, 4, 2, 1, 4), (128, 4, 2, 1, 4), (256, 1, 1, 1, 4), (512, 4, 1, 1, 4),
               (256, 2, 2, 1, 4), (256, 4, 2, 1, 8), (256, 4, 2, 8, 4), (128, 1, 2, 1, 4)]
# K4: (RV, staged samples, threads a block, outputs a thread in the
# horizontal passes); the shipped shape first
K4_VARIANTS = [(4, 1, 512, 1), (4, 0, 512, 1), (1, 1, 512, 1), (2, 1, 512, 1), (8, 1, 512, 1),
               (4, 1, 256, 1), (4, 1, 384, 1), (4, 1, 1024, 1), (4, 1, 512, 4)]
K4_CHUNKS = (1, 4, 8, 16, 32)
# K10: (threads a block, output columns a tile, blocks an SM the registers
# are bounded for, the chain's outputs a thread along the box axis, output
# rows a tile, chains at once); the shipped shape first (its rows and
# groups are what kernels/cvc_wta.py::plan_tile picks at 2K and ZED-VGA)
K10_VARIANTS = [(512, 128, 1, 4, 64, 2), (512, 128, 1, 4, 64, 1), (256, 64, 2, 4, 64, 1),
                (512, 128, 1, 4, 32, 2)]


# the variants are many: 10 timed launches after 2 warm-up ones
cuda_ms = functools.partial(cs.cuda_ms, iters=10, warmup=2)


def build_wta(variants):
    return _build.build_variants("wta", {v: [
        f"-DPSM_WTA_TY={v[0]}", f"-DPSM_WTA_DC={v[1]}", f"-DPSM_WTA_PX={v[2]}",
        f"-DPSM_WTA_NC={v[3]}", f"-DPSM_WTA_STAGES={v[4]}", f"-DPSM_WTA_MINB={v[5]}"]
        for v in variants})


def build_k1(variants):
    return _build.build_variants("lowmaps", {v: [
        f"-DPSM_K1_NT={v[0]}", f"-DPSM_K1_RH={v[1]}", f"-DPSM_K1_MINB={v[2]}",
        f"-DPSM_K1_NT_S={v[0]}", f"-DPSM_K1_RH_S={v[1]}", f"-DPSM_K1_MINB_S={v[2]}",
        f"-DPSM_K1_DCH={v[3]}", f"-DPSM_FGF_RV={v[4]}"] for v in variants})


def build_k4(variants):
    return _build.build_variants("cvc_lowmaps", {
        v: [f"-DPSM_FGF_RV={v[0]}", f"-DPSM_K4_STAGE={v[1]}", f"-DPSM_K4_NT={v[2]}",
            f"-DPSM_K4_RH={v[3]}"] for v in variants})


def build_k10(variants):
    return _build.build_variants("cvc_wta", {
        v[:4]: [f"-DPSM_K10_NT={v[0]}", f"-DPSM_K10_OTX={v[1]}", f"-DPSM_K10_MINB={v[2]}",
                f"-DPSM_FGF_RV={v[3]}"] for v in variants})


def run_wta(fn, var, guide, maps):
    """K2's staged kernel of variant `var` (its C entry `fn`)."""
    B, H, W, _ = guide.shape
    D, h, w = maps.shape[2:]
    dev = guide.device
    yi, _, yf = linear_tables(h, H, dev, torch.int32)
    xi, _, xf = linear_tables(w, W, dev, torch.int32)
    out = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    lth, ltw = low_window(h, H, var[0]), low_window(w, W, TILE_X)
    _build.check("wta", fn(maps.data_ptr(), guide.data_ptr(), yi.data_ptr(), yf.data_ptr(),
                           xi.data_ptr(), xf.data_ptr(), out.data_ptr(), B, D, h, w, H, W, lth,
                           ltw, torch.cuda.current_stream().cuda_stream))
    return out


def run_k4(fn, views, grds, stats, D, k, chunk, cost):
    """K4 through the C entry `fn` with `chunk` disparities a block."""
    B2, H, W, _ = views.shape
    h, w = stats.shape[-2:]
    dev = views.device
    out = torch.empty((B2, 4, D, h, w), dtype=torch.float32, device=dev)
    _build.check("cvc_lowmaps", fn(
        views.data_ptr(), grds.data_ptr(), stats.data_ptr(),
        nearest_table(H, h, dev, torch.int32).data_ptr(),
        nearest_table(W, w, dev, torch.int32).data_ptr(), out.data_ptr(), B2 // 2, D, H, W, h,
        w, k, ctypes.c_float(1.0 / (k * k)), chunk,
        *cost_args(cost["alpha"], cost["border_cost"], cost["tau1"], cost["tau2"]),
        torch.cuda.current_stream().cuda_stream))
    return out


def run_k1(fn, p, stats, k):
    """K1 through the C entry `fn`."""
    B, D, h, w = p.shape
    out = torch.empty((B, 4, D, h, w), dtype=torch.float32, device=p.device)
    _build.check("lowmaps", fn(p.data_ptr(), stats.data_ptr(), out.data_ptr(), B, D, h, w, k,
                               ctypes.c_float(1.0 / (k * k)),
                               torch.cuda.current_stream().cuda_stream))
    return out


def k1_variant_ms(p, stats, k, variants=K1_VARIANTS) -> dict:
    """{variant: ms} of K1 at box k, each held bitwise against the shipped
    kernel."""
    want = K.low_maps(p, stats, k)
    out = {}
    for var, fn in build_k1(variants).items():
        if not torch.equal(run_k1(fn, p, stats, k), want):
            raise AssertionError(f"K1 variant {var} differs from the shipped kernel")
        out[var] = cuda_ms(lambda: run_k1(fn, p, stats, k))
    return out


def wta_variant_ms(guide, maps, variants) -> dict:
    """{variant: ms} of K2's staged kernel on (guide, maps), each held
    bitwise against the shipped kernel; None where a run of PX pixels taps
    more than NC columns at this ratio."""
    want = K.upsample_wta(guide, maps)
    out = {}
    for var, fn in build_wta(variants).items():
        if var[2] > 1 and low_window(maps.shape[-1], guide.shape[2], var[2]) > var[3]:
            out[var] = None
            continue
        if not torch.equal(run_wta(fn, var, guide, maps), want):
            raise AssertionError(f"K2 variant {var} differs from the shipped kernel")
        out[var] = cuda_ms(lambda: run_wta(fn, var, guide, maps))
    return out


def k4_variant_ms(views, grds, stats, D, k, cost, variants, chunks=()) -> dict:
    """{(variant, chunk): ms} of K4, each held bitwise against the shipped
    kernel: every variant at the planned chunk, the first also at `chunks`."""
    want = K.cvc_low_maps(views, grds, stats, D, k, **cost)
    sm_count = torch.cuda.get_device_properties(views.device).multi_processor_count
    planned, _ = plan_chunks(views.shape[0], D, *stats.shape[-2:], k, sm_count)
    out = {}
    for i, (var, fn) in enumerate(build_k4(variants).items()):
        for ch in dict.fromkeys((planned, *chunks) if i == 0 else (planned,)):
            got = run_k4(fn, views, grds, stats, D, k, ch, cost)
            if not torch.equal(got, want):
                raise AssertionError(f"K4 variant {var} at chunk {ch} differs from the shipped "
                                     f"kernel")
            del got
            out[(var, ch)] = cuda_ms(lambda: run_k4(fn, views, grds, stats, D, k, ch, cost))
    return out


def k10_variant_ms(views, grds, stats, D, k, cost, variants=K10_VARIANTS) -> dict:
    """{variant: ms} of K10, each held bitwise against the shipped kernel."""
    want = K.cvc_wta(views, grds, stats, D, k, **cost)
    fns = build_k10(variants)
    out = {}
    for var in variants:
        fn, otx, rows, groups = fns[var[:4]], var[1], var[4], var[5]

        def run():
            return cvc_wta_launch(fn, views, grds, stats, D, k, rows, groups, **cost,
                                  tile_x=otx)

        if not torch.equal(run(), want):
            raise AssertionError(f"K10 variant {var} differs from the shipped kernel")
        out[var] = cuda_ms(run, iters=5, warmup=1)
    return out


def main(argv) -> int:
    only_k10 = argv == ["k10"]       # K10's variants alone, at ZED-VGA and 2K
    if not torch.cuda.is_available():
        print("tune_gif_tail: needs a CUDA card", file=sys.stderr)
        return 1
    import primestereomatch_torch as psm
    from primestereomatch_torch.models.gif_pipeline import stacked_views
    from primestereomatch_torch.ops.cost_volume import sampled_cost_volumes
    from primestereomatch_torch.ops.guided_filter import guide_stats

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    names = ("lowmaps", "wta", "cvc_lowmaps", "cvc_wta")
    print(f"build of {names}: {K.build(names):.1f} s", flush=True)
    if not only_k10:            # the variants' libraries and their logs, ahead of the timings
        build_k1(K1_VARIANTS)
        build_wta(WTA_VARIANTS)
        build_k4(K4_VARIANTS)
    build_k10(K10_VARIANTS)
    for key, log in _build.BUILD_LOGS.items():
        print(f"ptxas {key}: at most {cs.resources(log)}", flush=True)
        if key.startswith("cvc_wta"):     # per box size: its template instance's line
            print("\n".join(f"  {line.strip()}" for line in log.splitlines()
                            if "registers" in line or "spill" in line), flush=True)

    def inputs(cfg, left, right):
        views, grds = stacked_views(torch.as_tensor(left, device=dev)[None],
                                    torch.as_tensor(right, device=dev)[None], cfg)
        H, W = views.shape[1:3]
        stats = guide_stats(views, (H // cfg.subsample, W // cfg.subsample),
                            cfg.fgf_low_radius, cfg.gif_eps).contiguous()
        cost = dict(alpha=cfg.alpha, border_cost=cfg.border_cost, tau1=cfg.tau1, tau2=cfg.tau2)
        return views, grds, stats, cost

    teddy = cs.load_dataset("Teddy")
    left2k, right2k, _ = cs.synthetic_2k(0)
    left_vga, right_vga = cs.synthetic_pair(cs.HVGA, cs.WVGA, 1, (90, 270, 210, 450), 24, 12)
    cfg, cfg2k, cfg_s1 = psm.GIFConfig(), psm.GIFConfig(max_dis=256), psm.GIFConfig(subsample=1)

    # K1 and K2 at Teddy, 2K and Teddy at subsample=1 (a 17 x 17 box, ratio 1)
    for name, c, left, right in (("teddy", cfg, teddy.left_f32, teddy.right_f32),
                                 ("2k", cfg2k, left2k, right2k),
                                 ("teddy_s1", cfg_s1, teddy.left_f32, teddy.right_f32)
                                 )[:0 if only_k10 else 3]:
        views, grds, stats, cost = inputs(c, left, right)
        k = c.fgf_low_radius
        p = sampled_cost_volumes(views, grds, c.max_dis, tuple(stats.shape[-2:]), **cost)
        maps = K.low_maps(p, stats, k)
        if name != "2k" and not torch.equal(maps, K.low_maps_plain(p, stats, k)):
            raise AssertionError(f"K1 differs from its plain version at {name}")
        print(f"{name}: K1 k={k} {tuple(p.shape)}: "
              f"{cuda_ms(lambda: K.low_maps(p, stats, k)):.4f} ms", flush=True)
        if name != "2k":
            for var, ms in k1_variant_ms(p, stats, k).items():
                print(f"  K1 (threads, RH, blocks, d a block, RV) = {var}: {ms:.4f} ms, "
                      f"0 values differ", flush=True)
        del p
        if name != "2k" and not torch.equal(K.upsample_wta(views, maps),
                                            K.upsample_wta_plain(views, maps)):
            raise AssertionError(f"K2 differs from its plain version at {name}")
        print(f"{name}: K2 as shipped: "
              f"{cuda_ms(lambda: K.upsample_wta(views, maps)):.4f} ms", flush=True)
        if name != "teddy_s1":   # ratio 1 takes the per-pixel kernel, which has no knobs
            for var, ms in wta_variant_ms(views, maps, WTA_VARIANTS).items():
                print(f"  K2 (TY, DC, PX, NC, STAGES, blocks) = {var}: "
                      + (f"{ms:.4f} ms, 0 px differ" if ms is not None else "does not apply"),
                      flush=True)
        del maps
        torch.cuda.empty_cache()

    # K4 and K10 at ZED-VGA and 2K
    for name, c, left, right in (("vga", cfg, left_vga, right_vga), ("2k", cfg2k, left2k, right2k)):
        views, grds, stats, cost = inputs(c, left, right)
        k, D = c.fgf_low_radius, c.max_dis
        maps = K.cvc_low_maps(views, grds, stats, D, k, **cost)
        if name == "vga" and not torch.equal(
                maps, K.cvc_low_maps_plain(views, grds, stats, D, k, **cost)):
            raise AssertionError("K4 differs from its plain version at ZED-VGA")
        print(f"{name}: K4 as shipped: "
              f"{cuda_ms(lambda: K.cvc_low_maps(views, grds, stats, D, k, **cost)):.4f} ms",
              flush=True)
        for (var, ch), ms in k4_variant_ms(views, grds, stats, D, k, cost,
                                           K4_VARIANTS[:1 if only_k10 else None],
                                           () if only_k10 else K4_CHUNKS).items():
            print(f"  K4 (RV, staged, threads, RH) = {var}, chunk {ch}: {ms:.4f} ms, 0 values "
                  f"differ", flush=True)
        two = K.upsample_wta(views, maps)
        del maps
        if not torch.equal(K.cvc_wta(views, grds, stats, D, k, **cost), two):
            raise AssertionError(f"K10 differs from K4 -> K2 at {name}")
        ms = cuda_ms(lambda: K.cvc_wta(views, grds, stats, D, k, **cost), iters=5, warmup=1)
        print(f"{name}: K10 as shipped: {ms:.4f} ms, 0 px from K4 -> K2", flush=True)
        for var, ms in k10_variant_ms(views, grds, stats, D, k, cost).items():
            print(f"  K10 (threads, columns, blocks, RV, rows, chains) = {var}: {ms:.4f} ms, "
                  f"0 px differ",
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
