#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (STEREO_GIF and STEREO_SGBM) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failed check raises and exits non-zero):

  1. the card's name and power limit, as nvidia-smi prints them;
  2. build the nine CUDA sources from csrc/ (one nvcc per source, in
     parallel) and print the build seconds and ptxas resource lines;
  3. parity on the card, each kernel against its plain PyTorch version on
     the same CUDA tensors: GIF K1-K3 at the Teddy shapes (D=64, 375x450,
     maps 93x112) and the 2K shapes (D=256, 1242x2208, maps 310x552); K1 and
     K2 also at subsample=1 on Teddy (a 17x17 box, maps at full resolution,
     upsampling ratio 1: the TPU's generic-ratio kernel K5), K2 also at
     D=3 on the Teddy shape (a chunk of 8 disparities that is not filled;
     0 pixels required); K4 (cost + low-maps, bitwise expected; at 2K also
     at D=100, which its 16 disparities a block do not divide, 0 values
     required) and K10 (cost + chain + WTA, also against
     K4 -> K2 on the card, 0 differing pixels required) at a seeded ZED-VGA
     pair (376x672, D=64) and the 2K pair; K3 at 2K on two inputs, the WTA
     output and uniformly random disparities over all 256 bins (the most
     bin-window passes), 0 differing pixels required at every K3 shape;
     SGBM (K6-K9, bitwise) at Teddy D=64 and the 2K pair rounded to uint8,
     D=256: K7's uint16 group partials summed on the card against the
     plain int32 S, its int32 path (a P2 beyond the uint16 bound) against
     the plain S at that P2, K8 from the partials and from the int32 S
     against the plain selection, K9's sweep (hook, rows, columns) twice
     and its row and column scans alone against their plain versions, and
     its changed flag against the labels;
  4. the main paths, each with every launch count set to 0 just before it
     and read just after, and its kernels (and no others) asserted. GIF:
     Teddy and Cones end to end (K1, K2, K3), %BP(nonocc) within 0.3 of the
     reference binary's 17.229 / 9.072; a 2K frame (max_dis=256) on a
     seeded textured pair whose right view is the left one shifted by a
     known disparity field (K4, K2, K3); the same frame with
     tail_fusion='full' (K10, K3), which must recover the field and agree
     with the maps path within 2e-3; Teddy at subsample=1 (K1, K2, K3); and
     a batch of four Teddy-size frames through stereo_gif_forward_batch,
     each equal to its single-frame output. SGBM (SGBMConfig()): Teddy and
     Cones, whose int16 outputs must hash to the JAX package's (sha256) and
     meet the cv2-golden bounds of tests/test_sgbm_cv2_golden.py, then the
     2K pair with num_disparities=256, whose interior medians must be the
     field's 96 and 48 within 1; every SGBM frame launches K6 once, K7
     twice (the partials route), K8 once and K9 four times a host sync
     (two launches a sweep, two sweeps a read of its changed flag);
  5. times with CUDA events (3 warm-up, 20 timed launches; 1 and 2 for
     the slow SGBM plain versions at 2K, 1 and 3 for the fused tails' plain
     versions at 2K; K3's plain version on the random 2K input runs once)
     of each kernel and its plain version, K1's, K2's, K4's and K10's launch
     shapes (tile, chunk, shared memory, ptxas registers) and their times
     in a few shapes that were tried and rejected (tune_gif_tail.py builds
     and times them; K1's at Teddy and at subsample=1), K6's and K9's launch
     shapes and their times in the shapes tried (tune_bt_cost.py,
     tune_speckle.py), the speckle hook as the plain-torch ops it was
     before K9 took it in, K3's bin-window passes per block,
     K7's bytes per (pixel, d) by its own count, the rate that follows,
     its time at four ring sizes and on 8 image rows alone, end-to-end frame
     times (host clock, synchronised; 10 frames for the 2K GIF paths), a
     torch.profiler pass over 5 frames per shape and path for the device
     time by kernel and the device's idle share, the speckle sweeps and
     host syncs (reads of K9's changed flag) per SGBM frame, and peak device
     memory (one 2K frame on the maps path and on the full path side by
     side);
  6. gif_variants, each path driven as in 4: the uint8 cost
     (cvc_dtype='u8'), the PP toolchain (pp_toolchain=True) and table-mode
     JointWMF (feature indexes from utils/features.py, seed 0, clustered
     in four host processes meanwhile) at Teddy and Cones, %BP(nonocc)
     within 0.3 of the JAX package's (VARIANT_BP); the uint8 sampled cost
     of Teddy, whose sha256 must equal the JAX one's (U8_SHA256); uint8 at
     2K on both tails, which must launch K1, K2 and K3 and neither K4 nor
     K10 and recover the field; lr_check and fill_invalid on the card
     bitwise the CPU and the bilateral and table medians within the tie
     budget (99.9% of pixels), on the card's own Teddy WTA output; DispEst
     at Teddy against the reference binary's dumps (tests/golden/
     ref_teddy.npz: gradients 5e-7, CVC 1e-6, CVF 1e-3, WTA mismatch 5e-4)
     and its dump_cost_volume read back; ms per variant frame, the
     post-processing stages' device ms, DispEst's ms per stage and peak
     memory;
  7. one JSON line listing the kernels, then the final status JSON line.

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the package
beside this script; it exits non-zero without them. A longer report goes
to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import multiprocessing
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

import primestereomatch_torch as psm
import tune_bt_cost
import tune_gif_tail as tune
import tune_speckle
from primestereomatch_torch import kernels as K
from primestereomatch_torch.kernels import _build, cvc_lowmaps, sgbm_scan
from primestereomatch_torch.kernels.bt_cost import launch_shape as bt_launch_shape
from primestereomatch_torch.kernels.cvc_wta import THREADS as K10_THREADS
from primestereomatch_torch.kernels.cvc_wta import TILE_X as K10_TILE_X
from primestereomatch_torch.kernels.cvc_wta import plan_tile as k10_plan_tile
from primestereomatch_torch.kernels.cvc_wta import smem_bytes as k10_smem_bytes
from primestereomatch_torch.kernels.lowmaps import RUN as K1_RUN
from primestereomatch_torch.kernels.lowmaps import TILE as K1_TILE
from primestereomatch_torch.kernels.lowmaps import block_shape as k1_block_shape
from primestereomatch_torch.kernels.lowmaps import chain_smem_bytes
from primestereomatch_torch.kernels.speckle import launch_shape as speckle_launch_shape
from primestereomatch_torch.kernels import wta as wta_mod
from primestereomatch_torch.models.gif_pipeline import (
    _to_u8,
    sampled_u8_costs,
    stacked_views,
    view_gradients,
)
from primestereomatch_torch.ops import postproc
from primestereomatch_torch.ops import sgbm as sgbm_ops
from primestereomatch_torch.ops.cost_volume import sampled_cost_volumes
from primestereomatch_torch.ops.guided_filter import guide_stats
from primestereomatch_torch.ops.jointwmf import joint_wmf
from primestereomatch_torch.utils import bad_pixel_metrics, load_dataset
from primestereomatch_torch.utils.png import read_png

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN_NONOCC = {"Teddy": 17.229, "Cones": 9.072}   # reference binary, +-0.3
# sha256 of the JAX package's int16 STEREO_SGBM output with SGBMConfig()
# (tests/test_torch_sgbm.py recomputes them from JAX on the CPU)
SGBM_SHA256 = {
    "Teddy": "a88bc838da2045ca8893b45a05d6466288a2843a974dfa835605055c23dcba16",
    "Cones": "ee9e4a8e15462ebc92336ade40a98bf137333dd5b242df8366adbb5016f78a53",
}
# the STEREO_GIF variants of the gif_variants phase and the JAX package's
# %BP(nonocc) of each (left view, max_dis 64; table mode with the indexes of
# utils/features.py::feature_index_color, seed 0); the port's must fall
# within 0.3 (tests/test_torch_variants.py recomputes them from JAX)
VARIANT_CONFIGS = {
    "u8": dict(cvc_dtype="u8"),
    "toolchain": dict(pp_toolchain=True),
    "table": dict(wmf_mode="table"),
}
VARIANT_BP = {
    "Teddy": {"u8": 16.967703703703705, "toolchain": 11.615407407407407,
              "table": 17.299555555555557},
    "Cones": {"u8": 8.973037037037036, "toolchain": 7.351111111111111,
              "table": 9.049481481481482},
}
# sha256 of the JAX package's Teddy uint8 cost volumes nearest-downsampled
# to the FGF grid (93 x 112, D = 64), left then right
U8_SHA256 = "1933050fdb707da0e3fa6264331699c07c27c35d8c120c3a40b1f5ae6231a150"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
# H100 SXM int32 ALU peak: 64 INT32 lanes per SM (Hopper white paper) x 132
# SMs x the 1.98 GHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
ITERS, WARMUP = 20, 3
H2K, W2K = 1242, 2208          # 2K frame of a ZED-class camera
HVGA, WVGA = 376, 672          # its VGA mode
TPU_KERNEL = {
    "lowmaps": "primestereomatch_tpu/kernels/lowmaps_pallas.py:137",
    # one CUDA kernel for the TPU's polyphase kernel and its generic-ratio one
    "wta": "primestereomatch_tpu/kernels/wta_pallas.py:298 and :80",
    "cvc_lowmaps": "primestereomatch_tpu/kernels/cvc_lowmaps_pallas.py:64",
    "cvc_wta": "primestereomatch_tpu/kernels/cvc_wta_pallas.py:117 and :251",
    "wmf": "primestereomatch_tpu/kernels/wmf_pallas.py:69",
    "bt_cost": "primestereomatch_tpu/kernels/sgbm_pallas.py:383",
    "sgbm_scan": "primestereomatch_tpu/kernels/sgbm_pallas.py:83",
    "select": "primestereomatch_tpu/kernels/select_pallas.py:280",
    "speckle": "primestereomatch_tpu/kernels/speckle_pallas.py:51",
}
# profiler rows of the GIF kernels; the longer kernel names first:
# "lowmaps_kernel" is part of "cvc_lowmaps_kernel"
GIF_TAGS = {"cvc_lowmaps_kernel": "cvc_lowmaps", "cvc_wta_kernel": "cvc_wta",
            "lowmaps_kernel": "lowmaps", "upsample_wta_kernel": "wta",
            "upsample_wta_staged_kernel": "wta",
            "joint_wmf_kernel": "wmf", "wmf_weights_kernel": "wmf"}
PROBE_D = (1, 8, 32, 63)   # the disparities of the reference's stage dumps
GIF_KERNELS = ("lowmaps", "wta", "wmf", "cvc_lowmaps", "cvc_wta")
SGBM_KERNELS = ("bt_cost", "sgbm_scan", "select", "speckle")
# cv2-golden bounds (tests/test_sgbm_cv2_golden.py:58-104): within-1d on
# jointly valid x >= 64 at least, interior validity mismatch at most
CV2_BOUNDS = {"Teddy": (0.985, 0.045), "Cones": (0.990, 0.040)}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Mean device ms per call over `iters` calls after a warm-up."""
    for _ in range(warmup):
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


def timed_once(fn):
    """`fn()` and the device ms of that one call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def profiled_ms(fn, kernel: str = "", iters: int = ITERS) -> float:
    """Device ms per call of `fn` in the kernels whose names hold `kernel`
    (all of them by default), from torch.profiler: the kernels' own time,
    without the host's gaps between launches that back-to-back CUDA events
    see at small shapes. Device rows are those with no host time, as in
    `profile_frames`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if kernel in e.key and e.self_cpu_time_total == 0) / 1e3 / iters


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _chain_ops(n: int, k: int) -> int:
    # per cost value: 3 guide products, 8 separable k-boxes (2k-1 each), 27
    # for the solve
    return n * (22 + 16 * k)


def _wta_ops(B: int, D: int, H: int, W: int, w: int) -> int:
    # per d >= 1, the separable lerp as the plain version computes it: each
    # of the 4 maps row-lerped once per (output row, low-res column), 3 ops;
    # then per output pixel 4 column lerps (3 each), 6 combine, 1 compare
    return B * (D - 1) * (12 * H * w + 19 * H * W)


def bound_lowmaps(p: torch.Tensor, k: int):
    B, D, h, w = p.shape
    n = B * D * h * w
    # read p and the 12 stat planes once, write 4 maps
    return bound(4 * (n + B * 12 * h * w + 4 * n), _chain_ops(n, k))


def bound_wta(guide: torch.Tensor, maps: torch.Tensor):
    B, H, W, _ = guide.shape
    D, h, w = maps.shape[2:]
    nbytes = 4 * maps.numel() + 4 * guide.numel() + B * H * W + 8 * (H + W)
    return bound(nbytes, _wta_ops(B, D, H, W, w))


def bound_cvc_lowmaps(views: torch.Tensor, grds: torch.Tensor, stats: torch.Tensor, D: int,
                      k: int):
    B2, _, h, w = stats.shape
    n = B2 * D * h * w
    # read the views, gradients and stat planes once, write 4 maps; per cost
    # value ~12 ops for the cost (4 sub, 4 abs, 2 add, 2 clamps or the blend)
    # and the chain's
    return bound(4 * (views.numel() + grds.numel() + stats.numel() + 4 * n),
                 12 * n + _chain_ops(n, k))


def bound_cvc_wta(views: torch.Tensor, grds: torch.Tensor, stats: torch.Tensor, D: int,
                  k: int):
    B2, H, W, _ = views.shape
    h, w = stats.shape[-2:]
    n = B2 * D * h * w
    # read the views, gradients and stat planes once, write uint8 disparities;
    # the operations of K4's function and of K2's
    return bound(4 * (views.numel() + grds.numel() + stats.numel()) + B2 * H * W + 8 * (H + W),
                 12 * n + _chain_ops(n, k) + _wta_ops(B2, D, H, W, w))


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


def bound_bt_cost(lf: torch.Tensor, cost: torch.Tensor):
    H, W, C = lf.shape
    n = cost.numel()
    # read both feature images once, write the cost once; per (y, x, d):
    # 10 integer ops per channel for the BT cost, 4 for the running sums
    return bound(2 * 4 * lf.numel() + cost.element_size() * n, n * (10 * C + 4),
                 INT32_OPS_PER_S)


def bound_scan(cost: torch.Tensor, n_dirs: int):
    n = cost.numel()
    # read C once, write the int32 S once; ~8 ops per (direction, pixel, d)
    return bound(n * (cost.element_size() + 4), 8 * n_dirs * n, INT32_OPS_PER_S)


def bound_select(shape):
    H, W, D = shape
    # read the aggregated cost once (4 bytes per value: the int32 S, or two
    # uint16 partials), write int16 disparities; per value 2 ops for the
    # argmin and 3 for the far-set min
    return bound(4 * H * W * D + 2 * H * W, 5 * H * W * D, INT32_OPS_PER_S)


def bound_sweep(m: torch.Tensor):
    # one sweep (hook, row scan, column scan): the labels (the hook's
    # neighbour reads are reads of the same labels) and the uint8 link mask
    # read once, the labels written once, the 4-byte flag; per pixel 8 ops
    # for the hook (4 link tests, 4 mins), 5 a scan axis (a forward and a
    # backward segmented step of 2, the final min) and 1 for the flag
    return bound(9 * m.numel() + 4, 19 * m.numel(), INT32_OPS_PER_S)


def hook_as_torch_ops(labels: torch.Tensor, conns) -> torch.Tensor:
    """The hook step as the speckle filter ran it before K9 took it in: 13
    plain-torch ops on the four bool link planes (up, down, left, right),
    timed for the K9 row's time before."""
    big = labels.numel()
    m = labels
    for c, dim, off in zip(conns, (0, 0, 1, 1), (-1, 1, -1, 1)):
        m = torch.minimum(m, torch.where(c, sgbm_ops._shifted(labels, dim, off, big), big))
    return m


def speckle_inputs(cfg, l_t: torch.Tensor, r_t: torch.Tensor):
    """The speckle filter's start on the SGBM disparities of a uint8 pair on
    the card: labels, the packed link mask and the four bool link planes."""
    lf = sgbm_ops.sobel_xclip(l_t, cfg.pre_filter_cap)
    rf = sgbm_ops.sobel_xclip(r_t, cfg.pre_filter_cap)
    D, k = cfg.num_disparities, cfg.block_size
    cost_bound = k * k * lf.shape[2] * 2 * cfg.pre_filter_cap
    parts = K.sgbm_aggregate_partials(K.bt_cost(lf, rf, D, k, cost_bound), cfg.p1, cfg.p2,
                                      cfg.num_directions, cost_bound)
    disp = K.select_disparity_partials(parts, cfg.uniqueness_ratio, cfg.disp12_max_diff,
                                       cfg.min_disparity)
    _, labels, conns = sgbm_ops.speckle_graph(disp, 16 * cfg.speckle_range,
                                              (cfg.min_disparity - 1) * 16)
    return labels, K.pack_links(*conns), conns


def synthetic_pair(H: int, W: int, seed: int, rect, d_fg: int, d_bg: int):
    """A textured HxW pair whose right view is the left one sampled at
    x + d(x, y): d = d_fg in `rect` (rows y0:y1, right-view columns x0:x1),
    d_bg elsewhere. Returns the pair, float32 BGR in [0,1]."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((H // 8 + 2, W // 8 + 2, 3)).astype(np.float32)
    yy = np.arange(H) / 8.0
    xx = np.arange(W) / 8.0
    y0, x0 = yy.astype(int), xx.astype(int)
    fy, fx = (yy - y0)[:, None, None], (xx - x0)[None, :, None]
    tex = (coarse[y0][:, x0] * (1 - fy) * (1 - fx) + coarse[y0 + 1][:, x0] * fy * (1 - fx)
           + coarse[y0][:, x0 + 1] * (1 - fy) * fx + coarse[y0 + 1][:, x0 + 1] * fy * fx)
    left = np.clip(0.7 * tex + 0.3 * rng.random((H, W, 3)), 0, 1).astype(np.float32)
    d = np.full((H, W), d_bg, np.int64)
    d[rect[0]:rect[1], rect[2]:rect[3]] = d_fg
    src = np.arange(W)[None, :] + d
    right = np.where((src < W)[..., None],
                     left[np.arange(H)[:, None], np.minimum(src, W - 1)],
                     rng.random((H, W, 3)).astype(np.float32))
    return left, np.ascontiguousarray(right, dtype=np.float32)


def synthetic_2k(seed: int = 0):
    """The 2208x1242 pair: d = 96 in a central rectangle, 48 elsewhere.
    Returns the pair and the rectangle."""
    rect = (300, 900, 700, 1500)
    return (*synthetic_pair(H2K, W2K, seed, rect, 96, 48), rect)


def time_rows(name: str, row: dict, timing: dict, plain_iters=(ITERS, WARMUP)) -> None:
    """CUDA-event times of each kernel and its plain version, and its bound."""
    for kname, (fk, fp, (b_ms, b_by)) in timing.items():
        row[kname].update(ms=cuda_ms(fk), plain_ms=cuda_ms(fp, *plain_iters), bound_ms=b_ms,
                          bound_by=b_by)
        r = row[kname]
        log(f"time {name} {kname}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({b_by}), {b_ms / r['ms']:.1%} of bound")


def parity(name: str, cfg, left, right, dev, report, with_wmf: bool = True):
    """K1-K3 against their plain versions on the same CUDA tensors, and
    the times of both (phases 3 and 5 for one shape). `with_wmf=False`
    stops after K1 and K2 (the subsample=1 shape, where K3's inputs are
    the Teddy shape's)."""
    g2, grds = stacked_views(torch.as_tensor(left, device=dev)[None],
                             torch.as_tensor(right, device=dev)[None], cfg)
    H, W = g2.shape[1:3]
    k, s = cfg.fgf_low_radius, cfg.subsample
    p2 = sampled_cost_volumes(g2, grds, cfg.max_dis, (H // s, W // s), alpha=cfg.alpha,
                              border_cost=cfg.border_cost, tau1=cfg.tau1, tau2=cfg.tau2)
    del grds
    stats = guide_stats(g2, tuple(p2.shape[-2:]), k, cfg.gif_eps).contiguous()
    B, D, h, w = p2.shape
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
    nt, rh, minb = k1_block_shape(k)
    row["lowmaps"]["design"] = {
        "tile": [K1_TILE] * 2, "threads": nt, "horizontal_run": rh, "blocks_per_sm": minb,
        "smem_bytes": chain_smem_bytes(K1_TILE, K1_TILE, k, rh),
        **tune.resources(_build.BUILD_LOGS["lowmaps"])}
    if name != "2k":
        # block shapes tried (tune_gif_tail.py; each bitwise the shipped kernel)
        row["lowmaps"]["design"]["tried_ms"] = {
            f"{a} threads, RH {b}, {c} blocks an SM, {d} d a block, RV {e}": ms
            for (a, b, c, d, e), ms in tune.k1_variant_ms(
                p2, stats, k, [v for v in tune.K1_VARIANTS if v != (nt, rh, minb, 1, K1_RUN)]
            ).items()}
    log(f"design {name} lowmaps: {row['lowmaps']['design']}")

    d_chunk = 16 if D > 64 else None
    disp_k = K.upsample_wta(g2, maps_p)
    disp_p = K.upsample_wta_plain(g2, maps_p, d_chunk=d_chunk)
    diff = (disp_k.int() - disp_p.int()).abs()
    frac = float((diff > 0).float().mean())
    row["wta"] = {"max_abs_err": int(diff.max()), "mismatch": frac,
                  "n_differ": int((diff > 0).sum()), "n": diff.numel()}
    log(f"parity {name} upsample_wta (B,H,W,D)={(B, H, W, D)} from {h}x{w}: mismatch={frac:.3e} "
        f"({row['wta']['n_differ']} px) max|diff|={row['wta']['max_abs_err']} (bound 2e-3)")
    if frac > 2e-3 or int(disp_k.min()) < 1:
        raise AssertionError(f"upsample_wta disagrees with its plain version at {name}")
    win = wta_mod.staged_window(h, w, H, W)
    row["wta"]["design"] = {"kernel": "per-pixel"} if win is None else {
        "kernel": "staged", "tile": [wta_mod.TILE_X, wta_mod.TILE_Y], "chunk": wta_mod.D_CHUNK,
        "window": list(win), "smem_bytes": wta_mod.staged_smem_bytes(*win),
        **tune.resources(_build.BUILD_LOGS["wta"])}
    log(f"design {name} upsample_wta: {row['wta']['design']}")
    if name == "teddy":
        # D = 3: one chunk of 8 disparities, a quarter filled
        maps3 = maps_p[:, :, :3].contiguous()
        n3 = int((K.upsample_wta(g2, maps3) != K.upsample_wta_plain(g2, maps3)).sum())
        row["wta"]["n_differ_d3"] = n3
        log(f"parity {name} upsample_wta at D=3: {n3} px differ (0 required)")
        if n3:
            raise AssertionError("upsample_wta at D=3 is not bitwise its plain version")
    if D > 64:
        # shapes tried and rejected: the next chunk's copies in flight; four
        # pixels of a row per thread from three columns picked by selects
        tried = tune.wta_variant_ms(g2, maps_p, [(16, 8, 1, 2, 2, 3), (16, 8, 4, 3, 1, 3),
                                                 (32, 4, 1, 2, 1, 3)])
        row["wta"]["design"]["rejected_ms"] = {
            "two_stages": tried[(16, 8, 1, 2, 2, 3)],
            "four_pixels_a_thread": tried[(16, 8, 4, 3, 1, 3)],
            "tile_64x32_chunk_4": tried[(32, 4, 1, 2, 1, 3)]}
        log(f"tried {name} upsample_wta (bitwise the shipped kernel): "
            f"{row['wta']['design']['rejected_ms']} ms")

    timing = {
        "lowmaps": (lambda: K.low_maps(p2, stats, k),
                    lambda: K.low_maps_plain(p2, stats, k), bound_lowmaps(p2, k)),
        "wta": (lambda: K.upsample_wta(g2, maps_p),
                lambda: K.upsample_wta_plain(g2, maps_p, d_chunk=d_chunk),
                bound_wta(g2, maps_p)),
    }
    if with_wmf:
        g_u8 = _to_u8(g2).contiguous()
        r, sig = cfg.wmf_radius, cfg.wmf_sigma

        def wmf_parity(key, disp):
            (med_p, plain_ms) = timed_once(lambda: K.weighted_median_plain(disp, g_u8, r, D, sig))
            med_k = K.weighted_median(disp, g_u8, r, D, sig)
            diff = (med_k.int() - med_p.int()).abs()
            frac = float((diff > 0).float().mean())
            passes = K.wmf.bin_window_passes(disp, r, D).float()
            row[key] = {"max_abs_err": int(diff.max()), "mismatch": frac,
                        "n_differ": int((diff > 0).sum()), "n": diff.numel(),
                        "passes_mean": float(passes.mean()), "passes_max": int(passes.max())}
            log(f"parity {name} weighted_median ({key}) (B,H,W) r={r} bins={D}: "
                f"mismatch={frac:.3e} ({row[key]['n_differ']} px) "
                f"max|diff|={row[key]['max_abs_err']} (bounds 1e-3, 1; 0 px required); "
                f"bin-window passes per block mean {row[key]['passes_mean']:.3f} "
                f"max {row[key]['passes_max']}")
            if frac > 1e-3 or int(diff.max()) > 1:
                raise AssertionError(f"weighted_median disagrees with its plain version at {name}")
            if row[key]["n_differ"]:
                raise AssertionError(f"weighted_median ({key}) is not bitwise its plain version "
                                     f"at {name}")
            return med_p, plain_ms

        med_p, _ = wmf_parity("wmf", disp_p)
        timing["wmf"] = (
            lambda: K.weighted_median(disp_p, g_u8, r, D, sig),
            lambda: K.weighted_median_plain(disp_p, g_u8, r, D, sig),
            bound_wmf(disp_p, med_p, r, D))
        if D > 64:
            # the most bin-window passes: uniformly random disparities over
            # every bin; its plain version runs once (the parity run is timed)
            rnd = torch.as_tensor(np.random.default_rng(3).integers(
                0, D, tuple(disp_p.shape), dtype=np.uint8), device=dev)
            med_r, plain_ms = wmf_parity("wmf_random", rnd)
            b_ms, b_by = bound_wmf(rnd, med_r, r, D)
            rr = row["wmf_random"]
            rr.update(ms=cuda_ms(lambda: K.weighted_median(rnd, g_u8, r, D, sig)),
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            log(f"time {name} wmf_random: kernel {rr['ms']:.4f} ms, plain {rr['plain_ms']:.4f} ms "
                f"(one run), bound {b_ms:.5f} ms ({b_by}), {b_ms / rr['ms']:.1%} of bound")
            del rnd, med_r
    time_rows(name, row, timing)
    report[name] = row


def fused_parity(name: str, cfg, left, right, dev, report):
    """K4 against its plain version (sampled cost, then K1's plain version)
    and K10 against K4 -> K2 on the card and against its plain version, on
    the same CUDA tensors, and the times (phases 3 and 5 for one shape)."""
    views, grds = stacked_views(torch.as_tensor(left, device=dev)[None],
                                torch.as_tensor(right, device=dev)[None], cfg)
    B2, H, W, _ = views.shape
    s, k, D = cfg.subsample, cfg.fgf_low_radius, cfg.max_dis
    stats = guide_stats(views, (H // s, W // s), k, cfg.gif_eps).contiguous()
    cost = dict(alpha=cfg.alpha, border_cost=cfg.border_cost, tau1=cfg.tau1, tau2=cfg.tau2)
    d_chunk = 16 if D > 64 else None
    row = {}

    maps_k = K.cvc_low_maps(views, grds, stats, D, k, **cost)
    maps_p = K.cvc_low_maps_plain(views, grds, stats, D, k, **cost)
    err = (maps_k - maps_p).abs()
    tol_ok = torch.allclose(maps_k, maps_p, atol=2e-4, rtol=1e-3)
    row["cvc_lowmaps"] = {"max_abs_err": float(err.max()), "n_differ": int((err > 0).sum()),
                          "n": maps_k.numel()}
    log(f"parity {name} cvc_lowmaps views {(B2, H, W)} D={D} -> maps {tuple(maps_k.shape)} "
        f"k={k}: max|diff|={row['cvc_lowmaps']['max_abs_err']:.3e} differing="
        f"{row['cvc_lowmaps']['n_differ']}/{maps_k.numel()} (atol 2e-4, rtol 1e-3)")
    if not tol_ok:
        raise AssertionError(f"cvc_lowmaps disagrees with its plain version at {name}")
    del maps_p, err
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, grid = cvc_lowmaps.plan_chunks(B2, D, H // s, W // s, k, sms)
    row["cvc_lowmaps"]["design"] = {
        "tile": [cvc_lowmaps.TILE] * 2, "chunk": chunk, "grid": list(grid),
        "smem_bytes": cvc_lowmaps.smem_bytes(k),
        **tune.resources(_build.BUILD_LOGS["cvc_lowmaps"])}
    log(f"design {name} cvc_lowmaps: {row['cvc_lowmaps']['design']}")
    if D > 64:
        # D = 100: the 16 disparities a block takes do not divide it
        d_odd = 100
        odd_chunk, _ = cvc_lowmaps.plan_chunks(B2, d_odd, H // s, W // s, k, sms)
        n_odd = int((K.cvc_low_maps(views, grds, stats, d_odd, k, **cost)
                     != K.cvc_low_maps_plain(views, grds, stats, d_odd, k, **cost)).sum())
        row["cvc_lowmaps"]["n_differ_d100"] = n_odd
        log(f"parity {name} cvc_lowmaps at D={d_odd} (chunks of {odd_chunk}): {n_odd} values "
            f"differ (0 required)")
        if n_odd or d_odd % odd_chunk == 0:
            raise AssertionError("cvc_lowmaps at a D its chunk does not divide is not bitwise "
                                 "its plain version")
        # shapes tried and rejected: one disparity a block, samples gathered
        # per disparity, one output per thread along the box axis, 256 threads
        tried = tune.k4_variant_ms(
            views, grds, stats, D, k, cost,
            [(4, 1, 512, 1), (4, 0, 512, 1), (1, 1, 512, 1), (4, 1, 256, 1), (4, 1, 512, 4)], (1,))
        row["cvc_lowmaps"]["design"]["rejected_ms"] = {
            "one_disparity_a_block": tried[((4, 1, 512, 1), 1)],
            "samples_not_staged": tried[((4, 0, 512, 1), chunk)],
            "one_output_a_thread": tried[((1, 1, 512, 1), chunk)],
            "256_threads_a_block": tried[((4, 1, 256, 1), chunk)],
            "4_outputs_a_thread_in_the_horizontal_passes": tried[((4, 1, 512, 4), chunk)]}
        log(f"tried {name} cvc_lowmaps (bitwise the shipped kernel): "
            f"{row['cvc_lowmaps']['design']['rejected_ms']} ms")

    disp_k = K.cvc_wta(views, grds, stats, D, k, **cost)
    disp_2 = K.upsample_wta(views, maps_k)
    disp_p = K.cvc_wta_plain(views, grds, stats, D, k, **cost, d_chunk=d_chunk)
    del maps_k
    diff = (disp_k.int() - disp_p.int()).abs()
    frac = float((diff > 0).float().mean())
    frac_2 = float((disp_k != disp_2).float().mean())
    row["cvc_wta"] = {"max_abs_err": int(diff.max()), "mismatch": frac,
                      "mismatch_vs_k4_k2": frac_2, "n_differ": int((diff > 0).sum()),
                      "n": diff.numel()}
    log(f"parity {name} cvc_wta views {(B2, H, W)} D={D}: vs plain mismatch={frac:.3e} "
        f"({row['cvc_wta']['n_differ']} px) max|diff|={row['cvc_wta']['max_abs_err']}; vs "
        f"cvc_lowmaps -> upsample_wta on the card mismatch={frac_2:.3e} (bounds 2e-3)")
    if max(frac, frac_2) > 2e-3 or int(disp_k.min()) < 1:
        raise AssertionError(f"cvc_wta disagrees at {name}")
    if frac_2:
        raise AssertionError(f"cvc_wta is not bitwise cvc_lowmaps -> upsample_wta at {name}")
    rows, groups, lth, ltw = k10_plan_tile(*stats.shape[-2:], H, W, k, B2, sms)
    row["cvc_wta"]["design"] = {
        "tile": [rows, K10_TILE_X], "chains_at_once": groups, "window": [lth, ltw],
        "threads": K10_THREADS, "smem_bytes": k10_smem_bytes(lth, ltw, k, groups),
        **tune.resources(_build.BUILD_LOGS["cvc_wta"])}
    log(f"design {name} cvc_wta: {row['cvc_wta']['design']}")
    if D > 64:
        # shapes tried and rejected (each bitwise the shipped kernel)
        tried = tune.k10_variant_ms(views, grds, stats, D, k, cost, tune.K10_VARIANTS[1:])
        row["cvc_wta"]["design"]["rejected_ms"] = {
            f"{nt} threads, {r} x {otx} tile, {mb} blocks an SM, RV {rv}, {g} chains": ms
            for (nt, otx, mb, rv, r, g), ms in tried.items()}
        log(f"tried {name} cvc_wta: {row['cvc_wta']['design']['rejected_ms']} ms")
    del disp_k, disp_2, disp_p, diff
    torch.cuda.empty_cache()

    timing = {
        "cvc_lowmaps": (lambda: K.cvc_low_maps(views, grds, stats, D, k, **cost),
                        lambda: K.cvc_low_maps_plain(views, grds, stats, D, k, **cost),
                        bound_cvc_lowmaps(views, grds, stats, D, k)),
        "cvc_wta": (lambda: K.cvc_wta(views, grds, stats, D, k, **cost),
                    lambda: K.cvc_wta_plain(views, grds, stats, D, k, **cost, d_chunk=d_chunk),
                    bound_cvc_wta(views, grds, stats, D, k)),
    }
    time_rows(name, row, timing, plain_iters=(3, 1) if D > 64 else (ITERS, WARMUP))
    report[name] = row


def sgbm_parity(name: str, cfg, left_u8, right_u8, dev, report):
    """K6-K9 against their plain versions on the same CUDA tensors, bitwise,
    and the times of both (phases 3 and 5 for one SGBM shape)."""
    l_t = torch.as_tensor(left_u8, device=dev)
    r_t = torch.as_tensor(right_u8, device=dev)
    lf = sgbm_ops.sobel_xclip(l_t, cfg.pre_filter_cap)
    rf = sgbm_ops.sobel_xclip(r_t, cfg.pre_filter_cap)
    D, k, nd = cfg.num_disparities, cfg.block_size, cfg.num_directions
    cost_bound = k * k * lf.shape[2] * 2 * cfg.pre_filter_cap
    sel = (cfg.uniqueness_ratio, cfg.disp12_max_diff, cfg.min_disparity)
    row = {}

    def check(kname, pairs, what):
        n = n_diff = err = 0
        for got, want in pairs:
            if got.dtype != want.dtype or got.shape != want.shape:
                raise AssertionError(f"{kname} at {name}: {got.dtype} {tuple(got.shape)} vs "
                                     f"{want.dtype} {tuple(want.shape)}")
            diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
            n, n_diff = n + diff.numel(), n_diff + int((diff > 0).sum())
            err = max(err, int(diff.max()))
        row[kname] = {"max_abs_err": err, "n_differ": n_diff, "n": n}
        log(f"parity {name} {kname} {what}: max|diff|={err} differing={n_diff}/{n} (bitwise)")
        if n_diff:
            raise AssertionError(f"{kname} disagrees with its plain version at {name}")

    cost = K.bt_cost(lf, rf, D, k, cost_bound)
    check("bt_cost", [(cost, K.bt_cost_plain(lf, rf, D, k, cost_bound))],
          f"(H,W,C,D)={tuple(lf.shape) + (D,)} k={k} {cost.dtype}")
    # the launch shape, and the shapes tried (each bitwise the shipped one)
    row["bt_cost"]["design"] = {
        **bt_launch_shape(*lf.shape[:2], D, k, lf.shape[2], cost.element_size(),
                          torch.cuda.get_device_properties(dev).multi_processor_count),
        **tune.resources(_build.BUILD_LOGS["bt_cost"]),
        "tried_ms": {f"strip {a}, d_chunk {b}": ms for (a, b), ms in
                     tune_bt_cost.variant_ms(lf, rf, D, k, cost_bound).items()}}
    log(f"design {name} bt_cost: {row['bt_cost']['design']}")
    # K7, the main path's entry: uint16 group partials, summed here on the
    # card only to hold them against the plain int32 S
    parts = K.sgbm_aggregate_partials(cost, cfg.p1, cfg.p2, nd, cost_bound)
    if len(parts) != 2 or any(q.dtype != torch.uint16 for q in parts):
        raise AssertionError(f"expected two uint16 partials at {name}, got "
                             f"{[(q.dtype, tuple(q.shape)) for q in parts]}")
    S = K.sgbm_aggregate_plain(cost, cfg.p1, cfg.p2, nd)
    check("sgbm_scan", [(sum(q.int() for q in parts), S)],
          f"(H,W,D)={tuple(S.shape)} {nd} directions, two uint16 partials summed")
    # its int32 path: a P2 beyond the uint16 bound leaves one int32 partial
    p2_wide = 2**16
    wide = K.sgbm_aggregate_partials(cost, cfg.p1, p2_wide, nd, cost_bound)
    if len(wide) != 1 or wide[0].dtype != torch.int32:
        raise AssertionError(f"expected the int32 S at P2={p2_wide}, got {len(wide)} partials")
    main_scan = row["sgbm_scan"]
    check("sgbm_scan", [(wide[0], K.sgbm_aggregate_plain(cost, cfg.p1, p2_wide, nd))],
          f"(H,W,D)={tuple(S.shape)} {nd} directions, int32 S at P2={p2_wide}")
    main_scan["int32_n_differ"] = row["sgbm_scan"]["n_differ"]
    row["sgbm_scan"] = main_scan
    del wide
    torch.cuda.empty_cache()
    disp = K.select_disparity_partials(parts, *sel)
    disp_p = K.select_disparity_plain(S, *sel)
    check("select", [(disp, disp_p), (K.select_disparity(S, *sel), disp_p)],
          f"(H,W,D)={tuple(S.shape)} uniq/d12/minD={sel}, from the partials and from the "
          f"int32 S")
    _, labels, conns = sgbm_ops.speckle_graph(disp, 16 * cfg.speckle_range,
                                              (cfg.min_disparity - 1) * 16)
    links = K.pack_links(*conns)
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    swept = K.speckle_sweep(labels, links, changed, 1)
    # the sweep, a second sweep, and the TPU kernel's scan alone on each axis
    check("speckle", [(swept, K.speckle_sweep_plain(labels, links)),
                      (K.speckle_sweep(swept, links), K.speckle_sweep_plain(swept, links))]
          + [(K.segmin_sweep(labels, c.to(torch.uint8), ax),
              K.segmin_sweep_plain(labels, c.to(torch.uint8), ax))
             for c, ax in ((conns[2], 1), (conns[0], 0))],
          f"(H,W)={tuple(labels.shape)} two sweeps (hook, rows, columns), the row and column "
          f"scans alone")
    if (int(changed.item()) == 1) != bool((swept != labels).any()):
        raise AssertionError(f"K9's changed flag disagrees with the labels at {name}")

    slow = D > 64     # the plain versions' Python loops run long at 2K
    timing = {
        "bt_cost": (lambda: K.bt_cost(lf, rf, D, k, cost_bound),
                    lambda: K.bt_cost_plain(lf, rf, D, k, cost_bound),
                    bound_bt_cost(lf, cost)),
        "sgbm_scan": (lambda: K.sgbm_aggregate_partials(cost, cfg.p1, cfg.p2, nd, cost_bound),
                      lambda: K.sgbm_aggregate_plain(cost, cfg.p1, cfg.p2, nd),
                      bound_scan(cost, nd)),
        "select": (lambda: K.select_disparity_partials(parts, *sel),
                   lambda: K.select_disparity_plain(S, *sel), bound_select(S.shape)),
        # one sweep: the row launch (with the hook), then the column launch
        "speckle": (lambda: K.speckle_sweep(labels, links, changed, 1),
                    lambda: K.speckle_sweep_plain(labels, links, changed, 1),
                    bound_sweep(labels)),
    }
    for kname, (fk, fp, (b_ms, b_by)) in timing.items():
        plain_iters = (2, 1) if slow and kname != "speckle" else (ITERS, WARMUP)
        row[kname].update(ms=cuda_ms(fk), plain_ms=cuda_ms(fp, *plain_iters), bound_ms=b_ms,
                          bound_by=b_by)
        torch.cuda.empty_cache()
        r = row[kname]
        log(f"time {name} {kname}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({b_by}), {b_ms / r['ms']:.1%} of bound")
    # K9: its device time alone (the wrapper's host time exceeds it at
    # Teddy), the hook as the plain-torch ops it was before (for the time
    # before), the TPU kernel's scan alone on each axis, the launch shape and
    # the shapes and staging depths tried (tune_speckle.py; each bitwise the
    # plain version)
    sp = row["speckle"]
    sp["device_ms"] = profiled_ms(lambda: K.speckle_sweep(labels, links, changed, 1), "speckle_")
    sp["hook_plain_ops_ms"] = cuda_ms(lambda: hook_as_torch_ops(labels, conns))
    sp["hook_plain_ops_device_ms"] = profiled_ms(lambda: hook_as_torch_ops(labels, conns))
    sp["segmin_ms"] = {ax: cuda_ms(lambda: K.segmin_sweep(labels, c.to(torch.uint8), ax))
                       for c, ax in ((conns[2], 1), (conns[0], 0))}
    sp["design"] = {"shape": list(speckle_launch_shape(*labels.shape)),
                    **tune.resources(_build.BUILD_LOGS["speckle"]),
                    "tried_ms": {f"{a} rows of {b} warps, {c} columns of {d} warps": ms
                                 for (a, b, c, d), ms in
                                 tune_speckle.variant_ms(labels, links).items()},
                    "staging_depth_ms": tune_speckle.depth_ms(labels, links)}
    log(f"time {name} speckle: device time (profiler) {sp['device_ms']:.4f} ms a sweep; the hook "
        f"as plain-torch ops {sp['hook_plain_ops_ms']:.4f} ms, device time "
        f"{sp['hook_plain_ops_device_ms']:.4f} ms; "
        f"the scans alone (axis: ms) {sp['segmin_ms']}; design {sp['design']}")
    # K7's own traffic and the rate that follows; its int32 entry and K8's;
    # the ring of pixels ahead at four sizes (bytes of shared memory a warp)
    scan, n = row["sgbm_scan"], cost.numel()
    scan["bytes_per_value"] = sgbm_scan.bytes_per_value(nd, cost.element_size(), True)
    scan["tb_per_s"] = n * scan["bytes_per_value"] / scan["ms"] / 1e9
    scan["int32_ms"] = cuda_ms(lambda: K.sgbm_aggregate(cost, cfg.p1, cfg.p2, nd))
    scan["int32_bytes_per_value"] = sgbm_scan.bytes_per_value(nd, cost.element_size(), False)
    scan["int32_tb_per_s"] = n * scan["int32_bytes_per_value"] / scan["int32_ms"] / 1e9
    row["select"]["int32_ms"] = cuda_ms(lambda: K.select_disparity(S, *sel))
    ring = sgbm_scan.RING_BYTES
    scan["ring_ms"] = {}
    for nbytes in (4096, 8192, 16384, 32768):
        sgbm_scan.RING_BYTES = nbytes
        scan["ring_ms"][nbytes] = cuda_ms(
            lambda: K.sgbm_aggregate_partials(cost, cfg.p1, cfg.p2, nd, cost_bound), 10, 2)
    sgbm_scan.RING_BYTES = ring
    # the first 8 image rows alone: where this takes as long as the whole
    # image, a launch lasts as long as its longest path's chain of steps
    few = cost[:8].contiguous()
    scan["rows8_ms"] = cuda_ms(
        lambda: K.sgbm_aggregate_partials(few, cfg.p1, cfg.p2, nd, cost_bound))
    log(f"time {name} sgbm_scan moves {scan['bytes_per_value']} B per (pixel, d): "
        f"{scan['tb_per_s']:.3f} TB/s; the int32 S entry {scan['int32_ms']:.4f} ms "
        f"({scan['int32_bytes_per_value']} B, {scan['int32_tb_per_s']:.3f} TB/s); select from "
        f"the int32 S {row['select']['int32_ms']:.4f} ms; ring bytes per warp -> ms "
        f"{ {k: round(v, 4) for k, v in scan['ring_ms'].items()} } (in use: {ring}); the first "
        f"8 rows alone {scan['rows8_ms']:.4f} ms")
    report[name] = row


def frame_ms(run, iters: int) -> float:
    """Host-clock ms per end-to-end frame of `run()` (device tensors in,
    synchronised)."""
    for _ in range(WARMUP):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_frames(run, tags: dict, frames: int = 5) -> dict:
    """Device time per frame by kernel, from torch.profiler over `frames`
    end-to-end frames of `run()`. Device rows are those with device time and
    no host time (kernels and copies); `tags` maps a substring of a kernel's
    name to its report key; the idle share is 1 - device time / wall."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    rows = [e for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    per = {**{t: 0.0 for t in tags.values()}, "other": 0.0}
    launches = 0
    for e in rows:
        tag = next((t for key, t in tags.items() if key in e.key), "other")
        per[tag] += e.self_device_time_total / 1e3 / frames
        launches += e.count
    busy = sum(per.values())
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1 - busy / wall_ms,
            "device_ms_by_kernel": per, "device_ops_per_frame": launches / frames}


def end_to_end(label: str, run, tags: dict, note: str, iters: int) -> dict:
    ms = frame_ms(run, iters)
    out = {"ms_per_frame": ms, "fps": 1e3 / ms, "profile": profile_frames(run, tags)}
    log(f"end to end {label}: {ms:.3f} ms/frame, {1e3 / ms:.2f} fps ({note})")
    prof = out["profile"]
    by = ", ".join(f"{k} {v:.3f}" for k, v in prof["device_ms_by_kernel"].items())
    log(f"profile {label}: wall {prof['wall_ms']:.3f} ms/frame under the profiler, device "
        f"{prof['device_ms']:.3f} ms ({by}), idle share {prof['idle_share']:.1%}, "
        f"{prof['device_ops_per_frame']:.0f} device ops/frame")
    return out


def check_medians_2k(ld: np.ndarray, rd: np.ndarray | None, rect) -> dict:
    """Interior medians of the 2K frame's disparities against the seeded
    field (96 in the rectangle, 48 elsewhere), within 1. `ld`/`rd` are
    integer disparities; NaN marks invalid pixels."""
    y0, y1, x0, x1 = rect
    m = 40   # interior margin away from region edges and occlusions
    checks = {
        "left fg": (ld[y0 + m:y1 - m, x0 + 96 + m:x1 + 96 - m], 96),
        "left bg": (ld[y0 + m:y1 - m, 200:x0 + 48 - m], 48),
    }
    if rd is not None:
        checks["right fg"] = (rd[y0 + m:y1 - m, x0 + m:x1 - m], 96)
        checks["right bg"] = (rd[y1 + m:H2K - m, 200:W2K - 400], 48)
    med = {}
    for key, (region, want) in checks.items():
        med[key] = float(np.nanmedian(region))
        if not abs(med[key] - want) <= 1:
            raise AssertionError(f"2K {key} median {med[key]} != {want}")
    return med


def peak_gib(run) -> float:
    """Peak device memory (GiB) of one `run()`, the resident tensors
    included."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def feature_tables(pool) -> dict:
    """Table mode's feature indexes (seed 0) of Teddy's and Cones' views,
    computed in `pool`'s processes while the card works (k-means on the
    host takes seconds a view). Returns futures of (findex, wmap) keyed
    (name, view)."""
    return {(n, v): pool.submit(_feature_index, n, v) for n in GOLDEN_NONOCC for v in (0, 1)}


def _feature_index(name: str, view: int):
    from primestereomatch_torch.utils import feature_index_color

    s = load_dataset(name)
    return feature_index_color(s.right_bgr if view else s.left_bgr, seed=0)


def gif_variants(dev, smi, drive, samples, frames, tables, left2k, right2k, rect) -> dict:
    """The gif_variants phase: the uint8 cost, the PP toolchain and table
    mode at Teddy and Cones (%BP(nonocc) within 0.3 of the JAX package's,
    each path's kernels asserted), the uint8 sampled cost's sha256 at
    Teddy, uint8 at 2K (K1 -> K2 -> K3 on both tails, no K4 or K10), the
    post-processing ops on the card against the CPU on the card's own WTA
    output, and DispEst at Teddy against the reference binary's stage dumps
    (tests/golden/ref_teddy.npz, the JAX package's bounds); times of each
    and peak memory."""
    out: dict = {"bp_nonocc": {}, "ms_per_frame": {}}
    views = torch.stack(frames["Teddy"])
    digest = hashlib.sha256(sampled_u8_costs(views, psm.GIFConfig()).cpu().numpy()
                            .tobytes()).hexdigest()
    log(f"variants: Teddy uint8 sampled cost sha256 {digest[:16]}... "
        f"{'equals' if digest == U8_SHA256 else 'DIFFERS FROM'} the JAX package's")
    if digest != U8_SHA256:
        raise AssertionError(f"u8 sampled cost sha256 {digest} != {U8_SHA256}")
    out["u8_sha256"] = digest

    t0 = time.perf_counter()
    tab = {key: f.result() for key, f in tables.items()}
    out["feature_wait_s"] = time.perf_counter() - t0     # the host clustering, not yet done
    k12 = ("lowmaps", "wta")
    expect = {"u8": k12 + ("wmf",), "toolchain": k12 + ("wmf",), "table": k12}
    notes = {"u8": "uint8 cost -> K1 -> K2 -> K3",
             "toolchain": "K1 -> K2 -> LR check, fill, bilateral median (plain torch) -> K3",
             "table": "K1 -> K2 -> table-mode JointWMF (plain torch)"}
    runs = {}
    for n, s in samples.items():
        for variant, kw in VARIANT_CONFIGS.items():
            cfg = psm.GIFConfig(**kw)
            extra = ()
            if variant == "table":
                (lf, wm), (rf, _) = tab[(n, 0)], tab[(n, 1)]
                extra = (torch.as_tensor(lf, device=dev), torch.as_tensor(rf, device=dev),
                         torch.as_tensor(wm, device=dev))
            run = (lambda n=n, cfg=cfg, extra=extra:
                   psm.stereo_gif_forward(*frames[n], cfg, True, *extra, device=dev))
            ld, rd = (t.cpu().numpy() for t in drive(f"{n}_{variant}", expect[variant], run))
            if ld.shape != s.gt.shape or min(ld.min(), rd.min()) < 1 or max(ld.max(),
                                                                           rd.max()) >= 64:
                raise AssertionError(f"{n} {variant}: disparities out of shape or range")
            bp = bad_pixel_metrics(ld, s.gt, s.scale_factor, 64,
                                   mask=s.mask_nonocc).percent_bad_pixels
            want = VARIANT_BP[n][variant]
            out["bp_nonocc"][f"{n}_{variant}"] = bp
            log(f"variants: {n} {variant} %BP(nonocc) {bp:.3f} (JAX package {want:.3f}, +-0.3)")
            if abs(bp - want) > 0.3:
                raise AssertionError(f"{n} {variant} %BP {bp} is not within 0.3 of {want}")
            runs[f"{n}_{variant}"] = run, notes[variant]

    # uint8 at 2K: the fused tails build the float cost, so K1 runs on both
    pair2k = (torch.as_tensor(left2k, device=dev), torch.as_tensor(right2k, device=dev))
    for fusion in ("maps", "full"):
        cfg = psm.GIFConfig(max_dis=256, cvc_dtype="u8", tail_fusion=fusion)
        run = lambda cfg=cfg: psm.stereo_gif_forward(*pair2k, cfg, device=dev)  # noqa: E731
        ld, rd = (t.cpu().numpy().astype(np.float64)
                  for t in drive(f"2k_u8_{fusion}", k12 + ("wmf",), run))
        med = check_medians_2k(ld, rd, rect)
        out[f"medians_2k_u8_{fusion}"] = med
        log(f"variants: 2k u8 ({fusion}) interior medians {med} match the field")
        runs[f"2k_u8_{fusion}"] = run, notes["u8"]

    # the post-processing ops on the card's own Teddy WTA output
    l_img, r_img = frames["Teddy"]
    ld, rd = psm.stereo_gif_forward(l_img, r_img, psm.GIFConfig(), False, device=dev)
    lv, rv = postproc.lr_check(ld, rd)
    lf = postproc.fill_invalid(ld, lv)
    rf = postproc.fill_invalid(rd, rv)
    cpu = [t.cpu() for t in (ld, rd, l_img, r_img)]
    lv_c, rv_c = postproc.lr_check(cpu[0], cpu[1])
    bitwise = {"lr_check": torch.equal(lv.cpu(), lv_c) and torch.equal(rv.cpu(), rv_c),
               "fill_invalid": torch.equal(lf.cpu(), postproc.fill_invalid(cpu[0], lv_c))
               and torch.equal(rf.cpu(), postproc.fill_invalid(cpu[1], rv_c))}
    pp = {"valid_share": float(lv.float().mean())}
    for key, ok in bitwise.items():
        log(f"variants: {key} on the card {'equals' if ok else 'DIFFERS FROM'} the CPU "
            f"(bitwise required)")
        if not ok:
            raise AssertionError(f"{key} on the card differs from the CPU")
    g_u8 = _to_u8(l_img)
    (l_fi, l_wm) = tab[("Teddy", 0)]
    fi_t, wm_t = torch.as_tensor(l_fi, device=dev), torch.as_tensor(l_wm, device=dev)
    stages = {
        "lr_check": lambda: postproc.lr_check(ld, rd),
        "fill_invalid": lambda: (postproc.fill_invalid(ld, lv), postproc.fill_invalid(rd, rv)),
        "weighted_median_left": lambda: postproc.weighted_median(l_img, lf, lv, 64),
        "weighted_median_right": lambda: postproc.weighted_median(r_img, rf, rv, 64,
                                                                  use_sqrt=True),
        "table_median_left": lambda: joint_wmf(ld, radius=9, n_bins=64, findex=fi_t,
                                               wmap=wm_t),
        "exact_median_both (K3)": lambda: K.weighted_median(
            torch.stack([ld, rd]), torch.stack([g_u8, _to_u8(r_img)]),
            9, 64, 25.5),
    }
    cpu_ref = {
        "weighted_median_left": lambda: postproc.weighted_median(
            cpu[2], lf.cpu(), lv_c, 64),
        "weighted_median_right": lambda: postproc.weighted_median(
            cpu[3], rf.cpu(), rv_c, 64, use_sqrt=True),
        "table_median_left": lambda: joint_wmf(cpu[0], radius=9, n_bins=64,
                                               findex=torch.as_tensor(l_fi),
                                               wmap=torch.as_tensor(l_wm)),
    }
    for key, fn in cpu_ref.items():
        got = stages[key]().cpu()
        want = fn()
        agree = float((got == want).float().mean())
        pp[f"{key}_agree"] = agree
        log(f"variants: {key} on the card agrees with the CPU at {agree:.6f} of the pixels "
            f"({int((got != want).sum())} differ; tie budget >= 0.999)")
        if agree < 0.999:
            raise AssertionError(f"{key} on the card is outside the tie budget: {agree}")
    # the corners: does the card keep a subnormal through scatter_add_ (a
    # float atomic add) and through expf, as the CPU does?
    tiny = torch.tensor([1e-40, -90.0])
    xs = torch.linspace(-104, 0, 2**20)             # made on the host, copied
    probe = {"scatter_add_1e-40": float(torch.zeros(1, device=dev).scatter_add_(
                 0, torch.zeros(1, dtype=torch.int64, device=dev), tiny[:1].to(dev))),
             "add_1e-40": float(torch.zeros(1, device=dev) + tiny[:1].to(dev)),
             "exp_-90": float(torch.exp(tiny[1:].to(dev))),
             "exp_-90_cpu": float(torch.exp(tiny[1:])),
             "exp_ulps_apart_on_[-104,0]": int((
                 torch.exp(xs.to(dev)).cpu().view(torch.int32)
                 - torch.exp(xs).view(torch.int32)).abs().max())}
    pp["subnormal_probe"] = probe
    log(f"variants: the card on subnormals and exp: {probe}")
    pp["device_ms"] = {key: profiled_ms(fn, iters=3) for key, fn in stages.items()}
    log(f"variants: post-processing device ms (profiler, Teddy 375x450, 64 bins): "
        f"{ {k: round(v, 4) for k, v in pp['device_ms'].items()} } ({smi})")
    out["postproc"] = pp

    # DispEst at Teddy against the reference binary's stage dumps
    ref = np.load(ROOT / "tests" / "golden" / "ref_teddy.npz")
    eng = psm.DispEst(psm.GIFConfig(), device=dev)
    grd = view_gradients(views, psm.GIFConfig()).cpu().numpy()
    lcv, rcv = eng.cost_const(l_img, r_img)
    lcvf = eng.cost_filter(l_img, lcv)
    rcvf = eng.cost_filter(r_img, rcv)
    err = {"grad": max(float(np.abs(grd[v] - ref[k]).max()) for v, k in ((0, "lgrdx"),
                                                                       (1, "rgrdx"))),
           "cvc": max(float(np.abs(cv[d].cpu().numpy() - ref[f"cvc_{sd}_d{d}"]).max())
                      for sd, cv in (("l", lcv), ("r", rcv)) for d in PROBE_D),
           "cvf": max(float(np.abs(cv[d].cpu().numpy() - ref[f"cvf_{sd}_d{d}"]).max())
                      for sd, cv in (("l", lcvf), ("r", rcvf)) for d in PROBE_D),
           "wta_mismatch": max(float((eng.disp_select(cv).cpu().numpy() != ref[f"{sd}disp_wta"])
                                     .mean()) for sd, cv in (("l", lcvf), ("r", rcvf)))}
    log(f"variants: DispEst at Teddy vs the reference dumps: {err} (bounds: gradients 5e-7, "
        f"CVC 1e-6, CVF 1e-3 at d in {PROBE_D}, WTA mismatch 5e-4)")
    for key, lim in (("grad", 5e-7), ("cvc", 1e-6), ("cvf", 1e-3), ("wta_mismatch", 5e-4)):
        if not err[key] <= lim:
            raise AssertionError(f"DispEst {key} {err[key]} beyond {lim}")
    dump = ROOT / "build" / "dispest_dump"
    dump.mkdir(parents=True, exist_ok=True)
    paths = eng.dump_cost_volume(lcv, str(dump / "l_"))
    want = np.clip(np.rint(lcv.cpu().numpy() * 255.0), 0, 255).astype(np.uint8)
    same = all(np.array_equal(read_png(p, 1), w) for p, w in zip(paths, want))
    for p in paths:
        pathlib.Path(p).unlink()
    dump.rmdir()
    log(f"variants: DispEst.dump_cost_volume wrote {len(paths)} slices; read back "
        f"{'unchanged' if same else 'CHANGED'}")
    if not same or len(paths) != lcv.shape[0]:
        raise AssertionError("dump_cost_volume does not round-trip through read_png")
    wta = eng.disp_select(lcvf)
    out["dispest"] = {"errors": err, "ms": {
        "cost_const": cuda_ms(lambda: eng.cost_const(l_img, r_img), 5, 1),
        "cost_filter": cuda_ms(lambda: eng.cost_filter(l_img, lcv), 5, 1),
        "disp_select": cuda_ms(lambda: eng.disp_select(lcvf), 5, 1),
        "post_process": cuda_ms(lambda: eng.post_process(wta, l_img), 5, 1),
        "compute": cuda_ms(lambda: eng.compute(l_img, r_img), 3, 1)}}
    del lcv, rcv, lcvf, rcvf
    log(f"variants: DispEst ms per stage at Teddy (one view; compute: both views, every "
        f"stage): { {k: round(v, 4) for k, v in out['dispest']['ms'].items()} } ({smi})")

    out["e2e"] = {}
    for key, (run, note) in runs.items():
        if key.startswith("Cones"):
            continue
        out["e2e"][key] = end_to_end(key, run, GIF_TAGS, note, 10 if key.startswith("2k") else 5)
        out["ms_per_frame"][key] = out["e2e"][key]["ms_per_frame"]
    out["peak_gib"] = {key: peak_gib(run) for key, (run, _) in runs.items()
                       if not key.startswith("Cones")}
    out["peak_gib"]["dispest_teddy"] = peak_gib(lambda: eng.compute(l_img, r_img))
    log(f"variants: ms per frame (host clock, synchronised) "
        f"{ {k: round(v, 3) for k, v in out['ms_per_frame'].items()} }; peak GiB "
        f"{ {k: round(v, 3) for k, v in out['peak_gib'].items()} } ({smi})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card",
              file=sys.stderr)
        return 1
    # table mode's k-means runs on the host in these processes meanwhile
    pool = concurrent.futures.ProcessPoolExecutor(
        4, mp_context=multiprocessing.get_context("spawn"))
    try:
        return run(feature_tables(pool))
    finally:
        pool.shutdown(cancel_futures=True)


def run(tables: dict) -> int:
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    build_secs = K.build()
    log(f"build: {build_secs:.1f} s for {len(_build.SOURCES)} sources (nvcc in parallel)")
    for n, text in _build.BUILD_LOGS.items():
        log(f"ptxas {n}: at most {tune.resources(text)} over its kernels")

    cfg = psm.GIFConfig()
    cfg2k = psm.GIFConfig(max_dis=256)
    cfg2k_full = psm.GIFConfig(max_dis=256, tail_fusion="full")
    cfg_s1 = psm.GIFConfig(subsample=1)
    scfg = psm.SGBMConfig()
    scfg2k = psm.SGBMConfig(num_disparities=256)
    teddy = load_dataset("Teddy")
    left2k, right2k, rect = synthetic_2k(0)
    left2k_u8, right2k_u8 = (np.clip(np.rint(a * 255), 0, 255).astype(np.uint8)
                             for a in (left2k, right2k))
    left_vga, right_vga = synthetic_pair(HVGA, WVGA, 1, (90, 270, 210, 450), 24, 12)
    report: dict = {}
    parity("teddy", cfg, teddy.left_f32, teddy.right_f32, dev, report)
    parity("2k", cfg2k, left2k, right2k, dev, report)
    torch.cuda.empty_cache()
    parity("teddy_s1", cfg_s1, teddy.left_f32, teddy.right_f32, dev, report, with_wmf=False)
    torch.cuda.empty_cache()
    fused_report: dict = {}
    fused_parity("vga", cfg, left_vga, right_vga, dev, fused_report)
    fused_parity("2k", cfg2k, left2k, right2k, dev, fused_report)
    torch.cuda.empty_cache()
    sgbm_report: dict = {}
    sgbm_parity("teddy", scfg, teddy.left_bgr, teddy.right_bgr, dev, sgbm_report)
    sgbm_parity("2k", scfg2k, left2k_u8, right2k_u8, dev, sgbm_report)
    torch.cuda.empty_cache()

    # ---- GIF main paths: counts at 0 just before each, read just after ---
    samples = {n: (teddy if n == "Teddy" else load_dataset(n)) for n in GOLDEN_NONOCC}
    frames = {n: (torch.as_tensor(s.left_f32, device=dev),
                  torch.as_tensor(s.right_f32, device=dev)) for n, s in samples.items()}
    frames["2k"] = (torch.as_tensor(left2k, device=dev), torch.as_tensor(right2k, device=dev))
    # four Teddy-size frames: Teddy, Cones, Teddy, Cones
    batch4 = tuple(torch.stack([frames[n][v] for n in ("Teddy", "Cones") * 2]) for v in (0, 1))
    path_launches: dict = {}

    def drive(label: str, expect: tuple, run):
        """One main path: exactly the kernels `expect` must launch in it."""
        torch.cuda.synchronize()
        K.reset_launches()
        out = run()
        torch.cuda.synchronize()
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        log(f"GIF main path {label}: launches {counts}")
        if set(counts) != set(expect):
            raise AssertionError(f"{label} launched {counts}, expected exactly {expect}")
        path_launches[label] = counts
        return out

    k123 = ("lowmaps", "wta", "wmf")
    outs = {n: drive(n, k123, lambda n=n: psm.stereo_gif_forward(*frames[n], cfg, device=dev))
            for n in samples}
    outs["2k"] = drive("2k", ("cvc_lowmaps", "wta", "wmf"),
                       lambda: psm.stereo_gif_forward(*frames["2k"], cfg2k, device=dev))
    outs["2k_full"] = drive("2k_full", ("cvc_wta", "wmf"),
                            lambda: psm.stereo_gif_forward(*frames["2k"], cfg2k_full, device=dev))
    outs["teddy_s1"] = drive("teddy_s1", k123,
                             lambda: psm.stereo_gif_forward(*frames["Teddy"], cfg_s1, device=dev))
    outs["batch4"] = drive("batch4", k123,
                           lambda: psm.stereo_gif_forward_batch(*batch4, cfg, device=dev))
    variants = gif_variants(dev, smi, drive, samples, frames, tables, left2k, right2k, rect)
    torch.cuda.empty_cache()
    launches = {k: sum(c.get(k, 0) for c in path_launches.values()) for k in GIF_KERNELS}
    log(f"GIF main paths, launches summed: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the GIF paths never launched: {launches}")

    def bp_nonocc(name: str, key: str) -> float:
        s = samples[name]
        ld, rd = (t.cpu().numpy() for t in outs[key])
        if ld.shape != s.gt.shape or int(max(ld.max(), rd.max())) >= cfg.max_dis or int(
                min(ld.min(), rd.min())) < 1:
            raise AssertionError(f"{key} disparities out of shape or range")
        return bad_pixel_metrics(ld, s.gt, s.scale_factor, cfg.max_dis,
                                 mask=s.mask_nonocc).percent_bad_pixels

    bp = {}
    for n in samples:
        bp[n] = bp_nonocc(n, n)
        log(f"{n}: %BP(nonocc) {bp[n]:.3f} (reference {GOLDEN_NONOCC[n]}, +-0.3)")
        if abs(bp[n] - GOLDEN_NONOCC[n]) > 0.3:
            raise AssertionError(f"{n} %BP {bp[n]} outside the golden band")
    bp["Teddy_s1"] = bp_nonocc("Teddy", "teddy_s1")
    log(f"Teddy at subsample=1: %BP(nonocc) {bp['Teddy_s1']:.3f}, disparities in [1, 64)")

    med2k = {}
    for key in ("2k", "2k_full"):
        ld, rd = (t.cpu().numpy() for t in outs[key])
        if ld.shape != (H2K, W2K) or ld.dtype != np.uint8 or min(ld.min(), rd.min()) < 1:
            raise AssertionError(f"{key} output {ld.shape} {ld.dtype} min {ld.min()}")
        med2k[key] = check_medians_2k(ld.astype(np.float64), rd.astype(np.float64), rect)
        log(f"{key} (1242x2208, max_dis=256): interior medians {med2k[key]} match the field")
    full_vs_maps = max(float((a != b).float().mean())
                       for a, b in zip(outs["2k_full"], outs["2k"]))
    log(f"2k tail_fusion='full' vs 'maps' after JointWMF: mismatch {full_vs_maps:.3e} "
        f"(bound 2e-3)")
    if full_vs_maps > 2e-3:
        raise AssertionError("the full-fusion 2K frame disagrees with the maps path")
    for v in (0, 1):
        for i, n in enumerate(("Teddy", "Cones") * 2):
            if not torch.equal(outs["batch4"][v][i], outs[n][v]):
                raise AssertionError(f"batch frame {i} view {v} differs from the single {n} frame")
    log("batch of 4 Teddy-size frames: every frame bitwise equal to its single-frame output")
    del outs
    torch.cuda.empty_cache()

    # ---- SGBM main path: counts at 0 just before, read just after --------
    sframes = {n: (torch.as_tensor(s.left_bgr, device=dev), torch.as_tensor(s.right_bgr,
                                                                            device=dev))
               for n, s in samples.items()}
    sframes["2k"] = (torch.as_tensor(left2k_u8, device=dev),
                     torch.as_tensor(right2k_u8, device=dev))
    torch.cuda.synchronize()
    K.reset_launches()
    souts, sper_frame = {}, {}
    for n, (l_t, r_t) in sframes.items():
        before = dict(_build.LAUNCHES)
        checks = sgbm_ops.SPECKLE_CHECKS["count"]
        souts[n] = psm.stereo_sgbm_forward(l_t, r_t, scfg2k if n == "2k" else scfg, device=dev)
        sper_frame[n] = {k: _build.LAUNCHES[k] - before[k] for k in SGBM_KERNELS}
        # a sweep is two K9 launches; the filter reads its changed flag (one
        # host sync) once per 2 sweeps (its default steps_per_check)
        sper_frame[n]["speckle_sweeps"] = sper_frame[n]["speckle"] // 2
        sper_frame[n]["host_syncs"] = sgbm_ops.SPECKLE_CHECKS["count"] - checks
    torch.cuda.synchronize()
    slaunches = {k: _build.LAUNCHES[k] for k in SGBM_KERNELS}
    log(f"SGBM main path launches: {slaunches}; per frame: {sper_frame}")
    if min(slaunches[k] for k in SGBM_KERNELS) < 1:
        raise AssertionError(f"a kernel of the SGBM path never launched: {slaunches}")
    for n, per in sper_frame.items():
        # the partials route: K6 once, K7 a family of each group per launch,
        # K8 once; K9 two launches a sweep, two sweeps a check
        if ((per["bt_cost"], per["sgbm_scan"], per["select"]) != (1, 2, 1)
                or per["speckle"] != 4 * per["host_syncs"] or not per["host_syncs"]):
            raise AssertionError(f"SGBM {n} launched {per}, expected K6 1, K7 2, K8 1, K9 4 a "
                                 f"host sync")
    if any(v for k, v in _build.LAUNCHES.items() if k not in SGBM_KERNELS):
        raise AssertionError(f"the SGBM path launched a GIF kernel: {_build.LAUNCHES}")

    goldens = np.load(ROOT / "tests" / "golden" / "sgbm_cv2.npz")
    nd = scfg.num_disparities
    sgbm_q: dict = {}
    for n, s in samples.items():
        ours = souts[n].cpu().numpy()
        digest = hashlib.sha256(ours.tobytes()).hexdigest()
        if ours.dtype != np.int16 or ours.shape != s.gt.shape or digest != SGBM_SHA256[n]:
            raise AssertionError(f"SGBM {n}: {ours.dtype} {ours.shape} sha256 {digest} is "
                                 f"not the JAX output's {SGBM_SHA256[n]}")
        ref = goldens[f"{n}_hh"]
        io, ir = ours[:, nd:], ref[:, nd:]
        both = (io >= 0) & (ir >= 0)
        within_1d = float((np.abs(io.astype(np.int32) - ir)[both] <= 16).mean())
        validity_mm = float(((io >= 0) != (ir >= 0)).mean())
        band_mm = float(((ours[:, :nd] >= 0) != (ref[:, :nd] >= 0)).mean())

        def bp_of(d16):
            u8 = np.clip(np.maximum(d16.astype(np.int32), 0) // 16, 0, nd - 1).astype(np.uint8)
            return bad_pixel_metrics(u8, s.gt, s.scale_factor, nd,
                                     mask=s.mask_nonocc).percent_bad_pixels

        bp_ours, bp_cv2 = bp_of(ours), bp_of(ref)
        sgbm_q[n] = {"sha256": digest, "within_1d": within_1d, "validity_mismatch": validity_mm,
                     "band_mismatch": band_mm, "bp_nonocc": bp_ours, "bp_nonocc_cv2": bp_cv2}
        w1_min, vm_max = CV2_BOUNDS[n]
        log(f"SGBM {n}: sha256 equals the JAX output's; vs cv2: within-1d {within_1d:.4f} "
            f"(>= {w1_min}), interior validity mismatch {validity_mm:.4f} (<= {vm_max}), "
            f"band mismatch {band_mm} (0); %BP(nonocc) {bp_ours:.3f} vs cv2 {bp_cv2:.3f} "
            f"(within 1.0)")
        if (both.mean() <= 0.5 or within_1d < w1_min or validity_mm > vm_max or band_mm != 0
                or abs(bp_ours - bp_cv2) > 1.0):
            raise AssertionError(f"SGBM {n} outside the cv2-golden bounds: {sgbm_q[n]}")

    d16 = souts["2k"].cpu().numpy()
    if d16.shape != (H2K, W2K) or d16.dtype != np.int16:
        raise AssertionError(f"SGBM 2K output {d16.shape} {d16.dtype}")
    disp = np.where(d16 >= 0, d16 / 16.0, np.nan)
    smed2k = check_medians_2k(disp, None, rect)
    log(f"SGBM 2k (1242x2208, D=256): interior medians of valid disparities {smed2k} match "
        f"the field; valid share {float((d16 >= 0).mean()):.3f}")
    del souts
    torch.cuda.empty_cache()

    e2e = {}
    sgbm_tags = {"bt_cost_kernel": "bt_cost",
                 "sgm_scan_kernel": "sgbm_scan", "select_kernel": "select",
                 "speckle_rows_kernel": "speckle", "speckle_cols_kernel": "speckle"}
    gif_runs = {
        "teddy": (frames["Teddy"], cfg, ITERS, "both views + JointWMF"),
        "2k": (frames["2k"], cfg2k, 10, "K4 -> K2 -> K3"),
        "2k_full": (frames["2k"], cfg2k_full, 10, "tail_fusion='full': K10 -> K3"),
        "teddy_s1": (frames["Teddy"], cfg_s1, ITERS, "subsample=1: CVC -> K1 (k=17) -> K2 -> K3"),
    }
    for n, (pair, c, iters, note) in gif_runs.items():
        e2e[n] = end_to_end(n, lambda: psm.stereo_gif_forward(*pair, c, device=dev),
                            GIF_TAGS, note, iters)
    e2e["batch4"] = end_to_end(
        "batch4", lambda: psm.stereo_gif_forward_batch(*batch4, cfg, device=dev), GIF_TAGS,
        "one call for 4 Teddy-size frames: divide by 4 for a frame", ITERS)
    for n, sc in (("teddy", scfg), ("2k", scfg2k)):
        l_u, r_u = sframes["Teddy" if n == "teddy" else "2k"]
        e2e[f"sgbm_{n}"] = end_to_end(
            f"SGBM {n}", lambda: psm.stereo_sgbm_forward(l_u, r_u, sc, device=dev),
            sgbm_tags, f"{sc.mode}, D={sc.num_disparities}, speckle filter", ITERS)
    torch.cuda.synchronize()
    peak = {"run": torch.cuda.max_memory_allocated() / 2**30}

    peak["gif_2k_maps"] = peak_gib(lambda: psm.stereo_gif_forward(*frames["2k"], cfg2k,
                                                                  device=dev))
    peak["gif_2k_full"] = peak_gib(lambda: psm.stereo_gif_forward(*frames["2k"], cfg2k_full,
                                                                  device=dev))
    peak["sgbm_2k"] = peak_gib(lambda: psm.stereo_sgbm_forward(*sframes["2k"], scfg2k,
                                                               device=dev))
    log(f"peak device memory (GiB, the resident input frames included): over the run "
        f"{peak['run']:.2f}; one GIF 2K frame on the maps path {peak['gif_2k_maps']:.2f}, with "
        f"tail_fusion='full' {peak['gif_2k_full']:.2f}; one SGBM 2K frame {peak['sgbm_2k']:.2f}")

    rows = []
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    for kname in GIF_KERNELS + SGBM_KERNELS:
        if kname in ("cvc_lowmaps", "cvc_wta"):
            rep, first, at = fused_report, "vga", "zed-vga 376x672 D=64"
        else:
            rep, first, at = (report if kname in GIF_KERNELS else sgbm_report), "teddy", \
                "teddy 375x450 D=64"
        t, k2 = rep[first][kname], rep["2k"][kname]
        row = {
            "name": kname, "route": "cuda",
            "source": f"primestereomatch_torch/csrc/{kname}.cu",
            "replaces": TPU_KERNEL[kname],
            "launches": launches[kname] if kname in GIF_KERNELS else slaunches[kname],
            **{key: t[key] for key in timed}, "library_ms": None, "at": at,
            "at_2k": {key: k2[key] for key in timed},
            "mismatch": {first: t.get("mismatch", t["n_differ"] / t["n"]),
                         "2k": k2.get("mismatch", k2["n_differ"] / k2["n"])},
        }
        if "design" in t:
            row["design"] = {first: t["design"], "2k": k2["design"]}
        if kname in ("lowmaps", "wta"):
            # Teddy at subsample=1: a 17x17 box, and the upsampling ratio 1 that
            # the TPU serves with its generic-ratio kernel
            g = report["teddy_s1"][kname]
            row["at_generic"] = {**{key: g[key] for key in timed},
                                 "mismatch": g.get("mismatch", g["n_differ"] / g["n"]),
                                 **({"design": g["design"]} if "design" in g else {}),
                                 "at": "teddy 375x450 D=64, subsample=1"}
        if kname == "wmf":
            g = report["2k"]["wmf_random"]
            row["at_2k_random"] = {**{key: g[key] for key in timed}, "mismatch": g["mismatch"],
                                   "passes_mean": g["passes_mean"],
                                   "passes_max": g["passes_max"],
                                   "at": "2k, uniformly random disparities over 256 bins"}
            for key, rep_k in (("at", t), ("at_2k", k2)):
                row[f"passes_{key}"] = {"mean": rep_k["passes_mean"], "max": rep_k["passes_max"]}
        if kname in ("sgbm_scan", "select"):
            extra = [key for key in t if key.startswith(("int32_", "bytes_", "tb_", "ring_", "rows8_"))]
            row["more"] = {"teddy": {key: t[key] for key in extra},
                           "2k": {key: k2[key] for key in extra}}
        if kname == "speckle":
            extra = ("device_ms", "hook_plain_ops_ms", "hook_plain_ops_device_ms", "segmin_ms")
            row["more"] = {"teddy": {key: t[key] for key in extra},
                           "2k": {key: k2[key] for key in extra}}
        if kname in GIF_KERNELS:
            row["launches_by_path"] = {p: c.get(kname, 0) for p, c in path_launches.items()}
        rows.append(row)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "kernels": rows, "parity": report, "sgbm_parity": sgbm_report,
        "fused_parity": fused_report, "bp_nonocc": bp, "path_launches": path_launches,
        "e2e": e2e, "medians_2k": med2k, "full_vs_maps_2k": full_vs_maps,
        "sgbm_quality": sgbm_q, "sgbm_per_frame": sper_frame, "sgbm_medians_2k": smed2k,
        "peak_gib": peak, "variants": variants,
        "build_logs": _build.BUILD_LOGS, "build_seconds": build_secs,
        "seconds": time.perf_counter() - t_start,
    }, indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
