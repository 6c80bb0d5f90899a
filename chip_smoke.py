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
     pair (376x672, D=64) and the 2K pair; K3 at 2K on three inputs, the
     WTA output, uniformly random disparities over all 256 bins (the most
     bin-window passes) and the WTA output of a gif_zed2k.clutter pool
     frame (the blocks the ranks cut most), 0 differing pixels required at
     every K3 shape;
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
     and times them; K1's at Teddy and at subsample=1), K6's, K8's and K9's
     launch shapes and their times in the shapes tried (tune_bt_cost.py,
     tune_select.py, tune_speckle.py; K8's from the partials and from the
     int32 S, with the kernel instance's registers from the build log, and
     its device time by the profiler), the speckle hook as the plain-torch
     ops it was before K9 took it in, K3's passes a block (over each
     tile's range and over its ranked levels, at every K3 input timed),
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
  7. calibrated: the ZED HD720 calibration (data/intrinsics.yml,
     data/extrinsics.yml) at HD720 (1280x720 an eye, crop 526x1016, an
     exact stride) and at ZED-VGA (672x376, calib_size 1280x720, crop
     274x530, a quasi width). Raw uint8 frames of a known two-level scene
     (synthetic_pair in rectified coordinates, sampled at each raw pixel's
     rectified coordinates) are rectified on the card by the port's
     Rectifier, the remap bitwise the CPU's on uint8 and float32 and the
     crops asserted; then matched (GIF: K4 -> K2 -> K3 and K10 -> K3 at
     HD720, K1 -> K2 -> K3 at VGA; SGBM: K6-K9), each path with every
     launch count set to 0 just before it and its kernels asserted; depth
     and reprojected points (Q composed with the crop's translation) bitwise
     the CPU's, each region's median disparity within 1 of its level and
     its depth within 2% of f * B / d; each kernel of the paths against its
     plain version at these shapes with the bounds of phase 3; ms by stage
     (rectify, disparity, depth; CUDA events and the host clock), a
     profiler pass per path and peak device memory;
  8. app: the calibrated HD720 video stream through the app layer. 16
     side-by-side raw frames (2560x720, both eyes in one image, the ZED
     layout) of the calibrated scene, one scene seed a frame, written as
     PNGs and decoded by the native runtime where it is built (else the
     Python reader; the live path is printed). Then, each path with every
     launch count set to 0 just before it and its kernels asserted: the
     CLI (`-a STEREO_GIF --frames 16 --pipeline video --source <dir>
     --calib-dir data`, 16 report lines; K4, K2, K3), StereoMatchApp.stream
     and 16 compute() calls, every frame of both bitwise equal to each other
     and to stereo_gif_forward of the Rectifier's output (disparities and
     crops), each region of the field within 1 of its level; SGBM video
     through compute() (K6-K9), bitwise the direct pipeline's canonical
     display; Teddy and Cones in image mode (GIF %BP(nonocc) within 0.3 of
     the reference binary's, SGBM the canonical display of the outputs
     SGBM_SHA256 pins) and a mosaic through --out read back; the 'm' key
     moving the GIF engine to the CPU (no launch, Teddy within 0.3) and
     back (K1, K2, K3); one --timed HD720 frame. Then ms a frame of stream
     and of compute (host clock, 16-frame passes in turns, from the PNG
     files and from the decoded frames in memory), the decode, the upload
     and the fetch (pageable and pinned), a profiler pass over each, peak
     device memory, and ms a frame and a profiler pass of the image-mode
     frames;
  9. sharded (parallel/): the 2K pairs of seeds 0 and 1 (D = 256), rows
     reflected to 1248 (a multiple of s * y). World 1 under NCCL, mesh
     (1, 1, 1), in this process: the sharded GIF step (K4, K2, K3) and
     SGBM step (K6-K9) on the 2 frames, bitwise the direct pipelines. Four
     ranks sharing the card under gloo (collectives of CUDA tensors staged
     through host memory, printed so): meshes (1, 2, 2), (1, 4, 1),
     (1, 1, 4) and (2, 2, 1), with and without JointWMF, launch K1 and K3's
     participation-weight mode and nothing else, and lie within 2e-3 of the
     single-device card output (the count printed) with the field
     recovered; (4, 1, 1) on 4 frames launches K4, K2, K3 and is bitwise.
     Each mesh with every launch count set to 0 just before it and read
     just after, on every rank; ms a frame (host clock, synchronised), the
     halo and merge bytes and host ms a rank, peak device memory a rank.
     The launcher (`python -m primestereomatch_torch.launch local
     --processes 4 --check`) at (1, 2, 2) and (2, 2, 1), at 2208 x 1248,
     D = 256. K1 against its plain version at one rank's extended tile of
     each tiled mesh, and K4, K2, K3 at the 2-frame batch (4 views); K3's
     valid mode against its plain version at the tiled meshes' JointWMF
     tiles (a zero-halo tile of the card's output and a plane of ones, a
     fractional plane, whole windows of zeros, unit blocks mixed with
     fractional ones; 0 pixels required), the share of its blocks on the
     unit path, its ms on three planes beside the valid-less kernel's on
     the same input, both entries' blocks an SM, and the valid-less 2K
     time against PERF.md's;
 10. one JSON line listing the ten TPU kernels' ports (K5 as its own row,
     `wta_generic`: K2's source's per-pixel kernel, launched by the
     subsample=1 path) and K3's valid mode as its own row (`wmf_valid`),
     then the final status JSON line.

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
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import torch

import primestereomatch_torch as psm
import tune_bt_cost
import tune_gif_tail as tune
import tune_select
import tune_speckle
from tune_bt_cost import profiled_ms
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
from primestereomatch_torch.kernels.select import launch_shape as select_launch_shape
from primestereomatch_torch.kernels.speckle import launch_shape as speckle_launch_shape
from primestereomatch_torch.kernels import wta as wta_mod
from primestereomatch_torch.calib import Rectifier, load_stereo_calibration, undistort_points
from primestereomatch_torch.models.gif_pipeline import (
    _to_u8,
    sampled_u8_costs,
    stacked_views,
    view_gradients,
)
from primestereomatch_torch.ops import postproc
from primestereomatch_torch.ops import sgbm as sgbm_ops
from primestereomatch_torch.ops.cost_volume import sampled_cost_volumes
from primestereomatch_torch.ops.depth import disparity_to_depth, reproject_disparity
from primestereomatch_torch.ops.geometry import fused_cvc_applies
from primestereomatch_torch.ops.guided_filter import guide_stats
from primestereomatch_torch.ops.jointwmf import joint_wmf
from primestereomatch_torch.ops.remap import remap_bilinear
from primestereomatch_torch.utils import bad_pixel_metrics, load_dataset
from primestereomatch_torch.utils.png import read_png, write_png

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
    "wta": "primestereomatch_tpu/kernels/wta_pallas.py:298",
    # K5: csrc/wta.cu's per-pixel kernel, which ratios of 2 and below take
    "wta_generic": "primestereomatch_tpu/kernels/wta_pallas.py:80",
    "cvc_lowmaps": "primestereomatch_tpu/kernels/cvc_lowmaps_pallas.py:64",
    "cvc_wta": "primestereomatch_tpu/kernels/cvc_wta_pallas.py:117 and :251",
    "wmf": "primestereomatch_tpu/kernels/wmf_pallas.py:69",
    "wmf_valid": "primestereomatch_tpu/kernels/wmf_pallas.py:69 (has_valid=True, :94-110)",
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
SGBM_TAGS = {"bt_cost_kernel": "bt_cost", "sgm_scan_kernel": "sgbm_scan",
             "select_kernel": "select", "speckle_rows_kernel": "speckle",
             "speckle_cols_kernel": "speckle"}
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


def wmf_passes(disp: torch.Tensor, radius: int, n_bins: int,
               valid: torch.Tensor | None = None) -> dict:
    """K3's passes over the window offsets a block on `disp`, the mean over
    its blocks: with bin windows over each haloed tile's range (the earlier
    design) and over its ranked levels (the kernel's); the share of blocks
    whose passes the ranks cut."""
    spans = K.wmf.range_window_passes(disp, radius, n_bins, valid).double()
    ranked = K.wmf.bin_window_passes(disp, radius, n_bins, valid).double()
    return {"passes_range_mean": float(spans.mean()), "passes_mean": float(ranked.mean()),
            "passes_max": int(ranked.max()),
            "ranks_cut_share": float((ranked < spans).double().mean())}


def passes_text(p: dict) -> str:
    return (f"passes a block {p['passes_range_mean']:.3f} over the range, {p['passes_mean']:.3f} "
            f"ranked (max {p['passes_max']}), the ranks cut {p['ranks_cut_share']:.1%} of blocks")


def clutter_2k(dev, cfg, seed: int = 1):
    """K3's inputs on the first pool frame of the benchmark's
    gif_zed2k.clutter cell at `seed`, as the app hands it to the GIF entry:
    the WTA output of both views (K10, bitwise K4 -> K2) and the uint8
    guide."""
    from portbench import run as bench
    from portbench.traffic.scene import eyes
    from primestereomatch_torch.app import U8_TO_F32

    frame = bench.make_pool(bench.load_cell("gif_zed2k.clutter"), seed, dev)[0]
    left, right = (torch.as_tensor(e, device=dev).float() * U8_TO_F32 for e in eyes(frame))
    views, grds = stacked_views(left[None], right[None], cfg)
    H, W = views.shape[1:3]
    s, k = cfg.subsample, cfg.fgf_low_radius
    stats = guide_stats(views, (H // s, W // s), k, cfg.gif_eps).contiguous()
    disp = K.cvc_wta(views, grds, stats, cfg.max_dis, k, alpha=cfg.alpha,
                     border_cost=cfg.border_cost, tau1=cfg.tau1, tau2=cfg.tau2)
    return disp, _to_u8(views).contiguous()


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

        def wmf_parity(key, disp, guide):
            (med_p, plain_ms) = timed_once(lambda: K.weighted_median_plain(disp, guide, r, D, sig))
            med_k = K.weighted_median(disp, guide, r, D, sig)
            diff = (med_k.int() - med_p.int()).abs()
            frac = float((diff > 0).float().mean())
            row[key] = {"max_abs_err": int(diff.max()), "mismatch": frac,
                        "n_differ": int((diff > 0).sum()), "n": diff.numel(),
                        **wmf_passes(disp, r, D)}
            log(f"parity {name} weighted_median ({key}) (B,H,W) r={r} bins={D}: "
                f"mismatch={frac:.3e} ({row[key]['n_differ']} px) "
                f"max|diff|={row[key]['max_abs_err']} (bounds 1e-3, 1; 0 px required); "
                f"{passes_text(row[key])}")
            if frac > 1e-3 or int(diff.max()) > 1:
                raise AssertionError(f"weighted_median disagrees with its plain version at {name}")
            if row[key]["n_differ"]:
                raise AssertionError(f"weighted_median ({key}) is not bitwise its plain version "
                                     f"at {name}")
            return med_p, plain_ms

        med_p, _ = wmf_parity("wmf", disp_p, g_u8)
        timing["wmf"] = (
            lambda: K.weighted_median(disp_p, g_u8, r, D, sig),
            lambda: K.weighted_median_plain(disp_p, g_u8, r, D, sig),
            bound_wmf(disp_p, med_p, r, D))
        if D > 64:
            # the most bin-window passes: uniformly random disparities over
            # every bin; and the WTA output of a cluttered scene (many depth
            # edges: the blocks the ranks cut most). Their plain versions run
            # once (the parity run is timed)
            rnd = torch.as_tensor(np.random.default_rng(3).integers(
                0, D, tuple(disp_p.shape), dtype=np.uint8), device=dev)
            for key, (d_in, guide) in (("wmf_random", (rnd, g_u8)),
                                       ("wmf_clutter", clutter_2k(dev, cfg))):
                med_r, plain_ms = wmf_parity(key, d_in, guide)
                b_ms, b_by = bound_wmf(d_in, med_r, r, D)
                rr = row[key]
                rr.update(ms=cuda_ms(lambda: K.weighted_median(d_in, guide, r, D, sig)),
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
                log(f"time {name} {key}: kernel {rr['ms']:.4f} ms, plain {rr['plain_ms']:.4f} "
                    f"ms (one run), bound {b_ms:.5f} ms ({b_by}), {b_ms / rr['ms']:.1%} of bound")
            del rnd, d_in, guide, med_r
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
    # K7, the main path's entry: uint16 group partials, each held against
    # its plain group, and summed here on the card only to hold them against
    # the plain int32 S
    parts = K.sgbm_aggregate_partials(cost, cfg.p1, cfg.p2, nd, cost_bound)
    if len(parts) != 2 or any(q.dtype != torch.uint16 for q in parts):
        raise AssertionError(f"expected two uint16 partials at {name}, got "
                             f"{[(q.dtype, tuple(q.shape)) for q in parts]}")
    S = K.sgbm_aggregate_plain(cost, cfg.p1, cfg.p2, nd)
    plain_parts = K.sgbm_aggregate_partials_plain(cost, cfg.p1, cfg.p2, nd, cost_bound)
    check("sgbm_scan", [(sum(q.int() for q in parts), S)] + list(zip(parts, plain_parts)),
          f"(H,W,D)={tuple(S.shape)} {nd} directions, two uint16 partials summed and each "
          f"against its plain group")
    del plain_parts
    # its route and, on the sweeps, their plan: strips, their width, warps,
    # blocks an SM (the cooperative launch's residency); its instances'
    # registers
    k7_route = sgbm_scan.route(cost, nd, cost_bound, cfg.p2)
    row["sgbm_scan"]["design"] = {
        "route": k7_route, **(sgbm_scan.plan(cost)._asdict() if k7_route == "sweeps" else {}),
        **tune.resources(_build.BUILD_LOGS.get("sgbm_scan", ""))}
    log(f"design {name} sgbm_scan: {row['sgbm_scan']['design']}")
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
    # the launch shape of each entry, its instance's registers, and the
    # threads tried (tune_select.py; each bitwise the shipped shape)
    row["select"]["design"] = {}
    for n_partials, costs in ((len(parts), parts), (0, (S,))):
        shape = select_launch_shape(*S.shape, n_partials)
        row["select"]["design"]["int32" if n_partials == 0 else "partials"] = {
            **shape,
            **tune_select.instance_resources(_build.BUILD_LOGS["select"], n_partials, shape),
            "tried_ms": {f"{t} threads": {"ms": ms, "device_ms": dev_ms}
                         for t, (ms, dev_ms) in tune_select.variant_ms(
                             costs, n_partials, sel, disp).items()}}
    log(f"design {name} select: {row['select']['design']}")
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
    # the path families' ring of pixels ahead at four sizes (bytes of shared
    # memory a warp)
    scan, n = row["sgbm_scan"], cost.numel()
    scan["bytes_per_value"] = sgbm_scan.bytes_per_value(nd, cost.element_size(), k7_route)
    scan["tb_per_s"] = n * scan["bytes_per_value"] / scan["ms"] / 1e9
    scan["int32_ms"] = cuda_ms(lambda: K.sgbm_aggregate(cost, cfg.p1, cfg.p2, nd))
    scan["int32_bytes_per_value"] = sgbm_scan.bytes_per_value(nd, cost.element_size(), "int32")
    scan["int32_tb_per_s"] = n * scan["int32_bytes_per_value"] / scan["int32_ms"] / 1e9
    row["select"]["int32_ms"] = cuda_ms(lambda: K.select_disparity(S, *sel))
    row["select"]["device_ms"] = profiled_ms(lambda: K.select_disparity_partials(parts, *sel),
                                             "select_kernel")
    ring = sgbm_scan.RING_BYTES
    scan["ring_ms"] = {}
    for nbytes in (4096, 8192, 16384, 32768):
        sgbm_scan.RING_BYTES = nbytes
        scan["ring_ms"][nbytes] = cuda_ms(
            lambda: K.sgbm_aggregate(cost, cfg.p1, cfg.p2, nd), 10, 2)
    sgbm_scan.RING_BYTES = ring
    # the first 8 image rows alone: what a launch takes besides its rows (the
    # longest path's chain of steps; on the sweeps the W->E chain across the
    # width)
    few = cost[:8].contiguous()
    scan["rows8_ms"] = cuda_ms(
        lambda: K.sgbm_aggregate_partials(few, cfg.p1, cfg.p2, nd, cost_bound))
    log(f"time {name} sgbm_scan moves {scan['bytes_per_value']} B per (pixel, d): "
        f"{scan['tb_per_s']:.3f} TB/s; the int32 S entry {scan['int32_ms']:.4f} ms "
        f"({scan['int32_bytes_per_value']} B, {scan['int32_tb_per_s']:.3f} TB/s); select from "
        f"the int32 S {row['select']['int32_ms']:.4f} ms, from the partials "
        f"{row['select']['device_ms']:.4f} ms of device time (profiler); the int32 entry's "
        f"ring bytes per warp -> ms {dict((k, round(v, 4)) for k, v in scan['ring_ms'].items())} "
        f"(in use: {ring}); the first 8 rows alone {scan['rows8_ms']:.4f} ms")
    report[name] = row


def k7_launches(H: int, W: int, cfg, dev) -> int:
    """K7's launches for an H x W frame of the SGBM pipeline under cfg (three
    channels): one on the sweeps, a path family of each group a launch into
    the uint16 partials, a family a launch into the int32 S."""
    bound = cfg.block_size**2 * 3 * 2 * cfg.pre_filter_cap
    cost = torch.empty((H, W, cfg.num_disparities), device=dev,
                       dtype=torch.int16 if bound < 2**15 else torch.int32)
    nd = cfg.num_directions
    return {"sweeps": 1, "paths": len(sgbm_scan._PATH_LAUNCHES[nd]),
            "int32": len(sgbm_scan._FAMILIES[nd])}[sgbm_scan.route(cost, nd, bound, cfg.p2)]


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

# ---- the calibrated phase ---------------------------------------------------
# one eye's (width, height), the calibration's size (None: the frame's), the
# crop (rows, cols), the known field's levels (foreground, background) and
# the GIF tails whose kernels each geometry drives
CALIB_CASES = {
    "hd720": ((1280, 720), None, (526, 1016), (40, 20),
              {"gif": ("cvc_lowmaps", "wta", "wmf"), "gif_full": ("cvc_wta", "wmf")}),
    "vga": ((672, 376), (1280, 720), (274, 530), (24, 12),
            {"gif": ("lowmaps", "wta", "wmf")}),
}
# the JAX app's uint8 -> float32 scale (primestereomatch_tpu/app.py:249-250):
# a float32 constant multiplied, not a division
U8_TO_F32 = float(np.float32(1 / 255.0))


def calibrated_scene(crop, img_size, levels, seed: int):
    """A known scene in the rectified frame (img_size, one eye): the
    synthetic pair over the whole frame, the foreground rectangle in the
    middle half of the crop box. Returns the pair (float32 BGR in [0, 1])
    and the rectangle in crop coordinates (rows, right-view columns)."""
    x0, y0, x1, y1 = crop
    h, w = y1 - y0, x1 - x0
    rect = (h // 4, 3 * h // 4, w // 3, 2 * w // 3)
    full = (rect[0] + y0, rect[1] + y0, rect[2] + x0, rect[3] + x0)
    return (*synthetic_pair(img_size[1], img_size[0], seed, full, *levels), rect)


def _bilinear(img: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """img (H, W, C) sampled at xy (..., 2) = (x, y), clamped to the edge."""
    H, W = img.shape[:2]
    x = np.clip(xy[..., 0], 0, W - 1)
    y = np.clip(xy[..., 1], 0, H - 1)
    xi = np.minimum(np.floor(x).astype(np.int64), W - 2)
    yi = np.minimum(np.floor(y).astype(np.int64), H - 2)
    fx, fy = (x - xi)[..., None], (y - yi)[..., None]
    return ((img[yi, xi] * (1 - fx) + img[yi, xi + 1] * fx) * (1 - fy)
            + (img[yi + 1, xi] * (1 - fx) + img[yi + 1, xi + 1] * fx) * fy)


def raw_coords(calib: dict, rect, img_size, calib_size) -> list:
    """Each eye's raw pixels' coordinates in the rectified frame of `rect`
    (the Rectifier's StereoRectification): undistort_points with the eye's
    R and P and its default iterations. The camera matrices are rescaled
    to img_size as the Rectifier rescales them."""
    w, h = img_size
    M = [np.asarray(calib[k], np.float64) for k in ("M1", "M2")]
    if calib_size is not None and tuple(calib_size) != tuple(img_size):
        S = np.diag([w / calib_size[0], h / calib_size[1], 1.0])
        M = [S @ m for m in M]
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    uv = np.stack([gx, gy], axis=-1)
    return [undistort_points(uv, m, dist, R=R, P=P)
            for m, dist, R, P in zip(M, (calib["D1"], calib["D2"]), (rect.R1, rect.R2),
                                     (rect.P1, rect.P2))]


def raw_frames(calib: dict, rect, img_size, calib_size, scene, coords=None) -> list:
    """The raw camera frames (uint8 BGR) that see `scene`, a pair in the
    rectified frame of `rect`: each raw pixel of an eye takes the scene's
    bilinear sample at its rectified coordinates (`raw_coords`, or
    `coords` computed by it once for many scenes)."""
    coords = coords or raw_coords(calib, rect, img_size, calib_size)
    return [np.clip(np.rint(_bilinear(view, xy) * 255), 0, 255).astype(np.uint8)
            for view, xy in zip(scene, coords)]


def field_regions(rect, levels, D: int, m: int = 16) -> dict:
    """Interior regions of the known field in the left view (crop
    coordinates), each with its level: the foreground rectangle shifted by
    its disparity, and the background band above it, right of the columns
    without a match."""
    y0, y1, x0, x1 = rect
    d_fg, d_bg = levels
    return {"fg": ((slice(y0 + m, y1 - m), slice(x0 + d_fg + m, x1 + d_fg - m)), d_fg),
            "bg": ((slice(m, y0 - m), slice(D + m, x1 + d_fg)), d_bg)}


def check_field(label: str, disp: np.ndarray, depth: np.ndarray, regions: dict, Q) -> dict:
    """Median disparity of each region within 1 of its level (NaN marks
    invalid pixels), and the median depth of its valid pixels within 2% of
    f * B / d (f = Q[2, 3], B = 1 / |Q[3, 2]|)."""
    out = {}
    for key, (box, want) in regions.items():
        med = float(np.nanmedian(disp[box]))
        dep = depth[box]
        dep_med = float(np.median(dep[dep > 0]))
        want_z = Q[2, 3] / abs(Q[3, 2]) / want
        out[key] = {"median_disparity": med, "level": want, "median_depth": dep_med,
                    "depth_rel_err": abs(dep_med - want_z) / want_z}
        if not abs(med - want) <= 1 or out[key]["depth_rel_err"] > 0.02:
            raise AssertionError(f"{label} {key}: {out[key]} (disparity within 1, depth 2%)")
    return out


def stage_ms(fn) -> dict:
    """ms per call of one stage: CUDA events, the host clock (synchronised)
    and the profiler's device time."""
    return {"events": cuda_ms(fn), "host": frame_ms(fn, ITERS),
            "device": profile_frames(fn, {})["device_ms"]}


def calib_kernel_parity(name: str, pair_u8, cfg, scfg, dev) -> dict:
    """Each kernel of the calibrated paths against its plain version on the
    rectified pair, with the bounds of the earlier phases, the kernel's ms
    (CUDA events), its plain version's ms (one call) and its bound. The
    GIF kernels of the geometry's tails (K4, K10 at an exact stride, else
    K1), K2 and K3; K6-K9."""
    row = {}

    def record(kname, what, got_ms, plain_ms, bnd, **vals):
        row[kname] = {**vals, "ms": got_ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                      "bound_by": bnd[1], "shape": what}
        log(f"calibrated {name} {kname} {what}: {vals}; kernel {got_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (one call), bound {bnd[0]:.5f} ms ({bnd[1]})")

    l_f, r_f = (t.to(torch.float32) * U8_TO_F32 for t in pair_u8)
    views, grds = stacked_views(l_f[None], r_f[None], cfg)
    B2, H, W, _ = views.shape
    s, k, D = cfg.subsample, cfg.fgf_low_radius, cfg.max_dis
    stats = guide_stats(views, (H // s, W // s), k, cfg.gif_eps).contiguous()
    cost = dict(alpha=cfg.alpha, border_cost=cfg.border_cost, tau1=cfg.tau1, tau2=cfg.tau2)

    def maps_check(kname, fk, fp, bnd, what):
        maps_p, plain_ms = timed_once(fp)
        maps_k = fk()
        err = (maps_k - maps_p).abs()
        record(kname, what, cuda_ms(fk), plain_ms, bnd(maps_p), max_abs_err=float(err.max()),
               n_differ=int((err > 0).sum()), n=maps_k.numel())
        if not torch.allclose(maps_k, maps_p, atol=2e-4, rtol=1e-3):
            raise AssertionError(f"{kname} disagrees with its plain version at {name}")
        return maps_k, maps_p

    def disp_check(kname, fk, fp, bnd, what, bound_frac=2e-3):
        disp_p, plain_ms = timed_once(fp)
        disp_k = fk()
        diff = (disp_k.int() - disp_p.int()).abs()
        frac = float((diff > 0).float().mean())
        record(kname, what, cuda_ms(fk), plain_ms, bnd(disp_p), max_abs_err=int(diff.max()),
               mismatch=frac, n_differ=int((diff > 0).sum()), n=diff.numel())
        if frac > bound_frac or (kname != "wmf" and int(disp_k.min()) < 1):
            raise AssertionError(f"{kname} disagrees with its plain version at {name}")
        return disp_k, disp_p

    shape = f"views {(B2, H, W)} D={D}"
    if fused_cvc_applies(W, D, s):
        maps_k, maps_p = maps_check(
            "cvc_lowmaps", lambda: K.cvc_low_maps(views, grds, stats, D, k, **cost),
            lambda: K.cvc_low_maps_plain(views, grds, stats, D, k, **cost),
            lambda _: bound_cvc_lowmaps(views, grds, stats, D, k), shape)
        full_k, _ = disp_check(
            "cvc_wta", lambda: K.cvc_wta(views, grds, stats, D, k, **cost),
            lambda: K.cvc_wta_plain(views, grds, stats, D, k, **cost),
            lambda _: bound_cvc_wta(views, grds, stats, D, k), shape)
        n2 = int((full_k != K.upsample_wta(views, maps_k)).sum())
        row["cvc_wta"]["n_differ_vs_k4_k2"] = n2
        log(f"calibrated {name} cvc_wta vs cvc_lowmaps -> upsample_wta on the card: {n2} px "
            f"differ (0 required)")
        if n2:
            raise AssertionError(f"cvc_wta is not bitwise cvc_lowmaps -> upsample_wta at {name}")
    else:
        p2 = sampled_cost_volumes(views, grds, D, (H // s, W // s), **cost)
        maps_k, maps_p = maps_check(
            "lowmaps", lambda: K.low_maps(p2, stats, k), lambda: K.low_maps_plain(p2, stats, k),
            lambda _: bound_lowmaps(p2, k), f"(B,D,h,w)={tuple(p2.shape)} k={k}")
        del p2
    _, disp_p = disp_check("wta", lambda: K.upsample_wta(views, maps_p),
                           lambda: K.upsample_wta_plain(views, maps_p),
                           lambda _: bound_wta(views, maps_p), f"(B,H,W,D)={(B2, H, W, D)}")
    g_u8 = _to_u8(views).contiguous()
    r, sig = cfg.wmf_radius, cfg.wmf_sigma
    disp_check("wmf", lambda: K.weighted_median(disp_p, g_u8, r, D, sig),
               lambda: K.weighted_median_plain(disp_p, g_u8, r, D, sig),
               lambda med: bound_wmf(disp_p, med, r, D), f"(B,H,W)={(B2, H, W)} r={r} bins={D}",
               bound_frac=0.0)
    row["wmf"].update(wmf_passes(disp_p, r, D))
    log(f"calibrated {name} wmf: {passes_text(row['wmf'])}")
    del views, grds, stats, maps_k, maps_p, disp_p, g_u8
    torch.cuda.empty_cache()

    # SGBM: every stage is integer, so each kernel is held bit for bit
    lf, rf = (sgbm_ops.sobel_xclip(t, scfg.pre_filter_cap) for t in pair_u8)
    D, k, nd = scfg.num_disparities, scfg.block_size, scfg.num_directions
    cost_bound = k * k * lf.shape[2] * 2 * scfg.pre_filter_cap
    sel = (scfg.uniqueness_ratio, scfg.disp12_max_diff, scfg.min_disparity)

    def exact(kname, fk, fp, bnd, what, reduce=lambda x: x):
        want, plain_ms = timed_once(fp)
        got = fk()
        diff = (reduce(got).to(torch.int64) - want.to(torch.int64)).abs()
        record(kname, what, cuda_ms(fk), plain_ms, bnd(want), max_abs_err=int(diff.max()),
               n_differ=int((diff > 0).sum()), n=diff.numel())
        if row[kname]["n_differ"]:
            raise AssertionError(f"{kname} disagrees with its plain version at {name}")
        return got, want

    what = f"(H,W,D)={(H, W, D)}"
    c, _ = exact("bt_cost", lambda: K.bt_cost(lf, rf, D, k, cost_bound),
                 lambda: K.bt_cost_plain(lf, rf, D, k, cost_bound),
                 lambda want: bound_bt_cost(lf, want), what + f" k={k}")
    parts, S = exact("sgbm_scan",
                     lambda: K.sgbm_aggregate_partials(c, scfg.p1, scfg.p2, nd, cost_bound),
                     lambda: K.sgbm_aggregate_plain(c, scfg.p1, scfg.p2, nd),
                     lambda _: bound_scan(c, nd),
                     what + f" {nd} directions, two uint16 partials summed",
                     reduce=lambda q: sum(x.int() for x in q))
    disp, _ = exact("select", lambda: K.select_disparity_partials(parts, *sel),
                    lambda: K.select_disparity_plain(S, *sel), lambda _: bound_select(S.shape),
                    what + " from the partials")
    if len(parts) != 2:
        raise AssertionError(f"expected two uint16 partials at {name}, got {len(parts)}")
    del c, parts, S
    _, labels, conns = sgbm_ops.speckle_graph(disp, 16 * scfg.speckle_range,
                                              (scfg.min_disparity - 1) * 16)
    links = K.pack_links(*conns)
    exact("speckle", lambda: K.speckle_sweep(labels, links),
          lambda: K.speckle_sweep_plain(labels, links), lambda _: bound_sweep(labels),
          f"(H,W)={tuple(labels.shape)} one sweep")
    torch.cuda.empty_cache()
    return row


def calibrated(dev, smi) -> dict:
    """The calibrated phase: the ZED HD720 calibration (data/intrinsics.yml,
    data/extrinsics.yml) at HD720 and at ZED-VGA (calib_size 1280x720).
    Raw frames of a known scene are rectified on the card (the remap bitwise
    the CPU's, the crop asserted), matched by STEREO_GIF on each of the
    geometry's tails and by STEREO_SGBM, each path with every launch count
    set to 0 just before it and read just after and its kernels asserted,
    and turned into depth (bitwise the CPU's; each region's disparity within
    1 of its level and its depth within 2% of f * B / d). Then each kernel
    of the paths against its plain version at these shapes, ms by stage
    (CUDA events, the host clock, the profiler's device time), a profiler
    pass per path and peak device memory."""
    calib = load_stereo_calibration(str(ROOT / "data" / "intrinsics.yml"),
                                    str(ROOT / "data" / "extrinsics.yml"))
    cfg, scfg = psm.GIFConfig(), psm.SGBMConfig()
    cfgs = {"gif": cfg, "gif_full": psm.GIFConfig(tail_fusion="full")}
    out: dict = {"launches": {}}
    for name, (size, calib_size, crop_hw, levels, gif_routes) in CALIB_CASES.items():
        rec = Rectifier(calib, size, calib_size=calib_size, device=dev)
        x0, y0, x1, y1 = rec.crop
        if (y1 - y0, x1 - x0) != crop_hw:
            raise AssertionError(f"{name}: crop {rec.crop} is not {crop_hw}")
        Q = rec.rect.Q
        # Q of the crop's coordinates: (x, y) of the crop are (x + x0, y + y0)
        Q_crop = Q @ np.array([[1, 0, 0, x0], [0, 1, 0, y0], [0, 0, 1, 0], [0, 0, 0, 1]],
                              np.float64)
        scene_l, scene_r, rect = calibrated_scene(rec.crop, size, levels, 5)
        raw_np = raw_frames(calib, rec.rect, size, calib_size, (scene_l, scene_r))
        raw = tuple(torch.as_tensor(a, device=dev) for a in raw_np)     # uploaded once
        res: dict = {"crop": list(rec.crop), "crop_hw": list(crop_hw), "card": smi}

        # the Rectifier on the card against the plain remap on the CPU, uint8
        # and float32
        pair = rec(*raw)
        cpu_maps = [m[y0:y1, x0:x1].cpu() for m in (rec.map_l, rec.map_r)]
        n_u8 = sum(int((g.cpu() != remap_bilinear(torch.from_numpy(a), m)).sum())
                   for g, a, m in zip(pair, raw_np, cpu_maps))
        raw_f = [torch.from_numpy(a).to(torch.float32) * U8_TO_F32 for a in raw_np]
        n_f32 = sum(int((g.cpu() != remap_bilinear(f, m)).sum())
                    for g, f, m in zip(rec(*(f.to(dev) for f in raw_f)), raw_f, cpu_maps))
        scene_err = float(np.abs(pair[0].cpu().numpy() / 255.0 - scene_l[y0:y1, x0:x1]).mean())
        res["remap_mismatch"] = {"u8": n_u8, "f32": n_f32}
        log(f"calibrated {name}: raw {size[0]}x{size[1]} (calib_size {calib_size}) -> crop "
            f"{rec.crop} = {crop_hw}; remap card vs CPU: {n_u8} uint8 and {n_f32} float32 values "
            f"differ (0 required); rectified left vs the scene: mean |diff| {scene_err:.4f}")
        if n_u8 or n_f32 or tuple(pair[0].shape) != (*crop_hw, 3):
            raise AssertionError(f"{name}: the remap on the card is not the CPU's")

        def drive(label, expect, run):
            torch.cuda.synchronize()
            K.reset_launches()
            got = run()
            torch.cuda.synchronize()
            counts = {k: v for k, v in _build.LAUNCHES.items() if v}
            log(f"calibrated main path {name} {label}: launches {counts}")
            if set(counts) != set(expect):
                raise AssertionError(f"{name} {label} launched {counts}, expected exactly "
                                     f"{expect}")
            out["launches"][f"{name}_{label}"] = counts
            return got

        def gif_disp(lr, c):
            return psm.stereo_gif_forward(lr[0].to(torch.float32) * U8_TO_F32,
                                          lr[1].to(torch.float32) * U8_TO_F32, c, device=dev)

        def sgbm_disp(lr):
            return psm.stereo_sgbm_forward(*lr, scfg, device=dev).to(torch.float32) * (
                1 / sgbm_ops.DISP_SCALE)

        paths = {key: (lambda lr, c=cfgs[key]: gif_disp(lr, c)[0], gif_routes[key])
                 for key in gif_routes}
        paths["sgbm"] = (sgbm_disp, SGBM_KERNELS)
        regions = field_regions(rect, levels, cfg.max_dis)
        res["paths"] = {}
        for key, (disp_fn, expect) in paths.items():
            def frame(disp_fn=disp_fn):
                d = disp_fn(rec(*raw))
                return d, disparity_to_depth(d, Q)

            d, z = drive(key, expect, frame)
            d_cpu = d.cpu()
            n_z = int((z.cpu() != disparity_to_depth(d_cpu, Q)).sum())
            pts = reproject_disparity(d, Q_crop)
            n_p = int((pts.cpu() != reproject_disparity(d_cpu, Q_crop)).sum())
            disp_np = d_cpu.numpy().astype(np.float64)
            disp_np[disp_np <= 0] = np.nan
            field = check_field(f"{name} {key}", disp_np, z.cpu().numpy(), regions, Q)
            log(f"calibrated {name} {key}: depth card vs CPU {n_z} values differ, reprojected "
                f"points {n_p} (0 required); regions {field}")
            if n_z or n_p:
                raise AssertionError(f"{name} {key}: depth on the card is not the CPU's")
            # ms by stage (the rectify stage is the same for every path of a
            # geometry): CUDA events, the host clock and the profiler's device
            # time, inputs on the card
            lr = rec(*raw)
            stages = {"disparity": lambda: disp_fn(lr), "depth": lambda: disparity_to_depth(d, Q)}
            if "rectify" not in res:
                res["rectify"] = stage_ms(lambda: rec(*raw))
                # beside it, in this call: remap_bilinear op by op on each
                # eye's crop of the maps (the taps recomputed every frame)
                crop_maps = [m[y0:y1, x0:x1] for m in (rec.map_l, rec.map_r)]
                res["rectify_op_by_op"] = stage_ms(
                    lambda: [remap_bilinear(t, m) for t, m in zip(raw, crop_maps)])
                log(f"calibrated {name}: rectify (events / host / device) "
                    f"{tuple(round(x, 4) for x in res['rectify'].values())} ms, remap_bilinear "
                    f"op by op {tuple(round(x, 4) for x in res['rectify_op_by_op'].values())} ms")
            ms = {"rectify": res["rectify"], **{st: stage_ms(fn) for st, fn in stages.items()}}
            e2e = end_to_end(f"calibrated {name} {key}", frame, {**GIF_TAGS, **SGBM_TAGS},
                             "raw uint8 pair on the card -> rectify -> disparity -> depth",
                             ITERS)
            res["paths"][key] = {"field": field, "ms_by_stage": ms, "e2e": e2e,
                                 "peak_gib": peak_gib(frame), "launches": out["launches"][
                                     f"{name}_{key}"]}
            log(f"calibrated {name} {key}: ms by stage (events / host / device) "
                f"{ {st: tuple(round(x, 4) for x in v.values()) for st, v in ms.items()} }, "
                f"frame {e2e['ms_per_frame']:.3f} ms, peak "
                f"{res['paths'][key]['peak_gib']:.3f} GiB ({smi})")
            del d, z, pts, lr
        res["kernels"] = calib_kernel_parity(name, pair, cfg, scfg, dev)
        out[name] = res
        del raw, pair
        torch.cuda.empty_cache()
    return out


# ---- the app phase ------------------------------------------------------------
# the HD720 video stream through the app layer: APP_FRAMES side-by-side raw
# frames of the calibrated scene, one scene seed a frame
APP_FRAMES = 16
APP_SEED = 5


def app_frames(frame_dir: pathlib.Path, calib: dict, rec, size, calib_size, levels) -> list:
    """Write APP_FRAMES side-by-side raw frames (both eyes in one image, the
    ZED layout that SideBySideFileSource splits) of the calibrated scene,
    seeds APP_SEED.., as PNGs (utils/png.py::write_png) into `frame_dir`, on
    8 host threads. Returns the paths and the field's rectangle."""
    coords = raw_coords(calib, rec.rect, size, calib_size)

    def make(i):
        scene_l, scene_r, rect = calibrated_scene(rec.crop, size, levels, APP_SEED + i)
        raw = raw_frames(calib, rec.rect, size, calib_size, (scene_l, scene_r), coords)
        path = frame_dir / f"frame_{i:04d}.png"
        write_png(str(path), np.concatenate(raw, axis=1))
        return path, rect

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        made = list(ex.map(make, range(APP_FRAMES)))
    return [p for p, _ in made], made[0][1]


def transfer_ms(dev, pair: np.ndarray, outs: list) -> dict:
    """ms a frame of the stream's copies at these shapes: the raw pair's
    upload and the fetch of the disparities and crops, from pageable memory
    (the host clock: such a copy blocks the host) and through pinned
    buffers with non_blocking=True (CUDA events: the copies' device time),
    and the host's copies into and out of the pinned slots that stream()
    makes (the host clock)."""
    pinned = torch.from_numpy(pair).pin_memory()
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs]
    return {
        "upload_pageable_host": frame_ms(lambda: torch.from_numpy(pair).to(dev), ITERS),
        "upload_pinned_device": cuda_ms(lambda: pinned.to(dev, non_blocking=True)),
        "stage_into_pinned_host": frame_ms(lambda: pinned.copy_(torch.from_numpy(pair)), ITERS),
        "fetch_pageable_host": frame_ms(lambda: [t.cpu() for t in outs], ITERS),
        "fetch_pinned_device": cuda_ms(
            lambda: [h.copy_(t, non_blocking=True) for h, t in zip(hosts, outs)]),
        "copy_out_of_pinned_host": frame_ms(lambda: [h.clone().numpy() for h in hosts], ITERS),
    }


def app_phase(dev, smi) -> dict:
    """The app phase: the calibrated ZED HD720 video stream through the app
    layer. 16 side-by-side raw frames (2560x720) of the calibrated scene are
    decoded (the native runtime where it is built, else utils/png.py),
    rectified and matched through the CLI (`--pipeline`), through
    StereoMatchApp.stream() and compute(), each frame bitwise equal across
    the three and to stereo_gif_forward of the Rectifier's output, the
    field's regions within 1; SGBM video through compute(); Teddy and Cones
    in image mode (GIF %BP(nonocc), the SGBM outputs that SGBM_SHA256 pins,
    a mosaic through --out); the 'm' key's card <-> CPU round trip; one
    timed frame. Every path with its launch counts set to 0 just before it
    and its kernels asserted. Then stream and compute ms a frame side by
    side, decode, upload and fetch ms, a profiler pass and peak memory."""
    import contextlib
    import io
    import shutil

    from primestereomatch_torch import cli, hci, native
    from primestereomatch_torch.app import AppConfig, StereoMatchApp
    from primestereomatch_torch.hci import KeyLoop
    from primestereomatch_torch.utils.video import SideBySideFileSource, read_image

    calib = load_stereo_calibration(str(ROOT / "data" / "intrinsics.yml"),
                                    str(ROOT / "data" / "extrinsics.yml"))
    size, calib_size, crop_hw, levels, routes = CALIB_CASES["hd720"]
    k_gif, k123 = routes["gif"], ("lowmaps", "wta", "wmf")
    rec = Rectifier(calib, size, calib_size=calib_size, device=dev)
    cfg, scfg = psm.GIFConfig(), psm.SGBMConfig()
    out: dict = {"card": smi, "launches": {}, "native_available": native.native_available()}
    frame_dir = ROOT / "chiprun_out" / "app_hd720_frames"     # ~80 MB: removed at the end
    shutil.rmtree(frame_dir, ignore_errors=True)
    frame_dir.mkdir(parents=True)
    saved_reader = hci._stdin_reader
    # the key loop of every CLI run reads no keys: the run does not depend on stdin
    hci._stdin_reader = lambda: ""

    def drive(label, expect, run):
        torch.cuda.synchronize()
        K.reset_launches()
        got = run()
        torch.cuda.synchronize()
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        log(f"app main path {label}: launches {counts}")
        if set(counts) != set(expect):
            raise AssertionError(f"app {label} launched {counts}, expected exactly {expect}")
        out["launches"][label] = counts
        return got

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("frame ")]
        return rc, lines

    def video_app(alg="STEREO_GIF", **kw):
        return StereoMatchApp(AppConfig(alg=alg, media_mode="video",
                                        video_source=str(frame_dir),
                                        calib_dir=str(ROOT / "data"), mask_mode="none", **kw))

    try:
        t0 = time.perf_counter()
        paths, rect = app_frames(frame_dir, calib, rec, size, calib_size, levels)
        log(f"app: wrote {len(paths)} side-by-side HD720 raw frames (2560x720) in "
            f"{time.perf_counter() - t0:.1f} s")

        # the decode path: the prefetching source over every frame, and one
        # decode after another
        t0 = time.perf_counter()
        host = list(SideBySideFileSource(str(frame_dir)))
        prefetch_ms = (time.perf_counter() - t0) * 1e3 / len(host)
        t0 = time.perf_counter()
        for p in paths:
            read_image(str(p))
        seq_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
        t0 = time.perf_counter()
        read_png(str(paths[0]), 3)
        py_ms = (time.perf_counter() - t0) * 1e3
        path_name = ("native (libpng, prefetching threads)" if out["native_available"]
                     else "Python (utils/png.py)")
        out["decode_ms"] = {"source": prefetch_ms, "sequential": seq_ms, "python_reader": py_ms}
        log(f"app: decode path {path_name}: {prefetch_ms:.2f} ms a frame through "
            f"SideBySideFileSource, {seq_ms:.2f} one after another, the Python reader "
            f"{py_ms:.2f} ms a frame")
        if len(host) != APP_FRAMES or host[0][0].shape != (size[1], size[0], 3):
            raise AssertionError(f"decoded {len(host)} frames of {host[0][0].shape}")

        # the video stream through the CLI
        rc, lines = drive("cli_video_stream", k_gif, lambda: run_cli(
            ["-a", "STEREO_GIF", "--frames", str(APP_FRAMES), "--pipeline", "video",
             "--source", str(frame_dir), "--calib-dir", str(ROOT / "data")]))
        log(f"app: python -m primestereomatch_torch ... video --pipeline: rc {rc}, "
            f"{len(lines)} report lines; first '{lines[0] if lines else ''}'")
        if rc != 0 or len(lines) != APP_FRAMES:
            raise AssertionError(f"the CLI returned {rc} with {len(lines)} report lines")

        # stream() and compute() against each other and the direct pipeline
        sa, ca = video_app(), video_app()
        streamed = drive("stream", k_gif, lambda: list(sa.stream(APP_FRAMES)))
        computed = drive("compute", k_gif, lambda: [ca.compute() for _ in range(APP_FRAMES)])
        regions = field_regions(rect, levels, cfg.max_dis)
        fields = []
        for i, (s, c) in enumerate(zip(streamed, computed, strict=True)):
            sbs = torch.from_numpy(read_image(str(paths[i]))).to(dev)
            l8, r8 = rec(sbs[:, :size[0]].contiguous(), sbs[:, size[0]:].contiguous())
            ld, rd = psm.stereo_gif_forward(l8.to(torch.float32) * U8_TO_F32,
                                            r8.to(torch.float32) * U8_TO_F32, cfg, device=dev)
            want = (ld.cpu().numpy(), rd.cpu().numpy(), l8.cpu().numpy(), r8.cpu().numpy())
            for key, w in zip(("l_disp", "r_disp", "left_bgr", "right_bgr"), want):
                if not (np.array_equal(getattr(s, key), w)
                        and np.array_equal(getattr(c, key), w)):
                    raise AssertionError(f"app frame {i} {key}: stream, compute and the direct "
                                         f"pipeline differ")
            disp = s.l_disp.astype(np.float64)
            disp[disp <= 0] = np.nan
            z = disparity_to_depth(torch.from_numpy(s.l_disp), rec.rect.Q).numpy()
            fields.append(check_field(f"app frame {i}", disp, z, regions, rec.rect.Q))
        out["field"] = fields
        log(f"app: {APP_FRAMES} HD720 frames, stream == compute == Rectifier -> "
            f"stereo_gif_forward bit for bit (disparities and crops {crop_hw}); regions of "
            f"every frame within 1 of {levels}: frame 0 {fields[0]}")

        # SGBM video through compute()
        sg = video_app("STEREO_SGBM")
        sres = drive("sgbm_compute", SGBM_KERNELS, lambda: [sg.compute() for _ in range(4)])
        for i, r in enumerate(sres):
            sbs = torch.from_numpy(read_image(str(paths[i]))).to(dev)
            l8, r8 = rec(sbs[:, :size[0]].contiguous(), sbs[:, size[0]:].contiguous())
            want = psm.sgbm_display_u8(psm.stereo_sgbm_forward(l8, r8, scfg, device=dev), 1,
                                       cfg.max_dis).cpu().numpy()
            if not np.array_equal(r.l_disp, want):
                raise AssertionError(f"app SGBM frame {i} differs from the direct pipeline")
        log("app: SGBM video, 4 HD720 frames through compute(): l_disp bitwise "
            "sgbm_display_u8(stereo_sgbm_forward(crop), 1, 64)")

        # image mode: Teddy and Cones
        out["image"] = {}
        for name in GOLDEN_NONOCC:
            ga = StereoMatchApp(AppConfig(alg="STEREO_GIF", media_mode="image", dataset=name))
            bp = drive(f"image_{name}_gif", k123, ga.compute).metrics.percent_bad_pixels
            sga = StereoMatchApp(AppConfig(alg="STEREO_SGBM", media_mode="image", dataset=name))
            got = drive(f"image_{name}_sgbm", SGBM_KERNELS, sga.compute).l_disp
            s = ga._sample
            d16 = psm.stereo_sgbm_forward(s.left_bgr, s.right_bgr, scfg, device=dev)
            digest = hashlib.sha256(d16.cpu().numpy().tobytes()).hexdigest()
            same = np.array_equal(got, psm.sgbm_display_u8(d16, 1, 64).cpu().numpy())
            out["image"][name] = {"gif_bp_nonocc": bp, "sgbm_equal": same, "e2e": {
                "gif": end_to_end(f"app image {name} GIF", ga.compute, GIF_TAGS,
                                  "StereoMatchApp.compute: upload, K1 -> K2 -> K3, fetch, %BP",
                                  ITERS),
                "sgbm": end_to_end(f"app image {name} SGBM", sga.compute, SGBM_TAGS,
                                   "StereoMatchApp.compute: upload, K6-K9, display, fetch, %BP",
                                   ITERS)}}
            log(f"app image {name}: GIF %BP(nonocc) {bp:.3f} (reference {GOLDEN_NONOCC[name]}, "
                f"+-0.3); SGBM l_disp equals the canonical display of the output pinned by "
                f"SGBM_SHA256: {same and digest == SGBM_SHA256[name]}")
            if abs(bp - GOLDEN_NONOCC[name]) > 0.3 or not same or digest != SGBM_SHA256[name]:
                raise AssertionError(f"app image {name}: {out['image'][name]}")
        mosaic_dir = ROOT / "chiprun_out" / "app_mosaic"
        rc, lines = run_cli(["-a", "STEREO_GIF", "--out", str(mosaic_dir), "image",
                             "--dataset", "Teddy"])
        mosaic = read_png(str(mosaic_dir / "frame_0000.png"), 3)
        teddy = load_dataset("Teddy")
        log(f"app: --out wrote {mosaic_dir.name}/frame_0000.png {mosaic.shape}: '{lines[0]}'")
        if rc or mosaic.shape != (750, 1350, 3) or not np.array_equal(mosaic[:375, :450],
                                                                      teddy.left_bgr):
            raise AssertionError(f"the --out mosaic is {mosaic.shape}, rc {rc}")

        # the 'm' key: the GIF engine to the CPU (no kernel) and back
        ka = StereoMatchApp(AppConfig(alg="STEREO_GIF", media_mode="image", dataset="Teddy"))
        msgs, feed = [], ["m"]
        keys = KeyLoop(ka, reader=lambda: feed.pop(0) if feed else "", echo=msgs.append)
        keys.pump()
        t0 = time.perf_counter()
        bp_cpu = drive("keys_m_cpu", (), ka.compute).metrics.percent_bad_pixels
        cpu_s = time.perf_counter() - t0
        feed.append("m")
        keys.pump()
        bp_card = drive("keys_m_card", k123, ka.compute).metrics.percent_bad_pixels
        out["keys"] = {"messages": msgs, "bp_cpu": bp_cpu, "bp_card": bp_card,
                       "cpu_frame_s": cpu_s, "cpu_threads": torch.get_num_threads()}
        log(f"app keys: {msgs}; Teddy on the CPU %BP(nonocc) {bp_cpu:.3f} in {cpu_s:.2f} s "
            f"({torch.get_num_threads()} threads), back on the card {bp_card:.3f}")
        if (ka.gif_device.type != "cuda" or abs(bp_cpu - GOLDEN_NONOCC["Teddy"]) > 0.3
                or abs(bp_card - GOLDEN_NONOCC["Teddy"]) > 0.3):
            raise AssertionError(f"the 'm' round trip: {out['keys']}")

        # one timed HD720 frame: DispEst's stages (plain torch; K3 in PP)
        ta = video_app(timed=True)
        timed = drive("timed", ("wmf",), ta.compute).times_ms
        out["timed_ms"] = timed
        log(f"app: one --timed HD720 frame, ms by stage (CUDA events to a synchronisation) "
            f"{ {k: round(v, 3) for k, v in timed.items()} }")

        # ms a frame of stream and of compute, side by side in turns, each pass
        # from a fresh source: the PNG files (decode threads started inside the
        # pass) and the decoded frames in memory (a camera's raw frames)
        sources = {"files": lambda: SideBySideFileSource(str(frame_dir)),
                   "memory": lambda: iter(host)}

        def app_pass(kind, src):
            def run():
                a = sa if kind == "stream" else ca
                a._source = sources[src]()
                if kind == "stream":
                    return list(a.stream(APP_FRAMES))
                return [a.compute() for _ in range(APP_FRAMES)]
            return run

        # host-bound passes spread by ~20% between passes: 4 rounds from memory
        rounds = {"files": 1, "memory": 4}
        passes = {f"{k}_{src}": [] for src in sources for k in ("stream", "compute")}
        for src in sources:
            for kind in ("stream", "compute", "compute", "stream") * rounds[src]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                app_pass(kind, src)()
                passes[f"{kind}_{src}"].append((time.perf_counter() - t0) * 1e3 / APP_FRAMES)
        ms = {k: float(np.mean(v)) for k, v in passes.items()}
        pair = np.stack([host[0][0], host[0][1]])
        res_t = [torch.from_numpy(x).to(dev) for x in (computed[0].l_disp, computed[0].r_disp,
                                                         np.stack([computed[0].left_bgr,
                                                                   computed[0].right_bgr]))]
        copies = transfer_ms(dev, pair, res_t)
        prof = {key: profile_frames(app_pass(*key.split("_")), GIF_TAGS, frames=2)
                for key in ("stream_memory", "compute_memory", "stream_files")}
        for p in prof.values():     # a call is APP_FRAMES frames
            for key in ("wall_ms", "device_ms", "device_ops_per_frame"):
                p[key] /= APP_FRAMES
            p["device_ms_by_kernel"] = {k: v / APP_FRAMES
                                        for k, v in p["device_ms_by_kernel"].items()}
        peak = {k: peak_gib(app_pass(k, "memory")) for k in ("stream", "compute")}
        out.update(ms_per_frame=ms, passes=passes, copies_ms=copies, profile=prof,
                   peak_gib=peak)
        for src in sources:
            st, co = passes[f"stream_{src}"], passes[f"compute_{src}"]
            log(f"app HD720 ms a frame from {src} (host clock, 16-frame passes in turns stream, "
                f"compute, compute, stream): stream mean {np.mean(st):.3f} median "
                f"{np.median(st):.3f} {[round(x, 3) for x in st]}, compute mean {np.mean(co):.3f} "
                f"median {np.median(co):.3f} {[round(x, 3) for x in co]} ({smi})")
        log(f"app HD720 copies ms a frame: upload of the raw pair (2x720x1280x3 uint8) pageable "
            f"{copies['upload_pageable_host']:.3f} (host), pinned {copies['upload_pinned_device']:.3f}"
            f" (device); fetch of the disparities and crops pageable "
            f"{copies['fetch_pageable_host']:.3f} (host), pinned "
            f"{copies['fetch_pinned_device']:.3f} (device); the host's copies into the pinned "
            f"slot {copies['stage_into_pinned_host']:.3f} and out of the result slots "
            f"{copies['copy_out_of_pinned_host']:.3f}")
        for k, p in prof.items():
            by = ", ".join(f"{t} {v:.3f}" for t, v in p["device_ms_by_kernel"].items())
            log(f"app profile {k}: wall {p['wall_ms']:.3f} ms a frame under the profiler, device "
                f"{p['device_ms']:.3f} ms ({by}), idle share {p['idle_share']:.1%}, "
                f"{p['device_ops_per_frame']:.0f} device ops a frame")
        log(f"app peak device memory of a 16-frame pass from memory: stream {peak['stream']:.3f} "
            f"GiB, compute {peak['compute']:.3f} GiB")
    finally:
        hci._stdin_reader = saved_reader
        shutil.rmtree(frame_dir, ignore_errors=True)
    return out


H_SHARD = 1248    # the 2K frame's rows reflected to a multiple of s * y for y up to 4
# the sharded phase's meshes of four ranks sharing the card: name -> ((b, y, d), frames)
SHARD_MESHES = {"1x2x2": ((1, 2, 2), 2), "1x4x1": ((1, 4, 1), 2), "1x1x4": ((1, 1, 4), 2),
                "2x2x1": ((2, 2, 1), 2), "4x1x1": ((4, 1, 1), 4)}
SHARD_RANKS = 4
SHARD_TIMED = 2    # timed steps a mesh, after the counted one
# the rank whose extended tile K1 is held at, (y index, d index) a tiled
# mesh: a bottom, an interior, a whole-frame and a top tile
TILE_RANKS = {"1x2x2": (1, 1), "1x4x1": (1, 0), "1x1x4": (0, 2), "2x2x1": (0, 0)}
# K3's participation-weight mode at the extended JointWMF tiles of the tiled
# meshes (views, rows, columns): 2 frames a rank at y = 2 (the kernels line's
# shape), y = 4, y = 1 (d = 4), and 1 frame a rank at b = 2, y = 2
WMF_TILES = {"y2": (4, 624 + 18, W2K), "y4": (4, 312 + 18, W2K), "y1": (4, 1248 + 18, W2K),
             "b2y2": (2, 624 + 18, W2K)}


def bound_wmf_valid(disp: torch.Tensor, out: torch.Tensor, valid: torch.Tensor, radius: int,
                    n_bins: int):
    """`bound_wmf` with a participation plane: only neighbours of nonzero
    weight take work (this run's data), one multiply more a pair where the
    weight is neither 0 nor 1 (times 1 a weight is itself), and the
    plane's 4 bytes a pixel read."""
    B, H, W = disp.shape

    def cover(n):   # windows that hold each position along one axis
        i = np.arange(n)
        return (np.minimum(i + radius, n - 1) - np.maximum(i - radius, 0) + 1).astype(np.float64)

    def pairs(at):   # window pairs whose neighbour is `at` (B, H, W), summed
        return float(cover(H) @ at.double().sum(dim=0).cpu().numpy() @ cover(W))

    scan = B * H * W * n_bins + 2 * int(out.to(torch.int64).add(1).sum())
    return bound(9 * B * H * W, 11 * pairs(valid != 0) + pairs((valid != 0) & (valid != 1))
                 + scan)


def sharded_frames():
    """The seeded 2K pairs of seeds 0 and 1 (synthetic_2k), their rows
    reflected from 1242 to H_SHARD (the pad `make_sharded_gif` asks of a
    tiled mesh). Returns (2, H_SHARD, W, 3) left and right, float32, and
    the field's rectangle."""
    pairs = [synthetic_2k(seed) for seed in (0, 1)]
    pad = ((0, H_SHARD - H2K), (0, 0), (0, 0))
    left, right = (np.stack([np.pad(p[v], pad, mode="reflect") for p in pairs]) for v in (0, 1))
    return left, right, pairs[0][2]


def _launched() -> dict:
    return {k: v for k, v in _build.LAUNCHES.items() if v}


def sharded_rank(rank: int, port: int, work: str) -> None:
    """One of SHARD_RANKS ranks sharing the card (gloo; collectives of CUDA
    tensors staged through host memory): every mesh of SHARD_MESHES on the
    same global batch (the frames the parent wrote to `work`), tiled meshes
    with and without JointWMF. Per mesh it writes its block, its launches
    (counts set to 0 just before the counted step, read just after), the
    bytes and host time of its halos and merges, its peak device memory and
    the wall ms of SHARD_TIMED more steps (all ranks between barriers)."""
    import torch.distributed as dist

    from primestereomatch_torch.parallel import MeshPlan, make_mesh, make_sharded_gif
    from primestereomatch_torch.parallel import sharded as sh
    from primestereomatch_torch.parallel.launch import initialize

    backend = initialize(f"localhost:{port}", SHARD_RANKS, rank)
    dev = torch.device("cuda", torch.cuda.current_device())
    frames = np.load(pathlib.Path(work) / "frames.npz")
    cfg = psm.GIFConfig(max_dis=256)
    out: dict = {"backend": backend}
    try:
        for name, (plan, n_frames) in SHARD_MESHES.items():
            batch = [torch.as_tensor(np.concatenate([frames[v]] * (n_frames // 2)), device=dev)
                     for v in ("left", "right")]
            mesh = make_mesh(MeshPlan(*plan))
            tiled = plan[1] > 1 or plan[2] > 1
            for pp in ((True, False) if tiled else (True,)):
                step = make_sharded_gif(mesh, cfg, pp)
                torch.cuda.synchronize()
                dist.barrier()
                torch.cuda.reset_peak_memory_stats()
                K.reset_launches()
                sh.reset_comm()
                lo, ro, (bsl, rows) = step(*batch)
                torch.cuda.synchronize()
                res = {"launches": _launched(), "comm": dict(sh.COMM),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "block": (lo.cpu().numpy(), ro.cpu().numpy()),
                       "index": (bsl.start, bsl.stop, rows.start, rows.stop)}
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(SHARD_TIMED):
                    step(*batch)
                torch.cuda.synchronize()
                dist.barrier()
                res["ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / (SHARD_TIMED * n_frames)
                out[name + ("" if pp else "_no_pp")] = res
            del batch
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(pathlib.Path(work) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _assemble(ranks: list, key: str, B: int) -> list:
    """The global (B, H_SHARD, W) outputs of a mesh from the ranks' blocks;
    the ranks of one block must agree."""
    outs = [np.full((B, H_SHARD, W2K), -1, np.int32) for _ in range(2)]
    for res in ranks:
        b0, b1, y0, y1 = res[key]["index"]
        for o, blk in zip(outs, res[key]["block"]):
            seen = o[b0:b1, y0:y1]
            if not ((seen == -1) | (seen == blk)).all():
                raise AssertionError(f"sharded {key}: ranks of one block disagree")
            o[b0:b1, y0:y1] = blk
    if not all((o >= 0).all() for o in outs):
        raise AssertionError(f"sharded {key}: a block no rank returned")
    return outs


# single values near 1 (and -0) that a unit tile of the `mixed` plane holds
NEAR_ONE = (0.99999994, 1.0000001, -0.0)
WMF_PLANES = ("zero_halos", "ones", "fractional", "zero_windows", "mixed")


def wmf_valid_planes(dev, ref_disp: torch.Tensor, guide_u8: torch.Tensor, shape, r: int,
                     n_bins: int, rng) -> dict:
    """K3 valid mode's inputs at a (views, rows, cols) tile: kind -> (disp,
    guide, plane). 'zero_halos': a top tile of `ref_disp` (r zero rows
    above, its rows and the r real rows below; zero rows below too where the
    tile is the whole frame), the plane 0 on the zero rows, as the mesh
    makes it; 'ones': the same with a plane of ones; on random disparities
    over all bins: 'fractional' (uniform in [0, 1)), 'zero_windows' (that
    with whole 64x64 windows of zeros, output 0 there) and 'mixed' (the
    zero-halo plane with 128x128 squares of fractions on a checkerboard, unit
    blocks beside fractional ones, and single NEAR_ONE values in unit
    areas)."""
    B, He, W = shape
    pick = torch.arange(B, device=dev) % ref_disp.shape[0]
    body, g_body = ref_disp[pick, :He - r], guide_u8[pick, :He - r]
    n_bot = He - r - body.shape[1]
    top = torch.nn.functional.pad(body, (0, 0, r, n_bot)).contiguous()
    g_top = torch.nn.functional.pad(g_body, (0, 0, 0, 0, r, n_bot)).contiguous()
    v_top = torch.ones((B, He, W), dtype=torch.float32, device=dev)
    v_top[:, :r] = 0.0
    v_top[:, He - n_bot:] = 0.0
    rnd = torch.as_tensor(rng.integers(0, n_bins, (B, He, W), dtype=np.uint8), device=dev)
    frac = torch.as_tensor(rng.random((B, He, W), dtype=np.float32), device=dev)
    holes = frac.clone()
    holes[:, 100:164, 200:264] = 0.0
    holes[:, -64:, :64] = 0.0
    mixed = v_top.clone()
    yy, xx = np.meshgrid(np.arange(He) // 128, np.arange(W) // 128, indexing="ij")
    square = torch.as_tensor((yy + xx) % 2 == 1, device=dev).expand(B, He, W).contiguous()
    mixed[square] = frac[square]
    for value in NEAR_ONE:
        n = 40 * B
        at = (rng.integers(0, B, n), rng.integers(r, He - r, n), rng.integers(0, W, n))
        keep = ~square[at].cpu().numpy()
        mixed[tuple(torch.as_tensor(a[keep], device=dev) for a in at)] = value
    return {"zero_halos": (top, g_top, v_top), "ones": (top, g_top, torch.ones_like(v_top)),
            "fractional": (rnd, g_top, frac), "zero_windows": (rnd, g_top, holes),
            "mixed": (rnd, g_top, mixed)}


def wmf_valid_parity(dev, smi: str, ref_disp: torch.Tensor, guide_u8: torch.Tensor, r: int,
                     n_bins: int, sig: float) -> dict:
    """K3's participation-weight mode against its plain version at the
    tiled meshes' JointWMF tiles (WMF_TILES), on every plane of
    wmf_valid_planes: 0 differing pixels required, 0 in the empty windows.
    The share of blocks that take the unit path (kernels/wmf.py::
    unit_plane_blocks) a plane. Times at each tile: the valid mode on the
    zero-halo, fractional and all-ones planes, the valid-less kernel on the
    same disparities and guide, the plain version once, and both entries'
    passes over the window offsets a block (bin_window_passes); blocks an
    SM of both entries."""
    rng = np.random.default_rng(13)
    rep: dict = {"blocks_per_sm": {"valid": K.wmf.blocks_per_sm(True, r),
                                   "valid_less": K.wmf.blocks_per_sm(False, r)}}
    log(f"wmf_valid blocks an SM at r = {r}: valid mode {rep['blocks_per_sm']['valid']}, "
        f"valid-less {rep['blocks_per_sm']['valid_less']}; {smi}")
    for tname, shape in WMF_TILES.items():
        planes = wmf_valid_planes(dev, ref_disp, guide_u8, shape, r, n_bins, rng)
        row: dict = {"shape": list(shape)}
        for kind, (d, g, v) in planes.items():
            plain, plain_ms = timed_once(lambda: K.weighted_median_plain(d, g, r, n_bins, sig, v))
            got = K.weighted_median(d, g, r, n_bins, sig, valid=v)
            diff = (got.int() - plain.int()).abs()
            unit = float(K.wmf.unit_plane_blocks(v, r).double().mean())
            row[kind] = {"n_differ": int((diff > 0).sum()), "max_abs_err": int(diff.max()),
                         "plain_ms_once": plain_ms, "unit_block_share": unit}
            if kind == "zero_windows":
                row[kind]["max_in_empty_window"] = int(got[:, 100 + r:164 - r,
                                                           200 + r:264 - r].max())
            log(f"parity wmf_valid {tname} {tuple(d.shape)} {kind}: {row[kind]['n_differ']} px "
                f"differ (0 required), max|diff| {row[kind]['max_abs_err']}, {unit:.1%} of "
                f"blocks on the unit path")
            if row[kind]["n_differ"] or row[kind].get("max_in_empty_window", 0):
                raise AssertionError(f"wmf_valid {tname} {kind} is not bitwise its plain version")
            if kind in ("zero_halos", "fractional", "ones"):
                b_ms, b_by = bound_wmf_valid(d, plain, v, r, n_bins)
                row[kind].update(
                    ms=cuda_ms(lambda: K.weighted_median(d, g, r, n_bins, sig, valid=v)),
                    valid_less_ms=cuda_ms(lambda: K.weighted_median(d, g, r, n_bins, sig)),
                    bound_ms=b_ms, bound_by=b_by)
                row[kind]["ratio"] = row[kind]["ms"] / row[kind]["valid_less_ms"]
                row[kind]["passes"] = {"valid": wmf_passes(d, r, n_bins, v),
                                       "valid_less": wmf_passes(d, r, n_bins)}
                log(f"time wmf_valid {tname} {tuple(d.shape)} {kind}: valid mode "
                    f"{row[kind]['ms']:.4f} ms, valid-less {row[kind]['valid_less_ms']:.4f} ms "
                    f"on the same input ({row[kind]['ratio']:.3f}x), bound {b_ms:.5f} ms "
                    f"({b_by}), {b_ms / row[kind]['ms']:.1%} of bound; valid mode "
                    f"{passes_text(row[kind]['passes']['valid'])}; valid-less "
                    f"{passes_text(row[kind]['passes']['valid_less'])}; {smi}")
        zh = row["zero_halos"]
        row.update(ms=zh["ms"], valid_less_ms=zh["valid_less_ms"], plain_ms=zh["plain_ms_once"],
                   bound_ms=zh["bound_ms"], bound_by=zh["bound_by"],
                   max_abs_err=max(row[k]["max_abs_err"] for k in planes))
        rep[tname] = row
    return rep


def tile_rows(views: torch.Tensor, yi: int, yn: int, halo: int, s: int) -> torch.Tensor:
    """Row tile `yi` of `yn` of (N, H, W, 3) views extended by `halo` rows
    each side as `halo_exchange_rows(edge='reflect', block=s)` extends it:
    the neighbours' rows inside the frame, the tile's own s-row block
    reflect at the frame's edges."""
    from primestereomatch_torch.parallel.sharded import _reflect_blocks

    ht = views.shape[1] // yn
    y0 = yi * ht
    own = views[:, y0:y0 + ht]

    def edge(top: bool) -> torch.Tensor:
        return own[:, torch.as_tensor(_reflect_blocks(ht, halo, s, top), device=views.device)]

    above = edge(True) if yi == 0 else views[:, y0 - halo:y0]
    below = edge(False) if yi == yn - 1 else views[:, y0 + ht:y0 + ht + halo]
    return torch.cat([above, own, below], dim=1).contiguous()


def sharded_kernel_parity(dev, smi: str, lt: torch.Tensor, rt: torch.Tensor, cfg) -> dict:
    """The sharded meshes' kernels against their plain versions on the
    same CUDA tensors, at the shapes the meshes give them. K1 at one rank's
    extended tile of each tiled mesh (TILE_RANKS): its halo rows, its d
    block's costs (`sharded.tile_costs_low`) and the tile's guide
    statistics, within atol 2e-4 / rtol 1e-3. K4 (same tolerance), K2
    (2e-3 of pixels) and K3 (bitwise) at the 2-frame batch of the
    batch-only meshes, 4 views of H_SHARD x 2208. Each kernel's ms, its
    plain version's (one run) and the bound."""
    from primestereomatch_torch.ops.guided_filter import fgf_tile_halo
    from primestereomatch_torch.parallel.sharded import tile_costs_low

    s, k, D = cfg.subsample, cfg.fgf_low_radius, cfg.max_dis
    r, sig = cfg.wmf_radius, cfg.wmf_sigma
    halo = fgf_tile_halo(cfg.gif_radius, s)
    out: dict = {"lowmaps": {}, "cvc_lowmaps": {}, "wta": {}, "wmf": {}}

    def held(kname, key, where, shape, fk, fp, bnd, kind):
        got = fk()
        want, plain_ms = timed_once(fp)
        if kind == "maps":
            err = (got - want).abs()
            row = {"max_abs_err": float(err.max()), "n_differ": int((err > 0).sum()),
                   "n": got.numel()}
            ok, rule = torch.allclose(got, want, atol=2e-4, rtol=1e-3), "atol 2e-4, rtol 1e-3"
        else:
            diff = (got.int() - want.int()).abs()
            row = {"max_abs_err": int(diff.max()), "n_differ": int((diff > 0).sum()),
                   "n": diff.numel()}
            row["mismatch"] = row["n_differ"] / row["n"]
            if kind == "wta":
                ok, rule = row["mismatch"] <= 2e-3 and int(got.min()) >= 1, "bound 2e-3"
            else:
                ok, rule = row["n_differ"] == 0, "0 px required"
        del got
        b_ms, b_by = bnd(want)
        row.update(shape=list(shape), ms=cuda_ms(fk), plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by)
        log(f"parity sharded {kname} at {where} {tuple(shape)}: max|diff| "
            f"{row['max_abs_err']:.3e}, {row['n_differ']}/{row['n']} differ ({rule}); kernel {row['ms']:.4f} ms, plain "
            f"{plain_ms:.4f} ms (one run), bound {b_ms:.5f} ms ({b_by}), "
            f"{b_ms / row['ms']:.1%} of bound; {smi}")
        if not ok:
            raise AssertionError(f"{kname} disagrees with its plain version at {where}")
        out[kname][key] = row
        return want

    for name, (yi, di) in TILE_RANKS.items():
        (b, y, d), n_frames = SHARD_MESHES[name]
        bl = n_frames // b
        ext = tile_rows(torch.cat([lt[:bl], rt[:bl]]), yi, y, halo, s)
        d_block = D // d
        p_low = tile_costs_low(ext, cfg, di * d_block, d_block)
        h, w = p_low.shape[-2:]
        stats = guide_stats(ext, (h, w), k, cfg.gif_eps).reshape(-1, 12, h, w).contiguous()
        p_low = p_low.reshape(-1, d_block, h, w).contiguous()
        held("lowmaps", name, f"mesh {name} rank (y {yi}, d {di}) extended tile", p_low.shape,
             lambda: K.low_maps(p_low, stats, k), lambda: K.low_maps_plain(p_low, stats, k),
             lambda _: bound_lowmaps(p_low, k), "maps")
        del ext, p_low, stats
        torch.cuda.empty_cache()

    views, grds = stacked_views(lt, rt, cfg)
    H, W = views.shape[1:3]
    stats = guide_stats(views, (H // s, W // s), k, cfg.gif_eps).contiguous()
    cost = dict(alpha=cfg.alpha, border_cost=cfg.border_cost, tau1=cfg.tau1, tau2=cfg.tau2)
    key, where = f"batch_{H}x{W}_4_views", "the batch-only meshes' 2-frame batch"
    maps = held("cvc_lowmaps", key, where, views.shape[:3],
                lambda: K.cvc_low_maps(views, grds, stats, D, k, **cost),
                lambda: K.cvc_low_maps_plain(views, grds, stats, D, k, **cost),
                lambda _: bound_cvc_lowmaps(views, grds, stats, D, k), "maps")
    disp = held("wta", key, where, views.shape[:3], lambda: K.upsample_wta(views, maps),
                lambda: K.upsample_wta_plain(views, maps, d_chunk=16),
                lambda _: bound_wta(views, maps), "wta")
    del maps, grds, stats
    g_u8 = _to_u8(views).contiguous()
    held("wmf", key, where, views.shape[:3], lambda: K.weighted_median(disp, g_u8, r, D, sig),
         lambda: K.weighted_median_plain(disp, g_u8, r, D, sig),
         lambda med: bound_wmf(disp, med, r, D), "exact")
    out["wmf"][key].update(wmf_passes(disp, r, D))
    log(f"sharded wmf at {where}: {passes_text(out['wmf'][key])}")
    del views, g_u8, disp
    torch.cuda.empty_cache()
    return out


def sharded_phase(dev, smi: str) -> dict:
    """The sharded phase (parallel/): the 2K frame (D = 256) padded to
    H_SHARD rows. World 1 under NCCL, mesh (1, 1, 1), in this process:
    the sharded GIF and SGBM steps on 2 frames, each mesh's kernels asserted
    and every frame bitwise the direct pipeline. Then SHARD_RANKS ranks
    sharing the card under gloo (sharded_rank): the tiled meshes launch K1
    and K3's valid mode and nothing else, within 2e-3 of the single-device
    card output with and without JointWMF and the field recovered; the
    batch-only mesh (4, 1, 1) launches K4, K2, K3 and is bitwise. The
    launcher (`python -m primestereomatch_torch.launch local`) at (1, 2, 2)
    and (2, 2, 1) with --check, at the same width, rows and D. K1, K4, K2
    and K3 at the meshes' shapes (sharded_kernel_parity) and K3's valid
    mode at the tiled meshes' shapes (wmf_valid_parity) against their plain
    versions."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from primestereomatch_torch.parallel import (MeshPlan, make_mesh, make_sharded_gif,
                                                 make_sharded_sgbm)
    from primestereomatch_torch.parallel.launch import initialize

    cfg = psm.GIFConfig(max_dis=256)
    scfg = psm.SGBMConfig(num_disparities=256)
    left, right, rect = sharded_frames()
    out: dict = {"card": smi, "rows": H_SHARD, "launches": {}, "meshes": {}}
    lt, rt = (torch.as_tensor(a, device=dev) for a in (left, right))
    # the single-device card outputs the meshes are held to
    refs = {pp: [psm.stereo_gif_forward(lt[i], rt[i], cfg, pp, device=dev) for i in range(2)]
            for pp in (True, False)}
    refs = {pp: [torch.stack([f[v] for f in fr]) for v in (0, 1)] for pp, fr in refs.items()}
    direct_ms = frame_ms(lambda: psm.stereo_gif_forward_batch(lt, rt, cfg, device=dev), 2) / 2

    # ---- world 1, NCCL: the one-card deployment ------------------------------
    backend = initialize(f"localhost:{_free_port()}", 1, 0)
    if backend != "nccl":
        raise AssertionError(f"world 1 on one card took {backend}, not nccl")
    try:
        mesh = make_mesh(MeshPlan(1, 1, 1))
        step = make_sharded_gif(mesh, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        lo, ro, _ = step(lt, rt)
        torch.cuda.synchronize()
        counts = _launched()
        out["launches"]["world1_gif"] = counts
        if set(counts) != {"cvc_lowmaps", "wta", "wmf"}:
            raise AssertionError(f"world-1 sharded GIF launched {counts}")
        if not (torch.equal(lo, refs[True][0]) and torch.equal(ro, refs[True][1])):
            raise AssertionError("world-1 sharded GIF is not bitwise the direct pipeline")
        w1 = {"backend": backend, "launches": counts,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "ms_per_frame": frame_ms(lambda: step(lt, rt), 2) / 2,
              "direct_ms_per_frame": direct_ms}
        lu, ru = (torch.as_tensor(np.clip(np.rint(a * 255), 0, 255).astype(np.uint8), device=dev)
                  for a in (left, right))
        sstep = make_sharded_sgbm(mesh, scfg)
        K.reset_launches()
        sout, _ = sstep(lu, ru)
        torch.cuda.synchronize()
        scounts = _launched()
        out["launches"]["world1_sgbm"] = scounts
        k7 = 2 * k7_launches(*lu.shape[1:3], scfg, dev)
        if set(scounts) != set(SGBM_KERNELS) or (scounts["bt_cost"], scounts["sgbm_scan"],
                                                  scounts["select"]) != (2, k7, 2):
            raise AssertionError(f"world-1 sharded SGBM launched {scounts}")
        for i in range(2):
            want = psm.stereo_sgbm_forward(lu[i], ru[i], scfg, device=dev)
            if not torch.equal(sout[i], want):
                raise AssertionError(f"world-1 sharded SGBM frame {i} is not the direct pipeline's")
            d16 = sout[i].cpu().numpy()[:H2K]
            check_medians_2k(np.where(d16 >= 0, d16 / 16.0, np.nan), None, rect)
        w1["sgbm_ms_per_frame"] = frame_ms(lambda: sstep(lu, ru), 2) / 2
        w1["sgbm_direct_ms_per_frame"] = frame_ms(
            lambda: psm.stereo_sgbm_forward(lu[0], ru[0], scfg, device=dev), 2)
        # a profiler pass a step (2 frames a step)
        w1["profile_per_step"] = profile_frames(lambda: step(lt, rt), GIF_TAGS, frames=3)
        w1["sgbm_profile_per_step"] = profile_frames(lambda: sstep(lu, ru), SGBM_TAGS, frames=3)
        for key in ("profile_per_step", "sgbm_profile_per_step"):
            prof = w1[key]
            by = ", ".join(f"{k} {v:.3f}" for k, v in prof["device_ms_by_kernel"].items())
            log(f"profile sharded world 1 {key}: wall {prof['wall_ms']:.3f} ms a step of 2 frames "
                f"under the profiler, device {prof['device_ms']:.3f} ms ({by}), idle share "
                f"{prof['idle_share']:.1%}, {prof['device_ops_per_frame']:.0f} device ops a step")
        out["meshes"]["world1_1x1x1"] = w1
        log(f"sharded world 1 (nccl), mesh (1,1,1), 2 frames 2208x{H_SHARD} D=256: GIF "
            f"{counts} bitwise the direct pipeline, {w1['ms_per_frame']:.3f} ms a frame "
            f"(direct batch {direct_ms:.3f}); SGBM {scounts} bitwise, "
            f"{w1['sgbm_ms_per_frame']:.3f} ms a frame (direct "
            f"{w1['sgbm_direct_ms_per_frame']:.3f}); "
            f"peak {w1['peak_gib']:.2f} GiB; {smi}")
    finally:
        dist.destroy_process_group()
    del lu, ru, sout, lo, ro
    torch.cuda.empty_cache()

    # ---- four ranks on the card, gloo, host-staged ---------------------------
    work = tempfile.mkdtemp(prefix="psm_sharded_")
    try:
        np.savez(pathlib.Path(work) / "frames.npz", left=left, right=right)
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        procs = [ctx.Process(target=sharded_rank, args=(r, port, work))
                 for r in range(SHARD_RANKS)]
        t0 = time.perf_counter()
        for pr in procs:
            pr.start()
        deadline = time.monotonic() + 600
        while any(pr.is_alive() for pr in procs):
            if any(pr.exitcode for pr in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        for pr in procs:
            if pr.is_alive():
                pr.kill()
            pr.join()
        if any(pr.exitcode for pr in procs):
            raise AssertionError(f"a sharded rank failed: exit codes "
                                 f"{[pr.exitcode for pr in procs]}")
        ranks = []
        for r in range(SHARD_RANKS):
            with open(pathlib.Path(work) / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        out["ranks_seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for key in [k for k in ranks[0] if k != "backend"]:
        name = key.removesuffix("_no_pp")
        (b, y, d), n_frames = SHARD_MESHES[name]
        pp = not key.endswith("_no_pp")
        counts: dict = {}
        for res in ranks:
            for k, v in res[key]["launches"].items():
                counts[k] = counts.get(k, 0) + v
        out["launches"][key] = counts
        tiled = y > 1 or d > 1
        expect = ({"lowmaps", "wmf_valid"} if pp else {"lowmaps"}) if tiled else \
            {"cvc_lowmaps", "wta", "wmf"}
        if set(counts) != expect:
            raise AssertionError(f"sharded {key} launched {counts}, expected exactly {expect}")
        got = _assemble(ranks, key, n_frames)
        want = [np.concatenate([t.cpu().numpy()] * (n_frames // 2)) for t in refs[pp]]
        n_differ = [int((g != w).sum()) for g, w in zip(got, want)]
        mismatch = max(n / g.size for n, g in zip(n_differ, got))
        row = {"plan": [b, y, d], "frames": n_frames, "postprocess": pp, "launches": counts,
               "n_differ": n_differ, "mismatch": mismatch,
               "backend": ranks[0]["backend"],
               "ms_per_frame": ranks[0][key]["ms_per_frame"],
               "halo_ms": [1e3 * res[key]["comm"]["halo_s"] for res in ranks],
               "merge_ms": [1e3 * res[key]["comm"]["merge_s"] for res in ranks],
               "halo_bytes": [res[key]["comm"]["halo_bytes"] for res in ranks],
               "merge_bytes": [res[key]["comm"]["merge_bytes"] for res in ranks],
               "peak_gib": [res[key]["peak_gib"] for res in ranks]}
        if tiled:
            if mismatch > 2e-3:
                raise AssertionError(f"sharded {key}: {n_differ} px differ from the single-device "
                                     f"card output (bound 2e-3)")
            row["medians"] = [check_medians_2k(got[0][i][:H2K].astype(np.float64),
                                               got[1][i][:H2K].astype(np.float64), rect)
                              for i in range(n_frames)]
        elif any(n_differ):
            raise AssertionError(f"batch-only {key} is not bitwise the single-device output")
        out["meshes"][key] = row
        log(f"sharded {key} mesh (b,y,d)=({b},{y},{d}) x{SHARD_RANKS} ranks on one card "
            f"({row['backend']}, collectives staged through host memory), {n_frames} frames "
            f"2208x{H_SHARD} D=256{'' if pp else ', no JointWMF'}: launches {counts}; "
            f"{n_differ} px differ from the single-device card output "
            f"({'bound 2e-3' if tiled else 'bitwise required'}); {row['ms_per_frame']:.3f} ms a "
            f"frame; halo {max(row['halo_ms']):.3f} ms / {max(row['halo_bytes'])} B a rank, merge "
            f"{max(row['merge_ms']):.3f} ms / {max(row['merge_bytes'])} B a rank (host-staged); "
            f"peak {max(row['peak_gib']):.2f} GiB a rank; {smi}")

    # ---- the launcher ---------------------------------------------------------
    out["launcher"] = {}
    for shape in ("1,2,2", "2,2,1"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "primestereomatch_torch.launch", "local", "--processes",
             str(SHARD_RANKS), "--mesh-shape", shape, "--height", str(H_SHARD), "--width",
             str(W2K), "--max-dis", str(cfg.max_dis), "--check", "--port", str(_free_port())],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        ok_lines = [ln for ln in proc.stdout.splitlines() if "verified bitwise" in ln]
        out["launcher"][shape] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                                  "verified_ranks": len(ok_lines)}
        for ln in proc.stdout.splitlines():
            log(f"launcher {shape}: {ln}")
        if proc.returncode or len(ok_lines) != SHARD_RANKS:
            raise AssertionError(f"launcher at mesh {shape} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")

    # ---- the kernels at the meshes' shapes against their plain versions ------
    out["kernel_parity"] = sharded_kernel_parity(dev, smi, lt, rt, cfg)

    # ---- K3's participation-weight mode ---------------------------------------
    views_u8 = _to_u8(torch.cat([lt, rt])).contiguous()      # (4, H_SHARD, W, 3): l0 l1 r0 r1
    disp = torch.cat(refs[False]).contiguous()               # WTA output, same view order
    out["wmf_valid"] = wmf_valid_parity(dev, smi, disp, views_u8, cfg.wmf_radius, cfg.max_dis,
                                        cfg.wmf_sigma)
    out["launches_summed"] = {k: sum(c.get(k, 0) for c in out["launches"].values())
                              for k in GIF_KERNELS + SGBM_KERNELS + ("wmf_valid",)}
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
        # the partials route: K6 once, K7 by its route, K8 once; K9 two
        # launches a sweep, two sweeps a check
        k7 = k7_launches(*sframes[n][0].shape[:2], scfg2k if n == "2k" else scfg, dev)
        if ((per["bt_cost"], per["sgbm_scan"], per["select"]) != (1, k7, 1)
                or per["speckle"] != 4 * per["host_syncs"] or not per["host_syncs"]):
            raise AssertionError(f"SGBM {n} launched {per}, expected K6 1, K7 {k7}, K8 1, K9 4 "
                                 f"a host sync")
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
            SGBM_TAGS, f"{sc.mode}, D={sc.num_disparities}, speckle filter", ITERS)
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

    # ---- the calibrated phase: counts at 0 just before each path ----------
    cal = calibrated(dev, smi)
    cal_launches = {k: sum(c.get(k, 0) for c in cal["launches"].values())
                    for k in GIF_KERNELS + SGBM_KERNELS}
    log(f"calibrated main paths, launches summed: {cal_launches}")

    # ---- the app phase: counts at 0 just before each path ------------------
    app = app_phase(dev, smi)
    app_launches = {k: sum(c.get(k, 0) for c in app["launches"].values())
                    for k in GIF_KERNELS + SGBM_KERNELS}
    log(f"app main paths, launches summed: {app_launches}")

    # ---- the sharded phase: counts at 0 just before each mesh ---------------
    torch.cuda.empty_cache()
    shard = sharded_phase(dev, smi)
    shard_launches = shard["launches_summed"]
    log(f"sharded main paths, launches summed: {shard_launches}")
    if not shard_launches["wmf_valid"] or not shard_launches["lowmaps"]:
        raise AssertionError(f"the tiled meshes never launched K1 or K3's valid mode: "
                             f"{shard_launches}")

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
            "launches": (launches[kname] if kname in GIF_KERNELS else slaunches[kname])
            + cal_launches[kname] + app_launches[kname] + shard_launches[kname],
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
            passes = ("passes_range_mean", "passes_mean", "passes_max", "ranks_cut_share")
            for key, at in (("wmf_random", "uniformly random disparities over 256 bins"),
                            ("wmf_clutter", "the WTA output of a gif_zed2k.clutter pool frame")):
                g = report["2k"][key]
                row[f"at_2k_{key[4:]}"] = {**{k_: g[k_] for k_ in timed + passes},
                                           "mismatch": g["mismatch"], "at": f"2k, {at}"}
            for key, rep_k in (("at", t), ("at_2k", k2)):
                row[f"passes_{key}"] = {k_: rep_k[k_] for k_ in passes}
        if kname in ("sgbm_scan", "select"):
            extra = [key for key in t if key.startswith(("int32_", "bytes_", "tb_", "ring_", "rows8_",
                                                         "device_"))]
            row["more"] = {"teddy": {key: t[key] for key in extra},
                           "2k": {key: k2[key] for key in extra}}
        if kname == "speckle":
            extra = ("device_ms", "hook_plain_ops_ms", "hook_plain_ops_device_ms", "segmin_ms")
            row["more"] = {"teddy": {key: t[key] for key in extra},
                           "2k": {key: k2[key] for key in extra}}
        if kname in GIF_KERNELS:
            row["launches_by_path"] = {p: c.get(kname, 0) for p, c in path_launches.items()}
        row["launches_calibrated"] = {p: c.get(kname, 0) for p, c in cal["launches"].items()}
        row["launches_app"] = {p: c.get(kname, 0) for p, c in app["launches"].items()}
        row["launches_sharded"] = {p: c.get(kname, 0) for p, c in shard["launches"].items()}
        if kname in shard["kernel_parity"]:
            row["at_sharded"] = shard["kernel_parity"][kname]
        row["at_calibrated"] = {g: {key: cal[g]["kernels"][kname][key]
                                    for key in timed + ("shape",)}
                                for g in CALIB_CASES if kname in cal[g]["kernels"]}
        rows.append(row)
    # K5, the TPU's generic-ratio kernel: K2's source serves it with its
    # per-pixel kernel, which only the subsample=1 path (ratio 1) takes
    g = report["teddy_s1"]["wta"]
    if g["design"]["kernel"] != "per-pixel":
        raise AssertionError(f"subsample=1 took K2's {g['design']['kernel']} kernel")
    k5_launches = path_launches["teddy_s1"]["wta"]
    k2_row = next(r for r in rows if r["name"] == "wta")
    k2_row["launches"] -= k5_launches
    rows.insert(rows.index(k2_row) + 1, {
        "name": "wta_generic", "route": "cuda", "source": "primestereomatch_torch/csrc/wta.cu",
        "replaces": TPU_KERNEL["wta_generic"], "launches": k5_launches,
        **{key: g[key] for key in timed}, "library_ms": None,
        "at": "teddy 375x450 D=64, subsample=1 (ratio 1): the per-pixel kernel",
        "mismatch": g.get("mismatch", g["n_differ"] / g["n"])})
    # K3's participation-weight mode: its own entry of csrc/wmf.cu, on the
    # tiled meshes' path; timed at the (1, 2, 2) mesh's JointWMF tile
    wv = dict(shard["wmf_valid"])
    occupancy = wv.pop("blocks_per_sm")
    t = wv["y2"]
    rows.append({
        "name": "wmf_valid", "route": "cuda", "source": "primestereomatch_torch/csrc/wmf.cu",
        "replaces": TPU_KERNEL["wmf_valid"], "launches": shard_launches["wmf_valid"],
        **{key: t[key] for key in timed}, "library_ms": None,
        "at": f"{t['shape'][0]}x{t['shape'][1]}x{t['shape'][2]} zero-halo tile of mesh (1,2,2)",
        "share_of_bound": t["bound_ms"] / t["ms"],
        "valid_less_ms_same_shape": t["valid_less_ms"], "blocks_per_sm": occupancy,
        "at_tiles": {n: {"shape": wv[n]["shape"],
                         **{k: {key: wv[n][k][key] for key in
                                ("ms", "valid_less_ms", "ratio", "bound_ms", "unit_block_share",
                                 "passes")}
                            for k in ("zero_halos", "fractional", "ones")}} for n in wv},
        "n_differ": {n: {k: wv[n][k]["n_differ"] for k in WMF_PLANES} for n in wv},
        "unit_block_share": {n: {k: wv[n][k]["unit_block_share"] for k in WMF_PLANES}
                             for n in wv},
        "launches_sharded": {p: c.get("wmf_valid", 0) for p, c in shard["launches"].items()},
    })
    k3_2k = report["2k"]["wmf"]["ms"]
    log(f"K3 valid-less at 2K {k3_2k:.4f} ms in this run ({k3_2k / 2.3041 - 1:+.1%} against "
        f"PERF.md's 2.3041 ms); valid mode {t['ms']:.4f} ms against "
        f"valid-less {t['valid_less_ms']:.4f} ms at the tile {t['shape']}, "
        f"{t['bound_ms'] / t['ms']:.1%} of bound; {smi}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "kernels": rows, "parity": report, "sgbm_parity": sgbm_report,
        "fused_parity": fused_report, "bp_nonocc": bp, "path_launches": path_launches,
        "e2e": e2e, "medians_2k": med2k, "full_vs_maps_2k": full_vs_maps,
        "sgbm_quality": sgbm_q, "sgbm_per_frame": sper_frame, "sgbm_medians_2k": smed2k,
        "peak_gib": peak, "variants": variants, "calibrated": cal, "app": app, "sharded": shard,
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
