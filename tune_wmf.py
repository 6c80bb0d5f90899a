#!/usr/bin/env python3
"""Time variants of the JointWMF kernel (K3, csrc/wmf.cu) on one NVIDIA card.

    python3 tune_wmf.py

Builds csrc/wmf.cu once per variant of its -D knobs (tile height TH, bin
window NB, look-ahead U; the first variant is the shipped default), runs
each on three inputs of chip_smoke.py's shapes (the Teddy frame's output,
the 2K frame's WTA output, uniformly random disparities at 2K), requires 0
pixels differing from the plain version, and prints CUDA-event times. Needs
one CUDA card and nvcc, like chip_smoke.py; writes nothing.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
import primestereomatch_torch as psm
from primestereomatch_torch import kernels as K
from primestereomatch_torch.kernels import _build
from primestereomatch_torch.kernels.wmf import N_DIST2
from primestereomatch_torch.models.gif_pipeline import _to_u8, stacked_views
from primestereomatch_torch.ops.guided_filter import guide_stats

# (TH, NB, U): the default first
VARIANTS = [(8, 64, 4), (8, 64, 1), (8, 32, 4), (8, 32, 1), (8, 128, 4), (4, 64, 4), (6, 64, 4),
            (8, 64, 8)]


def build_variants():
    fns = _build.build_variants("wmf", {
        (th, nb, u): [f"-DPSM_WMF_TH={th}", f"-DPSM_WMF_NB={nb}", f"-DPSM_WMF_U={u}"]
        for th, nb, u in VARIANTS})
    for key in fns:
        used = [ln.strip() for ln in _build.BUILD_LOGS[f"wmf {key}"].splitlines() if "Used" in ln]
        print(f"ptxas TH={key[0]} NB={key[1]} U={key[2]}: {used[0]}", flush=True)
    return fns


def run(fn, disp, guide, radius, n_bins, sigma=25.5):
    B, H, W = disp.shape
    sig_q = sigma / 256.0 * 64.0
    out = torch.empty_like(disp)
    wtab = torch.empty(N_DIST2, dtype=torch.float32, device=disp.device)
    _build.check("wmf", fn(disp.data_ptr(), guide.data_ptr(), out.data_ptr(), wtab.data_ptr(), B,
                           H, W, radius, n_bins, ctypes.c_float(1.0 / (2.0 * sig_q * sig_q)),
                           torch.cuda.current_stream().cuda_stream))
    return out


def inputs(dev):
    teddy = cs.load_dataset("Teddy")
    cfg = psm.GIFConfig()
    ld, rd = psm.stereo_gif_forward(teddy.left_f32, teddy.right_f32, cfg)
    g2, _ = stacked_views(torch.as_tensor(teddy.left_f32, device=dev)[None],
                          torch.as_tensor(teddy.right_f32, device=dev)[None], cfg)
    yield "teddy 2x375x450, 64 bins", torch.stack([ld, rd]), _to_u8(g2).contiguous(), 64
    left, right, _ = cs.synthetic_2k(0)
    cfg2 = psm.GIFConfig(max_dis=256)
    v2, grds = stacked_views(torch.as_tensor(left, device=dev)[None],
                             torch.as_tensor(right, device=dev)[None], cfg2)
    stats = guide_stats(v2, (cs.H2K // 4, cs.W2K // 4), cfg2.fgf_low_radius,
                        cfg2.gif_eps).contiguous()
    disp = K.cvc_wta(v2, grds, stats, 256, cfg2.fgf_low_radius, alpha=cfg2.alpha,
                     border_cost=cfg2.border_cost, tau1=cfg2.tau1, tau2=cfg2.tau2)
    g8 = _to_u8(v2).contiguous()
    yield "2k 2x1242x2208, 256 bins, WTA output", disp, g8, 256
    rnd = np.random.default_rng(3).integers(0, 256, tuple(disp.shape), dtype=np.uint8)
    yield "2k 2x1242x2208, 256 bins, random", torch.as_tensor(rnd, device=dev), g8, 256


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_wmf: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    fns = build_variants()
    for name, disp, guide, n_bins in inputs(dev):
        want = K.weighted_median_plain(disp, guide, 9, n_bins, 25.5)
        print(name, flush=True)
        for (th, nb, u), fn in fns.items():
            n_diff = int((run(fn, disp, guide, 9, n_bins) != want).sum())
            ms = cs.cuda_ms(lambda: run(fn, disp, guide, 9, n_bins), iters=10, warmup=2)
            print(f"  TH={th} NB={nb} U={u}: {ms:.4f} ms, {n_diff} px differ", flush=True)
            if n_diff:
                raise AssertionError(f"variant {(th, nb, u)} differs from the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
