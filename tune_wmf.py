#!/usr/bin/env python3
"""Time variants of the JointWMF kernel (K3, csrc/wmf.cu) on one NVIDIA card.

    python3 tune_wmf.py
    python3 tune_wmf.py valid [BASELINE_WMF_CU]

Without arguments: builds csrc/wmf.cu once per variant of its -D knobs
(tile height TH, bin window NB, look-ahead U; the first variant is the
shipped default), runs each on four inputs of chip_smoke.py's shapes (the
Teddy frame's output, the 2K frame's WTA output, uniformly random
disparities at 2K, the WTA output of a gif_zed2k.clutter pool frame),
requires 0 pixels differing from the plain version, and prints CUDA-event
times and each input's passes over the window offsets a block
(chip_smoke.wmf_passes: over each tile's range, ranked, and the share of
blocks whose passes the ranks cut).

`valid`: the valid-less entry on the same four inputs, then the
participation-weight entry (`psm_joint_wmf_valid`) at the
(1,2,2) mesh's JointWMF tile (chip_smoke.WMF_TILES["y2"]) on the zero-halo,
fractional and all-ones planes (chip_smoke.wmf_valid_planes, from the 2K
frame's WTA output) and on the zero-halo plane times 0.99999994f (the same
participation, but no block on the unit path), beside the valid-less entry
on the same disparities and guide, each held bitwise to the plain version.
Prints each build's ptxas registers, spills and static shared memory, and
the shipped build's dynamic shared memory and blocks an SM (the CUDA
runtime's occupancy calculator). With BASELINE_WMF_CU (another copy of
csrc/wmf.cu, such as an earlier commit's) that build is timed in turns with
the shipped one: baseline, shipped, shipped, baseline.

Needs one CUDA card and nvcc, like chip_smoke.py; writes nothing.
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
from primestereomatch_torch.kernels.wmf import N_DIST2, NB, TILE_H, TILE_W, blocks_per_sm
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
    yield ("2k 2x1242x2208, 256 bins, WTA output of a gif_zed2k.clutter pool frame",
           *cs.clutter_2k(dev, cfg2), 256)


def run_valid(fn, disp, guide, valid, radius, n_bins, sigma=25.5):
    B, H, W = disp.shape
    sig_q = sigma / 256.0 * 64.0
    out = torch.empty_like(disp)
    wtab = torch.empty(2 * N_DIST2, dtype=torch.float32, device=disp.device)
    _build.check("wmf_valid", fn(disp.data_ptr(), guide.data_ptr(), valid.data_ptr(),
                                 out.data_ptr(), wtab.data_ptr(), B, H, W, radius, n_bins,
                                 ctypes.c_float(1.0 / (2.0 * sig_q * sig_q)),
                                 torch.cuda.current_stream().cuda_stream))
    return out


def ptxas_use(log: str, valid: bool) -> str:
    """Registers, static shared bytes, stack and spills of the filter's
    entry (valid: its participation-weight instance) in a ptxas log."""
    lines = log.splitlines()
    at = next(i for i, ln in enumerate(lines)
              if "Compiling entry" in ln and f"joint_wmf_kernelILb{int(valid)}" in ln)
    spill = next(ln for ln in lines[at:] if "spill" in ln).strip()
    used = next(ln for ln in lines[at:] if "Used" in ln).split(":", 1)[-1].strip()
    return f"{used}; {spill}"


def main_valid(dev, baseline: str | None) -> int:
    builds = {"shipped": None} if baseline is None else {"baseline": baseline, "shipped": None}
    fns = {}
    for tag, source in builds.items():
        for name in ("wmf_valid", "wmf"):
            fns[tag, name] = _build.build_variants(name, {tag: []}, source)[tag]
        log = _build.BUILD_LOGS[f"wmf_valid {tag}"]
        for valid in (True, False):
            line = f"{tag} {'valid' if valid else 'valid-less'} entry: {ptxas_use(log, valid)}"
            if tag == "shipped":
                halo = (TILE_H + 18) * (TILE_W + 18)
                dyn = 4 * (NB * TILE_W * TILE_H + (2 if valid else 1) * halo)
                line += (f"; {dyn} B dynamic shared memory, {blocks_per_sm(valid, 9)} blocks an "
                         f"SM (occupancy calculator)")
            print(line, flush=True)
    order = list(builds) + list(builds)[::-1]
    ins = list(inputs(dev))
    for name, d, g, n_bins in ins:
        want = K.weighted_median_plain(d, g, 9, n_bins, 25.5)
        print(f"{name}: {cs.passes_text(cs.wmf_passes(d, 9, n_bins))}", flush=True)
        for tag in order:
            fw = fns[tag, "wmf"]
            if int((run(fw, d, g, 9, n_bins) != want).sum()):
                raise AssertionError(f"{tag} differs from the plain version on {name}")
            ms = cs.cuda_ms(lambda: run(fw, d, g, 9, n_bins), iters=20, warmup=3)
            print(f"  {tag}: valid-less {ms:.4f} ms, 0 px differ", flush=True)
    _, disp2k, g2k, n_bins = ins[1]
    planes = cs.wmf_valid_planes(dev, disp2k, g2k, cs.WMF_TILES["y2"], 9, n_bins,
                                 np.random.default_rng(13))
    d, g, v = planes["zero_halos"]
    planes["zero_halos_mul"] = (d, g, v * 0.99999994)
    for kind in ("zero_halos", "zero_halos_mul", "fractional", "ones"):
        d, g, v = planes[kind]
        want = K.weighted_median_plain(d, g, 9, n_bins, 25.5, v)
        want_less = K.weighted_median_plain(d, g, 9, n_bins, 25.5)
        unit = float(K.wmf.unit_plane_blocks(v, 9).double().mean())
        print(f"{kind} {tuple(d.shape)}, 256 bins, {unit:.1%} of blocks on the unit path; "
              f"{cs.passes_text(cs.wmf_passes(d, 9, n_bins, v))}:", flush=True)
        for tag in order:
            fv, fw = fns[tag, "wmf_valid"], fns[tag, "wmf"]
            n_diff = int((run_valid(fv, d, g, v, 9, n_bins) != want).sum())
            n_diff_less = int((run(fw, d, g, 9, n_bins) != want_less).sum())
            if n_diff or n_diff_less:
                raise AssertionError(f"{tag} differs from the plain version on {kind}")
            ms = cs.cuda_ms(lambda: run_valid(fv, d, g, v, 9, n_bins), iters=20, warmup=3)
            ms_less = cs.cuda_ms(lambda: run(fw, d, g, 9, n_bins), iters=20, warmup=3)
            print(f"  {tag}: valid {ms:.4f} ms, valid-less {ms_less:.4f} ms on the same input "
                  f"({ms / ms_less:.3f}x), 0 px differ", flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_wmf: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    if sys.argv[1:2] == ["valid"]:
        return main_valid(dev, sys.argv[2] if len(sys.argv) > 2 else None)
    fns = build_variants()
    for name, disp, guide, n_bins in inputs(dev):
        want = K.weighted_median_plain(disp, guide, 9, n_bins, 25.5)
        print(f"{name}: {cs.passes_text(cs.wmf_passes(disp, 9, n_bins))}", flush=True)
        for (th, nb, u), fn in fns.items():
            n_diff = int((run(fn, disp, guide, 9, n_bins) != want).sum())
            ms = cs.cuda_ms(lambda: run(fn, disp, guide, 9, n_bins), iters=10, warmup=2)
            print(f"  TH={th} NB={nb} U={u}: {ms:.4f} ms, {n_diff} px differ", flush=True)
            if n_diff:
                raise AssertionError(f"variant {(th, nb, u)} differs from the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
