#!/usr/bin/env python3
"""Time K8 (csrc/select.cu, the SGBM disparity selection) in the launch
shapes that were tried, on one NVIDIA card.

    python3 tune_select.py

A shape is the threads a block, a run-time argument of the one library,
so nothing is rebuilt. Each shape of THREADS_TRIED selects from
chip_smoke.py's SGBM costs (Teddy 375x450, D=64, and the 2K pair rounded to
uint8, D=256), from the two uint16 partials and from the int32 S, must equal
the plain version (Teddy) or the wrapper's pick (2K) bit for bit, and prints
its CUDA-event time and its device time by the profiler (at Teddy the
events also see the host's time a launch). Needs one CUDA card and nvcc,
like chip_smoke.py; writes nothing.
"""

from __future__ import annotations

import subprocess
import sys

import torch

import chip_smoke as cs
from primestereomatch_torch import kernels as K
from primestereomatch_torch.kernels import _build
from primestereomatch_torch.kernels.select import MAX_THREADS, launch, launch_shape

# the shipped shape first
THREADS_TRIED = (MAX_THREADS, 256, 128)


def variant_ms(costs: tuple, n_partials: int, sel: tuple, want: torch.Tensor,
               threads=THREADS_TRIED) -> dict:
    """{threads: (CUDA-event ms, profiler device ms)} of K8 on `costs` (the
    int32 S alone, or the uint16 partials) for each count of `threads`,
    each held bitwise against `want`."""
    fn = _build.load("select")
    H, W, D = costs[0].shape
    res = {}
    for t in threads:
        shape = launch_shape(H, W, D, n_partials, threads=t)
        if not torch.equal(launch(fn, costs, n_partials, *sel, shape), want):
            raise AssertionError(f"K8 at {t} threads differs")

        def run():
            launch(fn, costs, n_partials, *sel, shape)

        res[t] = (cs.cuda_ms(run), cs.profiled_ms(run, "select_kernel"))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_select: needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    import primestereomatch_torch as psm
    from primestereomatch_torch.ops import sgbm as sgbm_ops

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"build: {K.build(('select', 'bt_cost', 'sgbm_scan')):.1f} s", flush=True)
    log = _build.BUILD_LOGS.get("select", "")
    teddy = cs.load_dataset("Teddy")
    left2k, right2k, _ = cs.synthetic_2k(0)
    u8 = [np.clip(np.rint(a * 255), 0, 255).astype(np.uint8) for a in (left2k, right2k)]
    scfg = psm.SGBMConfig()
    sel = (scfg.uniqueness_ratio, scfg.disp12_max_diff, scfg.min_disparity)
    for name, (left, right), D in (("teddy", (teddy.left_bgr, teddy.right_bgr), 64),
                                   ("2k", u8, 256)):
        lf, rf = (sgbm_ops.sobel_xclip(torch.as_tensor(a, device=dev), scfg.pre_filter_cap)
                  for a in (left, right))
        k = scfg.block_size
        bound = k * k * lf.shape[2] * 2 * scfg.pre_filter_cap
        cost = K.bt_cost(lf, rf, D, k, bound)
        parts = K.sgbm_aggregate_partials(cost, scfg.p1, scfg.p2, scfg.num_directions, bound)
        del cost
        S = sum(q.int() for q in parts)
        want = K.select_disparity_partials(parts, *sel)
        if name == "teddy" and not torch.equal(want, K.select_disparity_plain(S, *sel)):
            raise AssertionError("K8 differs from its plain version at Teddy")
        for n_partials, costs in ((len(parts), parts), (0, (S,))):
            shipped = launch_shape(*S.shape, n_partials)
            print(f"{name} from {n_partials or 'the int32 S'} "
                  f"{'partials' if n_partials else ''}: (H, W, D) = {tuple(S.shape)}, shipped "
                  f"{shipped}, {cs.instance_resources(log, n_partials, shipped)}", flush=True)
            for t, (ms, dev_ms) in variant_ms(costs, n_partials, sel, want).items():
                print(f"  K8 at {t} threads: {ms:.4f} ms, device {dev_ms:.4f} ms, "
                      f"0 values differ", flush=True)
        del parts, S
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
