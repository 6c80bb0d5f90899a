#!/usr/bin/env python3
"""Time K6 (csrc/bt_cost.cu, the SGBM BT cost + window sum) in the launch
shapes that were tried, on one NVIDIA card.

    python3 tune_bt_cost.py

The strip of output rows a block walks down and the disparities a block
takes are run-time arguments of the one library, so nothing is rebuilt:
each shape (strip, d_chunk) of kernels/bt_cost.py::SHAPES runs at
chip_smoke.py's SGBM shapes (Teddy 375x450, D=64 and the 2K pair rounded
to uint8, D=256, block 5), must equal the plain version (Teddy) or the
wrapper's pick (2K) bit for bit, and prints its CUDA-event time. Needs one
CUDA card and nvcc, like chip_smoke.py; writes nothing.
"""

from __future__ import annotations

import subprocess
import sys

import torch

import chip_smoke as cs
from primestereomatch_torch import kernels as K
from primestereomatch_torch.kernels import _build
from primestereomatch_torch.kernels.bt_cost import SHAPES, launch, launch_shape, plan


def variant_ms(lf: torch.Tensor, rf: torch.Tensor, D: int, k: int, cost_bound: int,
               shapes=SHAPES) -> dict:
    """{(strip, d_chunk): ms} of K6 on these features, each shape's output
    held bitwise against the wrapper's (`launch_shape`)."""
    want = K.bt_cost(lf, rf, D, k, cost_bound)
    fn = _build.load("bt_cost")
    out = torch.empty_like(want)
    res = {}
    for strip, dc in shapes:
        shape = plan(k, lf.shape[2], want.element_size(), strip, dc)
        if not torch.equal(launch(fn, lf, rf, out, k, shape), want):
            raise AssertionError(f"K6 at strip {strip}, d_chunk {dc} differs from the shipped "
                                 f"shape")
        res[(strip, dc)] = cs.cuda_ms(lambda: launch(fn, lf, rf, out, k, shape))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_bt_cost: needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    import primestereomatch_torch as psm
    from primestereomatch_torch.ops import sgbm as sgbm_ops

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"build: {K.build(('bt_cost',)):.1f} s", flush=True)
    print(f"ptxas bt_cost: {_build.BUILD_LOGS.get('bt_cost', '').strip()}", flush=True)
    teddy = cs.load_dataset("Teddy")
    left2k, right2k, _ = cs.synthetic_2k(0)
    u8 = [np.clip(np.rint(a * 255), 0, 255).astype(np.uint8) for a in (left2k, right2k)]
    scfg = psm.SGBMConfig()
    for name, (left, right), D in (("teddy", (teddy.left_bgr, teddy.right_bgr), 64),
                                   ("2k", u8, 256)):
        lf, rf = (sgbm_ops.sobel_xclip(torch.as_tensor(a, device=dev), scfg.pre_filter_cap)
                  for a in (left, right))
        k = scfg.block_size
        bound = k * k * lf.shape[2] * 2 * scfg.pre_filter_cap
        got = K.bt_cost(lf, rf, D, k, bound)
        if name == "teddy" and not torch.equal(got, K.bt_cost_plain(lf, rf, D, k, bound)):
            raise AssertionError("K6 differs from its plain version at Teddy")
        shipped = launch_shape(*lf.shape[:2], D, k, lf.shape[2], got.element_size(),
                               torch.cuda.get_device_properties(dev).multi_processor_count)
        print(f"{name}: (H, W, C, D) = {tuple(lf.shape) + (D,)}, shipped plan {shipped}",
              flush=True)
        for (strip, dc), ms in variant_ms(lf, rf, D, k, bound).items():
            print(f"  K6 strip {strip}, d_chunk {dc}: {ms:.4f} ms, 0 values differ", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
