#!/usr/bin/env python3
"""Time K9 (csrc/speckle.cu, the speckle filter's sweep) in the launch
shapes that were tried, on one NVIDIA card.

    python3 tune_speckle.py

The blocks of the row launch and of the column launch are run-time
arguments of the one library, so nothing is rebuilt for them: each shape
(rows a block, warps a row, columns a block, warps a column) of SHAPES
sweeps the labels and links of chip_smoke.py's SGBM
disparities (Teddy 375x450, D=64, and the 2K pair rounded to uint8,
D=256), must equal the plain version bit for bit, and prints its
CUDA-event time (the C entry called directly) beside that of the hook as
plain-torch ops; then
speckle.cu is built once per staging depth of DEPTHS (elements a thread
stages at once, a -D knob) and each is timed at the shipped shape. Needs
one CUDA card and nvcc, like chip_smoke.py; writes nothing.
"""

from __future__ import annotations

import subprocess
import sys

import torch

import chip_smoke as cs
from primestereomatch_torch import kernels as K
from primestereomatch_torch.kernels import _build
from primestereomatch_torch.kernels.speckle import launch_shape

# (rows a block, warps a row, columns a block, warps a column); the
# shipped shape first, then one warp a line
SHAPES = [(2, 4, 8, 1), (4, 1, 8, 1), (2, 4, 8, 2), (1, 4, 8, 2), (2, 2, 8, 1), (2, 4, 4, 4),
          (2, 4, 16, 1), (8, 2, 8, 2)]


# elements a thread stages at once (csrc/speckle.cu: PSM_K9_U); 4 ships
DEPTHS = (4, 2, 8)


def _timed_sweeps(fn, labels: torch.Tensor, links: torch.Tensor, blocks) -> float:
    """ms of one sweep through the C entry `fn` (not the wrapper, whose
    Python time would be timed too at these sizes), held bitwise against
    the plain version first."""
    H, W = labels.shape
    tmp, out = torch.empty((2, H, W), dtype=torch.int32, device=labels.device)

    def run():
        _build.check("speckle", fn(labels.data_ptr(), links.data_ptr(), tmp.data_ptr(),
                                   out.data_ptr(), None, 1, H, W, *blocks,
                                   torch.cuda.current_stream().cuda_stream))

    run()
    if not torch.equal(out, K.speckle_sweep_plain(labels, links)):
        raise AssertionError(f"K9 with blocks {blocks} differs from its plain version")
    return cs.cuda_ms(run)


def variant_ms(labels: torch.Tensor, links: torch.Tensor, shapes=SHAPES) -> dict:
    """{shape: ms} of one sweep in each block shape."""
    fn = _build.load("speckle")
    return {shape: _timed_sweeps(fn, labels, links, launch_shape(*labels.shape, shape))
            for shape in shapes}


def depth_ms(labels: torch.Tensor, links: torch.Tensor, depths=DEPTHS) -> dict:
    """{depth: ms} of one sweep at the shipped shape, speckle.cu built once
    per staging depth."""
    fns = _build.build_variants("speckle", {u: [f"-DPSM_K9_U={u}"] for u in depths})
    return {u: _timed_sweeps(fn, labels, links, launch_shape(*labels.shape))
            for u, fn in fns.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_speckle: needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    import primestereomatch_torch as psm

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"build: {K.build():.1f} s", flush=True)
    teddy = cs.load_dataset("Teddy")
    left2k, right2k, _ = cs.synthetic_2k(0)
    u8 = [np.clip(np.rint(a * 255), 0, 255).astype(np.uint8) for a in (left2k, right2k)]
    for name, (left, right), D in (("teddy", (teddy.left_bgr, teddy.right_bgr), 64),
                                   ("2k", u8, 256)):
        cfg = psm.SGBMConfig(num_disparities=D)
        labels, links, conns = cs.speckle_inputs(cfg, torch.as_tensor(left, device=dev),
                                                 torch.as_tensor(right, device=dev))
        print(f"{name}: (H, W) = {tuple(labels.shape)}, shipped shape "
              f"{launch_shape(*labels.shape)}; the hook as plain-torch ops "
              f"{cs.cuda_ms(lambda: cs.hook_as_torch_ops(labels, conns)):.4f} ms", flush=True)
        for shape, ms in variant_ms(labels, links).items():
            print(f"  K9 (rows, warps a row, cols, warps a column) = {shape}: {ms:.4f} ms a "
                  f"sweep, 0 labels differ",
                  flush=True)
        for u, ms in depth_ms(labels, links).items():
            print(f"  K9 staging {u} elements a thread: {ms:.4f} ms a sweep, 0 labels differ",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
