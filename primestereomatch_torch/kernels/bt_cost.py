"""K6: BT pixel cost + k x k window sum of SGBM (CUDA, csrc/bt_cost.cu).

Replaces primestereomatch_tpu/kernels/sgbm_pallas.py::_bt_cost_kernel.
Bound on the H100 by integer operations (~10 per channel and (y, x, d)).
One launch: a block walks a strip of rows, stages each row's left and
right BT interpolants in shared memory once, computes each pixel cost once
per row, and sums the window with a sliding horizontal sum and a running
vertical one, writing every output once; no scratch volume. `plan` mirrors
the kernel's tile and shared-memory arithmetic, `launch_shape` picks the
strip and disparity chunk per shape.
"""

from __future__ import annotations

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.ops.sgbm import bt_block_cost, cost_dtype

# csrc/bt_cost.cu's shape: cost-plane columns a block computes per row
# (NCOL), threads a block (NT), and the disparity chunks it has instances
# for; change both together
COLUMNS = 64
THREADS = 256
D_CHUNKS = (64, 32)
BLOCKS_PER_SM = 3   # what the kernel's registers are bounded for
# (strip rows, disparities a block) in the order `launch_shape` tries them:
# longer strips recompute fewer halo rows, longer chunks share more
# interpolants; shorter ones fill the card at small images
SHAPES = ((32, 64), (16, 64), (32, 32), (16, 32))


def plan(k: int, C: int, out_bytes: int, strip: int = SHAPES[0][0],
         d_chunk: int | None = None) -> dict:
    """The launch shape of K6 for k x k windows, C channels and outputs of
    `out_bytes` bytes: output columns a block (`tile`), disparities a block
    (`d_chunk`, the first of D_CHUNKS whose block fits unless given), the
    run of output columns a thread sums (`run`) and the shared memory.
    Raises where no instance takes the shape."""
    if not 1 <= k <= COLUMNS:
        raise ValueError(f"block_size {k} must be in [1, {COLUMNS}] for the kernel's "
                         f"{COLUMNS}-column rows")
    tile = COLUMNS - (k - 1)
    for dc in (d_chunk,) if d_chunk else D_CHUNKS:
        if dc not in D_CHUNKS:
            raise ValueError(f"d_chunk {dc} has no instance; the kernel takes {D_CHUNKS}")
        run = -(-tile // (THREADS // dc))
        # pixel costs of a row, two staging buffers of (f, min, max) x C x
        # (left + right columns), the ring of k horizontal sums per output
        smem = (4 * (COLUMNS * (dc + 1) + 2 * 3 * C * (2 * COLUMNS + dc))
                + out_bytes * k * run * THREADS)
        if smem <= _build.MAX_SMEM_BYTES:
            return {"tile": tile, "d_chunk": dc, "run": run, "strip": strip, "smem": smem}
    raise ValueError(f"a K6 block for a {k}x{k} window over {C} channels needs more "
                     f"shared memory than the card gives a block")


def launch_shape(H: int, W: int, D: int, k: int, C: int, out_bytes: int,
                 sm_count: int) -> dict:
    """The plan of the first of SHAPES whose launch holds a block for every
    block the card runs at once (BLOCKS_PER_SM an SM), else of the last
    that fits: 32 rows and 64 disparities at 2K, 16 and 32 at Teddy."""
    shape = None
    for strip, dc in SHAPES:
        try:
            shape = plan(k, C, out_bytes, strip, dc)
        except ValueError:
            continue
        blocks = -(-W // shape["tile"]) * -(-D // dc) * -(-H // strip)
        if blocks >= BLOCKS_PER_SM * sm_count:
            break
    if shape is None:
        return plan(k, C, out_bytes)      # raises
    return shape


def bt_cost_plain(l_ftr: torch.Tensor, r_ftr: torch.Tensor, max_dis: int, block_size: int,
                  cost_bound: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, (H, W, D) out."""
    return bt_block_cost(l_ftr, r_ftr, max_dis, block_size, cost_bound, out_layout="hwd")


def bt_cost(l_ftr: torch.Tensor, r_ftr: torch.Tensor, max_dis: int, block_size: int,
            cost_bound: int | None = None) -> torch.Tensor:
    """(H, W, C) int32 features of both views -> (H, W, D) window cost,
    int16 when `cost_bound` < 2**15 else int32. Launches the CUDA kernel
    for CUDA tensors; CPU tensors take the plain version."""
    if l_ftr.dim() != 3 or r_ftr.shape != l_ftr.shape:
        raise ValueError(f"expected matching (H, W, C) features, got {tuple(l_ftr.shape)}, "
                         f"{tuple(r_ftr.shape)}")
    if l_ftr.dtype != torch.int32 or r_ftr.dtype != torch.int32:
        raise TypeError("features must be int32")
    if max_dis < 1 or block_size < 1:
        raise ValueError(f"need max_dis >= 1 and block_size >= 1, got {max_dis}, {block_size}")
    if l_ftr.device != r_ftr.device:
        raise ValueError("features must be on one device")
    if l_ftr.device.type == "cpu":
        return bt_cost_plain(l_ftr, r_ftr, max_dis, block_size, cost_bound)
    if l_ftr.device.type != "cuda":
        raise ValueError(f"unsupported device {l_ftr.device}")
    if not (l_ftr.is_contiguous() and r_ftr.is_contiguous()):
        raise ValueError("features must be contiguous")
    H, W, C = l_ftr.shape
    dt = cost_dtype(cost_bound)
    out = torch.empty((H, W, max_dis), dtype=dt, device=l_ftr.device)
    sms = torch.cuda.get_device_properties(l_ftr.device).multi_processor_count
    return launch(_build.load("bt_cost"), l_ftr, r_ftr, out, block_size,
                  launch_shape(H, W, max_dis, block_size, C, out.element_size(), sms))


def launch(fn, l_ftr: torch.Tensor, r_ftr: torch.Tensor, out: torch.Tensor, block_size: int,
           shape: dict) -> torch.Tensor:
    """K6 through the C entry `fn` in the launch shape `shape` (`plan`)."""
    H, W, C = l_ftr.shape
    rc = fn(l_ftr.data_ptr(), r_ftr.data_ptr(), out.data_ptr(), int(out.dtype == torch.int16),
            H, W, C, out.shape[2], block_size, shape["strip"], shape["d_chunk"],
            torch.cuda.current_stream(l_ftr.device).cuda_stream)
    _build.check("bt_cost", rc)
    _build.LAUNCHES["bt_cost"] += 1
    return out
