"""K7: SGM aggregation over 3, 5 or 8 directions (CUDA, csrc/sgbm_scan.cu).

Replaces primestereomatch_tpu/kernels/sgbm_pallas.py::_sgbm_scan_kernel.
The function is bound on the H100 by integer operations (~8 per direction,
pixel and d); the kernel by the device memory it moves at a 2K frame (every
pass reads the cost and reads and writes its sums) and by a step's latency
at Middlebury sizes. One warp walks each path with its state in registers
and the next pixels of the path in a shared-memory ring filled by cp.async.

Two entry points, as in the JAX package:

  sgbm_aggregate_partials  the main path: narrow group partials, one uint16
                           tensor per group of directions where
                           g * (cost_bound + p2) < 2**16 for the largest
                           group, S never formed; one launch walks a path
                           family of each group (2 launches for 8 and 5
                           directions, 1 for 3). Beyond the bound: the
                           int32 S as the only partial.
  sgbm_aggregate           the int32 S, one launch per path family.
"""

from __future__ import annotations

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.ops.sgbm import _scan_direction, aggregate

# 32 lanes x 64 disparities per lane; (D - 1) * 16 must fit the int16
# disparity output anyway
MAX_D = 2048
# shared memory per warp for the ring of pixels ahead (4 stages): 48 pixels
# in flight at D = 64, 12 at D = 256
RING_BYTES = 16384

ROWS, COLS, DIAG, ANTI = (0, 1), (1, 0), (1, 1), (1, -1)
# per mode: the path families (dy, dx) and whether both directions run
_FAMILIES = {
    8: ((ROWS, True), (COLS, True), (DIAG, True), (ANTI, True)),
    5: ((ROWS, True), (COLS, False), (DIAG, False), (ANTI, False)),
    3: ((ROWS, True), (COLS, False)),
}
# per mode: the two groups of families whose sums share a partial. A launch
# walks the i-th family of each group.
_GROUPS = {8: ((ROWS, COLS), (DIAG, ANTI)), 5: ((ROWS, COLS), (DIAG, ANTI)),
           3: ((ROWS,), (COLS,))}
# (shift, reverse) of ops.sgbm._scan_direction for a family's forward and
# backward pass; rows scan the transposed volume
_PLAIN_SCANS = {ROWS: ((0, False), (0, True)), COLS: ((0, False), (0, True)),
                DIAG: ((1, False), (-1, True)), ANTI: ((-1, False), (1, True))}


# the plain PyTorch version of the kernel's int32 entry (a scan per direction)
sgbm_aggregate_plain = aggregate


def _check(cost: torch.Tensor, num_directions: int) -> None:
    if num_directions not in _FAMILIES:
        raise ValueError(f"num_directions must be 3, 5 or 8, got {num_directions}")
    if cost.dim() != 3:
        raise ValueError(f"expected (H, W, D) cost, got {tuple(cost.shape)}")
    if cost.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"cost must be int16 or int32, got {cost.dtype}")
    if cost.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cost.device}")
    if cost.device.type == "cuda":
        if not cost.is_contiguous():
            raise ValueError("cost must be contiguous")
        if cost.shape[2] > MAX_D:
            raise ValueError(f"the scan kernel takes at most {MAX_D} disparities, "
                             f"got {cost.shape[2]}")


def partial_groups(num_directions: int, cost_bound: int | None, p2: int,
                   cost_dtype: torch.dtype = torch.int16):
    """The groups of path families whose directions are summed into one
    uint16 partial each, or None where only the int32 S is exact: every
    direction's L is at most cost_bound + p2, so a group of g directions
    needs g * (cost_bound + p2) < 2**16. The cost must be int16 (a bound
    below 2**15)."""
    if cost_bound is None or cost_dtype != torch.int16:
        return None
    both = dict(_FAMILIES[num_directions])
    groups = _GROUPS[num_directions]
    g = max(sum(1 + both[f] for f in fams) for fams in groups)
    return groups if g * (int(cost_bound) + int(p2)) < 2**16 else None


def _launch(cost, p1, p2, sums_u16, a, b=None) -> None:
    """One launch: family a = (out, (dy, dx), both, first) and, where given,
    family b into another tensor."""
    H, W, D = cost.shape
    fn = _build.load("sgbm_scan")
    args = []
    for fam in (a, b):
        out, (dy, dx), both, first = fam if fam is not None else (None, (0, 0), 0, 0)
        args += [out.data_ptr() if out is not None else None, dy, dx, int(both), int(first)]
    rc = fn(cost.data_ptr(), int(cost.dtype == torch.int16), int(sums_u16), *args, H, W, D,
            p1, p2, RING_BYTES, torch.cuda.current_stream(cost.device).cuda_stream)
    _build.check("sgbm_scan", rc)
    _build.LAUNCHES["sgbm_scan"] += 1


def sgbm_aggregate(cost: torch.Tensor, p1: int, p2: int,
                   num_directions: int = 8) -> torch.Tensor:
    """(H, W, D) int16/int32 window cost -> (H, W, D) int32 S, the sum of
    the directional DP over the mode's directions. Launches the CUDA kernel
    (one launch per path family) for CUDA tensors; CPU tensors take the
    plain version."""
    _check(cost, num_directions)
    if cost.device.type == "cpu":
        return sgbm_aggregate_plain(cost, p1, p2, num_directions)
    S = torch.empty(cost.shape, dtype=torch.int32, device=cost.device)
    for i, (fam, both) in enumerate(_FAMILIES[num_directions]):
        _launch(cost, p1, p2, False, (S, fam, both, i == 0))
    return S


def sgbm_aggregate_partials_plain(cost: torch.Tensor, p1: int, p2: int,
                                  num_directions: int = 8,
                                  cost_bound: int | None = None) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of `sgbm_aggregate_partials`: the same scans,
    each group's directions summed into its own tensor."""
    groups = partial_groups(num_directions, cost_bound, p2, cost.dtype)
    if groups is None:
        return (sgbm_aggregate_plain(cost, p1, p2, num_directions),)
    both = dict(_FAMILIES[num_directions])
    parts = []
    for fams in groups:
        S = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
        for fam in fams:
            c, s = (cost.transpose(0, 1), S.transpose(0, 1)) if fam == ROWS else (cost, S)
            for shift, reverse in _PLAIN_SCANS[fam][:1 + both[fam]]:
                _scan_direction(c, s, p1, p2, shift, reverse)
        parts.append(S.to(torch.uint16))
    return tuple(parts)


def sgbm_aggregate_partials(cost: torch.Tensor, p1: int, p2: int, num_directions: int = 8,
                            cost_bound: int | None = None) -> tuple[torch.Tensor, ...]:
    """(H, W, D) int16/int32 window cost, every value in [0, cost_bound] ->
    a tuple of (H, W, D) partials whose sum is `sgbm_aggregate`'s S: two
    uint16 tensors where `partial_groups` allows, else the int32 S alone.
    `select_disparity_partials` takes the tuple. Launches the CUDA kernel
    (a path family of each group per launch) for CUDA tensors; CPU tensors
    take the plain version."""
    _check(cost, num_directions)
    if cost.device.type == "cpu":
        return sgbm_aggregate_partials_plain(cost, p1, p2, num_directions, cost_bound)
    groups = partial_groups(num_directions, cost_bound, p2, cost.dtype)
    if groups is None:
        return (sgbm_aggregate(cost, p1, p2, num_directions),)
    both = dict(_FAMILIES[num_directions])
    parts = tuple(torch.empty(cost.shape, dtype=torch.uint16, device=cost.device)
                  for _ in groups)
    for i in range(max(len(fams) for fams in groups)):
        fams = [(out, g[i], both[g[i]], i == 0) for out, g in zip(parts, groups) if i < len(g)]
        _launch(cost, p1, p2, True, *fams)
    return parts


def bytes_per_value(num_directions: int, cost_itemsize: int, partials: bool) -> int:
    """Bytes of device memory the kernel moves per (pixel, d) of the cost:
    every pass reads the cost and reads and writes its sums; the first pass
    into a tensor only writes them."""
    both = dict(_FAMILIES[num_directions])
    groups = _GROUPS[num_directions] if partials else (tuple(both),)
    size = 2 if partials else 4
    passes = sum(1 + both[f] for fams in groups for f in fams)
    return passes * (cost_itemsize + 2 * size) - len(groups) * size
