"""K7: SGM aggregation over 3, 5 or 8 directions (CUDA, csrc/sgbm_scan.cu).

Replaces primestereomatch_tpu/kernels/sgbm_pallas.py::_sgbm_scan_kernel.
The function is bound on the H100 by integer operations (~8 per direction,
pixel and d). Two designs of the kernel, one picked by the shape (`route`):

  sweeps         the uint16 partials at 128 < D <= 256 and W >= 1600
                 (`takes_sweeps`) where the card holds both sweeps' blocks
                 at once (W <= 2376 on an H100): two sweeps over the image in
                 one cooperative launch, each carrying four directions with
                 their line state on chip, the top-down sweep W->E, NW->SE,
                 N->S and NE->SW, the bottom-up sweep (the same walk
                 mirrored) E->W, SE->NW, S->N and SW->NE. A sweep reads each
                 cost once and writes its directions' sum once: 8 bytes per
                 (pixel, d). A sweep is a block per column strip (`plan`:
                 the strips' width from W and the SM count) and a warp per
                 few of its columns, their states in registers from row to
                 row; neighbouring warps pass their edge columns' states
                 through shared memory, neighbouring strips through device
                 memory (`_SCRATCH`). Every state, cost and sum is 16 bits,
                 two disparities to a 32-bit word, stepped by Hopper's u16x2
                 instructions; exact where no half carries (`halves_hold`).
  path families  every other shape: a warp walks a path, forward and back,
                 its state in registers and the next pixels in a ring in
                 shared memory; a launch walks a family of each group into
                 the uint16 partials (44 bytes per (pixel, d)), or one
                 family into the int32 S (76). It is ahead of the sweeps at
                 every narrower image and at D <= 128 at every shape the
                 timing table has (PERF.md §6): there a sweep's rows wait on
                 their neighbours' hand-offs more than they compute.

Two entry points, as in the JAX package:

  sgbm_aggregate_partials  the main path: narrow group partials, two uint16
                           tensors where g * (cost_bound + p2) < 2**16 for
                           the largest group of g directions of the route
                           (`partial_groups`), S never formed. Beyond the
                           bound: the int32 S as the only partial.
  sgbm_aggregate           the int32 S, one launch per path family.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.ops.sgbm import _scan_direction, aggregate

# 32 lanes x 64 disparities per lane; (D - 1) * 16 must fit the int16
# disparity output anyway
MAX_D = 2048
# the disparities the sweeps take (csrc/sgbm_scan.cu's SWEEP_MIN_D and
# SWEEP_MAX_D: 8 a lane), and the narrowest image: the narrowest width at
# which they were ahead of the path families in the timing table (PERF.md
# §6; they tied at 1280 and lost at 1016 and below)
SWEEPS_MIN_D, SWEEPS_MAX_D = 129, 256
SWEEPS_MIN_W = 1600
# The sweeps keep two disparities to a 32-bit word, 16 bits each
# (csrc/sgbm_scan.cu): exact only where every value of a step lies in
# [0, HALF) (`halves_hold`).
HALF = 1 << 16
# the path families' kernel: shared memory per warp for the ring of pixels
# ahead (4 stages): 48 pixels in flight at D = 64, 12 at D = 256
RING_BYTES = 16384

# The directions, as ops.sgbm._scan_direction scans them: (over rows, i.e.
# the transposed volume; shift; reverse).
W_E, E_W = (True, 0, False), (True, 0, True)
N_S, S_N = (False, 0, False), (False, 0, True)
NW_SE, SE_NW = (False, 1, False), (False, -1, True)
NE_SW, SW_NE = (False, -1, False), (False, 1, True)
# a sweep's four directions in the kernel's order (its bits 1, 2, 4, 8):
# the top-down sweep, and the bottom-up one, which walks the mirrored image
_TOP = (W_E, NW_SE, N_S, NE_SW)
_BOTTOM = (E_W, SE_NW, S_N, SW_NE)
# per mode: the directions each sweep sums, as the kernel's bits
_SWEEP_BITS = {8: (0b1111, 0b1111), 5: (0b1111, 0b0001), 3: (0b0101, 0b0001)}


def _dirs(bits: int, sweep: tuple) -> tuple:
    return tuple(d for i, d in enumerate(sweep) if bits >> i & 1)


# per mode: the groups of directions whose sums share a partial, one a sweep
_GROUPS = {nd: (_dirs(top, _TOP), _dirs(bottom, _BOTTOM))
           for nd, (top, bottom) in _SWEEP_BITS.items()}

# the path families (dy, dx) and their two directions
ROWS, COLS, DIAG, ANTI = (0, 1), (1, 0), (1, 1), (1, -1)
_FAMILY_DIRS = {ROWS: (W_E, E_W), COLS: (N_S, S_N), DIAG: (NW_SE, SE_NW), ANTI: (NE_SW, SW_NE)}
# per mode: the uint16 partials' launches, each a (family, both directions)
# for the first partial and one for the second; the first launch writes
# them, the next adds
_PATH_LAUNCHES = {
    8: (((ROWS, True), (DIAG, True)), ((COLS, True), (ANTI, True))),
    5: (((ROWS, True), (DIAG, False)), ((COLS, False), (ANTI, False))),
    3: (((ROWS, True), (COLS, False)),),
}
_PATH_GROUPS = {nd: tuple(tuple(d for launch in launches
                                for d in _FAMILY_DIRS[launch[i][0]][:1 + launch[i][1]])
                          for i in range(2))
                for nd, launches in _PATH_LAUNCHES.items()}
# per mode: the int32 S's families, a launch each
_FAMILIES = {nd: tuple(fam for launch in launches for fam in launch)
             for nd, launches in _PATH_LAUNCHES.items()}


# the plain PyTorch version of the kernel's int32 entry (a scan per direction)
sgbm_aggregate_plain = aggregate


def _check(cost: torch.Tensor, num_directions: int) -> None:
    if num_directions not in _GROUPS:
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
                   cost_dtype: torch.dtype = torch.int16, route: str = "sweeps"):
    """The groups of directions whose sums go to one uint16 partial each on
    the route ("sweeps": a sweep's; "paths": the path families'), or None
    where they do not fit: every direction's L is at most cost_bound + p2,
    so a group of g directions needs g * (cost_bound + p2) < 2**16. The
    cost must be int16 (a bound below 2**15)."""
    if cost_bound is None or cost_dtype != torch.int16:
        return None
    groups = (_GROUPS if route == "sweeps" else _PATH_GROUPS)[num_directions]
    g = max(len(dirs) for dirs in groups)
    return groups if g * (int(cost_bound) + int(p2)) < 2**16 else None


def takes_sweeps(W: int, D: int) -> bool:
    """Whether the sweeps take an image W pixels wide with D disparities:
    their disparities, at least SWEEPS_MIN_W columns."""
    return SWEEPS_MIN_D <= D <= SWEEPS_MAX_D and W >= SWEEPS_MIN_W


def sweep_p1(p1: int, p2: int) -> int:
    """P1 as the sweeps' step takes it (csrc/sgbm_scan.cu's psm_sgm_sweep):
    every neighbour's L is at least minL, so a P1 above P2 never wins the
    step's min, and the step takes P2 for it."""
    return min(p1, p2)


def pads(p1: int, p2: int) -> tuple[int, int]:
    """What the sweeps' halves at d >= D hold: BIG = HALF - 1 - P1 in the
    state before a path's first pixel and past the lanes' edges (BIG + P1
    fits a half), and HALF - 1 - P2 in the costs, so that a step, which adds
    at most P2 to the cost, keeps such a half in [HALF - 1 - P2, HALF - 1]."""
    return HALF - 1 - sweep_p1(p1, p2), HALF - 1 - p2


def halves_hold(cost_bound: int, p1: int, p2: int) -> bool:
    """Whether the sweeps' 16-bit halves hold every value of a step over
    costs in [0, cost_bound]: no penalty negative (L in [0, cost_bound +
    P2]), every L below BIG (and so L + P1 in a half), and minL + P2 (at
    most cost_bound + 2 P2) in a half, so the halves past D stay at or above
    every L. A group's sum is `partial_groups`' rule."""
    lmax = cost_bound + p2
    return min(cost_bound, p1, p2) >= 0 and lmax + p2 < HALF and lmax < pads(p1, p2)[0]


def route(cost: torch.Tensor, num_directions: int, cost_bound: int | None, p1: int,
          p2: int) -> str:
    """How `sgbm_aggregate_partials` computes this cost: "sweeps" (the
    uint16 partials where `takes_sweeps`, the sweeps' groups fit, their
    halves hold the step and, for a CUDA cost, its card holds both sweeps'
    blocks), "paths" (the uint16 partials of the path families' groups where
    those fit), else "int32" (the S alone, by the path families' kernel)."""
    if (takes_sweeps(*cost.shape[1:])
            and partial_groups(num_directions, cost_bound, p2, cost.dtype) is not None
            and halves_hold(cost_bound, p1, p2)
            and (cost.device.type != "cuda" or plan(cost) is not None)):
        return "sweeps"
    if partial_groups(num_directions, cost_bound, p2, cost.dtype, "paths") is not None:
        return "paths"
    return "int32"


class Plan(NamedTuple):
    """A sweeps launch's shape (csrc/sgbm_scan.cu's psm_sgm_sweep_plan): the
    strips of a sweep and their width, a block's warps and a warp's columns,
    a block's shared memory, the blocks an SM the card holds (the residency
    the cooperative launch needs), the bytes of the edge slots, the card's
    SMs."""
    strips: int
    strip_width: int
    warps: int
    cols: int
    smem: int
    blocks_per_sm: int
    edge_bytes: int
    sms: int


_PLANS: dict = {}
_REFUSED = 9                     # cudaErrorInvalidConfiguration: the card cannot hold it
# per (device, stream): the edge slots, and the sequence the next launch's
# tags start above
_SCRATCH: dict = {}


def plan(cost: torch.Tensor) -> Plan | None:
    """The sweeps' launch over this int16 cost on its card, or None where
    the card cannot hold all of its blocks at once (too wide an image for
    its strips)."""
    W, D = cost.shape[1:]
    key = (cost.device, W, D)
    if key not in _PLANS:
        out = (ctypes.c_longlong * len(Plan._fields))()
        with torch.cuda.device(cost.device):
            rc = _build.load("sgbm_sweep_plan")(W, D, out)
        if rc != _REFUSED:
            _build.check("sgbm_sweep_plan", rc)
        _PLANS[key] = Plan(*out) if rc != _REFUSED else None
    return _PLANS[key]


def _scratch(cost: torch.Tensor, pl: Plan, stream: int) -> tuple[torch.Tensor, int]:
    """The scratch of the cost's card and stream, at least the plan's bytes,
    and the sequence for a launch over H rows. Allocated zeroed, and zeroed
    again only where the sequence would wrap: each launch's tags are above
    every earlier one's, so no slot is ever reset."""
    H = cost.shape[0]
    key = (cost.device, stream)
    buf, seq = _SCRATCH.get(key, (None, 0))
    if buf is None or buf.numel() < pl.edge_bytes:
        buf = torch.zeros(pl.edge_bytes, dtype=torch.uint8, device=cost.device)
    if seq + H + 2 >= 2**32:
        buf.zero_()
        seq = 0
    _SCRATCH[key] = (buf, seq + H + 1)
    return buf, seq


def _sweeps(cost, p1, p2, num_directions, parts) -> None:
    """Both sweeps in one launch, the top-down one into parts[0], the
    bottom-up one into parts[1]."""
    H, W, D = cost.shape
    pl = plan(cost)
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    buf, seq = _scratch(cost, pl, stream)
    top, bottom = _SWEEP_BITS[num_directions]
    with torch.cuda.device(cost.device):
        rc = _build.load("sgbm_sweep")(cost.data_ptr(), parts[0].data_ptr(), top,
                                       parts[1].data_ptr(), bottom, H, W, D, p1, p2,
                                       (ctypes.c_longlong * len(pl))(*pl), buf.data_ptr(), seq,
                                       stream)
    _build.check("sgbm_scan", rc)
    _build.LAUNCHES["sgbm_scan"] += 1
    _build.SWEEPS["sgbm_scan"] += 2


def _launch(cost, p1, p2, sums_u16, a, b=None) -> None:
    """One path families' launch: family a = (out, (dy, dx), both, first)
    and, where given, family b into another tensor."""
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


def _paths(cost, p1, p2, num_directions, parts) -> None:
    """The path families' launches into the two uint16 partials."""
    for i, launch in enumerate(_PATH_LAUNCHES[num_directions]):
        _launch(cost, p1, p2, True, *((out, fam, both, i == 0)
                                      for out, (fam, both) in zip(parts, launch)))


def sgbm_aggregate(cost: torch.Tensor, p1: int, p2: int,
                   num_directions: int = 8) -> torch.Tensor:
    """(H, W, D) int16/int32 window cost -> (H, W, D) int32 S, the sum of
    the directional DP over the mode's directions. Launches the path
    families' kernel (one launch per family) for CUDA tensors; CPU tensors
    take the plain version."""
    _check(cost, num_directions)
    if cost.device.type == "cpu":
        return sgbm_aggregate_plain(cost, p1, p2, num_directions)
    S = torch.empty(cost.shape, dtype=torch.int32, device=cost.device)
    for i, (fam, both) in enumerate(_FAMILIES[num_directions]):
        _launch(cost, p1, p2, False, (S, fam, both, i == 0))
    return S


def sum_groups_plain(cost: torch.Tensor, p1: int, p2: int, groups) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch: each group's directions scanned and summed into its
    own uint16 tensor."""
    parts = []
    for dirs in groups:
        S = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
        for rows, shift, reverse in dirs:
            c, s = (cost.transpose(0, 1), S.transpose(0, 1)) if rows else (cost, S)
            _scan_direction(c, s, p1, p2, shift, reverse)
        parts.append(S.to(torch.uint16))
    return tuple(parts)


def sgbm_aggregate_partials_plain(cost: torch.Tensor, p1: int, p2: int,
                                  num_directions: int = 8,
                                  cost_bound: int | None = None) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of `sgbm_aggregate_partials`: the same scans,
    each group of the cost's route summed into its own tensor."""
    r = route(cost, num_directions, cost_bound, p1, p2)
    if r == "int32":
        return (sgbm_aggregate_plain(cost, p1, p2, num_directions),)
    return sum_groups_plain(cost, p1, p2,
                            partial_groups(num_directions, cost_bound, p2, cost.dtype, r))


def sgbm_aggregate_partials(cost: torch.Tensor, p1: int, p2: int, num_directions: int = 8,
                            cost_bound: int | None = None) -> tuple[torch.Tensor, ...]:
    """(H, W, D) int16/int32 window cost, every value in [0, cost_bound] ->
    a tuple of (H, W, D) partials whose sum is `sgbm_aggregate`'s S: two
    uint16 tensors where `partial_groups` allows, else the int32 S alone.
    `select_disparity_partials` takes the tuple. Launches the CUDA kernel of
    the cost's `route` for CUDA tensors; CPU tensors take the plain
    version."""
    _check(cost, num_directions)
    if cost.device.type == "cpu":
        return sgbm_aggregate_partials_plain(cost, p1, p2, num_directions, cost_bound)
    r = route(cost, num_directions, cost_bound, p1, p2)
    if r == "int32":
        return (sgbm_aggregate(cost, p1, p2, num_directions),)
    parts = tuple(torch.empty(cost.shape, dtype=torch.uint16, device=cost.device)
                  for _ in range(2))
    (_sweeps if r == "sweeps" else _paths)(cost, p1, p2, num_directions, parts)
    return parts


def bytes_per_value(num_directions: int, cost_itemsize: int, route: str) -> int:
    """Bytes of device memory the kernel moves per (pixel, d) of the cost on
    the route. The sweeps: each reads the cost once and writes its uint16
    sums once (the edge slots, a few rows of a column per strip, left out).
    The path families ("paths" into the uint16 partials, "int32" into the
    S): every pass reads the cost and reads and writes its sums; the first
    pass into a tensor only writes them."""
    if route == "sweeps":
        return 2 * (cost_itemsize + 2)
    launches = _PATH_LAUNCHES[num_directions]
    size, tensors = (2, 2) if route == "paths" else (4, 1)
    passes = sum(1 + both for launch in launches for _, both in launch)
    return passes * (cost_itemsize + 2 * size) - tensors * size
