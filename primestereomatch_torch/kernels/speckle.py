"""K9: the speckle filter's sweep (CUDA, csrc/speckle.cu).

Replaces primestereomatch_tpu/kernels/speckle_pallas.py::_segmin_kernel
and the hook step around it. `speckle_sweep` is one sweep of min-label
propagation: the hook (each label takes the min over the neighbours it is
linked to), then the segmented min scans along rows and along columns; two
launches, and a device flag that records whether a label changed.
`segmin_sweep` is the TPU kernel's function alone: the segmented min scan
along one axis over a conn plane.

Bound on the H100 by bytes (9 per pixel, no reuse) but latency-bound as a
walk along a line: a few warps stage a line in shared memory and each lane
scans a segment of it, the segments' summaries joined by a shuffle scan
and the warps' totals.
"""

from __future__ import annotations

import functools

import torch

from primestereomatch_torch.kernels import _build

BIG = 1 << 28    # identity of the min; labels are < H * W < BIG
# bits of the packed link mask (csrc/speckle.cu mirrors them)
LINK_UP, LINK_DOWN, LINK_LEFT, LINK_RIGHT = 1, 2, 4, 8
# (rows a block of the row launch, warps a row, columns a block of the
# column launch, warps a column), the first that fits: see launch_shape
SHAPE = (2, 4, 8, 1)
COL_PAD = 8      # ints between two columns' lines (csrc/speckle.cu)
MAX_THREADS = 512   # a block's (csrc/speckle.cu)


def _block_bytes(n: int, warps: int, lines: int, pad: int) -> int:
    """Shared memory of a block of `lines` lines of n, `warps` warps a line
    (csrc/speckle.cu::block_ints): 32 segments a warp at an odd pitch, and
    4 ints a warp for the warps' totals."""
    seg = -(-n // (32 * warps))
    return 4 * lines * (32 * warps * (seg | 1) + pad + 4 * warps)


def row_smem_bytes(W: int, rows: int, warps: int) -> int:
    return _block_bytes(W, warps, rows, 0)


def col_smem_bytes(H: int, cols: int, warps: int) -> int:
    return _block_bytes(H, warps, cols, COL_PAD)


@functools.lru_cache(maxsize=64)   # the filter asks once a sweep
def launch_shape(H: int, W: int, shape: tuple[int, int, int, int] = SHAPE
                 ) -> tuple[int, int, int, int]:
    """(rows, row_warps, cols, col_warps) of a sweep: `shape`, with the
    lines a block (rows, cols) halved until the block fits shared memory.
    Raises where one line does not fit, or the shape is not one the
    kernels take (a power-of-two strip, at most 1024 threads a block)."""
    rows, rw, cols, cw = shape
    if cols & (cols - 1) or 32 * max(rw * rows, cw * cols) > MAX_THREADS or min(shape) < 1:
        raise ValueError(f"K9 takes no block shape {shape}")
    while rows > 1 and row_smem_bytes(W, rows, rw) > _build.MAX_SMEM_BYTES:
        rows //= 2
    while cols > 1 and col_smem_bytes(H, cols, cw) > _build.MAX_SMEM_BYTES:
        cols //= 2
    if (row_smem_bytes(W, rows, rw) > _build.MAX_SMEM_BYTES
            or col_smem_bytes(H, cols, cw) > _build.MAX_SMEM_BYTES):
        raise ValueError(f"a {H}x{W} image has lines longer than K9's shared memory holds")
    return rows, rw, cols, cw


def _segmin_dir(v: torch.Tensor, f: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive segmented min scan along `dim` (forward), f = connected to
    the predecessor, by doubling: each step combines with the element k
    back, the identity (BIG, connected) shifted in at the start."""
    n = v.shape[dim]
    k = 1
    while k < n:
        v_s = torch.cat([torch.full_like(v.narrow(dim, 0, k), BIG), v.narrow(dim, 0, n - k)], dim)
        f_s = torch.cat([torch.ones_like(f.narrow(dim, 0, k)), f.narrow(dim, 0, n - k)], dim)
        v = torch.where(f, torch.minimum(v_s, v), v)
        f = f & f_s
        k *= 2
    return v


def segmin_sweep_plain(m: torch.Tensor, conn: torch.Tensor, axis: int) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel's function: the forward scan
    with flags `conn`, the backward scan with flags conn shifted by one
    (element i is connected to i+1 when conn[i+1]; False at the end), their
    min."""
    f = conn.bool()
    fb = torch.cat([f.narrow(axis, 1, f.shape[axis] - 1),
                    torch.zeros_like(f.narrow(axis, 0, 1))], axis)
    fwd = _segmin_dir(m, f, axis)
    bwd = _segmin_dir(m.flip(axis), fb.flip(axis), axis).flip(axis)
    return torch.minimum(fwd, bwd)


def pack_links(up: torch.Tensor, dn: torch.Tensor, lf: torch.Tensor,
               rt: torch.Tensor) -> torch.Tensor:
    """The four bool link planes -> one (H, W) uint8 mask."""
    return (up.to(torch.uint8) * LINK_UP + dn.to(torch.uint8) * LINK_DOWN
            + lf.to(torch.uint8) * LINK_LEFT + rt.to(torch.uint8) * LINK_RIGHT)


def _neighbour(a: torch.Tensor, dim: int, off: int) -> torch.Tensor:
    """a[i + off] along `dim`; BIG where that index lies outside."""
    n = a.shape[dim]
    out = torch.full_like(a, BIG)
    if abs(off) < n:
        out.narrow(dim, max(-off, 0), n - abs(off)).copy_(a.narrow(dim, max(off, 0),
                                                                   n - abs(off)))
    return out


def hook_plain(labels: torch.Tensor, links: torch.Tensor) -> torch.Tensor:
    """The min over each label and the up, down, left and right neighbours
    it is linked to (a link out of the image is ignored)."""
    m = labels
    for bit, dim, off in ((LINK_UP, 0, -1), (LINK_DOWN, 0, 1), (LINK_LEFT, 1, -1),
                          (LINK_RIGHT, 1, 1)):
        m = torch.minimum(m, torch.where((links & bit) != 0, _neighbour(labels, dim, off), BIG))
    return m


def speckle_sweep_plain(labels: torch.Tensor, links: torch.Tensor,
                        changed: torch.Tensor | None = None, stamp: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the sweep: the hook, the row scan over the
    left links, the column scan over the up links. Writes `stamp` into
    `changed[0]` where the result differs from `labels`."""
    m = hook_plain(labels, links)
    m = segmin_sweep_plain(m, (links & LINK_LEFT) != 0, 1)
    out = segmin_sweep_plain(m, (links & LINK_UP) != 0, 0)
    if changed is not None:
        changed.copy_(torch.where((out != labels).any(), stamp, changed))
    return out


def _check(m: torch.Tensor, conn: torch.Tensor, what: str) -> None:
    if m.dim() != 2 or conn.shape != m.shape:
        raise ValueError(f"expected matching (H, W) tensors, got {tuple(m.shape)}, "
                         f"{tuple(conn.shape)}")
    if m.dtype != torch.int32 or conn.dtype != torch.uint8:
        raise TypeError(f"expected int32 labels and uint8 {what}, got {m.dtype}, {conn.dtype}")
    if m.numel() >= BIG:
        raise ValueError(f"{tuple(m.shape)} has more than 2**28 pixels")
    if m.device != conn.device:
        raise ValueError(f"labels and {what} must be on one device")
    if m.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {m.device}")
    if m.device.type == "cuda" and not (m.is_contiguous() and conn.is_contiguous()):
        raise ValueError(f"labels and {what} must be contiguous")


def speckle_sweep(labels: torch.Tensor, links: torch.Tensor,
                  changed: torch.Tensor | None = None, stamp: int = 1,
                  shape: tuple[int, int, int, int] = SHAPE) -> torch.Tensor:
    """(H, W) int32 labels in [0, 2**28) + (H, W) uint8 link mask
    (`pack_links`) -> the labels after one sweep. Where a label changed,
    `stamp` is written into `changed[0]` (an int32 tensor of one element on
    the labels' device), so a caller tests convergence by reading one int.
    `shape`: the blocks, as `launch_shape(H, W, shape)` fits them.
    Launches the two CUDA kernels for CUDA tensors; CPU tensors take the
    plain version."""
    _check(labels, links, "links")
    if changed is not None and (changed.shape != (1,) or changed.dtype != torch.int32
                                or changed.device != labels.device):
        raise ValueError("changed must be a (1,) int32 tensor on the labels' device")
    if labels.device.type == "cpu":
        return speckle_sweep_plain(labels, links, changed, stamp)
    H, W = labels.shape
    blocks = launch_shape(H, W, shape)
    tmp, out = torch.empty((2, H, W), dtype=torch.int32, device=labels.device)
    fn = _build.load("speckle")
    rc = fn(labels.data_ptr(), links.data_ptr(), tmp.data_ptr(), out.data_ptr(),
            changed.data_ptr() if changed is not None else None, stamp, H, W, *blocks,
            torch.cuda.current_stream(labels.device).cuda_stream)
    _build.check("speckle", rc)
    _build.LAUNCHES["speckle"] += 2     # the row launch and the column launch
    return out


def segmin_sweep(m: torch.Tensor, conn: torch.Tensor, axis: int) -> torch.Tensor:
    """(H, W) int32 labels in [0, 2**28) + (H, W) uint8 `conn` (nonzero =
    connected to the predecessor along `axis`) -> (H, W) int32. Launches the
    CUDA kernel (the sweep's row or column pass without the hook) for CUDA
    tensors; CPU tensors take the plain version."""
    _check(m, conn, "conn")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if m.device.type == "cpu":
        return segmin_sweep_plain(m, conn, axis)
    H, W = m.shape
    blocks = launch_shape(H, W)
    out = torch.empty_like(m)
    fn = _build.load("segmin")
    rc = fn(m.data_ptr(), conn.data_ptr(), out.data_ptr(), H, W, axis, *blocks,
            torch.cuda.current_stream(m.device).cuda_stream)
    _build.check("segmin", rc)
    _build.LAUNCHES["segmin"] += 1
    return out
