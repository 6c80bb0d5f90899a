"""K9: segmented min sweep of the speckle filter's labels (CUDA,
csrc/speckle.cu).

Replaces primestereomatch_tpu/kernels/speckle_pallas.py::_segmin_kernel.
Along one axis, out = min(forward, backward) segmented min scan of the
labels, where a segment is a run of elements each connected to its
predecessor (`conn`). Bound on the H100 by bytes (9 per pixel, no reuse);
each line is a sequential scan with its state in registers: one thread
per column for axis 0 (a warp reads 32 neighbouring columns), one warp per
row for axis 1 (a shuffle scan over 32 columns at a time).
"""

from __future__ import annotations

import torch

from primestereomatch_torch.kernels import _build

BIG = 1 << 28    # identity of the min; labels are < H * W < BIG


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
    """Plain PyTorch version of the kernel: the forward scan with flags
    `conn`, the backward scan with flags conn shifted by one (element i is
    connected to i+1 when conn[i+1]; False at the end), their min."""
    f = conn.bool()
    fb = torch.cat([f.narrow(axis, 1, f.shape[axis] - 1),
                    torch.zeros_like(f.narrow(axis, 0, 1))], axis)
    fwd = _segmin_dir(m, f, axis)
    bwd = _segmin_dir(m.flip(axis), fb.flip(axis), axis).flip(axis)
    return torch.minimum(fwd, bwd)


def segmin_sweep(m: torch.Tensor, conn: torch.Tensor, axis: int) -> torch.Tensor:
    """(H, W) int32 labels + (H, W) uint8 `conn` (1 = connected to the
    predecessor along `axis`) -> (H, W) int32. Launches the CUDA kernel for
    CUDA tensors; CPU tensors take the plain version."""
    if m.dim() != 2 or conn.shape != m.shape:
        raise ValueError(f"expected matching (H, W) tensors, got {tuple(m.shape)}, "
                         f"{tuple(conn.shape)}")
    if m.dtype != torch.int32 or conn.dtype != torch.uint8:
        raise TypeError(f"expected int32 labels and uint8 conn, got {m.dtype}, {conn.dtype}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if m.device != conn.device:
        raise ValueError("m and conn must be on one device")
    if m.device.type == "cpu":
        return segmin_sweep_plain(m, conn, axis)
    if m.device.type != "cuda":
        raise ValueError(f"unsupported device {m.device}")
    if not (m.is_contiguous() and conn.is_contiguous()):
        raise ValueError("m and conn must be contiguous")
    H, W = m.shape
    out = torch.empty_like(m)
    fn = _build.load("speckle")
    rc = fn(m.data_ptr(), conn.data_ptr(), out.data_ptr(), H, W, axis,
            torch.cuda.current_stream(m.device).cuda_stream)
    _build.check("speckle", rc)
    _build.LAUNCHES["speckle"] += 1
    return out
