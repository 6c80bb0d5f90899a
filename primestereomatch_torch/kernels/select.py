"""K8: SGBM disparity selection (CUDA, csrc/select.cu).

Replaces primestereomatch_tpu/kernels/select_pallas.py::_select_kernel_1p
and ::_select_kernel. Bound on the H100 by bytes (S is read once, 4 bytes
per pixel and d). One block per row; a group of lanes per pixel, each lane
loading 16-byte vectors of the pixel's contiguous costs (the vector route)
or single values (the scalar route, for D the vectors do not divide),
keeping them in registers for the argmin, the far-set minimum and
S[d_best +- 1], all folded by shuffles; the pixels' tails batched so a warp
finishes 32 at once; the right-view scatter as a 64-bit atomicMin in
shared memory. The kernel reads the int32 S (`select_disparity`) or the scan
kernel's uint16 group partials, which it adds in registers
(`select_disparity_partials`, the main path). `launch_shape` plans the
launch.
"""

from __future__ import annotations

import torch

from primestereomatch_torch.kernels import _build
from primestereomatch_torch.ops.sgbm import select_disparity_hdw

_SMEM_PER_COLUMN = 12        # 64-bit scatter key + int32 disparity
# csrc/select.cu's shape; change both together: lanes a pixel on the vector
# route and on the scalar one, the values a lane holds at
# once in each route's instances, the most threads a block
LANES = 8
SCALAR_LANES = 32
VALUES_PER_LANE = (8, 16, 32)
SCALAR_VALUES_PER_LANE = (8,)
VECTOR_BYTES = 16
# threads a block: the most a block takes (__launch_bounds__), so a row's
# pixels are spread over 16 warps; within 2% of the fastest shape tried at
# every shape (tune_select.py)
MAX_THREADS = 512


def max_row() -> int:
    """The longest image row a block takes: 12 bytes of shared memory a column."""
    return _build.MAX_SMEM_BYTES // _SMEM_PER_COLUMN


def launch_shape(H: int, W: int, D: int, n_partials: int, aligned: bool = True,
                 threads: int = MAX_THREADS) -> dict:
    """K8's launch for (H, W, D) costs from `n_partials` uint16 partials (0:
    the int32 S): the route (`vector` where the pixel's D values fill whole
    16-byte vectors and the tensors are `aligned` to 16 bytes, else
    `scalar`), the lanes a pixel, the values a lane holds at once (the
    smallest instance that holds the pixel, else the largest, walked in
    `chunks`), the threads a block, the pixels a block holds at once and the
    shared memory (one block an image row, H blocks). Raises where no block
    takes the row."""
    if W * _SMEM_PER_COLUMN > _build.MAX_SMEM_BYTES:
        raise ValueError(f"the select kernel takes rows of at most {max_row()} pixels, "
                         f"got W={W}")
    if D < 1 or n_partials not in (0, 1, 2):
        raise ValueError(f"need D >= 1 and 0-2 partials, got D={D}, {n_partials}")
    elt = 4 if n_partials == 0 else 2
    per_vector = VECTOR_BYTES // elt
    vector = aligned and D % per_vector == 0
    G, opts = (LANES, VALUES_PER_LANE) if vector else (SCALAR_LANES, SCALAR_VALUES_PER_LANE)
    vpl = next((v for v in opts if G * v >= D), opts[-1])
    if threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"threads must be a multiple of 32 up to {MAX_THREADS}, got {threads}")
    return {"route": "vector" if vector else "scalar", "lanes": G,
            "load_bytes": elt * (per_vector if vector else 1), "values_per_lane": vpl,
            "chunks": -(-D // (G * vpl)), "threads": threads,
            "pixels_in_flight": threads // G, "smem": W * _SMEM_PER_COLUMN}


def select_disparity_plain(S: torch.Tensor, uniqueness_ratio: int, disp12_max_diff: int,
                           min_disparity: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel on the same (H, W, D) costs."""
    return select_disparity_hdw(S.transpose(1, 2), uniqueness_ratio, disp12_max_diff,
                                min_disparity)


def _launch(costs: tuple[torch.Tensor, ...], n_partials: int, uniq: int, d12: int,
            min_d: int) -> torch.Tensor:
    """The kernel on the int32 S (n_partials = 0) or on 1-2 uint16 partials."""
    first = costs[0]
    if first.device.type != "cuda":
        raise ValueError(f"unsupported device {first.device}")
    if not all(c.is_contiguous() for c in costs):
        raise ValueError("the costs must be contiguous")
    H, W, D = first.shape
    shape = launch_shape(H, W, D, n_partials,
                         aligned=all(c.data_ptr() % VECTOR_BYTES == 0 for c in costs))
    return launch(_build.load("select"), costs, n_partials, uniq, d12, min_d, shape)


def launch(fn, costs: tuple[torch.Tensor, ...], n_partials: int, uniq: int, d12: int,
           min_d: int, shape: dict) -> torch.Tensor:
    """K8 through the C entry `fn` in the launch shape `shape` (`launch_shape`)."""
    first = costs[0]
    H, W, D = first.shape
    out = torch.empty((H, W), dtype=torch.int16, device=first.device)
    rc = fn(first.data_ptr(), costs[1].data_ptr() if len(costs) > 1 else None, n_partials,
            out.data_ptr(), H, W, D, uniq, d12, min_d, int(shape["route"] == "vector"),
            shape["values_per_lane"], shape["threads"],
            torch.cuda.current_stream(first.device).cuda_stream)
    _build.check("select", rc)
    _build.LAUNCHES["select"] += 1
    return out


def select_disparity(S: torch.Tensor, uniqueness_ratio: int, disp12_max_diff: int,
                     min_disparity: int = 0) -> torch.Tensor:
    """(H, W, D) int32 aggregated costs -> (H, W) int16 disparity x 16
    (invalid: (min_disparity - 1) * 16). Launches the CUDA kernel for CUDA
    tensors; CPU tensors take the plain version."""
    if S.dim() != 3:
        raise ValueError(f"expected (H, W, D) costs, got {tuple(S.shape)}")
    if S.dtype != torch.int32:
        raise TypeError(f"S must be int32, got {S.dtype}")
    if S.device.type == "cpu":
        return select_disparity_plain(S, uniqueness_ratio, disp12_max_diff, min_disparity)
    return _launch((S,), 0, uniqueness_ratio, disp12_max_diff, min_disparity)


def select_disparity_partials_plain(partials, uniqueness_ratio: int, disp12_max_diff: int,
                                    min_disparity: int = 0) -> torch.Tensor:
    """Plain PyTorch version: the selection on the int32 sum of the partials."""
    S = partials[0].to(torch.int32)
    for q in partials[1:]:
        S = S + q.to(torch.int32)
    return select_disparity_plain(S, uniqueness_ratio, disp12_max_diff, min_disparity)


def select_disparity_partials(partials, uniqueness_ratio: int, disp12_max_diff: int,
                              min_disparity: int = 0) -> torch.Tensor:
    """The selection on `sgbm_aggregate_partials`'s tuple: one int32 (H, W,
    D) tensor, or one or two uint16 ones whose sum is the aggregated cost
    -> (H, W) int16 disparity x 16. Launches the CUDA kernel, which adds the
    partials as it reads them, for CUDA tensors; CPU tensors take the plain
    version."""
    partials = tuple(partials)
    if not 1 <= len(partials) <= 2:
        raise ValueError(f"expected one or two partials, got {len(partials)}")
    first = partials[0]
    if first.dim() != 3 or any(q.shape != first.shape or q.device != first.device
                               for q in partials):
        raise ValueError(f"expected (H, W, D) partials of one shape on one device, got "
                         f"{[tuple(q.shape) for q in partials]}")
    if len(partials) == 1 and first.dtype == torch.int32:
        return select_disparity(first, uniqueness_ratio, disp12_max_diff, min_disparity)
    if any(q.dtype != torch.uint16 for q in partials):
        raise TypeError(f"partials must be one int32 tensor or uint16 tensors, got "
                        f"{[q.dtype for q in partials]}")
    if first.device.type == "cpu":
        return select_disparity_partials_plain(partials, uniqueness_ratio, disp12_max_diff,
                                               min_disparity)
    return _launch(partials, len(partials), uniqueness_ratio, disp12_max_diff, min_disparity)
