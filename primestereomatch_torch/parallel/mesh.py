"""Device-mesh construction for the sharded stereo pipeline over
torch.distributed (port of the JAX package's parallel/mesh.py).

The reference parallelises disparity levels and rows inside one memory
domain (OpenMP over d, src/DispEst.cpp:209-294; over y, src/DispSel.cpp:88).
Here both become dimensions of a mesh of ranks, one device a rank:

  b: frame batch (pure data parallelism, the throughput and video axis)
  y: image row tiles (a halo exchange of the windowed stages' support
     rows between neighbouring ranks)
  d: disparity blocks (each rank builds and filters its block; the WTA
     merges with an all-gather of (min, argmin), an associative min)

Columns stay whole: the cost at disparity d reads pixels up to d columns
away, so a column halo would be as wide as the disparity range.
"""

from __future__ import annotations

import dataclasses

import torch

AXIS_BATCH = "b"
AXIS_ROWS = "y"
AXIS_DISP = "d"


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    batch: int
    rows: int
    disp: int

    @property
    def n_devices(self) -> int:
        return self.batch * self.rows * self.disp


def factor_devices(n: int, max_disp_shards: int = 4) -> MeshPlan:
    """Factor n devices into (b, y, d): the disparity axis takes a small
    power of two (its all-gather merge is the cheapest collective, but the
    cost build re-reads the images on every d rank), rows the next one
    (the halo's share falls as tiles grow), and batch the rest."""
    if n < 1:
        raise ValueError(f"need >= 1 device, got {n}")
    d = 1
    while d * 2 <= max_disp_shards and n % (d * 2) == 0:
        d *= 2
    rem = n // d
    y = 1
    while y * 2 <= 4 and rem % (y * 2) == 0:
        y *= 2
    b = rem // y
    return MeshPlan(batch=b, rows=y, disp=d)


def make_mesh(plan: MeshPlan | None = None, device_type: str | None = None,
              ranks: list[int] | None = None):
    """A (b, y, d) `DeviceMesh` with `mesh_dim_names=("b", "y", "d")` over
    `ranks` (default: every rank of the initialised process group, in
    order; the counterpart of the JAX `devices`). `plan=None` factors their
    number (`factor_devices`). `device_type=None` means "cuda", which needs
    a card; "cpu" runs the plain versions. Every rank of the group calls
    it; a rank outside `ranks` gets a mesh without a coordinate."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "primestereomatch_torch.parallel.launch.initialize first")
    device_type = "cuda" if device_type is None else device_type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu' to run the plain "
                           "PyTorch versions of the kernels on the CPU")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}")
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    if plan is None:
        plan = factor_devices(len(ranks))
    if plan.n_devices != len(ranks):
        raise ValueError(f"{plan} does not cover {len(ranks)} devices")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(plan.batch, plan.rows, plan.disp)
    return DeviceMesh(device_type, grid, mesh_dim_names=(AXIS_BATCH, AXIS_ROWS, AXIS_DISP))
