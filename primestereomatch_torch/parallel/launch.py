"""Multi-process launcher of the sharded pipeline over torch.distributed
(port of the JAX package's parallel/launch.py).

  * `initialize(...)`: `dist.init_process_group` from a `host:port`
    coordinator (tcp://) or from the environment (env://), one process a
    rank and one device a rank. The backend is NCCL when every rank of the
    host has a card of its own, gloo otherwise: on the CPU, and for
    several ranks on one card, which NCCL refuses. Under gloo the
    collectives of CUDA tensors are staged through host memory
    (parallel/sharded.py); it prints which.
  * `worker_main(...)`: one rank: initialize, build the (b, y, d) mesh over
    every rank, feed every rank the same seeded global batch, run the
    sharded STEREO_GIF step on its block and, with --check, hold the block
    bitwise against the single-device pipeline on the same device.
  * CLI (`python -m primestereomatch_torch.launch`):
      - `local --processes N`: spawn N coordinated ranks on this machine
        (`--device cpu` for the plain versions; on one card they share it
        under gloo);
      - `worker --coordinator H:P --num-processes N --process-id I`: one
        rank, one invocation a rank.

Several hosts, one process per card (LOCAL_RANK / LOCAL_WORLD_SIZE from
the environment pick the card and the backend):

    python -m primestereomatch_torch.launch worker \\
        --coordinator 10.0.0.1:8476 --num-processes 8 --process-id $RANK
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from primestereomatch_torch.utils.device import resolve_device


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | None = None,
) -> str:
    """Join the process group; returns its backend. Without a coordinator
    the group comes from the environment (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE). `device` None means the card (it raises without one):
    rank r drives card LOCAL_RANK (default r) modulo the cards there are.
    On the CPU each rank takes its share of the host's cores as threads."""
    dev = resolve_device(device)
    if coordinator_address is not None:
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                    rank=process_id)
        world, rank = num_processes, process_id
    else:
        init = dict(init_method="env://")
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dev.type == "cpu":
        # the host's cores shared out among its ranks, not each rank taking all
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
    backend, staged = "gloo", False
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % n_cards)
        torch.cuda.init()
        if local_world <= n_cards:
            backend = "nccl"
        else:
            staged = True
    dist.init_process_group(backend=backend, **init)
    where = f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else "cpu"
    print(f"[rank {rank}/{world}] torch.distributed backend {backend} on {where}"
          + ("; collectives of CUDA tensors staged through host memory (gloo has no CUDA "
             "send/recv/all_gather)" if staged else ""), flush=True)
    return backend


def worker_main(
    coordinator: str | None,
    num_processes: int | None,
    process_id: int | None,
    batch: int = 2,
    height: int = 64,
    width: int = 96,
    max_dis: int = 16,
    subsample: int = 4,
    check: bool = True,
    seed: int = 0,
    mesh_shape: str | None = None,   # "b,y,d", e.g. "1,2,2"
    device: str | None = None,
) -> int:
    """One rank of the sharded STEREO_GIF step; returns 0 on success (with
    `check`, the rank's block bitwise equal to the single-device
    pipeline's)."""
    from primestereomatch_torch.config import GIFConfig
    from primestereomatch_torch.models.gif_pipeline import stereo_gif_forward
    from primestereomatch_torch.parallel.mesh import MeshPlan, factor_devices, make_mesh
    from primestereomatch_torch.parallel.sharded import make_sharded_gif, mesh_device

    initialize(coordinator, num_processes, process_id, device)
    try:
        n = dist.get_world_size()
        if mesh_shape:
            b, y, d = (int(t) for t in mesh_shape.split(","))
            plan = MeshPlan(batch=b, rows=y, disp=d)
        else:
            plan = factor_devices(n)
        mesh = make_mesh(plan, resolve_device(device).type)
        dev = mesh_device(mesh)
        cfg = GIFConfig(max_dis=max_dis, subsample=subsample)
        step = make_sharded_gif(mesh, cfg)

        # the same seeded global batch on every rank; each computes its block
        rng = np.random.default_rng(seed)
        l_np = rng.random((batch, height, width, 3), np.float32)
        r_np = rng.random((batch, height, width, 3), np.float32)
        l_blk, r_blk, (bsl, rows) = step(l_np, r_np)

        rc = 0
        if check:
            for i, f in enumerate(range(batch)[bsl]):
                want = stereo_gif_forward(l_np[f], r_np[f], cfg, device=dev)
                for view, got, exp in (("left", l_blk[i], want[0]), ("right", r_blk[i],
                                                                    want[1])):
                    exp = exp[rows]
                    if not torch.equal(got, exp):
                        bad = (got != exp).float().mean().item()
                        print(f"[rank {dist.get_rank()}] frame {f} {view} rows "
                              f"{rows.start}:{rows.stop} MISMATCH ({bad:.2%} px)",
                              file=sys.stderr, flush=True)
                        rc = 1
        print(f"[rank {dist.get_rank()}] ok: mesh (b, y, d) = ({plan.batch}, {plan.rows}, "
              f"{plan.disp}) over {n} devices, block frames {bsl.start}:{bsl.stop} rows "
              f"{rows.start}:{rows.stop} of ({batch}, {height}, {width}) "
              f"{'(verified bitwise)' if check and rc == 0 else ''}", flush=True)
        return rc
    finally:
        dist.destroy_process_group()


def spawn_local(
    processes: int,
    devices_per_process: int = 1,
    port: int = 8476,
    timeout: float = 600.0,
    **worker_kw,
) -> int:
    """Spawn `processes` coordinated ranks on this machine and wait for
    them; if one fails, the others are stopped (they would wait on it)."""
    if devices_per_process != 1:
        raise ValueError(f"devices_per_process={devices_per_process}: a torch rank drives "
                         f"one device, so it must be 1")
    args = [
        sys.executable, "-m", "primestereomatch_torch.parallel.launch", "worker",
        "--coordinator", f"localhost:{port}",
        "--num-processes", str(processes),
    ]
    for k, v in worker_kw.items():
        if v is None:
            continue
        if isinstance(v, bool):
            if not v:
                args += [f"--no-{k.replace('_', '-')}"]
        else:
            args += [f"--{k.replace('_', '-')}", str(v)]
    env = dict(os.environ)
    # the repo root only, as the JAX launcher sets it
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen(args + ["--process-id", str(i)], env=env)
             for i in range(processes)]
    deadline = time.monotonic() + timeout
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) or time.monotonic() > deadline:
                rc = 1
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for p in procs:
        rc |= p.returncode != 0
    return int(rc)


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="psm-torch-launch",
        description="multi-process launcher of the sharded pipeline over torch.distributed",
    )
    sub = ap.add_subparsers(dest="mode", required=True)

    def common(p):
        p.add_argument("--batch", type=int, default=2)
        p.add_argument("--height", type=int, default=64)
        p.add_argument("--width", type=int, default=96)
        p.add_argument("--max-dis", type=int, default=16)
        p.add_argument("--subsample", type=int, default=4)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument(
            "--check", action=argparse.BooleanOptionalAction, default=True,
            help="verify each rank's block bitwise vs the single-device pipeline",
        )
        p.add_argument(
            "--mesh-shape", default=None,
            help="explicit 'b,y,d' mesh (default: factor_devices heuristic)",
        )
        p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                       help="device of every rank (default: the card)")

    w = sub.add_parser("worker", help="one rank (one per process)")
    w.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (default: env:// from the environment)")
    w.add_argument("--num-processes", type=int, default=None)
    w.add_argument("--process-id", type=int, default=None)
    common(w)

    l = sub.add_parser("local", help="spawn N coordinated ranks on this machine")
    l.add_argument("--processes", type=int, default=2)
    l.add_argument("--devices-per-process", type=int, default=1,
                   help="must be 1: a torch rank drives one device (the JAX launcher's "
                        "virtual CPU devices per process have no counterpart)")
    l.add_argument("--port", type=int, default=8476)
    common(l)
    return ap


def main(argv: list[str] | None = None) -> int:
    ns = _build_parser().parse_args(argv)
    kw = dict(
        batch=ns.batch, height=ns.height, width=ns.width,
        max_dis=ns.max_dis, subsample=ns.subsample,
        check=ns.check, seed=ns.seed, mesh_shape=ns.mesh_shape,
        device=ns.device,
    )
    if ns.mode == "worker":
        return worker_main(ns.coordinator, ns.num_processes, ns.process_id, **kw)
    return spawn_local(ns.processes, ns.devices_per_process, port=ns.port, **kw)


if __name__ == "__main__":
    sys.exit(main())
