"""Explicitly sharded STEREO_GIF and STEREO_SGBM over a (b, y, d) mesh of
torch.distributed ranks (port of the JAX package's parallel/sharded.py).

The reference parallelises disparity levels with OpenMP and rows with
pthreads inside one memory domain (src/DispEst.cpp:209-294,
src/DispSel.cpp:51-88); here the two axes become mesh dimensions
(parallel/mesh.py), one device a rank:

  b: frames, pure data parallelism (no communication)
  y: row tiles; the windowed stages (guided filter, weighted median) get
     their support rows by one exchange with the neighbouring ranks
     (`halo_exchange_rows`: send/recv in the mesh's "y" group)
  d: disparity blocks; each rank builds and filters its block, takes a
     local (min, argmin), and the ranks merge them by an all-gather over
     the "d" group (`_merge_wta`)

The cost's halo rows are recomputed from exchanged image rows rather than
exchanging D * halo * W costs; columns stay whole; JointWMF runs
replicated over d.

The contract of a step. Every rank calls `step(l_imgs, r_imgs)` with the
same global (B, H, W, 3) batch, as `launch.worker_main` feeds it. The step
computes only the rank's (b, y) block and returns it with its global
(batch, row) slices, the counterpart of JAX's `addressable_shards`; the
ranks of one d group return the same block. With H % (s * y) == 0 and
W % s == 0 the blocks are bitwise those of the single-device pipeline on
the same device (tests/test_torch_parallel.py on the CPU, chip_smoke.py on
the card).

Transport. With the NCCL backend the collectives move CUDA tensors
directly. Gloo has no CUDA send/recv/all_gather, so under gloo (the CPU,
or several ranks on one card, which NCCL refuses) the collectives of CUDA
tensors are staged through host memory: transport only, the compute stays
on the card; `launch.initialize` prints which. `COMM` sums the host time
and the bytes each rank sends.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from primestereomatch_torch.config import GIFConfig, SGBMConfig
from primestereomatch_torch.kernels.wmf import weighted_median
from primestereomatch_torch.models.gif_pipeline import (
    _to_u8,
    stereo_gif_forward_batch,
    view_gradients,
)
from primestereomatch_torch.models.sgbm_pipeline import stereo_sgbm_forward
from primestereomatch_torch.ops.cost_volume import _stacked, build_cost_volume_block_sampled
from primestereomatch_torch.ops.guided_filter import fgf_tile_halo, fgf_wta_tile_low
from primestereomatch_torch.parallel.mesh import AXIS_BATCH, AXIS_DISP, AXIS_ROWS
from primestereomatch_torch.utils.device import device_table

# host seconds and bytes sent by this rank: row halos and the WTA merge
COMM = {"halo_s": 0.0, "halo_bytes": 0, "merge_s": 0.0, "merge_bytes": 0}


def reset_comm() -> None:
    for k in COMM:
        COMM[k] = type(COMM[k])(0)


def staged_through_host(t: torch.Tensor) -> bool:
    """Whether a collective of `t` goes through host memory: a CUDA tensor
    under the gloo backend."""
    return t.is_cuda and dist.get_backend() == dist.Backend.GLOO


def mesh_device(mesh) -> torch.device:
    """The device of this rank's blocks: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _peer(mesh, axis_name: str, step: int) -> int:
    """Global rank of the mesh neighbour `step` along `axis_name`."""
    coord = list(mesh.get_coordinate())
    coord[mesh.mesh_dim_names.index(axis_name)] += step
    return int(mesh.mesh[tuple(coord)])


def _tic(t: torch.Tensor) -> float:
    if staged_through_host(t):      # the staging copies wait for the stream anyway
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def halo_exchange_rows(
    x: torch.Tensor,
    halo: int,
    mesh,
    axis_name: str = AXIS_ROWS,
    row_axis: int = 0,
    edge: str = "reflect",
    block: int = 1,
) -> torch.Tensor:
    """Extend this rank's row block with `halo` rows from each neighbour
    along `axis_name` (one send/recv pair each way, `dist.batch_isend_irecv`
    in the mesh's group of that axis). At the global top and bottom, where
    there is no neighbour, the rows follow `edge`:
      'reflect' BORDER_REFLECT_101 of the local rows in whole `block`-row
                blocks: pad block -k is block k. block=1 is a plain row
                reflect (cv::blur's border); block=s commutes with a
                stride-s nearest downsample, so the low-res rows a tile
                samples are where the global low-res reflect-101 reads.
      'zero'    zeros (out-of-image rows for the weighted median's
                participation plane).
    Needs local rows >= halo + block, and halo and rows multiples of block."""
    if halo == 0:
        return x
    nrows = x.shape[row_axis]
    if nrows < halo + block:
        raise ValueError(f"tile rows {nrows} must be >= halo {halo} + block {block}")
    if halo % block or nrows % block:
        raise ValueError(f"halo {halo} and rows {nrows} must be multiples of block {block}")
    if edge not in ("reflect", "zero"):
        raise ValueError(f"unknown edge mode {edge!r}")
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    idx = mesh.get_local_rank(axis_name)
    first = x.narrow(row_axis, 0, halo)            # my top rows -> the rank above
    last = x.narrow(row_axis, nrows - halo, halo)  # my bottom rows -> the rank below

    t0 = _tic(x)
    from_above = from_below = None
    if n > 1:
        wire = torch.device("cpu") if staged_through_host(x) else x.device
        group = mesh.get_group(axis_name)
        ops, recvs = [], []
        for side, step, send in (("above", -1, first), ("below", 1, last)):
            if 0 <= idx + step < n:
                peer = _peer(mesh, axis_name, step)
                buf = torch.empty(send.shape, dtype=send.dtype, device=wire)
                out = send.to(wire).contiguous()
                ops += [dist.P2POp(dist.isend, out, peer, group),
                        dist.P2POp(dist.irecv, buf, peer, group)]
                recvs.append((side, buf))
                COMM["halo_bytes"] += out.numel() * out.element_size()
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for side, buf in recvs:
            buf = buf.to(x.device)
            if side == "above":
                from_above = buf
            else:
                from_below = buf
    COMM["halo_s"] += time.perf_counter() - t0

    def edge_rows(top: bool) -> torch.Tensor:
        if edge == "zero":
            return torch.zeros_like(first if top else last)
        idx_t = device_table(("halo_reflect", nrows, halo, block, top),
                             lambda: _reflect_blocks(nrows, halo, block, top), x.device,
                             torch.long)
        return x.index_select(row_axis, idx_t)

    top = edge_rows(True) if idx == 0 else from_above
    bot = edge_rows(False) if idx == n - 1 else from_below
    return torch.cat([top, x, bot], dim=row_axis)


def _reflect_blocks(nrows: int, halo: int, b: int, top: bool) -> np.ndarray:
    """Local rows of the block-reflect-101 halo: pad block -k is block k
    above, pad block nb + q is block nb - 2 - q below; each block's rows in
    their natural order."""
    nb, hb = nrows // b, halo // b
    blocks = range(hb, 0, -1) if top else (nb - 2 - q for q in range(hb))
    return np.concatenate([np.arange(k * b, k * b + b) for k in blocks])


def _merge_wta(
    local_min: torch.Tensor,   # (..., H, W) min cost over the local d block
    local_arg: torch.Tensor,   # (..., H, W) GLOBAL disparity of that min
    mesh,
    axis_name: str = AXIS_DISP,
) -> torch.Tensor:
    """Cross-rank WTA merge: all-gather (min, arg) over the "d" group, in
    ascending d-block order, then the first minimum, which is the lowest
    disparity on ties (the reference's strict-< ascending scan,
    src/DispSel.cpp:96-103)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if n == 1:
        return local_arg
    t0 = _tic(local_min)
    stage = staged_through_host(local_min)
    group = mesh.get_group(axis_name)
    gathered = []
    for t in (local_min, local_arg):
        src = t.cpu() if stage else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        gathered.append(torch.stack(parts).to(t.device))
        COMM["merge_bytes"] += src.numel() * src.element_size()
    COMM["merge_s"] += time.perf_counter() - t0
    g_min, g_arg = gathered
    sel = torch.argmin(g_min, dim=0, keepdim=True)
    return torch.take_along_dim(g_arg, sel, dim=0)[0]


def _frames(imgs, sl: slice, dev: torch.device, dtype=None,
            rows: slice = slice(None)) -> torch.Tensor:
    """Rows `rows` of frames `sl` of a global batch (a tensor or an array)
    on `dev`; only they are copied."""
    t = imgs[sl, rows]
    t = t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
    return t.to(device=dev, dtype=dtype).contiguous()


def make_sharded_sgbm(mesh, cfg=None):
    """Batch-parallel SGBM over the mesh's "b" axis. SGBM's directional
    scans are recurrences over whole rows and columns, so frames are its
    throughput axis (the reference runs it single-image too,
    src/StereoMatch.cpp:169-187); the "y" and "d" ranks of a frame block
    compute the same. Returns step(l_u8, r_u8) -> ((Bl, H, W) int16 block,
    (batch slice, row slice)); each rank runs `stereo_sgbm_forward` per
    frame."""
    cfg = cfg or SGBMConfig()
    bn = mesh.size(mesh.mesh_dim_names.index(AXIS_BATCH))
    bi = mesh.get_local_rank(AXIS_BATCH)
    dev = mesh_device(mesh)

    def step(l_imgs, r_imgs):
        B, H = l_imgs.shape[:2]
        if B % bn:
            raise ValueError(f"batch {B} not divisible by b shards {bn}")
        bl = B // bn
        sl = slice(bi * bl, (bi + 1) * bl)
        l_blk, r_blk = _frames(l_imgs, sl, dev), _frames(r_imgs, sl, dev)
        out = torch.stack([stereo_sgbm_forward(a, b, cfg, device=dev)
                           for a, b in zip(l_blk, r_blk)])
        return out, (sl, slice(0, H))

    return step


def tile_costs_low(ext: torch.Tensor, cfg: GIFConfig, d0: int, d_block: int) -> torch.Tensor:
    """The costs of disparities [d0, d0 + d_block) of extended row tiles
    (2Bl, He, W, 3), lefts first, at their FGF sample grid: (2Bl,
    d_block, He/s, W/s), the block of `sampled_cost_volumes` (plain torch)."""
    He, W = ext.shape[1:3]
    s = cfg.subsample
    cost = dict(alpha=cfg.alpha, border_cost=cfg.border_cost, tau1=cfg.tau1, tau2=cfg.tau2)

    def build(l_rows, r_rows, lg_rows, rg_rows, _n, yi_b, xi):
        return build_cost_volume_block_sampled(l_rows, r_rows, lg_rows, rg_rows, d0,
                                               d_block, cfg.max_dis, yi_b, xi, **cost)

    return _stacked(ext, view_gradients(ext, cfg), d_block, (He // s, W // s), build)


def make_sharded_gif(mesh, cfg: GIFConfig = GIFConfig(), run_postprocess: bool = True):
    """The mesh-sharded STEREO_GIF step: step(l_imgs, r_imgs) ->
    (l_block, r_block, (batch slice, row slice)) with (B, H, W, 3) float32
    images in [0, 1] (BGR) and (Bl, Ht, W) uint8 blocks (the module's
    contract). Always B % b == 0 and max_dis % d == 0. A mesh that tiles
    rows or disparities (y > 1 or d > 1) needs H % (s * y) == 0, W % s ==
    0 and row tiles H / y >= max(halo + s, r_wmf + 1) with halo =
    fgf_tile_halo(r, s) (one hop of halo); pad the rows of other frames.
    A batch-only mesh runs the single-device pipeline
    (`stereo_gif_forward_batch`, one launch a kernel for the rank's frames)
    and takes any H and W it takes.

    The tiled step: both views' tiles get `halo` rows from their y
    neighbours (s-row block-reflect at the global edges); the cost of the
    rank's d block at the tile's FGF grid (plain torch); the tile's chain
    (K1 on the card); upsample + local WTA on the interior rows (plain
    torch: K2 has neither the tile's global-border clamp nor a d offset);
    the (min, argmin) merge over d; then JointWMF on disparity and guide
    rows extended by the window radius, zeros at the global edges, through
    K3's participation-weight mode (0 weight on those rows)."""
    names = mesh.mesh_dim_names
    bn, yn, dn = (mesh.size(names.index(a)) for a in (AXIS_BATCH, AXIS_ROWS, AXIS_DISP))
    if cfg.max_dis % dn:
        raise ValueError(f"max_dis={cfg.max_dis} not divisible by d shards {dn}")
    # the sharded post-process is exact-mode JointWMF only: the toolchain
    # and table mode need global state (k-means clustering spans the image)
    if cfg.pp_toolchain:
        raise ValueError(
            "make_sharded_gif does not implement cfg.pp_toolchain=True; "
            "use the single-device pipeline for the lrCheck/fillInv/wgtMedian "
            "toolchain"
        )
    if cfg.wmf_mode != "exact":
        raise ValueError(
            f"make_sharded_gif supports wmf_mode='exact' only (got "
            f"{cfg.wmf_mode!r}): table-mode feature clustering is global"
        )
    d_block = cfg.max_dis // dn
    halo = fgf_tile_halo(cfg.gif_radius, cfg.subsample)
    r_wmf = cfg.wmf_radius
    s = cfg.subsample
    bi, yi, di = (mesh.get_local_rank(a) for a in (AXIS_BATCH, AXIS_ROWS, AXIS_DISP))
    d0 = di * d_block
    dev = mesh_device(mesh)
    batch_only = yn == 1 and dn == 1

    def tiled(views: torch.Tensor) -> torch.Tensor:
        """(2Bl, Ht, W, 3) tiles of the rank's frames, lefts first ->
        (2Bl, Ht, W) uint8."""
        Ht = views.shape[1]
        is_top, is_bot = yi == 0, yi == yn - 1
        ext = halo_exchange_rows(views, halo, mesh, row_axis=1, edge="reflect", block=s)
        p_low = tile_costs_low(ext, cfg, d0, d_block)
        best, arg = fgf_wta_tile_low(ext, p_low, cfg.gif_radius, cfg.gif_eps, s, halo,  # K1
                                     is_top, is_bot, d0, (halo, Ht))
        del p_low
        disp = _merge_wta(best, arg, mesh).to(torch.uint8)
        if not run_postprocess:
            return disp
        # the disparities and the guide (0 at the global edges) with the
        # window's rows from the y neighbours, in one exchange; the
        # participation plane is 1 on image rows and 0 on the zero rows,
        # which each rank knows without asking
        packed = torch.cat([disp[..., None], _to_u8(views)], dim=-1)
        packed = halo_exchange_rows(packed, r_wmf, mesh, row_axis=1, edge="zero")
        valid = torch.ones(packed.shape[:3], dtype=torch.float32, device=dev)
        if is_top:
            valid[:, :r_wmf] = 0.0
        if is_bot:
            valid[:, -r_wmf:] = 0.0
        med = weighted_median(packed[..., 0].contiguous(), packed[..., 1:].contiguous(),  # K3
                              r_wmf, cfg.max_dis, cfg.wmf_sigma, valid=valid)
        return med[:, r_wmf:r_wmf + Ht]

    def step(l_imgs, r_imgs):
        B, H, W = l_imgs.shape[:3]
        if B % bn:
            raise ValueError(f"batch {B} not divisible by b shards {bn}")
        bl = B // bn
        bsl = slice(bi * bl, (bi + 1) * bl)
        if batch_only:
            l_out, r_out = stereo_gif_forward_batch(
                _frames(l_imgs, bsl, dev, torch.float32), _frames(r_imgs, bsl, dev, torch.float32),
                cfg, run_postprocess, device=dev)
            return l_out, r_out, (bsl, slice(0, H))
        if H % (yn * s) or W % s:
            raise ValueError(
                f"shape ({B},{H},{W}) incompatible with mesh "
                f"(b={bn}, y={yn}) and subsample {s}; pad rows to a "
                f"multiple of {yn * s} (and W to a multiple of {s}) or "
                f"use a batch-only mesh"
            )
        if H // yn < max(halo + s, r_wmf + 1):
            raise ValueError(f"row tile {H // yn} too small for halo {max(halo, r_wmf)}")
        ht = H // yn
        rows = slice(yi * ht, (yi + 1) * ht)
        views = torch.cat([_frames(imgs, bsl, dev, torch.float32, rows)
                           for imgs in (l_imgs, r_imgs)])
        out = tiled(views)
        return out[:bl], out[bl:], (bsl, rows)

    return step
