"""The port's multi-device layer (primestereomatch_torch/parallel/, the row
tile ops and K3's participation-weight mode's plain version) against the
JAX package's on the same seeded inputs, on the CPU.

The sharded plans run in one gloo world of 8 CPU ranks, started once for
the module (`world`): each rank builds every plan's mesh, runs its block
and writes it for the parametrised cases to read. JAX is imported inside
the test functions only: the spawned ranks import this module and must not
load it. The port's sharded blocks must be bitwise the port's single-device
output on the CPU (the JAX package's own contract, tests/test_parallel.py),
the GIF within the WTA tie class (2e-3 of pixels) of JAX's sharded output
and the SGBM bitwise JAX's."""

import os
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from primestereomatch_torch import (
    GIFConfig,
    SGBMConfig,
    stereo_gif_forward,
    stereo_sgbm_forward,
)
from primestereomatch_torch.ops import cost_volume as cv
from primestereomatch_torch.ops import guided_filter as gf
from primestereomatch_torch.parallel import (
    MeshPlan,
    factor_devices,
    halo_exchange_rows,
    make_mesh,
    make_sharded_gif,
    make_sharded_sgbm,
)
from primestereomatch_torch.parallel.launch import initialize, spawn_local

CFG_KW = dict(max_dis=16, med_sz=7)   # small D and WMF window: fast on the CPU
WORLD = 8
# name -> (plan, H, W, run_postprocess): the five plans of
# test_sharded_matches_single_device, the two unaligned batch-only plans and
# the no-post-process plan of tests/test_parallel.py
GIF_CASES = {
    "1x1x1": (MeshPlan(1, 1, 1), 128, 96, True),
    "1x4x2": (MeshPlan(1, 4, 2), 128, 96, True),
    "2x2x2": (MeshPlan(2, 2, 2), 128, 96, True),
    "1x2x4": (MeshPlan(1, 2, 4), 128, 96, True),
    "8x1x1": (MeshPlan(8, 1, 1), 128, 96, True),
    "unaligned_1x1x1": (MeshPlan(1, 1, 1), 125, 96, True),
    "unaligned_4x1x1": (MeshPlan(4, 1, 1), 125, 96, True),
    "no_pp_1x2x2": (MeshPlan(1, 2, 2), 64, 64, False),
}
SGBM_PLAN, SGBM_SHAPE = MeshPlan(4, 1, 1), (4, 24, 48)
SGBM_KW = dict(num_disparities=8, speckle_window_size=10)
# name -> (plan, GIFConfig overrides, batch shape the step is run on, if any):
# what the JAX package refuses
REFUSALS = {
    "toolchain": (MeshPlan(1, 2, 2), dict(pp_toolchain=True), None),
    "table": (MeshPlan(1, 2, 2), dict(wmf_mode="table"), None),
    "max_dis": (MeshPlan(1, 2, 4), dict(max_dis=18), None),
    "misaligned": (MeshPlan(1, 2, 2), {}, (1, 66, 96)),
    "odd_width": (MeshPlan(1, 2, 2), {}, (1, 64, 94)),
    "small_tile": (MeshPlan(1, 4, 2), {}, (1, 64, 96)),
    "batch": (MeshPlan(2, 2, 1), {}, (3, 64, 96)),
}


def _pair(seed, h, w):
    """A correlated pair: the right view is the left shifted by 3 columns
    plus noise, so the WTA is not trivial."""
    rng = np.random.default_rng(seed)
    left = rng.random((h, w, 3), dtype=np.float32)
    right = np.roll(left, -3, axis=1) * 0.9 + 0.1 * rng.random((h, w, 3), dtype=np.float32)
    return left, right.astype(np.float32)


def _gif_batch(name):
    plan, h, w, _ = GIF_CASES[name]
    frames = [_pair(100 * i + h, h, w) for i in range(plan.batch)]
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


def _sgbm_batch():
    B, H, W = SGBM_SHAPE
    left = np.random.default_rng(7).integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    return left, np.roll(left, -2, axis=2)


def _halo_input(n, tile, w):
    return np.random.default_rng(n * tile + w).random((n * tile, w), dtype=np.float32)


def _index(sl):
    bsl, rows = sl
    return bsl.start, bsl.stop, rows.start, rows.stop


def _rank(rank, port, out_dir):
    """One rank of the module's world: every case, in the same order on
    every rank (a mesh is made by all ranks, its step run by its own)."""
    initialize(f"localhost:{port}", WORLD, rank, device="cpu")
    res = {}
    try:
        def mesh_of(plan):
            return make_mesh(plan, "cpu", ranks=range(plan.n_devices))

        for name, (plan, _, _, pp) in GIF_CASES.items():
            mesh = mesh_of(plan)
            if mesh.get_coordinate() is not None:
                lo, ro, sl = make_sharded_gif(mesh, GIFConfig(**CFG_KW), pp)(*_gif_batch(name))
                res[name] = (lo.numpy(), ro.numpy(), _index(sl))
        mesh = mesh_of(SGBM_PLAN)
        if mesh.get_coordinate() is not None:
            out, sl = make_sharded_sgbm(mesh, SGBMConfig(**SGBM_KW))(*_sgbm_batch())
            res["sgbm"] = (out.numpy(), _index(sl))
        for name, (n, tile, w, halo, edge) in (("reflect", (4, 8, 5, 3, "reflect")),
                                               ("zero", (2, 6, 4, 2, "zero"))):
            mesh = mesh_of(MeshPlan(1, n, 1))
            if mesh.get_coordinate() is not None:
                y = mesh.get_local_rank("y")
                blk = torch.from_numpy(_halo_input(n, tile, w)[y * tile:(y + 1) * tile])
                res[f"halo_{name}"] = (y, halo_exchange_rows(blk, halo, mesh, edge=edge).numpy())
        for name, (plan, kw, shape) in REFUSALS.items():
            mesh = mesh_of(plan)
            if rank == 0:
                try:
                    step = make_sharded_gif(mesh, GIFConfig(**{**CFG_KW, **kw}))
                    if shape is not None:
                        x = np.zeros((*shape, 3), np.float32)
                        step(x, x)
                    res[f"refuse_{name}"] = None
                except ValueError as e:
                    res[f"refuse_{name}"] = str(e)
        mesh = mesh_of(MeshPlan(2, 1, 1))
        if rank == 0:
            try:
                x = np.zeros((3, 8, 8, 3), np.uint8)
                make_sharded_sgbm(mesh)(x, x)
                res["refuse_sgbm_batch"] = None
            except ValueError as e:
                res["refuse_sgbm_batch"] = str(e)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results, from one gloo world of 8 CPU ranks."""
    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("world")
    mp.start_processes(_rank, args=(_free_port(), str(out)), nprocs=WORLD, join=True,
                       start_method="spawn")
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def _assemble(world, name, B, H, W):
    """The global outputs from the ranks' blocks; each (frame, row) is
    written by every rank that holds it, and all of them must agree."""
    outs = [np.full((B, H, W), -1, np.int32) for _ in range(2)]
    for res in world:
        if name not in res:
            continue
        *blocks, (b0, b1, y0, y1) = res[name]
        for out, blk in zip(outs, blocks):
            seen = out[b0:b1, y0:y1]
            assert ((seen == -1) | (seen == blk)).all(), "ranks of one block disagree"
            out[b0:b1, y0:y1] = blk
    assert all((o >= 0).all() for o in outs), "a block no rank returned"
    return outs


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_devices_matches_jax(n):
    from primestereomatch_tpu.parallel.mesh import factor_devices as jax_factor

    j = jax_factor(n)
    assert factor_devices(n) == MeshPlan(j.batch, j.rows, j.disp)


@pytest.mark.parametrize("radius,s", [(8, 4), (8, 2), (9, 3), (4, 4), (16, 8), (8, 1)])
def test_fgf_tile_halo_matches_jax(radius, s):
    from primestereomatch_tpu.ops.guided_filter import fgf_tile_halo as jax_halo

    assert gf.fgf_tile_halo(radius, s) == jax_halo(radius, s)


def _cost_inputs(H, W, seed=3):
    l, r = _pair(seed, H, W)
    grd = [np.random.default_rng(seed + i).random((H, W), dtype=np.float32) for i in (1, 2)]
    return l, r, *grd


@pytest.mark.parametrize("d_start", [0, 8])
@pytest.mark.parametrize("sampled", [True, False])
def test_block_costs_match_full_volume_and_jax(d_start, sampled):
    """The block costs are the full volumes' slices bitwise (an int or a
    0-d tensor offset) and within the full volumes' bound of JAX's
    (tests/test_torch_ops.py, atol 1e-6)."""
    import jax.numpy as jnp
    from primestereomatch_tpu.ops import cost_volume as jcv

    H, W, D, blk, s = 40, 64, 16, 8, 4
    args = _cost_inputs(H, W)
    t = [torch.from_numpy(a) for a in args]
    kw = dict(alpha=0.9, border_cost=1.0, tau1=0.5, tau2=0.1)
    yi, xi = np.arange(H // s) * s, np.arange(W // s) * s
    if sampled:
        full = cv.build_cost_volumes_sampled(*t, D, yi, xi, **kw)
        got = [cv.build_cost_volume_block_sampled(*t, d, blk, D, yi, xi, **kw)
               for d in (d_start, torch.tensor(d_start))]
        ref = jcv.build_cost_volume_block_sampled(*map(jnp.asarray, args), d_start, blk, D,
                                                   yi, xi, **kw)
    else:
        full = cv.build_cost_volumes(*t, D, **kw)
        got = [cv.build_cost_volume_block(*t, d, blk, D, **kw)
               for d in (d_start, torch.tensor(d_start))]
        ref = jcv.build_cost_volume_block(*map(jnp.asarray, args), d_start, blk, D, **kw)
    for g in got:
        for v in range(2):
            assert torch.equal(g[v], full[v][d_start:d_start + blk])
            np.testing.assert_allclose(g[v].numpy(), np.asarray(ref[v]), atol=1e-6)


def _tile_inputs(Db, seed):
    """An extended tile: a smooth guide (He = 16 + 2 * halo rows, r = 8,
    s = 4) and costs in [0, 3) at its sample grid."""
    s, halo = 4, gf.fgf_tile_halo(8, 4)
    He, W = 16 + 2 * halo, 64
    rng = np.random.default_rng(seed)
    coarse = rng.random((He // 8 + 2, W // 8 + 2, 3)).astype(np.float32)
    guide = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:He, :W]
    guide = np.clip(0.8 * guide + 0.2 * rng.random((He, W, 3)), 0, 1).astype(np.float32)
    p_low = (3 * rng.random((Db, He // s, W // s))).astype(np.float32)
    return guide, p_low, s, halo, He


EDGES = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("is_top,is_bot", EDGES)
def test_tile_filter_matches_jax(is_top, is_bot):
    """The tile's maps within 2e-6 of the JAX op's chain on the same tile,
    and its FGF (from the full-resolution block and from its samples)
    within the FGF's bound of JAX's (tests/test_ops.py: rtol 2e-5, atol
    2e-6), with the global-border clamp at every edge combination."""
    import jax.numpy as jnp
    from primestereomatch_tpu.ops import guided_filter as jgf

    guide, p_low, s, halo, He = _tile_inputs(8, 11 + 2 * is_top + is_bot)
    H = 64 + 16   # the global rows of the JAX op's global_h, which the port does not need
    args = (8, 1e-4, s, halo)
    got = gf.fast_guided_filter_color_tile_low(torch.from_numpy(guide), torch.from_numpy(p_low),
                                               *args, is_top, is_bot).numpy()
    want = np.asarray(jgf.fast_guided_filter_color_tile_low(
        jnp.asarray(guide), jnp.asarray(p_low), *args, H, jnp.bool_(is_top),
        jnp.bool_(is_bot)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    # the tile's maps against the JAX op's chain on the same tile
    k, h, w = 5, He // s, guide.shape[1] // s
    ch_low = tuple(jgf.resize_nearest(jnp.asarray(guide)[..., c], (h, w)) for c in range(3))
    means, inv = jgf._color_inverse_cov(ch_low, k, 1e-4)
    (a_r, a_g, a_b), b = jgf._solve_ab(jnp.asarray(p_low), ch_low, means, inv, k)
    want_maps = np.stack([np.asarray(jgf.box_mean(t, k)) for t in (a_r, a_g, a_b, b)])
    maps = gf.tile_low_maps(torch.from_numpy(guide), torch.from_numpy(p_low), k, 1e-4)
    np.testing.assert_allclose(maps.numpy(), want_maps, rtol=0, atol=2e-6)
    p_ext = np.repeat(np.repeat(p_low, s, 1), s, 2)
    got_full = gf.fast_guided_filter_color_tile(torch.from_numpy(guide), torch.from_numpy(p_ext),
                                                *args, is_top, is_bot).numpy()
    np.testing.assert_array_equal(got_full, got)


@pytest.mark.parametrize("d0", [0, 8])
@pytest.mark.parametrize("is_top,is_bot", EDGES)
def test_tile_wta_matches_jax(d0, is_top, is_bot):
    """The fused tile WTA: its argmin within the WTA tie class (2e-3) of
    JAX's, global d = 0 never selected, and bitwise the argmin of the
    port's own filtered tile (d = 0 masked)."""
    import jax.numpy as jnp
    from primestereomatch_tpu.ops import guided_filter as jgf

    guide, p_low, s, halo, He = _tile_inputs(8, 31 + d0 + 2 * is_top + is_bot)
    H, interior = 64 + 16, (halo, 16)
    args = (8, 1e-4, s, halo)
    best, arg = gf.fgf_wta_tile_low(torch.from_numpy(guide), torch.from_numpy(p_low), *args,
                                    is_top, is_bot, d0, interior, d_chunk=4)
    j_best, j_arg = jgf.fgf_wta_tile_low(jnp.asarray(guide), jnp.asarray(p_low), *args, H,
                                         jnp.bool_(is_top), jnp.bool_(is_bot), jnp.int32(d0),
                                         interior, d_chunk=4)
    assert arg.dtype == torch.int32 and arg.shape == (16, 64)
    assert float((arg.numpy() != np.asarray(j_arg)).mean()) <= 2e-3
    np.testing.assert_allclose(best.numpy(), np.asarray(j_best), rtol=2e-5, atol=2e-6)
    q = gf.fast_guided_filter_color_tile_low(torch.from_numpy(guide), torch.from_numpy(p_low),
                                             *args, is_top, is_bot)[:, halo:halo + 16]
    if d0 == 0:
        q[0] = float("inf")
        assert int(arg.min()) >= 1
    m, a = q.min(dim=0)
    assert torch.equal(arg, a.to(torch.int32) + d0) and torch.equal(best, m)


def test_halo_exchange_reflect_matches_pad(world):
    n, tile, halo = 4, 8, 3
    padded = np.pad(_halo_input(n, tile, 5), ((halo, halo), (0, 0)), mode="reflect")
    got = dict(res["halo_reflect"] for res in world if "halo_reflect" in res)
    assert sorted(got) == list(range(n))
    for i in range(n):
        np.testing.assert_array_equal(got[i], padded[i * tile:i * tile + tile + 2 * halo])


def test_halo_exchange_zero_edges(world):
    n, tile, halo = 2, 6, 2
    x = _halo_input(n, tile, 4)
    ext = dict(res["halo_zero"] for res in world if "halo_zero" in res)
    np.testing.assert_array_equal(ext[0][:halo], 0.0)            # global top
    np.testing.assert_array_equal(ext[1][-halo:], 0.0)           # global bottom
    np.testing.assert_array_equal(ext[0][-halo:], x[tile:tile + halo])
    np.testing.assert_array_equal(ext[1][:halo], x[tile - halo:tile])
    np.testing.assert_array_equal(np.concatenate([ext[0][halo:-halo], ext[1][halo:-halo]]), x)


@pytest.mark.parametrize("name", list(GIF_CASES))
def test_sharded_gif_matches_single_device_and_jax(world, name):
    import jax
    import jax.numpy as jnp
    from primestereomatch_tpu.config import GIFConfig as JaxGIFConfig
    from primestereomatch_tpu.parallel import MeshPlan as JaxPlan
    from primestereomatch_tpu.parallel import make_mesh as jax_mesh
    from primestereomatch_tpu.parallel import make_sharded_gif as jax_sharded

    plan, H, W, pp = GIF_CASES[name]
    l, r = _gif_batch(name)
    got = _assemble(world, name, plan.batch, H, W)
    for i in range(plan.batch):
        want = stereo_gif_forward(l[i], r[i], GIFConfig(**CFG_KW), pp, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i], w.numpy())
    mesh = jax_mesh(JaxPlan(plan.batch, plan.rows, plan.disp), jax.devices()[:plan.n_devices])
    ref = jax_sharded(mesh, JaxGIFConfig(**CFG_KW), run_postprocess=pp)(jnp.asarray(l),
                                                                        jnp.asarray(r))
    assert max(float((g != np.asarray(j)).mean()) for g, j in zip(got, ref)) <= 2e-3


def test_sharded_sgbm_batch_parallel(world):
    import jax
    import jax.numpy as jnp
    from primestereomatch_tpu.config import SGBMConfig as JaxSGBMConfig
    from primestereomatch_tpu.parallel import MeshPlan as JaxPlan
    from primestereomatch_tpu.parallel import make_mesh as jax_mesh
    from primestereomatch_tpu.parallel.sharded import make_sharded_sgbm as jax_sharded

    B, H, W = SGBM_SHAPE
    l, r = _sgbm_batch()
    got = np.zeros((B, H, W), np.int16)
    for res in world:
        if "sgbm" in res:
            out, (b0, b1, y0, y1) = res["sgbm"]
            assert out.dtype == np.int16
            got[b0:b1, y0:y1] = out
    for b in range(B):
        want = stereo_sgbm_forward(l[b], r[b], SGBMConfig(**SGBM_KW), device="cpu")
        np.testing.assert_array_equal(got[b], want.numpy())
    mesh = jax_mesh(JaxPlan(*SGBM_PLAN.__dict__.values()), jax.devices()[:4])
    ref = jax_sharded(mesh, JaxSGBMConfig(**SGBM_KW))(jnp.asarray(l), jnp.asarray(r))
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("name", list(REFUSALS) + ["sgbm_batch"])
def test_refusals_match_jax(world, name):
    import jax
    from primestereomatch_tpu.config import GIFConfig as JaxGIFConfig
    from primestereomatch_tpu.parallel import MeshPlan as JaxPlan
    from primestereomatch_tpu.parallel import make_mesh as jax_mesh
    from primestereomatch_tpu.parallel import make_sharded_gif as jax_sharded
    from primestereomatch_tpu.parallel.sharded import make_sharded_sgbm as jax_sgbm

    got = world[0][f"refuse_{name}"]
    assert got is not None, f"{name} was not refused"
    if name == "sgbm_batch":
        mesh = jax_mesh(JaxPlan(2, 1, 1), jax.devices()[:2])
        x = np.zeros((3, 8, 8, 3), np.uint8)
        with pytest.raises(ValueError) as e:
            jax_sgbm(mesh)(x, x)
    else:
        plan, kw, shape = REFUSALS[name]
        mesh = jax_mesh(JaxPlan(plan.batch, plan.rows, plan.disp),
                        jax.devices()[:plan.n_devices])
        with pytest.raises(ValueError) as e:
            step = jax_sharded(mesh, JaxGIFConfig(**{**CFG_KW, **kw}))
            x = np.zeros((*shape, 3), np.float32)
            step(x, x)
    assert got == str(e.value)


@pytest.mark.parametrize("mesh_shape", [None, "1,2,2", "2,2,1"])
def test_spawn_local_meshes(mesh_shape):
    """The launcher in four CPU ranks: factor_devices(4) = (1, 1, 4) and
    the meshes of tests/test_multihost.py, every block checked bitwise
    against the single-device pipeline."""
    rc = spawn_local(processes=4, port=_free_port(), batch=2, height=64, width=96,
                     max_dis=16, check=True, mesh_shape=mesh_shape, device="cpu")
    assert rc == 0


def test_spawn_local_refuses_several_devices_a_process():
    with pytest.raises(ValueError, match="must be 1"):
        spawn_local(processes=2, devices_per_process=2)


def test_make_mesh_needs_the_process_group():
    with pytest.raises(RuntimeError, match="not initialised"):
        make_mesh(MeshPlan(1, 1, 1), "cpu")


def test_weighted_median_valid_mode_matches_jax():
    """K3's participation-weight mode, plain version: fractional weights
    and whole windows of zeros (output 0) against the JAX op and its Pallas
    kernel (interpret mode), view by view."""
    import jax.numpy as jnp
    from primestereomatch_tpu.kernels.wmf_pallas import joint_wmf_pallas
    from primestereomatch_tpu.ops.jointwmf import joint_wmf as jax_wmf
    from primestereomatch_torch import kernels as K

    rng = np.random.default_rng(12)
    B, H, W, r, n_bins = 2, 28, 36, 4, 32
    disp = rng.integers(0, n_bins, (B, H, W), dtype=np.uint8)
    guide = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    valid = rng.random((B, H, W), dtype=np.float32)
    valid[0, :16, :20] = 0.0      # windows of zeros: total 0 -> 0
    valid[1, ::3] = 0.0
    got = K.weighted_median(torch.from_numpy(disp), torch.from_numpy(guide), r, n_bins,
                            valid=torch.from_numpy(valid))
    assert (got[0, :16 - r, :20 - r] == 0).all()
    for b in range(B):
        args = (jnp.asarray(disp[b]), jnp.asarray(guide[b]))
        want = np.asarray(jax_wmf(*args, radius=r, n_bins=n_bins, valid=jnp.asarray(valid[b])))
        np.testing.assert_array_equal(got[b].numpy(), want)
        # the TPU kernel's has_valid mode, within its last-ulp tie budget
        pallas = np.asarray(joint_wmf_pallas(*args, radius=r, n_bins=n_bins,
                                             valid=jnp.asarray(valid[b]), interpret=True))
        assert float((got[b].numpy() != pallas).mean()) <= 1e-3
