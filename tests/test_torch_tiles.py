"""The tile, chunk and shared-memory arithmetic of the port's kernel
wrappers, on the CPU: plain Python that decides how a kernel is launched.
No card and no JAX are needed."""

import numpy as np
import pytest

from primestereomatch_torch.kernels import _build, cvc_lowmaps
from primestereomatch_torch.kernels.bt_cost import COLUMNS as BT_COLUMNS
from primestereomatch_torch.kernels.bt_cost import THREADS as BT_THREADS
from primestereomatch_torch.kernels.bt_cost import BLOCKS_PER_SM as BT_BLOCKS_PER_SM
from primestereomatch_torch.kernels.bt_cost import launch_shape as bt_launch_shape
from primestereomatch_torch.kernels.bt_cost import plan as bt_plan
from primestereomatch_torch.kernels import wta as wta_mod
from primestereomatch_torch.kernels.cvc_wta import TILE_ROWS as K10_TILE_ROWS
from primestereomatch_torch.kernels.cvc_wta import TILE_X as K10_TILE_X
from primestereomatch_torch.kernels.cvc_wta import plan_tile as k10_plan_tile
from primestereomatch_torch.kernels.cvc_wta import smem_bytes as k10_smem_bytes
from primestereomatch_torch.kernels import select as select_mod
from primestereomatch_torch.kernels import speckle as speckle_mod
from primestereomatch_torch.kernels.lowmaps import MAX_K, TILE, block_shape, chain_smem_bytes
from primestereomatch_torch.ops.resize import linear_coeffs, low_window

# (maps h, w) -> (image H, W) of the shapes chip_smoke.py drives
TEDDY = ((93, 112), (375, 450))
TWO_K = ((310, 552), (1242, 2208))
ZED_VGA = ((94, 168), (376, 672))
TEDDY_S1 = ((375, 450), (375, 450))

AXES = [(552, 2208), (310, 1242), (168, 672),    # exact 4x
        (112, 450), (93, 375), (37, 150),        # quasi
        (48, 90), (30, 60),                      # below 2 and 2
        (7, 93), (9, 75),                        # above 8
        (450, 450), (375, 375)]                  # 1


@pytest.mark.parametrize("tile", [4, 32, 64])
@pytest.mark.parametrize("src,dst", AXES)
def test_low_window_covers_every_tap(src, dst, tile):
    """Both bilinear taps of every pixel of a tile lie in the window that
    starts at the tile's first tap, and some tile needs all of it."""
    win = low_window(src, dst, tile)
    lo, _ = linear_coeffs(src, dst)
    hi = np.minimum(lo + 1, src - 1)
    widest = 0
    for x0 in range(0, dst, tile):
        sl = slice(x0, min(x0 + tile, dst))
        assert lo[sl].min() == lo[x0]
        assert hi[sl].max() - lo[x0] + 1 <= win
        widest = max(widest, hi[sl].max() - lo[x0] + 1)
    assert widest == win


@pytest.mark.parametrize("low,full,staged", [
    (*TEDDY, True), (*TWO_K, True), (*ZED_VGA, True), (*TEDDY_S1, False),
    ((36, 80), (72, 160), False),       # ratio 2: a 34 x 10 window, 113 KB
    ((30, 48), (60, 90), False), ((33, 53), (99, 159), True), ((9, 7), (75, 93), True),
    ((18, 40), (144, 320), True),
])
def test_upsample_wta_plan(low, full, staged):
    """The staged kernel takes the ratios above 2, where three blocks'
    windows fit an SM; the other ratios take the per-pixel kernel."""
    win = wta_mod.staged_window(*low, *full)
    assert (win is not None) == staged
    if win is None:
        return
    lth, ltw = win
    assert (lth, ltw) == (low_window(low[0], full[0], wta_mod.TILE_Y),
                          low_window(low[1], full[1], wta_mod.TILE_X))
    assert lth * ltw <= wta_mod.WINDOW_PER_THREAD * wta_mod.THREADS
    assert wta_mod.BLOCKS_PER_SM * (wta_mod.staged_smem_bytes(lth, ltw) + 1024) \
        <= _build.SM_SMEM_BYTES


def test_upsample_wta_plan_at_the_4x_ratio():
    """The 2K tile: an 18 x 6 window, 50 KB, so the three blocks an SM's
    registers allow fit its shared memory."""
    assert wta_mod.staged_window(*TWO_K[0], *TWO_K[1]) == (6, 18)
    assert wta_mod.staged_smem_bytes(6, 18) == 50880
    assert wta_mod.BLOCKS_PER_SM == 3


@pytest.mark.parametrize("k", [3, 5, 7, 9, 17])
def test_chain_shared_memory_fits_a_block(k):
    """K1's and K4's 32 x 32 tiles fit a block's 227 KB at every box the
    pipeline uses; K4 stages its samples where they fit beside the chain."""
    chain = chain_smem_bytes(TILE, TILE, k)
    assert chain <= _build.MAX_SMEM_BYTES
    assert chain <= cvc_lowmaps.smem_bytes(k) <= _build.MAX_SMEM_BYTES
    assert (cvc_lowmaps.smem_bytes(k) > chain) == (k < 17)
    assert k <= MAX_K


@pytest.mark.parametrize("k", [3, 5, 7, 9, 17])
def test_low_maps_block_fits_its_blocks_an_sm(k):
    """K1's block: its chain's shared memory lets the blocks an SM its
    registers are bounded for share one SM; the run-time box keeps one
    output a thread (the blocked passes need k at compile time)."""
    threads, rh, blocks = block_shape(k)
    assert threads % 32 == 0 and rh in (1, 2, 4, 8) and TILE % rh == 0
    assert rh == 1 or k in (3, 5, 9, 17)
    assert blocks * (chain_smem_bytes(TILE, TILE, k, rh) + 1024) <= _build.SM_SMEM_BYTES


def test_low_maps_block_at_17():
    """At k = 17 the reused band region holds a 32 x 32 tile in 115,520
    bytes (153,856 with the unblocked chain), so two blocks share an SM."""
    assert chain_smem_bytes(TILE, TILE, 17) == 153856
    assert block_shape(17) == (256, 4, 2) and block_shape(5) == (128, 4, 2)
    assert chain_smem_bytes(TILE, TILE, 17, 4) == 115520
    assert 2 * (115520 + 1024) <= _build.SM_SMEM_BYTES


@pytest.mark.parametrize("k", [3, 5, 9, 17])
@pytest.mark.parametrize("rh", [2, 4, 8])
def test_blocked_chain_holds_every_region(k, rh):
    """The blocked chain's second region holds the row sums, the maps and
    the final sums, each at its pitch, and the first-level sums and the
    sums over mid's rows fit where the band lay."""
    m = 2 * (k // 2)
    bh = bw = TILE + 2 * m
    mh = mw = TILE + m
    region1 = chain_smem_bytes(TILE, TILE, k, rh) // 16 - bh * bw
    assert region1 >= max(mh * (bw | 1), (mh + 3) * mw, TILE * (TILE | 1)) + rh
    assert mh * (mw | 1) <= bh * bw and TILE * (mw | 1) <= bh * bw
    assert chain_smem_bytes(TILE, TILE, k, rh) < chain_smem_bytes(TILE, TILE, k)


@pytest.mark.parametrize("H,W,shape", [(375, 450, (2, 4, 8, 1)), (1242, 2208, (2, 4, 8, 1)),
                                       (1300, 40, (2, 4, 8, 1)), (1, 1, (2, 4, 8, 1)),
                                       (40, 40000, (1, 4, 8, 1)), (20000, 40, (2, 4, 2, 1))])
def test_speckle_launch_shape(H, W, shape):
    """K9's blocks: the shipped shape, with the lines a block halved until
    the block fits shared memory; 32 segments a warp at an odd pitch."""
    assert speckle_mod.launch_shape(H, W) == shape
    rows, rw, cols, cw = shape
    assert speckle_mod.row_smem_bytes(W, rows, rw) <= _build.MAX_SMEM_BYTES
    assert speckle_mod.col_smem_bytes(H, cols, cw) <= _build.MAX_SMEM_BYTES
    for n, warps in ((W, rw), (H, cw)):
        seg = -(-n // (32 * warps))
        assert 32 * warps * seg >= n > 32 * warps * (seg - 1)


def test_speckle_launch_shape_at_2k():
    """At 2K a row block holds 2 rows of 2208 labels, 4 warps (128 segments
    of 18) a row, in 19 KB; a column block 8 columns of 1242, a warp (32
    segments of 39) a column, in 40 KB."""
    assert speckle_mod.row_smem_bytes(2208, 2, 4) == 4 * 2 * (128 * 19 + 16)
    assert speckle_mod.col_smem_bytes(1242, 8, 1) == 4 * 8 * (32 * 39 + 8 + 4)


@pytest.mark.parametrize("shape", [(2, 4, 8, 1), (4, 1, 8, 1), (2, 4, 8, 2), (1, 4, 8, 2),
                                   (2, 2, 8, 1), (2, 4, 4, 4), (2, 4, 16, 1), (8, 2, 8, 2)])
def test_speckle_shapes_tried_are_launchable(shape):
    assert speckle_mod.launch_shape(1242, 2208, shape) == shape


def test_speckle_launch_shape_refuses_what_no_block_takes():
    with pytest.raises(ValueError):
        speckle_mod.launch_shape(10, 60000)       # a row beyond shared memory
    with pytest.raises(ValueError):
        speckle_mod.launch_shape(60000, 10)
    with pytest.raises(ValueError):
        speckle_mod.launch_shape(10, 10, (2, 4, 6, 2))    # a strip of 6 columns
    with pytest.raises(ValueError):
        speckle_mod.launch_shape(10, 10, (2, 4, 8, 4))    # 1024 threads


@pytest.mark.parametrize("low,full,k", [(*ZED_VGA, 5), (*TWO_K, 5), ((36, 80), (72, 160), 9),
                                        ((37, 80), (150, 320), 17)])
def test_cvc_wta_tile_fits_a_block(low, full, k):
    rows, groups, lth, ltw = k10_plan_tile(*low, *full, k, 2, 132)
    assert rows in K10_TILE_ROWS and groups in (1, 2)
    assert (lth, ltw) == (low_window(low[0], full[0], rows), low_window(low[1], full[1],
                                                                         K10_TILE_X))
    assert k10_smem_bytes(lth, ltw, k, groups) <= _build.MAX_SMEM_BYTES
    if groups == 1:
        assert k10_smem_bytes(lth, ltw, k, 2) > _build.MAX_SMEM_BYTES


def test_cvc_wta_tile_at_ratio_1_does_not_fit():
    """Ratio 1 with a 17 x 17 box: even a 16-row tile spans 17 x 96
    low-res pixels of the 80 x 96 image, and the chain's band does not fit
    a block."""
    assert (low_window(80, 80, 16), low_window(96, 96, K10_TILE_X)) == (17, 96)
    assert k10_smem_bytes(17, 96, 17, 1) > _build.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        k10_plan_tile(80, 96, 80, 96, 17, 2, 132)


def test_cvc_wta_tile_at_the_shapes_driven():
    """2K and ZED-VGA at the 4x ratio take 64 x 128 tiles, an 18 x 34
    window, and two chains at once (207,000 bytes); at ZED-VGA 72 blocks,
    one wave on 132 SMs."""
    assert k10_plan_tile(*TWO_K[0], *TWO_K[1], 5, 2, 132) == (64, 2, 18, 34)
    assert k10_plan_tile(*ZED_VGA[0], *ZED_VGA[1], 5, 2, 132) == (64, 2, 18, 34)
    assert k10_smem_bytes(18, 34, 5, 2) == 207000


def _k10_64_tile_fits(low, full, k):
    """Whether K10's earlier 64 x 64 tile (six words a band entry, four
    map tiles, no row lerp) fitted a block: the geometries it took."""
    lth, ltw = low_window(low[0], full[0], 64), low_window(low[1], full[1], 64)
    band = (lth + 4 * (k // 2)) * (ltw + 4 * (k // 2))
    return chain_smem_bytes(lth, ltw, k) + 4 * (4 * lth * ltw + 6 * band) + 3 * 4 * 64 \
        <= _build.MAX_SMEM_BYTES


# (subsample, k, H, W): tests/test_torch_cuda.py's FUSED_CASES and the
# camera sizes ZED-VGA, HD720 and 2K at the four boxes and ratios
K10_GEOMETRIES = [(4, 5, 150, 320), (2, 9, 72, 160), (8, 3, 144, 320), (3, 5, 99, 159),
                  (4, 5, 70, 150), (4, 17, 150, 320), (4, 7, 150, 320), (4, 5, 124, 132),
                  (4, 5, 132, 124), (4, 5, 72, 100), (4, 5, 376, 672), (4, 5, 63, 127),
                  (4, 5, 65, 129), (4, 5, 128, 256)] + [
    (s, k, H, W) for s in (2, 3, 4, 8) for k in (3, 5, 9, 17)
    for H, W in ((376, 672), (720, 1280), (1242, 2208))]


@pytest.mark.parametrize("s,k,H,W", K10_GEOMETRIES)
def test_cvc_wta_plan_takes_every_geometry_the_64_tile_took(s, k, H, W):
    """The planner finds a tile wherever the earlier kernel's fitted, so
    ops/geometry.py::full_fusion_applies never routes a frame into an
    error; the tile it picks fits a block."""
    low, full = (H // s, W // s), (H, W)
    if not _k10_64_tile_fits(low, full, k):
        with pytest.raises(ValueError, match="shared memory"):
            k10_plan_tile(*low, *full, k, 2, 132)
        return
    rows, groups, lth, ltw = k10_plan_tile(*low, *full, k, 2, 132)
    assert rows in K10_TILE_ROWS
    assert k10_smem_bytes(lth, ltw, k, groups) <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("n_views,D,low,k", [
    (2, 256, TWO_K[0], 5), (2, 64, ZED_VGA[0], 5), (2, 100, TWO_K[0], 5), (8, 64, TEDDY[0], 5),
    (4, 16, (18, 37), 5), (2, 2, (18, 37), 17), (256, 256, ZED_VGA[0], 5), (2, 256, TWO_K[0], 17),
])
def test_cvc_low_maps_chunks_cover_every_disparity(n_views, D, low, k):
    """The chunks cover D, are at most MAX_CHUNK long, keep the grid inside
    CUDA's limits and leave the card two blocks per resident block where
    the work allows it."""
    chunk, grid = cvc_lowmaps.plan_chunks(n_views, D, *low, k, 132)
    n_chunks = grid[2] // n_views
    assert 1 <= chunk <= min(cvc_lowmaps.MAX_CHUNK, D)
    assert grid[2] == n_views * n_chunks and (n_chunks - 1) * chunk < D <= n_chunks * chunk
    assert grid[:2] == (-(-low[1] // TILE), -(-low[0] // TILE))
    assert grid[2] <= cvc_lowmaps.MAX_GRID_Z
    resident = 132 * (_build.SM_SMEM_BYTES // (cvc_lowmaps.smem_bytes(k) + 1024))
    if chunk > 1:
        assert grid[0] * grid[1] * grid[2] >= resident


def test_cvc_low_maps_chunks_at_the_shapes_driven():
    """2K: 16 disparities a block; ZED-VGA: 4, which still fills 132 SMs."""
    assert cvc_lowmaps.plan_chunks(2, 256, *TWO_K[0], 5, 132) == (16, (18, 10, 32))
    assert cvc_lowmaps.plan_chunks(2, 64, *ZED_VGA[0], 5, 132) == (4, (6, 3, 32))
    # 100 = 6 * 16 + 4: the last chunk is cut
    assert cvc_lowmaps.plan_chunks(2, 100, *TWO_K[0], 5, 132)[1][2] == 2 * 7


def test_cvc_low_maps_grid_limit():
    """2 x 128 views at D = 256 stay inside the grid's z extent; beyond it
    the plan raises."""
    chunk, grid = cvc_lowmaps.plan_chunks(256, 256, *ZED_VGA[0], 5, 132)
    assert grid[2] == 256 * -(-256 // chunk) <= cvc_lowmaps.MAX_GRID_Z
    with pytest.raises(ValueError, match="exceed one launch's grid"):
        cvc_lowmaps.plan_chunks(2 * 40000, 256, *ZED_VGA[0], 5, 132)


# ---- K6 (csrc/bt_cost.cu): tile, disparity chunk and shared memory --------

@pytest.mark.parametrize("H,W,D,strip,d_chunk", [(375, 450, 64, 16, 32),
                                                (1242, 2208, 256, 32, 64)], ids=["teddy", "2k"])
def test_bt_cost_plan_at_the_shapes_driven(H, W, D, strip, d_chunk):
    """SGBMConfig() at Teddy and 2K: 5x5 windows over 3 channels, int16 out,
    60 output columns a block. 2K takes 32-row strips and 64 disparities a
    block (68,864 bytes, three blocks an SM) and still fills the card three
    times over; Teddy would not (96 blocks), so it takes the shortest shape."""
    shape = bt_launch_shape(H, W, D, 5, 3, 2, 132)
    assert (shape["strip"], shape["d_chunk"], shape["tile"]) == (strip, d_chunk, 60)
    assert shape == bt_plan(5, 3, 2, strip, d_chunk)
    assert bt_plan(5, 3, 2) == {"tile": 60, "d_chunk": 64, "run": 15, "strip": 32,
                                "smem": 68864}
    assert BT_BLOCKS_PER_SM * (shape["smem"] + 1024) <= _build.SM_SMEM_BYTES
    grid = (-(-W // shape["tile"]), -(-D // shape["d_chunk"]), -(-H // shape["strip"]))
    assert grid[2] <= 65535
    blocks = grid[0] * grid[1] * grid[2]
    assert (blocks >= BT_BLOCKS_PER_SM * 132) == (H > 1000)


# (k, C, output bytes) of tests/test_torch_cuda.py's K6 shapes
@pytest.mark.parametrize("k,C,out_bytes,d_chunk", [
    (5, 3, 2, 64), (3, 3, 2, 64), (11, 3, 4, 64), (4, 1, 2, 64), (1, 3, 2, 64), (7, 3, 4, 64),
    (2, 1, 2, 64), (25, 3, 4, 32), (9, 3, 2, 64), (64, 3, 4, 64), (15, 3, 4, 64),
    (17, 3, 4, 32),
])
def test_bt_cost_plan_fits_a_block(k, C, out_bytes, d_chunk):
    """Every window up to the kernel's 64 columns fits: 64 disparities a
    block where the ring of k horizontal sums allows, else 32. The runs of
    the window-sum step cover the tile, and the pixel-cost step's threads
    cover the row's 64 columns and the chunk."""
    shape = bt_plan(k, C, out_bytes)
    assert shape["d_chunk"] == d_chunk
    assert shape["tile"] == BT_COLUMNS - (k - 1) >= 1
    groups = BT_THREADS // shape["d_chunk"]
    assert shape["run"] == -(-shape["tile"] // groups)
    assert BT_THREADS % BT_COLUMNS == 0
    assert shape["d_chunk"] % (BT_THREADS // BT_COLUMNS) == 0
    ring = out_bytes * k * shape["run"] * BT_THREADS
    stage = 4 * 2 * 3 * C * (2 * BT_COLUMNS + shape["d_chunk"])
    pixel = 4 * BT_COLUMNS * (shape["d_chunk"] + 1)
    assert shape["smem"] == ring + stage + pixel <= _build.MAX_SMEM_BYTES


def test_bt_cost_plan_refuses_what_no_instance_takes():
    with pytest.raises(ValueError, match="block_size"):
        bt_plan(65, 3, 2)
    with pytest.raises(ValueError, match="instance"):
        bt_plan(5, 3, 2, d_chunk=16)
    with pytest.raises(ValueError, match="shared memory"):
        bt_plan(5, 200, 4)
    with pytest.raises(ValueError, match="shared memory"):
        bt_plan(25, 3, 4, d_chunk=64)


# ---- K8 (csrc/select.cu): route, lanes, values a lane and shared memory ---

SELECT_ROW_LIMIT = 227 * 1024 // 12       # a block of 12 bytes a column: the row limit to keep


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n_partials", [0, 1, 2])
@pytest.mark.parametrize("W", [1, 450, 2208, SELECT_ROW_LIMIT])
def test_select_launch_shape_covers_every_disparity(W, n_partials, aligned):
    """For D = 1..256: a block's shared memory fits, the lanes hold every
    disparity (in one chunk where an instance holds the pixel), an instance
    of csrc/select.cu serves the shape, and the 16-byte route is taken
    exactly where the pixel's values fill whole aligned vectors."""
    elt = 4 if n_partials == 0 else 2
    for D in range(1, 257):
        shape = select_mod.launch_shape(7, W, D, n_partials, aligned=aligned)
        assert shape["smem"] == 12 * W <= _build.MAX_SMEM_BYTES
        vector = aligned and (D * elt) % 16 == 0
        assert shape["route"] == ("vector" if vector else "scalar")
        assert shape["load_bytes"] == (16 if vector else elt)
        lanes, vpl = shape["lanes"], shape["values_per_lane"]
        assert lanes == (select_mod.LANES if vector else select_mod.SCALAR_LANES)
        assert vpl in (select_mod.VALUES_PER_LANE if vector
                       else select_mod.SCALAR_VALUES_PER_LANE)
        assert vpl % (shape["load_bytes"] // elt) == 0     # whole loads a lane
        assert lanes * vpl * shape["chunks"] >= D > lanes * vpl * (shape["chunks"] - 1)
        if D <= lanes * vpl:
            assert shape["chunks"] == 1
            smaller = [v for v in (select_mod.VALUES_PER_LANE if vector
                                   else select_mod.SCALAR_VALUES_PER_LANE) if v < vpl]
            assert all(lanes * v < D for v in smaller)      # the smallest that holds it
        assert 32 % lanes == 0 and shape["threads"] % 32 == 0
        assert shape["threads"] <= select_mod.MAX_THREADS
        assert shape["pixels_in_flight"] == shape["threads"] // lanes


@pytest.mark.parametrize("n_partials,D,vpl,chunks", [(2, 64, 8, 1), (2, 256, 32, 1),
                                                     (0, 64, 8, 1), (0, 256, 32, 1),
                                                     (2, 70, 8, 1), (2, 520, 32, 3),
                                                     (0, 520, 32, 3), (2, 3, 8, 1)])
def test_select_launch_shape_at_the_shapes_driven(n_partials, D, vpl, chunks):
    """Teddy (D = 64) and 2K (D = 256) from the partials or the int32 S: 8
    lanes a pixel, one chunk, 512 threads (64 pixels a block at once); D =
    70 and 3 take the scalar route, D = 520 the chunks."""
    shape = select_mod.launch_shape(375, 450, D, n_partials)
    assert (shape["values_per_lane"], shape["chunks"], shape["threads"]) == (vpl, chunks, 512)
    assert shape["route"] == ("scalar" if D in (70, 3) else "vector")
    assert shape["lanes"] == (32 if D in (70, 3) else 8)


def test_select_row_limit_does_not_shrink():
    assert select_mod.max_row() == SELECT_ROW_LIMIT == 19370
    select_mod.launch_shape(1, SELECT_ROW_LIMIT, 64, 2)
    with pytest.raises(ValueError, match="rows of at most 19370"):
        select_mod.launch_shape(1, SELECT_ROW_LIMIT + 1, 64, 2)


def test_select_launch_shape_refuses_what_no_block_takes():
    with pytest.raises(ValueError):
        select_mod.launch_shape(1, 10, 0, 2)                 # no disparity
    with pytest.raises(ValueError):
        select_mod.launch_shape(1, 10, 64, 3)                # three partials
    with pytest.raises(ValueError):
        select_mod.launch_shape(1, 10, 64, 2, threads=1024)  # beyond __launch_bounds__
    with pytest.raises(ValueError):
        select_mod.launch_shape(1, 10, 64, 2, threads=100)   # not whole warps
