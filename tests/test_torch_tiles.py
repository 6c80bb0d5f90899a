"""The tile, chunk and shared-memory arithmetic of the port's kernel
wrappers, on the CPU: plain Python that decides how a kernel is launched.
No card and no JAX are needed."""

import numpy as np
import pytest

from primestereomatch_torch.kernels import _build, cvc_lowmaps
from primestereomatch_torch.kernels import wta as wta_mod
from primestereomatch_torch.kernels.cvc_wta import TILE as K10_TILE
from primestereomatch_torch.kernels.cvc_wta import smem_bytes as k10_smem_bytes
from primestereomatch_torch.kernels.lowmaps import MAX_K, TILE, chain_smem_bytes
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


@pytest.mark.parametrize("low,full,k", [(*ZED_VGA, 5), (*TWO_K, 5), ((36, 80), (72, 160), 9),
                                        ((37, 80), (150, 320), 17)])
def test_cvc_wta_tile_fits_a_block(low, full, k):
    lth, ltw = (low_window(a, b, K10_TILE) for a, b in zip(low, full))
    assert k10_smem_bytes(lth, ltw, k) <= _build.MAX_SMEM_BYTES


def test_cvc_wta_tile_at_ratio_1_does_not_fit():
    """Ratio 1 with a 17 x 17 box: a 64 x 64 tile spans 65 x 65 low-res pixels."""
    lth, ltw = low_window(80, 80, K10_TILE), low_window(96, 96, K10_TILE)
    assert (lth, ltw) == (65, 65)
    assert k10_smem_bytes(lth, ltw, 17) > _build.MAX_SMEM_BYTES


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
