"""The CUDA kernels against their plain versions on the card. These tests
import nothing of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA card they skip. chip_smoke.py checks the same at the main
path's full shapes."""

import pathlib

import numpy as np
import pytest
import torch

from primestereomatch_torch import (
    GIFConfig,
    kernels as K,
    stereo_gif_forward,
    stereo_gif_forward_batch,
)
from primestereomatch_torch.ops.guided_filter import guide_stats

import port_helpers

pytestmark = pytest.mark.cuda
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, B=2, D=16, H=72, W=150, s=4, k=5, seed=0):
    rng = np.random.default_rng(seed)
    g = torch.as_tensor(rng.random((B, H, W, 3)).astype(np.float32), device=dev)
    p = torch.as_tensor(rng.random((B, D, H // s, W // s)).astype(np.float32), device=dev)
    return g, p, guide_stats(g, (H // s, W // s), k, 1e-4).contiguous()


# (B, D, low-res h, w): the default, one less and one more than a 32-pixel
# tile on either axis, an image smaller than one tile, two tiles and a column
LOW_SHAPES = [(2, 16, 18, 37), (1, 2, 31, 33), (2, 3, 33, 31), (1, 65, 18, 20), (2, 5, 64, 65)]


# k = 17 and 7: the largest instantiated box and one the run-time instance takes
@pytest.mark.parametrize("s,k", [(4, 5), (2, 9), (8, 3), (4, 17), (4, 7)])
@pytest.mark.parametrize("B,D,h,w", LOW_SHAPES)
def test_low_maps_kernel_matches_plain(dev, s, k, B, D, h, w):
    """K1 is bitwise its plain version at every box size and tiling."""
    _, p, stats = _inputs(dev, B=B, D=D, H=h * s, W=w * s, s=s, k=k)
    K.reset_launches()
    got = K.low_maps(p, stats, k)
    assert K.LAUNCHES["lowmaps"] == 1
    assert torch.equal(got, K.low_maps_plain(p, stats, k))


# W 150 and 160: quasi and exact column ratios, the staged kernel's 64 x 16
# tiles cut on both axes; D - 1 below, equal to and no multiple of its chunk
# of 8 disparities; an image lower than one tile
@pytest.mark.parametrize("W", [150, 160])
@pytest.mark.parametrize("B,D,H", [(2, 16, 72), (1, 2, 124), (2, 3, 132), (1, 65, 72),
                                   (1, 9, 72), (1, 6, 12)])
def test_upsample_wta_kernel_matches_plain(dev, W, B, D, H):
    g, p, stats = _inputs(dev, B=B, D=D, H=H, W=W)
    maps = K.low_maps_plain(p, stats, 5)
    K.reset_launches()
    got = K.upsample_wta(g, maps)
    assert K.LAUNCHES["wta"] == 1
    assert torch.equal(got, K.upsample_wta_plain(g, maps))


@pytest.mark.parametrize("HW", [(15, 63), (17, 65), (31, 127), (33, 129), (64, 256),
                                (12, 40)])
def test_upsample_wta_staged_kernel_at_tile_edges(dev, HW):
    """The staged kernel (a 4x ratio) on images one less and one more than
    its 64 x 16 tiles, on whole tiles and below one tile: bitwise plain."""
    from primestereomatch_torch.kernels.wta import staged_window

    H, W = HW
    h, w = -(-H // 4), -(-W // 4)
    assert staged_window(h, w, H, W) is not None
    rng = np.random.default_rng(W)
    g = torch.as_tensor(rng.random((2, H, W, 3)).astype(np.float32), device=dev)
    maps = torch.as_tensor(rng.random((2, 4, 7, h, w)).astype(np.float32), device=dev)
    assert torch.equal(K.upsample_wta(g, maps), K.upsample_wta_plain(g, maps))


WMF_CASES = [(9, 64), (9, 256), (4, 256), (3, 10), (0, 8)]


def _wmf_guide(dev, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 256, (*shape, 3), dtype=np.uint8), device=dev)


def _sparse_levels(shape, n_bins: int, levels_a_view, rng) -> np.ndarray:
    """Disparities of view b drawn from levels_a_view[b % len] levels of 0 to
    n_bins - 2, every level in every 32x8 cell of the kernel's tiles that
    has room (so a haloed tile holds the view's count, or fewer at the
    image's edges and ragged cells, or more where the halo adds one); the
    other pixels skewed to the low levels in one cell and to the high ones
    in the next (the median's rank window the first or the last); and
    n_bins - 1 at one pixel a view, row TILE_H + 1: a level that the first
    tile row holds in its halo only."""
    B, H, W = shape
    th, tw = K.wmf.TILE_H, K.wmf.TILE_W
    disp = np.empty(shape, np.uint8)
    for b in range(B):
        n = min(levels_a_view[b % len(levels_a_view)], n_bins - 1)
        levels = np.sort(rng.choice(n_bins - 1, n, replace=False))
        for i, y in enumerate(range(0, H, th)):
            for j, x in enumerate(range(0, W, tw)):
                cell = disp[b, y:y + th, x:x + tw]
                u = rng.random(cell.shape) ** (3.0 if (i + j) % 2 else 1 / 3.0)
                cell[...] = levels[(u * n).astype(int)]
                at = rng.permutation(cell.size)[:n]
                cell.reshape(-1)[at] = levels[:at.size]
        disp[b, min(th + 1, H - 1), min(5, W - 1)] = n_bins - 1
    return disp


# the levels a view of each shape holds in kind "sparse_levels": at 256 bins
# and radius 9 the tiles' haloed tiles hold 64, 65, 128 and 129 levels among
# others, 1, 2 and 3 rank windows
SPARSE_LEVELS = {(2, 40, 70): (64, 128), (1, 5, 20): (2,), (1, 37, 101): (129,)}


@pytest.mark.parametrize("radius,n_bins", WMF_CASES)
@pytest.mark.parametrize("kind", ["random", "two_level", "beyond_bins", "sparse_levels"])
@pytest.mark.parametrize("shape", [(2, 40, 70), (1, 5, 20), (1, 37, 101)],
                         ids=["tiles", "below_a_tile", "ragged"])
def test_weighted_median_kernel_is_bitwise_plain(dev, radius, n_bins, kind, shape):
    """K3 sums every bin in the plain version's order: 0 pixels differ, on
    full-range random disparities (every bin window, both sweeps), on a
    two-level map (a flipped tie would move the median from 3 to 200), with
    disparities >= n_bins (skipped by both), on sparse levels over a wide
    range (the blocks' rank windows, `_sparse_levels`), on an image smaller
    than one 32x8 tile and on one whose sides are no multiple of it."""
    rng = np.random.default_rng(radius * 1000 + n_bins + shape[1])
    if kind == "random":
        disp = rng.integers(0, n_bins, shape, dtype=np.uint8)
    elif kind == "two_level":
        disp = np.where(rng.random(shape) < 0.5, 3, min(200, n_bins - 1)).astype(np.uint8)
    elif kind == "sparse_levels":
        disp = _sparse_levels(shape, n_bins, SPARSE_LEVELS[shape], rng)
        if (radius, n_bins, shape) == (9, 256, (2, 40, 70)):
            passes = set(K.wmf.bin_window_passes(torch.as_tensor(disp), radius, n_bins)
                         .flatten().tolist())
            assert {1, 3, 4} <= passes        # 1, 2 and 3 rank windows
    else:
        disp = rng.integers(0, 256, shape, dtype=np.uint8)    # some >= n_bins unless 256
        disp[0, :3] = 255
    disp = torch.as_tensor(disp, device=dev)
    guide = _wmf_guide(dev, shape, n_bins)
    K.reset_launches()
    got = K.weighted_median(disp, guide, radius, n_bins, 25.5)
    assert K.LAUNCHES["wmf"] == 1
    assert torch.equal(got, K.weighted_median_plain(disp, guide, radius, n_bins, 25.5))


def test_weighted_median_kernel_smooth_guide_and_flat_regions(dev):
    """A smooth guide (heavy weights far from the centre, knife-edge halves)
    on a piecewise-constant map with one block of outliers."""
    yy, xx = np.mgrid[0:64, 0:96]
    guide = np.stack([yy * 2, xx * 2, (yy + xx)], -1).astype(np.uint8)[None]
    disp = np.where(xx < 48, 20, 180).astype(np.uint8)[None].copy()
    disp[0, 10:14, 40:56] = 255
    disp_t, guide_t = torch.as_tensor(disp, device=dev), torch.as_tensor(guide, device=dev)
    for n_bins in (256, 200):
        got = K.weighted_median(disp_t, guide_t, 9, n_bins, 25.5)
        assert torch.equal(got, K.weighted_median_plain(disp_t, guide_t, 9, n_bins, 25.5))


def test_weighted_median_kernel_refuses_a_tile_beyond_shared_memory(dev):
    disp = torch.zeros((1, 16, 40), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        K.weighted_median(disp, _wmf_guide(dev, (1, 16, 40), 0), 120, 64, 25.5)


@pytest.mark.parametrize("radius,n_bins", [(9, 64), (4, 256), (3, 10)])
def test_weighted_median_kernel_matches_plain(dev, radius, n_bins):
    rng = np.random.default_rng(n_bins)
    disp = torch.as_tensor(rng.integers(0, n_bins, (2, 40, 70), dtype=np.uint8), device=dev)
    guide = torch.as_tensor(rng.integers(0, 256, (2, 40, 70, 3), dtype=np.uint8), device=dev)
    got = K.weighted_median(disp, guide, radius, n_bins, 25.5)
    want = K.weighted_median_plain(disp, guide, radius, n_bins, 25.5)
    diff = (got.int() - want.int()).abs()
    assert (diff > 0).float().mean() <= 1e-3 and int(diff.max()) <= 1


def test_kernels_reject_non_contiguous(dev):
    g, p, stats = _inputs(dev)
    with pytest.raises(ValueError):
        K.low_maps(p.transpose(2, 3), stats.transpose(2, 3), 5)


def test_forward_on_card_matches_cpu(dev):
    rng = np.random.default_rng(5)
    left = rng.random((64, 160, 3)).astype(np.float32)
    right = np.roll(left, -6, axis=1)
    cfg = GIFConfig(max_dis=16, med_sz=7)
    K.reset_launches()
    got = stereo_gif_forward(left, right, cfg)
    # 160 = 4 * 40 is an exact stride: the cost is built inside K4
    assert all(K.LAUNCHES[n] == 1 for n in ("cvc_lowmaps", "wta", "wmf"))
    assert K.LAUNCHES["lowmaps"] == 0
    want = stereo_gif_forward(left, right, cfg, device="cpu")
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        assert (a.cpu() != b).float().mean() <= 2e-3


# ---- the fused tails: K4, K10, and K2 at the TPU K5's generic ratios ------

def _views(dev, H, W, s, k, B=1, seed=0):
    """Stacked views (lefts first) with a shifted right view, their random
    gradients and the guide statistics."""
    rng = np.random.default_rng(seed)
    left = rng.random((B, H, W, 3)).astype(np.float32)
    views = torch.as_tensor(np.concatenate([left, np.roll(left, -3, axis=2)]), device=dev)
    grds = torch.as_tensor(rng.random((2 * B, H, W)).astype(np.float32), device=dev)
    return views, grds, guide_stats(views, (H // s, W // s), k, 1e-4).contiguous()


FUSED_CASES = [(4, 5, 150, 320, {}), (2, 9, 72, 160, {}), (8, 3, 144, 320, {}),
               (3, 5, 99, 159, {}),                                # an odd ratio
               (4, 5, 70, 150, {"tau1": 0.3, "tau2": 0.05}),       # quasi columns, clamps
               (2, 9, 72, 160, {"tau1": 0.3, "alpha": 0.7, "border_cost": 0.5}),
               (4, 17, 150, 320, {}),      # the largest instantiated box
               (4, 7, 150, 320, {}),       # a box the run-time instance takes
               (4, 5, 124, 132, {}),       # 31 x 33 low-res: one less, one more than a tile
               (4, 5, 132, 124, {"tau1": 0.3}),
               (4, 5, 72, 100, {}),        # smaller than one tile
               (4, 5, 376, 672, {}),       # ZED-VGA: several disparities a block
               (4, 5, 63, 127, {}),        # one row and one column less than K10's 64 x 128 tile
               (4, 5, 65, 129, {"tau2": 0.05}),    # one more
               (4, 5, 128, 256, {})]       # whole tiles


@pytest.mark.parametrize("s,k,H,W,cost", FUSED_CASES)
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("D", [16, 2, 3, 65])
def test_cvc_low_maps_kernel_matches_plain(dev, s, k, H, W, cost, B, D):
    """K4 is bitwise its plain version (sampled cost, then K1's plain
    version), both directions, with and without clamps, whether or not
    the chunk of disparities a block takes divides D."""
    views, grds, stats = _views(dev, H, W, s, k, B)
    K.reset_launches()
    got = K.cvc_low_maps(views, grds, stats, D, k, **cost)
    assert K.LAUNCHES["cvc_lowmaps"] == 1 and K.LAUNCHES["lowmaps"] == 0
    want = K.cvc_low_maps_plain(views, grds, stats, D, k, **cost)
    assert got.shape == want.shape == (2 * B, 4, D, H // s, W // s)
    assert torch.equal(got, want)


@pytest.mark.parametrize("s,k,H,W,cost", FUSED_CASES)
@pytest.mark.parametrize("B", [1, 2])
def test_cvc_wta_kernel_matches_k4_then_k2(dev, s, k, H, W, cost, B):
    """K10 is bitwise K4's kernel followed by K2's kernel, and within the
    argmin tie class of its plain version."""
    views, grds, stats = _views(dev, H, W, s, k, B, seed=1)
    K.reset_launches()
    got = K.cvc_wta(views, grds, stats, 16, k, **cost)
    assert K.LAUNCHES["cvc_wta"] == 1 and K.LAUNCHES["wta"] == 0
    assert got.dtype == torch.uint8 and 1 <= int(got.min()) and int(got.max()) < 16
    two = K.upsample_wta(views, K.cvc_low_maps(views, grds, stats, 16, k, **cost))
    assert torch.equal(got, two)
    plain = K.cvc_wta_plain(views, grds, stats, 16, k, **cost)
    assert (got != plain).float().mean() <= 2e-3


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("rows", [64, 32, 16])
@pytest.mark.parametrize("edge", [-1, 1, 0], ids=["less", "more", "whole"])
def test_cvc_wta_kernel_tile_heights_match_k4_then_k2(dev, groups, rows, edge):
    """Each tile height K10 has, with one chain or two at once, forced, on
    images one row and one column less than its tile, one more, and whole
    tiles (two of each), at an odd and an even count of disparities:
    bitwise K4 followed by K2."""
    from primestereomatch_torch.kernels import _build
    from primestereomatch_torch.kernels.cvc_wta import TILE_X, launch

    H, W = (rows + edge, TILE_X + edge) if edge else (2 * rows, 2 * TILE_X)
    views, grds, stats = _views(dev, H, W, 4, 3, 1, seed=rows + edge)
    for D in (12, 9):
        got = launch(_build.load("cvc_wta"), views, grds, stats, D, 3, rows, groups)
        want = K.upsample_wta(views, K.cvc_low_maps(views, grds, stats, D, 3))
        assert torch.equal(got, want)


def test_cvc_wta_kernel_refuses_a_tile_beyond_shared_memory(dev):
    """Ratio 1 with a 17x17 box: even a 16-row tile spans 17x96 low-res
    pixels and the chain's band does not fit a block's shared memory."""
    views, grds, stats = _views(dev, 80, 96, 1, 17)
    with pytest.raises(ValueError, match="shared memory"):
        K.cvc_wta(views, grds, stats, 8, 17)


@pytest.mark.parametrize("hw,HW", [((30, 48), (60, 90)), ((40, 70), (40, 70)), ((9, 7), (75, 93))])
def test_upsample_wta_kernel_at_generic_ratios(dev, hw, HW):
    """K2 at the ratios of the TPU's generic kernel: sub-2x, 1 and above 8."""
    rng = np.random.default_rng(HW[1])
    g = torch.as_tensor(rng.random((2, *HW, 3)).astype(np.float32), device=dev)
    maps = torch.as_tensor(rng.random((2, 4, 16, *hw)).astype(np.float32), device=dev)
    got = K.upsample_wta(g, maps)
    assert (got != K.upsample_wta_plain(g, maps)).float().mean() <= 2e-3


@pytest.mark.parametrize("W,kw,names", [
    (160, {}, ("cvc_lowmaps", "wta", "wmf")),
    (154, {}, ("lowmaps", "wta", "wmf")),
    (160, {"tail_fusion": "full"}, ("cvc_wta", "wmf")),
    (154, {"tail_fusion": "full"}, ("lowmaps", "wta", "wmf")),
    (96, {"subsample": 1}, ("lowmaps", "wta", "wmf")),
], ids=["exact", "quasi", "full", "full-quasi", "s1"])
def test_batch_forward_on_card(dev, W, kw, names):
    """Each tail on the card: exactly its kernels launch, once for all 2B
    views; each frame equals the single-frame forward bitwise and the CPU
    within the argmin tie class."""
    rng = np.random.default_rng(W)
    left = rng.random((3, 64, W, 3)).astype(np.float32)
    right = np.roll(left, -4, axis=2)
    cfg = GIFConfig(max_dis=8, med_sz=7, **kw)
    K.reset_launches()
    ld, rd = stereo_gif_forward_batch(left, right, cfg)
    assert {n for n, c in K.LAUNCHES.items() if c} == set(names)
    assert all(K.LAUNCHES[n] == 1 for n in names)
    for b in range(3):
        one = stereo_gif_forward(left[b], right[b], cfg)
        assert torch.equal(one[0], ld[b]) and torch.equal(one[1], rd[b])
    cpu = stereo_gif_forward_batch(left, right, cfg, device="cpu")
    for a, b in zip((ld, rd), cpu):
        assert a.device.type == "cuda" and (a.cpu() != b).float().mean() <= 2e-3


# ---- STEREO_SGBM: K6-K9, bitwise equal to their plain versions -----------

def _features(dev, H, W, C, cap, seed):
    rng = np.random.default_rng(seed)
    lf = torch.as_tensor(rng.integers(0, 2 * cap + 1, (H, W, C), dtype=np.int32), device=dev)
    rf = torch.as_tensor(rng.integers(0, 2 * cap + 1, (H, W, C), dtype=np.int32), device=dev)
    return lf, rf


@pytest.mark.parametrize("H,W,C,D,k,cap", [
    (37, 75, 3, 24, 5, 63),        # D % 8 != 0
    (40, 70, 3, 16, 3, 100),       # 2 * cap > 127
    (30, 90, 3, 16, 11, 63),       # cost bound >= 2**15: int32
    (33, 50, 1, 8, 4, 63),         # one channel, even window
    (20, 140, 3, 70, 5, 63),       # D > 64, several d blocks
    (45, 23, 3, 24, 5, 63),        # narrower than one 60-column tile
    (9, 130, 3, 24, 5, 63),        # lower than one 32-row strip
    (70, 200, 3, 100, 5, 63),      # a D the 64-disparity chunk does not divide, 3 strips
    (40, 130, 3, 40, 1, 63),       # k = 1: the pixel cost alone
    (45, 150, 3, 40, 7, 300),      # cost bound 88200: int32 out, odd k beyond 5
    (35, 66, 1, 130, 2, 63),       # even k, D beyond two chunks, one channel
    (30, 100, 3, 40, 25, 63),      # a window of 25 in int32: 32 disparities a block
])
def test_bt_cost_kernel_matches_plain(dev, H, W, C, D, k, cap):
    lf, rf = _features(dev, H, W, C, cap, H + D)
    bound = k * k * C * 2 * cap
    K.reset_launches()
    got = K.bt_cost(lf, rf, D, k, bound)
    assert K.LAUNCHES["bt_cost"] == 1
    want = K.bt_cost_plain(lf, rf, D, k, bound)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("strip,d_chunk", [(32, 64), (16, 64), (32, 32), (16, 32), (1, 32)])
@pytest.mark.parametrize("k,cap", [(5, 63), (3, 300), (9, 63)])
def test_bt_cost_kernel_launch_shapes_match_plain(dev, strip, d_chunk, k, cap):
    """Every strip height and disparity chunk K6 has (the shapes
    tune_bt_cost.py times), int16 and int32 out, down to one-row strips:
    bitwise the plain version."""
    from primestereomatch_torch.kernels import _build
    from primestereomatch_torch.kernels.bt_cost import launch, plan

    lf, rf = _features(dev, 50, 97, 3, cap, strip + d_chunk + k)
    bound = k * k * 3 * 2 * cap
    want = K.bt_cost_plain(lf, rf, 75, k, bound)
    out = torch.empty_like(want)
    shape = plan(k, 3, out.element_size(), strip, d_chunk)
    got = launch(_build.load("bt_cost"), lf, rf, out, k, shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("nd", [3, 5, 8])
@pytest.mark.parametrize("H,W,D,dtype", [
    (29, 47, 16, torch.int16), (19, 61, 24, torch.int32), (23, 17, 70, torch.int16),
    (5, 40, 1, torch.int16), (4, 7, 1500, torch.int16),
])
def test_sgbm_scan_kernel_matches_plain(dev, nd, H, W, D, dtype):
    rng = np.random.default_rng(H * W + nd)
    cost = torch.as_tensor(rng.integers(0, 9450, (H, W, D)), dtype=dtype, device=dev)
    K.reset_launches()
    got = K.sgbm_aggregate(cost, 600, 2400, nd)
    # the path families' kernel, a launch a family
    assert K.LAUNCHES["sgbm_scan"] == {3: 2, 5: 4, 8: 4}[nd] and K.SWEEPS["sgbm_scan"] == 0
    assert torch.equal(got, K.sgbm_aggregate_plain(cost, 600, 2400, nd))


@pytest.mark.parametrize("nd", [3, 5, 8])
@pytest.mark.parametrize("D", [16, 64, 100, 256, 7])
@pytest.mark.parametrize("dtype,p2", [(torch.int16, 2400), (torch.int16, 60000),
                                      (torch.int32, 2400)],
                         ids=["partials", "p2_beyond_the_bound", "int32_cost"])
def test_sgbm_scan_partials_kernel_matches_plain(dev, nd, D, dtype, p2):
    """K7's partials sum to the plain S bitwise: uint16 groups where
    g * (cost_bound + p2) < 2**16 (at these widths the path families'
    kernel, 2 launches, 1 for 3 directions), the int32 S beyond it and for
    an int32 cost (a launch per family). D = 100 copies 8 bytes at a time,
    D = 7 takes the plain-load ring."""
    from primestereomatch_torch.kernels import sgbm_scan

    rng = np.random.default_rng(D + nd)
    H, W = (23, 37) if D > 64 else (31, 45)
    cost = torch.as_tensor(rng.integers(0, 9451, (H, W, D)), dtype=dtype, device=dev)
    narrow = K.partial_groups(nd, 9450, p2, dtype) is not None
    assert narrow == (dtype == torch.int16 and p2 == 2400)
    route = sgbm_scan.route(cost, nd, 9450, 600, p2)
    assert route == ("paths" if narrow else "int32")
    K.reset_launches()
    parts = K.sgbm_aggregate_partials(cost, 600, p2, nd, 9450)
    if narrow:
        assert len(parts) == 2 and all(q.dtype == torch.uint16 for q in parts)
        assert (K.LAUNCHES["sgbm_scan"], K.SWEEPS["sgbm_scan"]) == _partials_launches(nd, route)
    else:
        assert len(parts) == 1 and parts[0].dtype == torch.int32
        assert (K.LAUNCHES["sgbm_scan"], K.SWEEPS["sgbm_scan"]) == ({3: 2, 5: 4, 8: 4}[nd], 0)
    want = K.sgbm_aggregate_plain(cost, 600, p2, nd)
    assert torch.equal(sum(q.int() for q in parts), want)
    plain = K.sgbm_aggregate_partials_plain(cost, 600, p2, nd, 9450)
    assert len(plain) == len(parts)
    assert all(torch.equal(a, b) for a, b in zip(parts, plain))


@pytest.mark.parametrize("nd", [8, 5, 3])
@pytest.mark.parametrize("D,route", [(32, "paths"), (160, "sweeps")])
def test_sgbm_scan_partials_at_the_edge_of_uint16(dev, nd, D, route):
    """Costs at their bound and the largest P2 each design's groups allow
    (the sweeps': 4 and 4, 4 and 1, 2 and 1 directions; the path families':
    4 and 4, 3 and 2, 2 and 1): every L reaches cost_bound + p2 somewhere
    and the groups still fit, each equal to its plain group."""
    from primestereomatch_torch.kernels import sgbm_scan

    bound = 9450
    g = max(len(grp) for grp in K.partial_groups(nd, bound, 0, torch.int16, route))
    assert g == {"sweeps": {8: 4, 5: 4, 3: 2}, "paths": {8: 4, 5: 3, 3: 2}}[route][nd]
    p2 = (2**16 - 1) // g - bound
    groups = K.partial_groups(nd, bound, p2, torch.int16, route)
    assert groups is not None
    assert K.partial_groups(nd, bound, p2 + 1, torch.int16, route) is None
    rng = np.random.default_rng(3)
    cost = torch.as_tensor(rng.choice([0, bound], (40, 50, D)), dtype=torch.int16, device=dev)
    parts = tuple(torch.empty(cost.shape, dtype=torch.uint16, device=dev) for _ in range(2))
    K.reset_launches()
    (sgbm_scan._sweeps if route == "sweeps" else sgbm_scan._paths)(cost, 600, p2, nd, parts)
    assert (K.LAUNCHES["sgbm_scan"], K.SWEEPS["sgbm_scan"]) == _partials_launches(nd, route)
    plain = sgbm_scan.sum_groups_plain(cost, 600, p2, groups)
    assert all(torch.equal(a, b) for a, b in zip(parts, plain))
    assert torch.equal(sum(q.int() for q in parts), K.sgbm_aggregate_plain(cost, 600, p2, nd))


def test_sgbm_partials_take_the_path_families_where_a_sweep_group_does_not_fit(dev):
    """MODE_SGBM on an image the sweeps take with a P2 whose L fits a group
    of three directions but not of four: the sweeps' top-down group of four
    does not fit, the path families' groups (3 and 2) do, so the uint16
    partials take them, each equal to its plain group."""
    from primestereomatch_torch.kernels import sgbm_scan

    bound, p2 = 9450, (2**16 - 1) // 3 - 9450
    rng = np.random.default_rng(4)
    cost = torch.as_tensor(rng.choice([0, bound], (4, 1700, 160)), dtype=torch.int16, device=dev)
    assert sgbm_scan.route(cost, 5, bound, 600, 2400) == "sweeps"
    assert K.partial_groups(5, bound, p2) is None
    assert sgbm_scan.route(cost, 5, bound, 600, p2) == "paths"
    K.reset_launches()
    parts = K.sgbm_aggregate_partials(cost, 600, p2, 5, bound)
    assert (K.LAUNCHES["sgbm_scan"], K.SWEEPS["sgbm_scan"]) == (2, 0)
    plain = K.sgbm_aggregate_partials_plain(cost, 600, p2, 5, bound)
    assert len(parts) == len(plain) == 2
    assert all(torch.equal(a, b) for a, b in zip(parts, plain))
    assert torch.equal(sum(q.int() for q in parts), K.sgbm_aggregate_plain(cost, 600, p2, 5))


def _partials_launches(nd, route):
    """K7's launches and sweeps for the uint16 partials: both sweeps in one
    launch, or a launch per path family of each group."""
    return ({3: 1, 5: 2, 8: 2}[nd], 0) if route == "paths" else (1, 2)


# (H, W): strips of one column (W below the card's strips), a 2K row
# (34-column strips, the last one 32 wide), W = 301 (the last strip one
# column), a single row, a single column (W = 1600 and 2376:
# test_sgbm_sweeps_strips_from_the_plan)
SWEEP_SHAPES = [(29, 47), (12, 2208), (23, 301), (1, 7), (9, 1)]


def _sweep_penalties(pen, nd):
    """(costs, P1, P2) of a case: "random" costs up to 9450 with SGBMConfig's
    P1 600 and P2 2400; at the edge of the sweeps' 16-bit halves, costs of 0
    and 9450 (every L reaches 9450 + P2 somewhere) with P2 the largest the
    sweeps' largest group admits and P1 600 ("p2_max") or P2 ("p1_eq_p2");
    "p1_gt_p2", P1 2400 above P2 600 on random costs."""
    p2_max = (2**16 - 1) // {8: 4, 5: 4, 3: 2}[nd] - 9450
    return {"random": ("random", 600, 2400), "p2_max": ("edge", 600, p2_max),
            "p1_eq_p2": ("edge", p2_max, p2_max), "p1_gt_p2": ("random", 2400, 600)}[pen]


@pytest.mark.parametrize("nd", [3, 5, 8])
@pytest.mark.parametrize("D,pen", [(D, "random") for D in (7, 16, 64, 100, 129, 130, 131, 255,
                                                            256)]
                         + [(D, pen) for D in (129, 131, 255, 256)
                            for pen in ("p2_max", "p1_eq_p2", "p1_gt_p2")])
@pytest.mark.parametrize("H,W", SWEEP_SHAPES)
def test_sgbm_sweeps_match_the_plain_groups(dev, nd, D, pen, H, W):
    """Each design's uint16 partials are bitwise their plain groups and
    their sum the plain S: the path families' at every D, the sweeps' (both
    in one launch) at the D they take, at every shape; the entry takes the
    route its rule gives, and the int32 cost's S (the path families) equals
    the plain S. D = 129, 130, 131 and 255 leave lanes and halves past D;
    the edge cases hold the sweeps' 16-bit halves at their largest values,
    with P1 = P2 and P1 > P2."""
    from primestereomatch_torch.kernels import sgbm_scan

    kind, p1, p2 = _sweep_penalties(pen, nd)
    rng = np.random.default_rng(H * W + D + nd)
    C = rng.integers(0, 9451, (H, W, D)) if kind == "random" else rng.choice([0, 9450], (H, W, D))
    cost = torch.as_tensor(C, dtype=torch.int16, device=dev)
    want = K.sgbm_aggregate_plain(cost, p1, p2, nd)
    designs = {"paths": sgbm_scan._paths}
    if sgbm_scan.SWEEPS_MIN_D <= D <= sgbm_scan.SWEEPS_MAX_D:
        designs["sweeps"] = sgbm_scan._sweeps
    for route, fn in designs.items():
        parts = tuple(torch.empty(cost.shape, dtype=torch.uint16, device=dev) for _ in range(2))
        K.reset_launches()
        fn(cost, p1, p2, nd, parts)
        assert (K.LAUNCHES["sgbm_scan"], K.SWEEPS["sgbm_scan"]) == _partials_launches(nd, route)
        plain = sgbm_scan.sum_groups_plain(
            cost, p1, p2, K.partial_groups(nd, 9450, p2, torch.int16, route))
        assert all(torch.equal(a, b) for a, b in zip(parts, plain)), route
        assert torch.equal(sum(q.int() for q in parts), want), route
    route = "sweeps" if sgbm_scan.takes_sweeps(W, D) else "paths"
    assert sgbm_scan.route(cost, nd, 9450, p1, p2) == route
    parts = K.sgbm_aggregate_partials(cost, p1, p2, nd, 9450)
    assert torch.equal(sum(q.int() for q in parts), want)
    wide = torch.as_tensor(C, dtype=torch.int32, device=dev)
    assert torch.equal(K.sgbm_aggregate(wide, p1, p2, nd), want)


@pytest.mark.parametrize("nd", [8, 5, 3])
@pytest.mark.parametrize("H,W,D", [(17, 37, 130), (6, 20, 256), (11, 5, 200), (9, 300, 160),
                                   (7, 2208, 256), (5, 2376, 136), (4, 1600, 129),
                                   (4, 2208, 131), (3, 2376, 255)])
def test_sgbm_sweeps_strips_from_the_plan(dev, nd, H, W, D):
    """The plan's strips cover the width, the last one narrower where they
    do not divide it, a block's warps cover its strip, the last warp with
    fewer columns where they do not divide it, and the card holds both
    sweeps' blocks: strips of one column (W below the card's strips), of 5
    columns in warps of 2, of 34 in 12 warps of 3 (2K), of 36 in 12 warps of
    3 (W = 2376, the widest an H100 holds) and of 25 (W = 1600); the sweeps'
    partials equal their plain groups in every mode, odd D included."""
    from primestereomatch_torch.kernels import sgbm_scan

    rng = np.random.default_rng(H + W + D)
    cost = torch.as_tensor(rng.integers(0, 9451, (H, W, D)), dtype=torch.int16, device=dev)
    pl = sgbm_scan.plan(cost)
    assert pl is not None
    assert (pl.strips - 1) * pl.strip_width < W <= pl.strips * pl.strip_width
    assert (pl.warps - 1) * pl.cols < pl.strip_width <= pl.warps * pl.cols <= 12 * pl.cols
    assert 2 * pl.strips <= pl.sms * pl.blocks_per_sm
    parts = tuple(torch.empty(cost.shape, dtype=torch.uint16, device=dev) for _ in range(2))
    sgbm_scan._sweeps(cost, 600, 2400, nd, parts)
    plain = sgbm_scan.sum_groups_plain(cost, 600, 2400, sgbm_scan._GROUPS[nd])
    assert all(torch.equal(a, b) for a, b in zip(parts, plain))


@pytest.mark.parametrize("H,W,D", [(5, None, 256), (4, 1600, 512), (3, 2208, 512)])
def test_sgbm_partials_take_the_path_families_where_the_sweeps_do_not_fit(dev, H, W, D):
    """An image a little wider than the card holds both sweeps' strips of
    (12 warps x 3 columns, one block an SM), and 512 disparities (past the
    sweeps) at W = 1600 and 2208: the uint16 partials take the path
    families' kernel, each equal to its plain group, and the int32 S equals
    the plain S."""
    from primestereomatch_torch.kernels import sgbm_scan

    if W is None:
        W = torch.cuda.get_device_properties(dev).multi_processor_count // 2 * 36 + 24
    rng = np.random.default_rng(W + D)
    cost = torch.as_tensor(rng.integers(0, 9451, (H, W, D)), dtype=torch.int16, device=dev)
    if D <= sgbm_scan.SWEEPS_MAX_D:
        assert sgbm_scan.takes_sweeps(W, D) and sgbm_scan.plan(cost) is None
    assert sgbm_scan.route(cost, 8, 9450, 600, 2400) == "paths"
    K.reset_launches()
    parts = K.sgbm_aggregate_partials(cost, 600, 2400, 8, 9450)
    assert (K.LAUNCHES["sgbm_scan"], K.SWEEPS["sgbm_scan"]) == (2, 0)
    plain = K.sgbm_aggregate_partials_plain(cost, 600, 2400, 8, 9450)
    assert all(torch.equal(x, y) for x, y in zip(parts, plain))
    want = K.sgbm_aggregate_plain(cost, 600, 2400, 8)
    assert torch.equal(sum(q.int() for q in parts), want)
    assert torch.equal(K.sgbm_aggregate(cost, 600, 2400, 8), want)


def test_sgbm_sweeps_again_on_the_same_slots(dev):
    """A second launch, after one of another shape, reuses the edge slots
    the first left: the launch's tags are above every earlier one's, so none
    is read stale; the three launches equal their plain groups."""
    from primestereomatch_torch.kernels import sgbm_scan

    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.integers(0, 9451, (33, 410, 160)), dtype=torch.int16, device=dev)
    b = torch.as_tensor(rng.integers(0, 9451, (20, 300, 256)), dtype=torch.int16, device=dev)

    def sweeps(cost, nd):
        parts = tuple(torch.empty(cost.shape, dtype=torch.uint16, device=dev) for _ in range(2))
        sgbm_scan._sweeps(cost, 600, 2400, nd, parts)
        return parts

    first = sweeps(a, 8)
    sweeps(b, 5)
    key = (a.device, torch.cuda.current_stream(a.device).cuda_stream)
    slots = sgbm_scan._SCRATCH[key][0]
    again = sweeps(a, 8)
    assert sgbm_scan._SCRATCH[key][0] is slots
    plain = sgbm_scan.sum_groups_plain(a, 600, 2400, sgbm_scan._GROUPS[8])
    for got in (first, again):
        assert all(torch.equal(x, y) for x, y in zip(got, plain))


# K8's settings: every min_disparity (negative ones included), uniqueness
# ratio and disp12_max_diff (-1: no LR check) of the tests, in every
# combination
SELECT_SETTINGS = [(min_d, uniq, d12) for min_d in (-20, -3, 0, 3, 7) for uniq in (0, 10, 15)
                   for d12 in (-1, 0, 1, 5)]


def _select_costs(dev, entry, values, shape, seed):
    """(the costs handed to K8, their int32 sum S). entry: "s" the int32 S,
    "one" / "two" that many uint16 partials. values: "wide" (two partials
    sum beyond 65535), "ties" (0..3: first-min ties and ties in the far set),
    "huge" (the int32 S only; per pixel one of: values up to 2**31 - 1, a
    band of near-ties around 2**28 (the far set's sentinel), a band just
    below 2**31: the uniqueness products and the sub-pixel sums wrap). A
    tenth of the pixels get their minimum at d = 0, another tenth at
    D - 1."""
    rng = np.random.default_rng(seed)
    n = {"s": 1, "one": 1, "two": 2}[entry]
    if values == "huge":
        assert entry == "s"
        kind = rng.integers(0, 3, shape[:2])[None, :, :, None]
        parts = np.where(kind == 0, rng.integers(0, 2**31, (n,) + shape),
                         np.where(kind == 1, 2**28 + rng.integers(-4, 5, (n,) + shape),
                                  2**31 - 1 - rng.integers(0, 9, (n,) + shape)))
    else:
        hi = 4 if values == "ties" else {"s": 5000, "one": 65536, "two": 47400}[entry]
        parts = rng.integers(0, hi, (n,) + shape)
    D = shape[-1]
    if D > 1:
        pick = rng.random(shape[:2])
        parts[:, pick < 0.1, 0] = 0
        far_end = pick > 0.9
        parts[:, far_end] = np.maximum(parts[:, far_end], 1)
        parts[:, far_end, D - 1] = 0
    dt = np.int32 if entry == "s" else np.uint16
    costs = tuple(torch.as_tensor(q.astype(dt), device=dev) for q in parts)
    return costs, sum(q.int() for q in costs)


def _select(costs, *sel):
    if costs[0].dtype == torch.int32:
        return K.select_disparity(costs[0], *sel)
    return K.select_disparity_partials(costs, *sel)


# D: one and three values (the scalar route, a far set only at d = 0), a
# vector route of one lane's vector, Teddy's 64, one the vectors do not
# divide (scalar), 96 and 128 (16 values a lane on the vector route), 2K's
# 256, 301 (scalar, walked in chunks) and 520 (the vector route in chunks)
@pytest.mark.parametrize("entry,values", [("s", "wide"), ("one", "wide"), ("two", "wide"),
                                          ("s", "ties"), ("one", "ties"), ("two", "ties"),
                                          ("s", "huge")])
@pytest.mark.parametrize("D", [1, 3, 16, 64, 70, 96, 128, 256, 301, 520])
def test_select_kernel_matches_plain(dev, D, entry, values):
    """K8 from the int32 S, one or two uint16 partials (added as it reads):
    bitwise the plain selection on their int32 sum, one launch a call, at
    every setting; the partials' result is also the int32 kernel's on S."""
    # rows D + 96 wide, so every min_disparity leaves columns inside the minX band
    costs, S = _select_costs(dev, entry, values, (21, D + 96, D), D + len(entry) + len(values))
    for sel in SELECT_SETTINGS:
        min_d, uniq, d12 = sel
        K.reset_launches()
        got = _select(costs, uniq, d12, min_d)
        assert K.LAUNCHES["select"] == 1
        assert torch.equal(got, K.select_disparity_plain(S, uniq, d12, min_d)), sel
        if entry != "s":
            assert torch.equal(got, K.select_disparity(S, uniq, d12, min_d)), sel
            assert torch.equal(K.select_disparity_partials((S,), uniq, d12, min_d), got)


@pytest.mark.parametrize("entry", ["s", "one", "two"])
@pytest.mark.parametrize("H,W,D", [(7, 1, 64), (1, 300, 64), (1, 300, 70),
                                   (2, "limit", 64), (2, "limit", 3)])
def test_select_kernel_at_row_edges(dev, entry, H, W, D):
    """One-pixel rows, one-row images and rows at the wrapper's limit."""
    from primestereomatch_torch.kernels.select import max_row

    W = max_row() if W == "limit" else W
    costs, S = _select_costs(dev, entry, "wide", (H, W, D), W + D)
    for min_d, uniq, d12 in ((0, 10, 1), (-20, 15, 0), (7, 0, -1)):
        got = _select(costs, uniq, d12, min_d)
        assert torch.equal(got, K.select_disparity_plain(S, uniq, d12, min_d))
    with pytest.raises(ValueError):
        _select(tuple(torch.zeros((1, max_row() + 1, D), dtype=c.dtype, device=dev)
                      for c in costs), 10, 1, 0)


@pytest.mark.parametrize("entry", ["s", "two"])
def test_select_kernel_unaligned_takes_the_scalar_route(dev, entry):
    """Costs that start off a 16-byte boundary go the scalar route, bitwise."""
    from primestereomatch_torch.kernels.select import launch_shape

    costs, S = _select_costs(dev, entry, "wide", (13, 41, 64), 5)
    # one value in: every pixel's base 2 or 4 bytes past a 16-byte boundary
    shifted = tuple(c.reshape(-1)[1:1 + 13 * 40 * 64].view(13, 40, 64) for c in costs)
    assert all(c.is_contiguous() and c.data_ptr() % 16 for c in shifted)
    assert launch_shape(13, 40, 64, 0 if entry == "s" else 2, aligned=False)["route"] == "scalar"
    S2 = sum(c.int() for c in shifted)
    assert torch.equal(_select(shifted, 10, 1, 0), K.select_disparity_plain(S2, 10, 1, 0))


def test_select_kernel_degenerate(dev):
    """A V-shaped cost (d_best 3), equal values everywhere (the first d),
    d_best at 0 and at D - 1, and every value INT_MAX (the first d)."""
    D = 8
    d_idx = torch.arange(D, device=dev, dtype=torch.int32)
    for S in ((d_idx - 3).abs() * 1000 + 10, torch.full((D,), 100, dtype=torch.int32, device=dev),
              d_idx * 7 + 1, (D - 1 - d_idx) * 7 + 1,
              torch.full((D,), 2**31 - 1, dtype=torch.int32, device=dev)):
        S = S.expand(16, 80, D).contiguous()
        assert torch.equal(K.select_disparity(S, 10, 1), K.select_disparity_plain(S, 10, 1))


@pytest.mark.parametrize("H,W", [(24, 40), (17, 150), (130, 33), (1, 70), (1300, 40), (70, 1)])
def test_segmin_sweep_kernel_matches_plain(dev, H, W):
    rng = np.random.default_rng(H + W)
    m = torch.as_tensor(rng.integers(0, H * W, (H, W), dtype=np.int32), device=dev)
    conn = torch.as_tensor(rng.random((H, W)) < 0.7, device=dev).to(torch.uint8)
    for axis in (0, 1):
        assert torch.equal(K.segmin_sweep(m, conn, axis), K.segmin_sweep_plain(m, conn, axis))


def _serpentine(H=32, W=32):
    d = np.full((H, W), -16, np.int16)
    d[0::2] = 160
    for i, y in enumerate(range(1, H - 1, 2)):
        d[y, W - 1 if i % 2 == 0 else 0] = 160
    return d


def _speckle_case(kind, H, W, seed):
    """Labels and a packed link mask: random, all links on, all off, or the
    graph of a serpentine component."""
    from primestereomatch_torch.ops.sgbm import speckle_graph

    rng = np.random.default_rng(seed)
    m = torch.as_tensor(rng.integers(0, H * W + 1, (H, W), dtype=np.int32))
    if kind == "random":
        return m, torch.as_tensor(rng.integers(0, 16, (H, W), dtype=np.uint8))
    if kind in ("on", "off"):
        return m, torch.full((H, W), 15 if kind == "on" else 0, dtype=torch.uint8)
    _, labels, conns = speckle_graph(torch.as_tensor(_serpentine(H, W)), 32, -16)
    return labels, K.pack_links(*conns)


# a column longer than many segments, one row, one column, one pixel, the
# shapes of segmin's test, and the SGBM Teddy shape
SWEEP_SHAPES = [(1300, 40), (1, 70), (70, 1), (1, 1), (24, 40), (17, 150), (375, 450)]


@pytest.mark.parametrize("kind", ["random", "on", "off"])
@pytest.mark.parametrize("H,W", SWEEP_SHAPES)
def test_speckle_sweep_kernel_matches_plain(dev, kind, H, W):
    """K9's sweep (hook, rows, columns) is bitwise its plain version, and its
    flag takes the stamp iff a label changed (out != in anywhere)."""
    m, links = (t.to(dev) for t in _speckle_case(kind, H, W, H * 7 + W))
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    K.reset_launches()
    got = K.speckle_sweep(m, links, changed, 3)
    assert K.LAUNCHES["speckle"] == 2
    assert torch.equal(got, K.speckle_sweep_plain(m, links))
    assert (int(changed.item()) == 3) == bool((got != m).any())
    # a second sweep from the first one's output, with a fresh stamp
    again = K.speckle_sweep(got, links, changed, 4)
    assert torch.equal(again, K.speckle_sweep_plain(got, links))
    assert (int(changed.item()) == 4) == bool((again != got).any())


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (4, 1, 8, 1), (2, 4, 8, 2), (1, 8, 2, 8),
                                   (8, 2, 16, 1), (1, 16, 1, 16)])
def test_speckle_sweep_kernel_at_every_block_shape(dev, shape):
    m, links = (t.to(dev) for t in _speckle_case("serpentine", 64, 48, 0))
    for _ in range(3):
        got = K.speckle_sweep(m, links, shape=shape)
        assert torch.equal(got, K.speckle_sweep_plain(m, links))
        m = got


@pytest.mark.parametrize("cap", [None, 2, 6])
@pytest.mark.parametrize("spc", [1, 2, 3])
def test_filter_speckles_on_card_matches_cpu(dev, cap, spc):
    from primestereomatch_torch.ops.sgbm import filter_speckles

    d = _serpentine(48, 40)
    rng = np.random.default_rng(spc)
    d[rng.random(d.shape) < 0.05] = 96
    want = filter_speckles(torch.as_tensor(d), 400, 32, -16, max_iters=cap, steps_per_check=spc)
    got = filter_speckles(torch.as_tensor(d, device=dev), 400, 32, -16, max_iters=cap,
                          steps_per_check=spc)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mode", ["hh", "sgbm", "3way"])
def test_sgbm_forward_on_card_matches_cpu(dev, mode):
    from primestereomatch_torch import SGBMConfig, stereo_sgbm_forward

    rng = np.random.default_rng(9)
    left = rng.integers(0, 256, (60, 130, 3), dtype=np.uint8)
    right = np.roll(left, -5, axis=1)
    cfg = SGBMConfig(num_disparities=16, mode=mode, speckle_window_size=20)
    K.reset_launches()
    got = stereo_sgbm_forward(left, right, cfg)
    assert got.device.type == "cuda" and got.dtype == torch.int16
    for name in ("bt_cost", "sgbm_scan", "select", "speckle"):
        assert K.LAUNCHES[name] >= 1, name
    # the partials route at D = 16: the path families' kernel, a family of
    # each group per launch
    assert K.LAUNCHES["sgbm_scan"] == {"hh": 2, "sgbm": 2, "3way": 1}[mode]
    assert K.SWEEPS["sgbm_scan"] == 0
    assert torch.equal(got.cpu(), stereo_sgbm_forward(left, right, cfg, device="cpu"))


# ---- the STEREO_GIF variants: u8 cost, the PP toolchain, table mode, ------
# ---- the float JointWMF and the staged engine -----------------------------

def _agree(a, b, share=0.999):
    """The JointWMF tie budget: at least 99.9% of the medians agree (CUDA
    expf may differ from the CPU's by an ulp on a cumulative tie)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    assert (a.cpu() == b.cpu()).float().mean() >= share


def _pair(H, W, shift, seed):
    rng = np.random.default_rng(seed)
    left = rng.random((H, W, 3)).astype(np.float32)
    return left, np.ascontiguousarray(np.roll(left, -shift, axis=1))


def test_postproc_ops_on_card_match_cpu(dev):
    """lr_check and fill_invalid bitwise, weighted_median (both exponent
    forms) within the tie budget, on the card's own WTA output."""
    from primestereomatch_torch.ops import postproc

    left, right = _pair(64, 154, 5, 1)
    cfg = GIFConfig(max_dis=16)
    ld, rd = stereo_gif_forward(left, right, cfg, run_postprocess=False)
    lv, rv = postproc.lr_check(ld, rd)
    lv_c, rv_c = postproc.lr_check(ld.cpu(), rd.cpu())
    assert torch.equal(lv.cpu(), lv_c) and torch.equal(rv.cpu(), rv_c)
    for d, v, img, use_sqrt in ((ld, lv, left, False), (rd, rv, right, True)):
        filled = postproc.fill_invalid(d, v)
        assert torch.equal(filled.cpu(), postproc.fill_invalid(d.cpu(), v.cpu()))
        img_t = torch.as_tensor(img)
        got = postproc.weighted_median(img_t.to(dev), filled, v, 16, 19, use_sqrt=use_sqrt)
        _agree(got, postproc.weighted_median(img_t, filled.cpu(), v.cpu(), 16, 19,
                                             use_sqrt=use_sqrt))


def test_table_median_on_card_matches_cpu(dev):
    from primestereomatch_torch.ops.jointwmf import joint_wmf
    from primestereomatch_torch.utils import feature_index_color

    rng = np.random.default_rng(8)
    guide = rng.integers(0, 256, (48, 70, 3), dtype=np.uint8)
    fi, wm = feature_index_color(guide, n_feat=64, seed=0)
    disp = torch.as_tensor(rng.integers(0, 32, (48, 70), dtype=np.uint8))
    fi_t, wm_t = torch.as_tensor(fi), torch.as_tensor(wm)
    got = joint_wmf(disp.to(dev), radius=9, n_bins=32, findex=fi_t.to(dev), wmap=wm_t.to(dev))
    _agree(got, joint_wmf(disp, radius=9, n_bins=32, findex=fi_t, wmap=wm_t))


@pytest.mark.parametrize("fusion,scene", [("maps", "seeded"), ("full", "seeded"),
                                          ("maps", "2k"), ("full", "2k")],
                         ids=["maps", "full", "maps-2k", "full-2k"])
def test_u8_forward_launches_k1_at_exact_stride(dev, fusion, scene):
    """At 160 = 4 * 40 the float cost takes K4 (or K10), the uint8 cost K1
    -> K2 -> K3; the card agrees with the CPU within the tie class. At 2K
    (2208 = 4 * 552, D = 256) the same kernels recover the seeded field of
    chip_smoke.synthetic_2k: each region's median within 1 of its level."""
    import chip_smoke

    if scene == "2k":
        left, right, rect = chip_smoke.synthetic_2k(0)
        cfg = GIFConfig(max_dis=256, cvc_dtype="u8", tail_fusion=fusion)
    else:
        left, right = _pair(64, 160, 6, 2)
        cfg = GIFConfig(max_dis=16, med_sz=7, cvc_dtype="u8", tail_fusion=fusion)
    K.reset_launches()
    got = stereo_gif_forward(left, right, cfg)
    assert {n for n, c in K.LAUNCHES.items() if c} == {"lowmaps", "wta", "wmf"}
    if scene == "2k":
        chip_smoke.check_medians_2k(*(t.cpu().numpy().astype(np.float64) for t in got), rect)
    else:
        want = stereo_gif_forward(left, right, cfg, device="cpu")
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and (a.cpu() != b).float().mean() <= 2e-3


@pytest.mark.parametrize("scene", ["seeded", "teddy"])
def test_u8_costs_on_card_are_bitwise_cpu(dev, scene):
    """The uint8 costs at the FGF grid on the card bitwise the CPU's; at
    Teddy (D = 64) their sha256 is chip_smoke.U8_SHA256, the JAX
    package's."""
    import hashlib

    import chip_smoke
    from primestereomatch_torch.models.gif_pipeline import sampled_u8_costs
    from primestereomatch_torch.ops.cost_volume import unit_cost
    from primestereomatch_torch.utils import load_dataset

    if scene == "teddy":
        s = load_dataset("Teddy")
        left, right, cfg = s.left_f32, s.right_f32, GIFConfig()
    else:
        left, right = _pair(72, 150, 3, 4)
        cfg = GIFConfig(max_dis=24)
    views = torch.as_tensor(np.stack([left, right]))
    got = sampled_u8_costs(views.to(dev), cfg)
    want = sampled_u8_costs(views, cfg)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(unit_cost(got).cpu(), unit_cost(want))
    if scene == "teddy":
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        assert digest == chip_smoke.U8_SHA256


VARIANT_CASES = [("toolchain", None), ("table", None)] + [
    (v, n) for n in ("Teddy", "Cones") for v in port_helpers.VARIANT_CONFIGS]


@pytest.mark.parametrize("variant,scene", VARIANT_CASES,
                         ids=[v + (f"-{n.lower()}" if n else "") for v, n in VARIANT_CASES])
def test_variant_forward_on_card_matches_cpu(dev, variant, scene):
    """Each variant on the card launches K1, K2 and K3 (table mode: K1, K2;
    its median is plain torch) and agrees with the CPU within the tie
    class, on a seeded 64x154 pair (D = 16) and on Middlebury Teddy and
    Cones at GIFConfig's defaults (D = 64; table mode with the feature
    indexes of seed 0), where tests/test_torch_variants.py holds the CPU's
    %BP(nonocc) to the JAX package's."""
    from primestereomatch_torch.utils import feature_index_color, load_dataset

    to_u8 = lambda x: np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)  # noqa: E731
    if scene:
        s = load_dataset(scene)
        left, right, u8, feat = s.left_f32, s.right_f32, (s.left_bgr, s.right_bgr), {}
        cfg = GIFConfig(**port_helpers.VARIANT_CONFIGS[variant])
    else:
        left, right = _pair(64, 154, 5, 3)
        u8, feat = (to_u8(left), to_u8(right)), dict(n_feat=64)
        cfg = GIFConfig(max_dis=16, med_sz=7, **port_helpers.VARIANT_CONFIGS[variant])
    extra = ()
    if cfg.wmf_mode == "table":
        lf, wm = feature_index_color(u8[0], seed=0, **feat)
        rf, _ = feature_index_color(u8[1], seed=0, **feat)
        extra = (lf, rf, wm)
    K.reset_launches()
    got = stereo_gif_forward(left, right, cfg, True, *extra)
    # table mode's median is plain torch; the toolchain ends in K3
    assert K.LAUNCHES["wmf"] == (0 if extra else 1) and K.LAUNCHES["lowmaps"] == 1
    assert {n for n, c in K.LAUNCHES.items() if c} == {"lowmaps", "wta"} | (
        set() if extra else {"wmf"})
    want = stereo_gif_forward(left, right, cfg, True, *extra, device="cpu")
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and (a.cpu() != b).float().mean() <= 2e-3


def test_joint_wmf_float_goes_through_k3(dev):
    """Exact mode with at most 256 levels launches K3, bitwise its plain
    version; with a participation plane (here of ones) it launches K3's
    valid mode: two K3 launches, equal results."""
    from primestereomatch_torch.ops.jointwmf import joint_wmf, joint_wmf_float

    rng = np.random.default_rng(6)
    disp = torch.as_tensor((rng.random((40, 70)) * 30.0).astype(np.float32), device=dev)
    guide = torch.as_tensor(rng.integers(0, 256, (40, 70, 3), dtype=np.uint8), device=dev)
    K.reset_launches()
    got = joint_wmf_float(disp, guide, radius=5, n_levels=64)
    assert K.LAUNCHES["wmf"] == 1 and got.device.type == "cuda"
    ones = joint_wmf_float(disp, guide, radius=5, n_levels=64,
                           valid=torch.ones(40, 70, device=dev))
    assert K.LAUNCHES["wmf"] == 1 and K.LAUNCHES["wmf_valid"] == 1
    assert torch.equal(got, ones)
    # the plain op on the same levels
    from primestereomatch_torch.ops.jointwmf import from32f_to_32s
    idx, mapping, _ = from32f_to_32s(disp.cpu().numpy(), 64)
    med = joint_wmf(torch.as_tensor(idx, device=dev), guide, radius=5, n_bins=64)
    assert torch.equal(got, torch.as_tensor(mapping, device=dev)[med.long()])


def test_dispest_stages_on_card_match_cpu(dev, tmp_path):
    """DispEst's stages on the card against the CPU's, its dump read back,
    its compute() the forward within the tie class."""
    from primestereomatch_torch import DispEst
    from primestereomatch_torch.utils.png import read_png

    left, right = _pair(72, 150, 4, 5)
    cfg = GIFConfig(max_dis=16, med_sz=7)
    card, cpu = DispEst(cfg), DispEst(cfg, device="cpu")
    cv, cv_c = card.cost_const(left, right), cpu.cost_const(left, right)
    for a, b in zip(cv, cv_c):
        assert a.device.type == "cuda" and torch.allclose(a.cpu(), b, atol=1e-6)
    cvf = card.cost_filter(left, cv[0])
    assert torch.allclose(cvf.cpu(), cpu.cost_filter(left, cv[0].cpu()), atol=1e-5)
    wta = card.disp_select(cvf)
    assert torch.equal(wta.cpu(), cpu.disp_select(cvf.cpu()))
    K.reset_launches()
    pp = card.post_process(wta, left)
    assert K.LAUNCHES["wmf"] == 1
    _agree(pp, cpu.post_process(wta.cpu(), left))
    paths = card.dump_cost_volume(cv[0][:3], str(tmp_path / "cv_"))
    want = np.clip(np.rint(cv[0][:3].cpu().numpy() * 255.0), 0, 255).astype(np.uint8)
    assert all(np.array_equal(read_png(p, 1), w) for p, w in zip(paths, want))
    got = card.compute(left, right)
    ref = stereo_gif_forward(left, right, cfg)
    assert all((a != b).float().mean() <= 2e-3 for a, b in zip(got, ref))


def test_dispest_stages_on_card_match_the_reference_dumps(dev):
    """DispEst's stages on the card at Middlebury Teddy (GIFConfig's
    defaults) against the reference binary's stage dumps
    (tests/golden/ref_teddy.npz) at the JAX package's bounds: gradients
    5e-7, CVC 1e-6 and CVF 1e-3 at d in (1, 8, 32, 63), WTA mismatch 5e-4."""
    from primestereomatch_torch import DispEst
    from primestereomatch_torch.models.gif_pipeline import view_gradients
    from primestereomatch_torch.utils import load_dataset

    s = load_dataset("Teddy")
    ref = np.load(ROOT / "tests" / "golden" / "ref_teddy.npz")
    cfg = GIFConfig()
    eng = DispEst(cfg)
    views = torch.as_tensor(np.stack([s.left_f32, s.right_f32]), device=dev)
    grd = view_gradients(views, cfg).cpu().numpy()
    assert max(float(np.abs(grd[v] - ref[k]).max())
               for v, k in ((0, "lgrdx"), (1, "rgrdx"))) <= 5e-7
    for side, img, cv in zip("lr", (s.left_f32, s.right_f32),
                             eng.cost_const(s.left_f32, s.right_f32)):
        cvf = eng.cost_filter(img, cv)
        for d in (1, 8, 32, 63):
            assert float(np.abs(cv[d].cpu().numpy() - ref[f"cvc_{side}_d{d}"]).max()) <= 1e-6
            assert float(np.abs(cvf[d].cpu().numpy() - ref[f"cvf_{side}_d{d}"]).max()) <= 1e-3
        wta = eng.disp_select(cvf).cpu().numpy()
        assert float((wta != ref[f"{side}disp_wta"]).mean()) <= 5e-4


# ---- rectification and depth: the card bitwise the CPU ----------------------

def _calibration():
    from primestereomatch_torch.calib import load_stereo_calibration
    from primestereomatch_torch.utils.datasets import data_root

    root = data_root()
    return load_stereo_calibration(str(root / "intrinsics.yml"), str(root / "extrinsics.yml"))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_remap_on_card_matches_cpu(dev, dtype):
    """Random maps over and beyond a 50x70 image (out-of-image taps, integer
    and half-pixel coordinates), (H, W, 3) and (H, W) images."""
    from primestereomatch_torch.ops import remap_bilinear

    rng = np.random.default_rng(11)
    img = (rng.integers(0, 256, (50, 70, 3)) if dtype == np.uint8
           else rng.random((50, 70, 3))).astype(dtype)
    xy = rng.uniform(-3, 73, (40, 90, 2)).astype(np.float32)
    xy[:5] = np.round(xy[:5] * 2) / 2
    m = torch.from_numpy(xy)
    for im in (img, img[..., 1]):
        t = torch.from_numpy(np.ascontiguousarray(im))
        got = remap_bilinear(t.to(dev), m.to(dev))
        assert got.dtype == t.dtype and torch.equal(got.cpu(), remap_bilinear(t, m))


@pytest.mark.parametrize("size,calib_size,crop,levels", [
    ((1280, 720), None, (526, 1016), (40, 20)), ((672, 376), (1280, 720), (274, 530), (24, 12)),
], ids=["hd720", "zed_vga"])
def test_rectifier_and_depth_on_card_match_cpu(dev, size, calib_size, crop, levels):
    """The Rectifier on the card (maps uploaded once, uint8 numpy frames in)
    equals the CPU one bit for bit at HD720 and ZED-VGA, with the crops of
    the shipped calibration; disparity_to_depth and reproject_disparity on
    the card equal the CPU's on the same disparities (zero, negative and
    beyond max_depth included). Then raw frames of the known scene
    (tests/port_helpers.py) rectified on the card and matched by each GIF
    tail the crop's width takes (HD720's exact stride: K4 -> K2 -> K3 and
    K10 -> K3; ZED-VGA's quasi width: K1 -> K2 -> K3) and by SGBM (K6-K9),
    exactly those kernels launched: each region of the field within 1 of
    its level and its depth within 2% of f * B / d."""
    from primestereomatch_torch import SGBMConfig, stereo_sgbm_forward
    from primestereomatch_torch.app import U8_TO_F32
    from primestereomatch_torch.calib import Rectifier
    from primestereomatch_torch.ops import disparity_to_depth, reproject_disparity
    from primestereomatch_torch.ops.geometry import fused_cvc_applies

    calib = _calibration()
    card = Rectifier(calib, size, calib_size=calib_size)
    cpu = Rectifier(calib, size, calib_size=calib_size, device="cpu")
    assert card.map_l.device.type == "cuda" and card.crop == cpu.crop
    assert torch.equal(card.map_l.cpu(), cpu.map_l) and torch.equal(card.map_r.cpu(), cpu.map_r)
    rng = np.random.default_rng(12)
    w, h = size
    raw = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(2)]
    for img in (raw, [(a.astype(np.float32) * np.float32(1 / 255.0)) for a in raw]):
        got, want = card(*img), cpu(*img)
        for g, c in zip(got, want):
            assert g.device.type == "cuda" and tuple(g.shape) == (*crop, 3)
            assert torch.equal(g.cpu(), c)
    disp = torch.as_tensor(rng.uniform(-4, 80, crop).astype(np.float32))
    disp[:3] = 0
    Q = card.rect.Q
    assert torch.equal(disparity_to_depth(disp.to(dev), Q).cpu(), disparity_to_depth(disp, Q))
    for kw in ({}, {"max_depth": 100.0, "invalid_value": -1.0}):
        assert torch.equal(reproject_disparity(disp.to(dev), Q, **kw).cpu(),
                           reproject_disparity(disp, Q, **kw))

    scene_l, scene_r, rect = port_helpers.calibrated_scene(card.crop, size, levels, 5)
    l8, r8 = card(*port_helpers.raw_frames(calib, card.rect, size, calib_size, (scene_l, scene_r)))
    regions = port_helpers.field_regions(rect, levels, 64)
    if fused_cvc_applies(crop[1], 64, 4):
        tails = [({}, {"cvc_lowmaps", "wta", "wmf"}), ({"tail_fusion": "full"}, {"cvc_wta", "wmf"})]
    else:
        tails = [({}, {"lowmaps", "wta", "wmf"})]
    runs = [(lambda kw=kw: stereo_gif_forward(l8.to(torch.float32) * U8_TO_F32,
                                              r8.to(torch.float32) * U8_TO_F32,
                                              GIFConfig(**kw))[0], kernels)
            for kw, kernels in tails]
    runs.append((lambda: stereo_sgbm_forward(l8, r8, SGBMConfig()).to(torch.float32) / 16,
                 {"bt_cost", "sgbm_scan", "select", "speckle"}))
    for run, kernels in runs:
        K.reset_launches()
        d = run()
        assert {n for n, c in K.LAUNCHES.items() if c} == kernels
        dn = d.cpu().numpy().astype(np.float64)
        dn[dn <= 0] = np.nan
        port_helpers.check_field(str(kernels), dn, disparity_to_depth(d, Q).cpu().numpy(), regions,
                                Q)


def _launched():
    return {n for n, c in K.LAUNCHES.items() if c}


def test_app_image_mode_on_card(dev):
    """The app's image mode on the card: Teddy and Cones, GIF %BP(nonocc)
    within 0.3 of the reference binary's (K1, K2, K3) and SGBM the
    canonical display of the output chip_smoke.SGBM_SHA256 pins; the 'm'
    key moving the GIF engine to the CPU (no launch, the same %BP band) and
    back; one --timed frame (DispEst's stages: K3 alone)."""
    import hashlib

    import chip_smoke
    from primestereomatch_torch import SGBMConfig, sgbm_display_u8, stereo_sgbm_forward
    from primestereomatch_torch.app import AppConfig, StereoMatchApp
    from primestereomatch_torch.hci import KeyLoop

    gif = {"lowmaps", "wta", "wmf"}
    for name, golden in chip_smoke.GOLDEN_NONOCC.items():
        ga = StereoMatchApp(AppConfig(alg="STEREO_GIF", media_mode="image", dataset=name))
        K.reset_launches()
        assert abs(ga.compute().metrics.percent_bad_pixels - golden) <= 0.3
        assert _launched() == gif
        sa = StereoMatchApp(AppConfig(alg="STEREO_SGBM", media_mode="image", dataset=name))
        got = sa.compute().l_disp
        d16 = stereo_sgbm_forward(ga._sample.left_bgr, ga._sample.right_bgr, SGBMConfig())
        assert hashlib.sha256(d16.cpu().numpy().tobytes()).hexdigest() == \
            chip_smoke.SGBM_SHA256[name]
        np.testing.assert_array_equal(got, sgbm_display_u8(d16, 1, 64).cpu().numpy())
    golden = chip_smoke.GOLDEN_NONOCC["Teddy"]
    ka = StereoMatchApp(AppConfig(alg="STEREO_GIF", media_mode="image", dataset="Teddy"))
    feed = ["m"]
    keys = KeyLoop(ka, reader=lambda: feed.pop(0) if feed else "", echo=lambda _: None)
    for where, kernels in (("cpu", set()), ("cuda", gif)):
        keys.pump()
        assert ka.gif_device.type == where
        K.reset_launches()
        assert abs(ka.compute().metrics.percent_bad_pixels - golden) <= 0.3
        assert _launched() == kernels
        feed.append("m")
    ta = StereoMatchApp(AppConfig(alg="STEREO_GIF", media_mode="image", dataset="Teddy",
                                  timed=True))
    K.reset_launches()
    assert {"CVC", "CVF", "DispSel", "PP"} <= set(ta.compute().times_ms)
    assert _launched() == {"wmf"}


def test_cli_on_card(dev, monkeypatch, tmp_path, capsys):
    """The CLI on the card: a --pipeline video run (one report line a
    frame; K4, K2, K3 at 672 = 4 * 168) and an --out mosaic of Teddy read
    back."""
    from primestereomatch_torch import cli, hci
    from primestereomatch_torch.utils import load_dataset
    from primestereomatch_torch.utils.png import read_png

    monkeypatch.setattr(hci, "_stdin_reader", lambda: "")
    K.reset_launches()
    assert cli.main(["-a", "STEREO_GIF", "--max-dis", "16", "--med-sz", "7", "--mask", "none",
                     "--frames", "4", "--pipeline", "video", "--source", "synthetic"]) == 0
    assert _launched() == {"cvc_lowmaps", "wta", "wmf"}
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("frame ")]
    assert len(lines) == 4
    assert cli.main(["-a", "STEREO_GIF", "--out", str(tmp_path), "image",
                     "--dataset", "Teddy"]) == 0
    mosaic = read_png(str(tmp_path / "frame_0000.png"), 3)
    assert mosaic.shape == (750, 1350, 3)
    np.testing.assert_array_equal(mosaic[:375, :450], load_dataset("Teddy").left_bgr)


@pytest.mark.parametrize("case", ["raw", "calibrated", "sgbm"])
def test_app_stream_equals_compute_on_card(dev, case):
    """StereoMatchApp on the card (AppConfig's default device): every frame
    of stream() equals compute()'s and the direct pipeline's (the source's
    frames, the Rectifier's crops where calibrated, through
    stereo_gif_forward) bit for bit, exactly K4, K2 and K3 launched, and a
    yielded frame does not change while later frames reuse the pinned
    ring's slots. The calibrated stream rectifies 384x216 frames with the
    shipped calibration (calib_size 1280x720) and returns the crops with
    the disparities. 'sgbm': the calibrated SGBM video (the stream falls
    back to compute()): each frame the canonical display of
    stereo_sgbm_forward on the crops (K6-K9)."""
    from primestereomatch_torch import sgbm_display_u8, stereo_sgbm_forward
    from primestereomatch_torch.app import RING, U8_TO_F32, AppConfig, StereoMatchApp
    from primestereomatch_torch.calib import Rectifier
    from primestereomatch_torch.utils.video import SyntheticZEDSource

    calib_dir = None if case == "raw" else str(ROOT / "data")
    alg = "STEREO_SGBM" if case == "sgbm" else "STEREO_GIF"
    n = 3 * RING + 1

    def source():
        return SyntheticZEDSource(width=384, height=216, n_frames=n, max_disparity=16,
                                  smoothing=0)

    def make():
        a = StereoMatchApp(AppConfig(alg=alg, media_mode="video", max_dis=16, med_sz=7,
                                     mask_mode="none", calib_dir=calib_dir))
        a._source = source()
        return a

    streamed, snaps = [], []
    for res in make().stream(n):
        streamed.append(res)
        snaps.append([x.copy() for x in (res.l_disp, res.r_disp, res.left_bgr, res.right_bgr)])
    assert len(streamed) == n
    ref = make()
    assert ref.device.type == "cuda"
    rec = Rectifier(_calibration(), (384, 216), calib_size=(1280, 720)) if calib_dir else None
    K.reset_launches()
    for res, snap, (l_raw, r_raw) in zip(streamed, snaps, source(), strict=True):
        want = ref.compute()
        got = (res.l_disp, res.r_disp, res.left_bgr, res.right_bgr)
        for g, s, w in zip(got, snap, (want.l_disp, want.r_disp, want.left_bgr,
                                       want.right_bgr)):
            np.testing.assert_array_equal(g, s)
            np.testing.assert_array_equal(g, w)
        l8, r8 = (torch.as_tensor(x, device=dev) for x in (l_raw, r_raw))
        if rec is not None:
            l8, r8 = rec(l8, r8)
        if alg == "STEREO_GIF":
            direct = stereo_gif_forward(l8.to(torch.float32) * U8_TO_F32,
                                        r8.to(torch.float32) * U8_TO_F32, ref.gif_cfg)
        else:
            direct = (sgbm_display_u8(stereo_sgbm_forward(l8, r8, ref.sgbm_cfg), 1,
                                      ref.cfg.max_dis),)
        for g, w in zip(got, direct):
            np.testing.assert_array_equal(g, w.cpu().numpy())
        np.testing.assert_array_equal(res.left_bgr, l8.cpu().numpy())
        np.testing.assert_array_equal(res.right_bgr, r8.cpu().numpy())
    assert {k for k, v in K.LAUNCHES.items() if v} == (
        {"cvc_lowmaps", "wta", "wmf"} if alg == "STEREO_GIF"
        else {"bt_cost", "sgbm_scan", "select", "speckle"})
    if calib_dir:
        assert streamed[0].left_bgr.shape == (156, 304, 3)


def _valid_plane(kind: str, shape, r: int, rng) -> np.ndarray:
    """A participation plane: 'zero_halos' (0 on r rows at both ends: the
    global edges of a row tile), 'fractional' (uniform in [0, 1)) or
    'zero_windows' (64 x 64 blocks of zeros, whole windows with no weight,
    on a fractional plane). 'sparse_fractional' and 'sparse_zero_only'
    (the test gives them sparse levels): the fractional plane, and the
    zero-halo plane. On the zero-halo plane: 'mixed' (128 x 128
    squares of fractions on a checkerboard: unit blocks beside fractional
    ones), 'near_one' (0.99999994, 1.0000001 and -0 scattered, a pixel in
    20000 each, at least 2: their blocks leave the unit path but for -0), 'subnormal'
    (1e-30 on the checkerboard's squares: products below FLT_MIN, flushed)
    and 'far_colours' (the plane alone; the test pairs it with a guide of
    far colours)."""
    v = np.ones(shape, np.float32)
    if kind in ("fractional", "zero_windows", "sparse_fractional"):
        v = rng.random(shape, dtype=np.float32)
        if kind == "zero_windows":
            v[:, 100:164, 200:264] = 0.0
            v[:, -64:, :64] = 0.0
        return v
    v[:, :r] = 0.0
    v[:, -r:] = 0.0
    yy, xx = np.meshgrid(np.arange(shape[1]) // 128, np.arange(shape[2]) // 128, indexing="ij")
    square = np.broadcast_to((yy + xx) % 2 == 1, shape)
    if kind == "mixed":
        v = np.where(square, rng.random(shape, dtype=np.float32), v)
    elif kind == "subnormal":
        v = np.where(square, np.float32(1e-30), v)
    elif kind == "near_one":
        n = max(2, v.size // 20000)
        for value in (0.99999994, 1.0000001, -0.0):
            v[tuple(rng.integers(0, m, n) for m in shape)] = np.float32(value)
    return v


# the extended JointWMF tiles of the tiled meshes at 2K (chip_smoke.WMF_TILES;
# 2 frames a rank, r = 9): y = 2, y = 4, y = 1 (d only), and b = 2
WMF_TILES = [(4, 624 + 18, 2208), (4, 312 + 18, 2208), (4, 1248 + 18, 2208),
             (2, 624 + 18, 2208)]
# (shape, plane): the tiles on the planes the mesh makes and their worst
# cases; the unit path's edges at the y = 2 tile and at a small odd shape;
# sparse levels (rank windows) on both paths
VALID_CASES = ([(s, k) for s in WMF_TILES for k in ("zero_halos", "fractional", "zero_windows")]
               + [(s, k) for s in (WMF_TILES[0], (2, 75, 130))
                  for k in ("mixed", "near_one", "subnormal", "far_colours")]
               + [((2, 75, 130), k) for k in ("zero_halos", "fractional")]
               + [(s, k) for s in (WMF_TILES[0], (2, 75, 130))
                  for k in ("sparse_fractional", "sparse_zero_only")])


@pytest.mark.parametrize("shape,kind", VALID_CASES,
                         ids=["x".join(map(str, s)) + f"-{k}" for s, k in VALID_CASES])
def test_weighted_median_valid_mode_is_bitwise_plain(dev, shape, kind):
    """K3's participation-weight mode: 0 pixels apart from its plain
    version (the plain JointWMF with `valid`, view by view) at the sharded
    tiles' shapes; 0 where a whole window has no weight. Blocks whose plane
    is all 0 or 1 take the unit path, the others the multiply: the mixed
    planes hold both. 'far_colours': a unit plane over a guide whose binned
    pixels are 6-bit colour 50 apart from the rest (squared distance 7500:
    subnormal weights, flushed), so pixels without a bin of their own get
    total 0 and output 0. 'sparse_*': sparse levels (`_sparse_levels`), on
    the multiply path, and on the unit path with one more level that only
    pixels of weight 0 hold: blocks rank without it."""
    rng = np.random.default_rng(shape[1] + len(kind))
    r, n_bins = 9, 256
    if kind.startswith("sparse"):
        disp = _sparse_levels(shape, n_bins, (65, 129), rng)
        if kind == "sparse_zero_only":
            unused = np.setdiff1d(np.arange(n_bins), disp)[0]
            disp[:, :r] = unused                  # the zero-halo plane's 0 rows
            disp[:, -r:] = unused
    else:
        disp = rng.integers(0, n_bins, shape, dtype=np.uint8)
    disp = torch.as_tensor(disp, device=dev)
    guide = _wmf_guide(dev, shape, n_bins)
    if kind == "far_colours":
        n_bins = 128
        binned = torch.as_tensor(rng.random(shape) < 0.1, device=dev)
        disp = torch.where(binned, disp % n_bins, 200).to(torch.uint8)
        guide = (binned[..., None] * 200).expand(*shape, 3).to(torch.uint8).contiguous()
    valid = torch.as_tensor(_valid_plane(kind, shape, r, rng), device=dev)
    unit = float(K.wmf.unit_plane_blocks(valid, r).float().mean())
    if kind in ("mixed", "near_one", "subnormal"):
        assert 0.0 < unit < 1.0
    K.reset_launches()
    got = K.weighted_median(disp, guide, r, n_bins, 25.5, valid=valid)
    assert K.LAUNCHES["wmf_valid"] == 1 and K.LAUNCHES["wmf"] == 0
    assert torch.equal(got, K.weighted_median_plain(disp, guide, r, n_bins, 25.5, valid))
    if kind == "zero_windows":
        assert int(got[:, 100 + r:164 - r, 200 + r:264 - r].max()) == 0
    if kind == "far_colours":
        assert unit == 1.0 and bool((got[~binned & (valid > 0)] == 0).any())
    if kind.startswith("sparse"):
        ranked = K.wmf.bin_window_passes(disp, r, n_bins, valid)
        assert bool((ranked < K.wmf.range_window_passes(disp, r, n_bins, valid)).any())
        assert unit == (1.0 if kind == "sparse_zero_only" else 0.0)


def test_weighted_median_valid_ones_equals_the_valid_less_kernel(dev):
    shape = (2, 75, 130)
    rng = np.random.default_rng(3)
    disp = torch.as_tensor(rng.integers(0, 64, shape, dtype=np.uint8), device=dev)
    guide = _wmf_guide(dev, shape, 64)
    ones = torch.ones(shape, dtype=torch.float32, device=dev)
    assert torch.equal(K.weighted_median(disp, guide, 9, 64, 25.5, valid=ones),
                       K.weighted_median(disp, guide, 9, 64, 25.5))


def _sharded_pair(B, H, W, seed=0):
    rng = np.random.default_rng(seed)
    left = rng.random((B, H, W, 3), dtype=np.float32)
    right = np.roll(left, -3, axis=2) * 0.9 + 0.1 * rng.random((B, H, W, 3), dtype=np.float32)
    return left, right.astype(np.float32)


@pytest.mark.parametrize("size", ["small", "2k"])
def test_world_one_nccl_sharded_steps_are_the_direct_pipeline(dev, size):
    """The one-card deployment: a world of 1 rank under NCCL, mesh
    (1, 1, 1); the sharded GIF step (K4, K2, K3) and SGBM step (K6-K9, K6
    and K8 once a frame) on 2 frames bitwise the direct pipelines. At 2K
    (chip_smoke.synthetic_2k of seeds 0 and 1, rows reflected from 1242 to
    1248, D = 256) the SGBM frames also recover the seeded field."""
    import socket

    import torch.distributed as dist

    from primestereomatch_torch import SGBMConfig, stereo_sgbm_forward
    from primestereomatch_torch.parallel import (MeshPlan, make_mesh, make_sharded_gif,
                                                 make_sharded_sgbm)
    from primestereomatch_torch.parallel.launch import initialize

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    import chip_smoke

    if size == "2k":
        pairs = [chip_smoke.synthetic_2k(seed) for seed in (0, 1)]
        pad = ((0, 1248 - chip_smoke.H2K), (0, 0), (0, 0))
        l, r = (np.stack([np.pad(p[v], pad, mode="reflect") for p in pairs]) for v in (0, 1))
        cfg, scfg = GIFConfig(max_dis=256), SGBMConfig(num_disparities=256)
    else:
        l, r = _sharded_pair(2, 96, 160)
        cfg, scfg = GIFConfig(max_dis=32, med_sz=9), SGBMConfig(num_disparities=32)
    assert initialize(f"localhost:{port}", 1, 0) == "nccl"
    try:
        mesh = make_mesh(MeshPlan(1, 1, 1))
        K.reset_launches()
        lo, ro, (bsl, rows) = make_sharded_gif(mesh, cfg)(l, r)
        assert {k for k, v in K.LAUNCHES.items() if v} == {"cvc_lowmaps", "wta", "wmf"}
        assert (bsl, rows) == (slice(0, 2), slice(0, l.shape[1]))
        for i in range(2):
            want = stereo_gif_forward(l[i], r[i], cfg)
            assert torch.equal(lo[i], want[0]) and torch.equal(ro[i], want[1])
        lu = np.clip(np.rint(l * 255), 0, 255).astype(np.uint8)
        ru = np.clip(np.rint(r * 255), 0, 255).astype(np.uint8)
        K.reset_launches()
        out, _ = make_sharded_sgbm(mesh, scfg)(lu, ru)
        assert {k for k, v in K.LAUNCHES.items() if v} == {"bt_cost", "sgbm_scan", "select",
                                                          "speckle"}
        assert K.LAUNCHES["bt_cost"] == K.LAUNCHES["select"] == 2
        for i in range(2):
            assert torch.equal(out[i], stereo_sgbm_forward(lu[i], ru[i], scfg))
            if size == "2k":
                d16 = out[i].cpu().numpy()[:chip_smoke.H2K]
                chip_smoke.check_medians_2k(np.where(d16 >= 0, d16 / 16.0, np.nan), None,
                                            pairs[0][2])
    finally:
        dist.destroy_process_group()


TWO_K = dict(height=1248, width=2208, max_dis=256)
MESHES = ["1,2,2", "2,2,1", "1,4,1", "1,1,4", "4,1,1"]
# (mesh, launcher options, JointWMF): every mesh at the launcher's 96x64
# frames, D = 16 (rows 128 for y = 4: a tile's rows must hold the 24-row
# halo; the batch-only mesh on 4 frames), then at 2208x1248, D = 256, and
# the tiled meshes at 2K without JointWMF
SPAWN_CASES = ([(m, {"1,4,1": {"height": 128}, "4,1,1": {"batch": 4}}.get(m, {}), True)
                for m in MESHES]
               + [(m, {**TWO_K, "batch": 4 if m == "4,1,1" else 2}, True) for m in MESHES]
               + [(m, {**TWO_K, "batch": 2}, False) for m in MESHES if m != "4,1,1"])


@pytest.mark.parametrize("mesh_shape,kw,postprocess", SPAWN_CASES,
                         ids=[m + ("-2k" if kw.get("width") else "") + ("" if pp else "-no_pp")
                              for m, kw, pp in SPAWN_CASES])
def test_spawn_local_on_the_card(dev, tmp_path, mesh_shape, kw, postprocess):
    """Four ranks of the launcher's worker (the processes spawn_local
    starts) sharing the card under gloo (host-staged collectives), each
    in a spawned process (port_helpers.counted_launcher_rank): every block
    bitwise the single-device pipeline on the card, and the sharded steps'
    launches summed over the ranks exactly K1 and K3's valid mode on a
    tiled mesh (K1 alone without JointWMF), K4, K2 and K3 on the
    batch-only mesh."""
    import json
    import multiprocessing
    import socket
    import time

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    argv = ["--mesh-shape", mesh_shape, "--check"]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    outs = [tmp_path / f"rank{r}.json" for r in range(4)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=port_helpers.counted_launcher_rank,
                         args=(r, port, argv, postprocess, str(out)))
             for r, out in enumerate(outs)]
    for pr in procs:
        pr.start()
    deadline = time.monotonic() + 300
    while any(pr.is_alive() for pr in procs):
        if any(pr.exitcode for pr in procs) or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    for pr in procs:
        if pr.is_alive():
            pr.kill()
        pr.join()
    assert [pr.exitcode for pr in procs] == [0] * 4
    ranks = [json.loads(out.read_text()) for out in outs]
    assert [r["rc"] for r in ranks] == [0] * 4
    launches: dict = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    b, y, d = (int(t) for t in mesh_shape.split(","))
    if y > 1 or d > 1:
        want = {"lowmaps", "wmf_valid"} if postprocess else {"lowmaps"}
    else:
        want = {"cvc_lowmaps", "wta", "wmf"}
    assert set(launches) == want, launches
