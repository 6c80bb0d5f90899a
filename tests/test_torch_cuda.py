"""The CUDA kernels against their plain versions on the card. These tests
import nothing of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA card they skip. chip_smoke.py checks the same at the main
path's full shapes."""

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

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("radius,n_bins", WMF_CASES)
@pytest.mark.parametrize("kind", ["random", "two_level", "beyond_bins"])
@pytest.mark.parametrize("shape", [(2, 40, 70), (1, 5, 20), (1, 37, 101)],
                         ids=["tiles", "below_a_tile", "ragged"])
def test_weighted_median_kernel_is_bitwise_plain(dev, radius, n_bins, kind, shape):
    """K3 sums every bin in the plain version's order: 0 pixels differ, on
    full-range random disparities (every bin window, both sweeps), on a
    two-level map (a flipped tie would move the median from 3 to 200), with
    disparities >= n_bins (skipped by both), on an image smaller than one
    32x8 tile and on one whose sides are no multiple of it."""
    rng = np.random.default_rng(radius * 1000 + n_bins + shape[1])
    if kind == "random":
        disp = rng.integers(0, n_bins, shape, dtype=np.uint8)
    elif kind == "two_level":
        disp = np.where(rng.random(shape) < 0.5, 3, min(200, n_bins - 1)).astype(np.uint8)
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
    assert K.LAUNCHES["sgbm_scan"] == {3: 2, 5: 4, 8: 4}[nd]
    assert torch.equal(got, K.sgbm_aggregate_plain(cost, 600, 2400, nd))


@pytest.mark.parametrize("nd", [3, 5, 8])
@pytest.mark.parametrize("D", [16, 64, 100, 256, 7])
@pytest.mark.parametrize("dtype,p2", [(torch.int16, 2400), (torch.int16, 60000),
                                      (torch.int32, 2400)],
                         ids=["partials", "p2_beyond_the_bound", "int32_cost"])
def test_sgbm_scan_partials_kernel_matches_plain(dev, nd, D, dtype, p2):
    """K7's partials sum to the plain S bitwise: uint16 groups where
    g * (cost_bound + p2) < 2**16 (2 launches, 1 for 3 directions), the
    int32 S beyond it and for an int32 cost (a launch per family). D = 100
    copies 8 bytes at a time, D = 7 takes the plain-load ring."""
    rng = np.random.default_rng(D + nd)
    H, W = (23, 37) if D > 64 else (31, 45)
    cost = torch.as_tensor(rng.integers(0, 9451, (H, W, D)), dtype=dtype, device=dev)
    narrow = K.partial_groups(nd, 9450, p2, dtype) is not None
    assert narrow == (dtype == torch.int16 and p2 == 2400)
    K.reset_launches()
    parts = K.sgbm_aggregate_partials(cost, 600, p2, nd, 9450)
    if narrow:
        assert len(parts) == 2 and all(q.dtype == torch.uint16 for q in parts)
        assert K.LAUNCHES["sgbm_scan"] == {3: 1, 5: 2, 8: 2}[nd]
    else:
        assert len(parts) == 1 and parts[0].dtype == torch.int32
        assert K.LAUNCHES["sgbm_scan"] == {3: 2, 5: 4, 8: 4}[nd]
    want = K.sgbm_aggregate_plain(cost, 600, p2, nd)
    assert torch.equal(sum(q.int() for q in parts), want)
    plain = K.sgbm_aggregate_partials_plain(cost, 600, p2, nd, 9450)
    assert len(plain) == len(parts)
    assert all(torch.equal(a, b) for a, b in zip(parts, plain))


def test_sgbm_scan_partials_at_the_edge_of_uint16(dev):
    """Costs at their bound and the largest P2 the rule allows: every L
    reaches cost_bound + p2 somewhere and the groups of four still fit."""
    bound = 9450
    p2 = (2**16 - 1) // 4 - bound
    assert K.partial_groups(8, bound, p2) is not None
    assert K.partial_groups(8, bound, p2 + 1) is None
    rng = np.random.default_rng(3)
    cost = torch.as_tensor(rng.choice([0, bound], (40, 50, 32)), dtype=torch.int16, device=dev)
    parts = K.sgbm_aggregate_partials(cost, 600, p2, 8, bound)
    assert len(parts) == 2
    assert torch.equal(sum(q.int() for q in parts), K.sgbm_aggregate_plain(cost, 600, p2, 8))


@pytest.mark.parametrize("min_d", [-20, -3, 0, 7])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("D", [16, 70])
def test_select_kernel_from_partials_matches_plain(dev, min_d, n_parts, D):
    """K8 adds one or two uint16 partials as it reads: bitwise the plain
    selection on their int32 sum, and the int32 kernel on it."""
    rng = np.random.default_rng(abs(min_d) + n_parts + D)
    parts = tuple(torch.as_tensor(rng.integers(0, 47400, (21, 96, D)).astype(np.uint16),
                                  device=dev) for _ in range(n_parts))
    S = sum(q.int() for q in parts)
    K.reset_launches()
    got = K.select_disparity_partials(parts, 10, 1, min_d)
    assert K.LAUNCHES["select"] == 1
    assert torch.equal(got, K.select_disparity_plain(S, 10, 1, min_d))
    assert torch.equal(got, K.select_disparity(S, 10, 1, min_d))
    assert torch.equal(K.select_disparity_partials((S,), 10, 1, min_d), got)


@pytest.mark.parametrize("min_d", [-20, -3, 0, 3, 7])
@pytest.mark.parametrize("uniq,d12", [(10, 1), (0, 0), (10, -1)])
def test_select_kernel_matches_plain(dev, min_d, uniq, d12):
    rng = np.random.default_rng(abs(min_d) + uniq + d12)
    S = torch.as_tensor(rng.integers(0, 5000, (21, 96, 16), dtype=np.int32), device=dev)
    got = K.select_disparity(S, uniq, d12, min_d)
    assert torch.equal(got, K.select_disparity_plain(S, uniq, d12, min_d))


def test_select_kernel_degenerate(dev):
    D = 8
    d_idx = torch.arange(D, device=dev, dtype=torch.int32)
    for S in ((d_idx - 3).abs() * 1000 + 10, torch.full((D,), 100, dtype=torch.int32,
                                                       device=dev)):
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
    # the partials route: a path family of each group per launch
    assert K.LAUNCHES["sgbm_scan"] == {"hh": 2, "sgbm": 2, "3way": 1}[mode]
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


@pytest.mark.parametrize("fusion", ["maps", "full"])
def test_u8_forward_launches_k1_at_exact_stride(dev, fusion):
    """At 160 = 4 * 40 the float cost takes K4 (or K10), the uint8 cost K1
    -> K2 -> K3; the card agrees with the CPU within the tie class."""
    left, right = _pair(64, 160, 6, 2)
    cfg = GIFConfig(max_dis=16, med_sz=7, cvc_dtype="u8", tail_fusion=fusion)
    K.reset_launches()
    got = stereo_gif_forward(left, right, cfg)
    assert {n for n, c in K.LAUNCHES.items() if c} == {"lowmaps", "wta", "wmf"}
    want = stereo_gif_forward(left, right, cfg, device="cpu")
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and (a.cpu() != b).float().mean() <= 2e-3


def test_u8_costs_on_card_are_bitwise_cpu(dev):
    from primestereomatch_torch.models.gif_pipeline import sampled_u8_costs
    from primestereomatch_torch.ops.cost_volume import unit_cost

    left, right = _pair(72, 150, 3, 4)
    views = torch.as_tensor(np.stack([left, right]))
    cfg = GIFConfig(max_dis=24)
    got = sampled_u8_costs(views.to(dev), cfg)
    want = sampled_u8_costs(views, cfg)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(unit_cost(got).cpu(), unit_cost(want))


@pytest.mark.parametrize("variant", [dict(pp_toolchain=True), dict(wmf_mode="table")],
                         ids=["toolchain", "table"])
def test_variant_forward_on_card_matches_cpu(dev, variant):
    from primestereomatch_torch.utils import feature_index_color

    left, right = _pair(64, 154, 5, 3)
    cfg = GIFConfig(max_dis=16, med_sz=7, **variant)
    extra = ()
    if cfg.wmf_mode == "table":
        to_u8 = lambda x: np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)  # noqa: E731
        lf, wm = feature_index_color(to_u8(left), n_feat=64, seed=0)
        rf, _ = feature_index_color(to_u8(right), n_feat=64, seed=0)
        extra = (lf, rf, wm)
    K.reset_launches()
    got = stereo_gif_forward(left, right, cfg, True, *extra)
    # table mode's median is plain torch; the toolchain ends in K3
    assert K.LAUNCHES["wmf"] == (0 if extra else 1) and K.LAUNCHES["lowmaps"] == 1
    want = stereo_gif_forward(left, right, cfg, True, *extra, device="cpu")
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and (a.cpu() != b).float().mean() <= 2e-3


def test_joint_wmf_float_goes_through_k3(dev):
    """Exact mode with at most 256 levels launches K3 once, bitwise its
    plain version (the same call with a mask of ones takes the plain op)."""
    from primestereomatch_torch.ops.jointwmf import joint_wmf_float

    rng = np.random.default_rng(6)
    disp = torch.as_tensor((rng.random((40, 70)) * 30.0).astype(np.float32), device=dev)
    guide = torch.as_tensor(rng.integers(0, 256, (40, 70, 3), dtype=np.uint8), device=dev)
    K.reset_launches()
    got = joint_wmf_float(disp, guide, radius=5, n_levels=64)
    assert K.LAUNCHES["wmf"] == 1 and got.device.type == "cuda"
    plain = joint_wmf_float(disp, guide, radius=5, n_levels=64,
                            valid=torch.ones(40, 70, device=dev))
    assert K.LAUNCHES["wmf"] == 1
    assert torch.equal(got, plain)


def test_dispest_stages_on_card_match_cpu(dev, tmp_path):
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
