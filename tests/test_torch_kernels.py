"""The plain versions of the port's three kernels held against the JAX
package's ops and its Pallas kernels (interpret mode on the CPU), and the
kernel wrappers' CPU behaviour. The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerances are the JAX package's own
(tests/test_kernels.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from primestereomatch_tpu.kernels.lowmaps_pallas import (
    fgf_low_maps_pallas,
    fgf_low_maps_pallas_batched,
)
from primestereomatch_tpu.kernels.wmf_pallas import joint_wmf_pallas
from primestereomatch_tpu.kernels.wta_pallas import (
    fgf_wta_pallas_maps_batched,
    poly_col_params,
)
from primestereomatch_tpu.ops import guided_filter as jgf
from primestereomatch_tpu.ops.jointwmf import joint_wmf as jax_joint_wmf
from primestereomatch_torch import kernels as K
from primestereomatch_torch.ops import guided_filter as gf
from primestereomatch_torch.ops.jointwmf import joint_wmf


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("H,W,D,s", [(128, 256, 16, 4), (96, 192, 8, 2)])
def test_low_maps_plain_matches_jax(H, W, D, s):
    """K1's plain version vs the JAX op and the Pallas kernel cropped to
    (h, w), at the JAX package's bound atol 2e-4, rtol 1e-3."""
    rng = np.random.default_rng(H + s)
    h, w = H // s, W // s
    g = rng.random((H, W, 3)).astype(np.float32)
    p = rng.random((D, h, w)).astype(np.float32)
    ma, mb = gf.fgf_low_maps(_t(g), _t(p), 8, 1e-4, s)
    got = torch.stack([*ma, mb]).numpy()
    jma, jmb = jgf.fgf_low_maps(jnp.asarray(g), jnp.asarray(p), 8, 1e-4, s)
    want = np.stack([np.asarray(t) for t in (*jma, jmb)])
    assert np.allclose(got, want, atol=2e-4, rtol=1e-3)
    pallas = np.asarray(fgf_low_maps_pallas(jnp.asarray(g), jnp.asarray(p), 8, 1e-4, s,
                                            interpret=True))
    assert np.allclose(got, pallas[:, :, :h, :w], atol=2e-4, rtol=1e-3)
    # the wrapper's layout: (B, 4, D, h, w) from the batched entry point
    maps = K.fgf_low_maps_batched(_t(g)[None], _t(p)[None], 8, 1e-4, s)
    np.testing.assert_array_equal(maps[0].numpy(), got)


@pytest.mark.parametrize("H,W,D,s", [(48, 200, 16, 4), (96, 192, 8, 2), (40, 450, 16, 4)])
def test_upsample_wta_plain_equals_jax_lerp(H, W, D, s):
    """K2's plain version equals the JAX lerp path fed the same maps."""
    rng = np.random.default_rng(W + D)
    h, w = H // s, W // s
    g = rng.random((H, W, 3)).astype(np.float32)
    p = rng.random((D, h, w)).astype(np.float32)
    jma, jmb = jgf.fgf_low_maps(jnp.asarray(g), jnp.asarray(p), 8, 1e-4, s)
    want = np.asarray(jgf.fgf_wta_low_maps(jnp.asarray(g), jma, jmb, (H, W), d_chunk=D,
                                           upsample_impl="lerp"))
    ma, mb = tuple(_t(m) for m in jma), _t(jmb)
    np.testing.assert_array_equal(gf.fgf_wta_low_maps(_t(g), ma, mb, (H, W)).numpy(), want)
    # chunked over d: the strict-< fold keeps the first minimum
    np.testing.assert_array_equal(
        gf.fgf_wta_low_maps(_t(g), ma, mb, (H, W), d_chunk=3).numpy(), want)


def test_upsample_wta_plain_vs_pallas_poly_quasi():
    """K2's plain version vs the TPU poly kernel at Teddy's quasi column
    ratio (112 -> 450), both fed the same maps: the kernel combines before
    its column lerp, so only argmin ties may differ (<= 2e-3)."""
    H, W, D, s = 64, 450, 16, 4
    h, w = H // s, W // s
    pp = poly_col_params(w, W)
    assert pp is not None and not pp["exact"]
    rng = np.random.default_rng(7)
    g2 = rng.random((2, H, W, 3)).astype(np.float32)
    p2 = rng.random((2, D, h, w)).astype(np.float32)
    maps_j = fgf_low_maps_pallas_batched(
        jnp.asarray(g2), jnp.asarray(p2), 8, 1e-4, s, out_wp=pp["out_wp"],
        out_margin=pp["margin"], poison_d0=True, interpret=True)
    want = np.asarray(fgf_wta_pallas_maps_batched(
        jnp.asarray(g2), maps_j, (h, w), (H, W), d_chunk=8, poly=True, mask_d0=False,
        maps_layout="poly", interpret=True))
    hp = maps_j.shape[2] // 2
    m = pp["margin"]
    maps = np.stack([np.asarray(maps_j[:, :, b * hp:b * hp + h, m:m + w]) for b in range(2)])
    got = K.upsample_wta(_t(g2), _t(maps)).numpy()
    assert got.shape == want.shape == (2, H, W)
    assert (got != want).mean() <= 2e-3


@pytest.mark.parametrize("radius,n_bins,pallas", [
    (5, 16, True), (3, 10, True), (9, 64, False),
])
def test_joint_wmf_plain_matches_jax(radius, n_bins, pallas):
    """K3's plain version vs the JAX op and its Pallas kernel: mismatch
    <= 1e-3 and max |diff| <= 1 (last-ulp median ties). At r=9 the
    interpret-mode kernel takes ~20 s on the CPU; the JAX package's own
    tests hold it to the jnp op there, so the port is held to the op, on an
    image large enough that most 19x19 windows lie whole inside it."""
    rng = np.random.default_rng(radius * n_bins)
    H, W = (64, 128) if radius == 9 else (24, 40)
    disp = rng.integers(0, n_bins, (H, W), dtype=np.uint8)
    guide = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    got = joint_wmf(_t(disp), _t(guide), radius=radius, n_bins=n_bins).numpy()
    refs = [jax_joint_wmf(jnp.asarray(disp), jnp.asarray(guide), radius=radius,
                          n_bins=n_bins)]
    if pallas:
        refs.append(joint_wmf_pallas(jnp.asarray(disp), jnp.asarray(guide), radius=radius,
                                     n_bins=n_bins, interpret=True))
    for ref in refs:
        ref = np.asarray(ref)
        assert (got != ref).mean() <= 1e-3
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("kind", ["two_level", "beyond_bins"])
def test_joint_wmf_plain_special_maps_match_jax(kind):
    """K3's plain version vs the JAX op on the maps the CUDA kernel's bin
    windows are tested with on the card: a two-level map (3 and 200 of 256
    bins) and a map with disparities >= n_bins, which add nothing in both
    (the JAX op's one-hot matches no bin, the plain version gives them
    weight 0). Tolerance: mismatch <= 1e-3 (last-ulp ties in the cumulative
    sums, which XLA adds in another order). max |diff| <= 1 is asserted
    only where neighbouring bins are occupied: on the two-level map a
    flipped tie moves the median to the next occupied bin, 197 away. The
    guide has low contrast, so no weight is subnormal (XLA may flush
    those)."""
    rng = np.random.default_rng(17)
    H, W, radius = 32, 56, 4
    guide = rng.integers(100, 140, (H, W, 3), dtype=np.uint8)
    if kind == "two_level":
        n_bins = 256
        disp = np.where(rng.random((H, W)) < 0.5, 3, 200).astype(np.uint8)
    else:
        n_bins = 40
        disp = rng.integers(0, 60, (H, W), dtype=np.uint8)      # a third >= n_bins
        disp[:6, :20] = 255                                     # whole windows without a bin
    got = joint_wmf(_t(disp), _t(guide), radius=radius, n_bins=n_bins).numpy()
    ref = np.asarray(jax_joint_wmf(jnp.asarray(disp), jnp.asarray(guide), radius=radius,
                                   n_bins=n_bins))
    assert (got != ref).mean() <= 1e-3
    if kind == "two_level":
        assert set(np.unique(got)) <= {3, 200}
    else:
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        assert got.max() < n_bins and (got[:2, :16] == 0).all()
    # the wrapper takes this plain version for CPU tensors
    wrapped = K.weighted_median(_t(disp)[None], _t(guide)[None], radius, n_bins, 25.5)
    np.testing.assert_array_equal(wrapped[0].numpy(), got)


def test_wmf_bin_window_passes_counts_the_kernels_sweeps():
    """`bin_window_passes` counts, per 32x8 tile of the CUDA kernel, one pass
    per window of NB of the distinct binned disparities of the haloed tile
    (their ranks), and one more where there are several;
    `range_window_passes` the same over every bin between the least and
    greatest binned disparity."""
    from primestereomatch_torch.kernels.wmf import (
        NB,
        TILE_H,
        TILE_W,
        bin_window_passes,
        range_window_passes,
    )

    disp = torch.full((1, 2 * TILE_H, 3 * TILE_W), 250, dtype=torch.uint8)
    for count in (bin_window_passes, range_window_passes):
        assert count(disp, 3, 10).sum() == 0                 # nothing has a bin
        assert (count(disp, 3, 256) == 1).all()              # one level: one window
    disp[0, 0, 0], disp[0, 0, 1] = 3, 200
    spans = (250 - 3) // NB + 1
    got = range_window_passes(disp, 3, 256)[0]
    assert got[0, 0] == spans + 1 and (got.flatten()[1:] == 1).all()
    assert (bin_window_passes(disp, 3, 256) == 1).all()      # three levels: one rank window
    # the halo reaches into the next tile: radius 9 from column TILE_W + 5
    disp[0, 0, 0], disp[0, 0, 1] = 250, 250
    disp[0, 3, TILE_W + 5] = 250 - NB
    got = range_window_passes(disp, 9, 256)[0]
    assert got[0].tolist() == [3, 3, 1] and got[1].tolist() == [3, 3, 1]
    assert (bin_window_passes(disp, 9, 256) == 1).all()
    # NB + 2 levels in the first tile: two rank windows of the four of the range
    disp[0, 1:4, :(NB + 2) // 3] = torch.arange(NB + 2, dtype=torch.uint8).view(3, -1) * 3
    assert bin_window_passes(disp, 9, 256)[0, 0, 0] == 3
    assert range_window_passes(disp, 9, 256)[0, 0, 0] == 250 // NB + 2
    ragged = torch.zeros((2, TILE_H + 1, TILE_W - 3), dtype=torch.uint8)
    for count in (bin_window_passes, range_window_passes):
        assert tuple(count(ragged, 9, 64).shape) == (2, 2, 1)


def test_joint_wmf_plain_constant_region():
    """Constant disparity under a constant guide is its own median, exactly."""
    disp = torch.full((16, 130), 7, dtype=torch.uint8)
    guide = torch.full((16, 130, 3), 128, dtype=torch.uint8)
    assert bool((joint_wmf(disp, guide, radius=9, n_bins=64) == 7).all())


def _wrapper_inputs():
    rng = np.random.default_rng(11)
    B, D, H, W, s = 2, 8, 32, 48, 4
    g = torch.as_tensor(rng.random((B, H, W, 3)).astype(np.float32))
    p = torch.as_tensor(rng.random((B, D, H // s, W // s)).astype(np.float32))
    stats = gf.guide_stats(g, (H // s, W // s), 5, 1e-4)
    disp = torch.as_tensor(rng.integers(1, D, (B, H, W), dtype=np.uint8))
    guide_u8 = torch.as_tensor(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8))
    return g, p, stats, disp, guide_u8


@pytest.mark.parametrize("name", ["lowmaps", "wta", "wmf", "bt_cost", "sgbm_scan", "select",
                                  "speckle", "cvc_lowmaps", "cvc_wta", "sgbm_scan_partials",
                                  "select_partials", "speckle_sweep"])
def test_wrappers_on_cpu_run_plain_and_count_nothing(name):
    """Given CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    g, p, stats, disp, guide_u8 = _wrapper_inputs()
    maps = K.low_maps_plain(p, stats, 5)
    rng = np.random.default_rng(3)
    ftr = [torch.as_tensor(rng.integers(0, 127, (20, 30, 3), dtype=np.int32)) for _ in range(2)]
    S = torch.as_tensor(rng.integers(0, 5000, (12, 40, 8), dtype=np.int32))
    conn = torch.as_tensor(rng.integers(0, 2, (12, 40), dtype=np.uint8))
    K.reset_launches()
    if name == "lowmaps":
        got, want = K.low_maps(p, stats, 5), maps
    elif name == "wta":
        got, want = K.upsample_wta(g, maps), K.upsample_wta_plain(g, maps)
    elif name == "wmf":
        got = K.weighted_median(disp, guide_u8, 4, 8, 25.5)
        want = K.weighted_median_plain(disp, guide_u8, 4, 8, 25.5)
    elif name == "bt_cost":
        got, want = K.bt_cost(*ftr, 8, 5, 9450), K.bt_cost_plain(*ftr, 8, 5, 9450)
    elif name == "sgbm_scan":
        got, want = K.sgbm_aggregate(S, 600, 2400), K.sgbm_aggregate_plain(S, 600, 2400)
    elif name == "select":
        got, want = K.select_disparity(S, 10, 1), K.select_disparity_plain(S, 10, 1)
    elif name == "sgbm_scan_partials":
        C = S.to(torch.int16)
        parts = K.sgbm_aggregate_partials(C, 600, 2400, 8, 5000)
        assert len(parts) == 2 and all(q.dtype == torch.uint16 for q in parts)
        plain = K.sgbm_aggregate_partials_plain(C, 600, 2400, 8, 5000)
        assert all(torch.equal(a, b) for a, b in zip(parts, plain))
        got, want = sum(q.int() for q in parts), K.sgbm_aggregate_plain(C, 600, 2400)
    elif name == "select_partials":
        parts = ((S // 2).to(torch.uint16), (S - S // 2).to(torch.uint16))
        got = K.select_disparity_partials(parts, 10, 1)
        assert torch.equal(got, K.select_disparity_partials_plain(parts, 10, 1))
        want = K.select_disparity_plain(S, 10, 1)
    elif name == "cvc_lowmaps":
        grd = g[..., 0].contiguous()
        got, want = K.cvc_low_maps(g, grd, stats, 8, 5), K.cvc_low_maps_plain(g, grd, stats, 8, 5)
    elif name == "cvc_wta":
        grd = g[..., 0].contiguous()
        got, want = K.cvc_wta(g, grd, stats, 8, 5), K.cvc_wta_plain(g, grd, stats, 8, 5)
    elif name == "speckle_sweep":
        links = torch.as_tensor(rng.integers(0, 16, (12, 40), dtype=np.uint8))
        got = K.speckle_sweep(S[..., 0], links, torch.zeros(1, dtype=torch.int32))
        want = K.speckle_sweep_plain(S[..., 0], links)
    else:
        got, want = K.segmin_sweep(S[..., 0], conn, 1), K.segmin_sweep_plain(S[..., 0], conn, 1)
    assert torch.equal(got, want)
    assert set(K.LAUNCHES.values()) == {0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    g, p, stats, disp, guide_u8 = _wrapper_inputs()
    maps = K.low_maps_plain(p, stats, 5)
    with pytest.raises(TypeError):
        K.low_maps(p.double(), stats, 5)
    with pytest.raises(ValueError):
        K.low_maps(p, stats[:, :11], 5)
    with pytest.raises(ValueError):
        K.low_maps(p, stats, 4)                     # even box
    with pytest.raises(ValueError):
        K.upsample_wta(g, maps[:, :3])
    with pytest.raises(TypeError):
        K.upsample_wta(g.double(), maps)
    with pytest.raises(TypeError):
        K.weighted_median(disp.int(), guide_u8)
    with pytest.raises(ValueError):
        K.weighted_median(disp, guide_u8, n_bins=300)
