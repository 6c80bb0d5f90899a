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


@pytest.mark.parametrize("name", ["lowmaps", "wta", "wmf"])
def test_wrappers_on_cpu_run_plain_and_count_nothing(name):
    """Given CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    g, p, stats, disp, guide_u8 = _wrapper_inputs()
    maps = K.low_maps_plain(p, stats, 5)
    K.reset_launches()
    if name == "lowmaps":
        got, want = K.low_maps(p, stats, 5), maps
    elif name == "wta":
        got, want = K.upsample_wta(g, maps), K.upsample_wta_plain(g, maps)
    else:
        got = K.weighted_median(disp, guide_u8, 4, 8, 25.5)
        want = K.weighted_median_plain(disp, guide_u8, 4, 8, 25.5)
    assert torch.equal(got, want)
    assert K.LAUNCHES == {"lowmaps": 0, "wta": 0, "wmf": 0}


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
