"""The fused STEREO_GIF tails of the port on the CPU: the plain versions of
K4 (cost + low-maps) and K10 (cost + chain + WTA) against the JAX package's
Pallas kernels in interpret mode, K2's plain version at the generic ratios
of the TPU's K5, and the geometry predicates against the JAX dispatch (the
slice as a whole: tests/test_torch_tail_pipeline.py). Inputs come from a
seed through numpy; tolerances are the JAX package's own
(tests/test_kernels.py)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from primestereomatch_tpu.config import GIFConfig as JaxGIFConfig
from primestereomatch_tpu.kernels import cvc_lowmaps_pallas as jk4
from primestereomatch_tpu.kernels import cvc_wta_pallas as jk10
from primestereomatch_tpu.kernels.wta_pallas import fgf_wta_pallas, poly_col_params
from primestereomatch_tpu.ops.resize import nearest_indices
from primestereomatch_torch import (
    GIFConfig,
    from_jax_config,
    kernels as K,
)
from primestereomatch_torch.ops.geometry import full_fusion_applies, fused_cvc_applies
from primestereomatch_torch.ops.guided_filter import guide_stats


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(H, W, seed):
    """Random views and gradients, as the JAX kernel tests use."""
    rng = np.random.default_rng(seed)
    views = rng.random((2, H, W, 3)).astype(np.float32)
    grds = rng.random((2, H, W)).astype(np.float32)
    return views, grds


def _jax_args(views, grds, v):
    """One view's arguments of the JAX fused kernels: (img, grd, other img,
    other grd, is_left); view 0 is the left one."""
    o = 1 - v
    return (jnp.asarray(views[v]), jnp.asarray(grds[v]), jnp.asarray(views[o]),
            jnp.asarray(grds[o]), v == 0)


@pytest.mark.parametrize("v", [0, 1], ids=["left", "right"])
@pytest.mark.parametrize("H,W,D,s,tau", [
    (128, 256, 16, 4, (None, None)), (96, 192, 8, 2, (None, None)),
    (96, 256, 8, 4, (0.3, 0.05)),
])
def test_cvc_low_maps_plain_matches_jax_kernel(H, W, D, s, tau, v):
    """K4's plain version vs the TPU kernel (interpret mode) for each
    direction, on the kernel's logical (h, w) window, at K1's bound
    (atol 2e-4, rtol 1e-3)."""
    h, w, k = H // s, W // s, 2 * (8 // s) + 1
    views, grds = _pair(H, W, H + s)
    stats = guide_stats(_t(views), (h, w), k, 1e-4)
    got = K.cvc_low_maps(_t(views), _t(grds), stats, D, k, tau1=tau[0], tau2=tau[1]).numpy()
    assert got.shape == (2, 4, D, h, w)
    yi, xi = nearest_indices(H, h), nearest_indices(W, w)
    want = np.asarray(jk4.cvc_fgf_low_maps_pallas(
        *_jax_args(views, grds, v), D, yi, xi, 8, 1e-4, s, tau1=tau[0], tau2=tau[1],
        interpret=True))
    assert np.allclose(got[v], want[:, :, :h, :w], atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("v", [0, 1], ids=["left", "right"])
@pytest.mark.parametrize("H,W,D,s", [(128, 256, 16, 4), (126, 256, 16, 4)])
def test_cvc_wta_plain_matches_jax_kernel(H, W, D, s, v):
    """K10's plain version vs the TPU kernel (interpret mode), each
    direction: only argmin ties may differ (<= 2e-3; the TPU kernel
    combines with the guide before its column lerp). And bitwise the
    port's own K4 plain -> K2 plain."""
    h, w, k = H // s, W // s, 2 * (8 // s) + 1
    views, grds = _pair(H, W, H)
    stats = guide_stats(_t(views), (h, w), k, 1e-4)
    got = K.cvc_wta(_t(views), _t(grds), stats, D, k)
    assert got.shape == (2, H, W) and got.dtype == torch.uint8 and int(got.min()) >= 1
    maps = K.cvc_low_maps_plain(_t(views), _t(grds), stats, D, k)
    assert torch.equal(got, K.upsample_wta_plain(_t(views), maps))
    yi, xi = nearest_indices(H, h), nearest_indices(W, w)
    want = np.asarray(jk10.cvc_fgf_wta_pallas(
        *_jax_args(views, grds, v), D, yi, xi, 8, 1e-4, s, interpret=True))
    n = int((got[v].numpy() != want).sum())
    print(f"view {v}: {n} of {want.size} px differ")
    assert n / want.size <= 2e-3


@pytest.mark.parametrize("hw,HW", [((30, 48), (60, 90)), ((32, 64), (32, 64))])
def test_upsample_wta_plain_matches_jax_generic_kernel(hw, HW):
    """K2's plain version at the ratios of the TPU's generic kernel (K5,
    `_wta_kernel`): a sub-2x column ratio, which `poly_col_params` rejects,
    and ratio 1 (subsample=1). Equal, or within 2e-3 with the count printed."""
    (h, w), (H, W) = hw, HW
    assert poly_col_params(w, W) is None
    D = 8
    rng = np.random.default_rng(h + W)
    g = rng.random((H, W, 3)).astype(np.float32)
    maps = rng.random((4, D, h, w)).astype(np.float32)
    want = np.asarray(fgf_wta_pallas(jnp.asarray(g), *(jnp.asarray(m) for m in maps), (H, W),
                                     d_chunk=4, interpret=True))
    got = K.upsample_wta(_t(g)[None], _t(maps)[None])[0].numpy()
    n = int((got != want).sum())
    print(f"{hw}->{HW}: {n} of {want.size} px differ")
    assert n / want.size <= 2e-3 and got.min() >= 1


# (W, s, D): the 2K, HD720, ZED-VGA widths, Middlebury widths, s = 1
GEOMETRIES = [(2208, 4, 256), (1280, 4, 128), (672, 4, 64), (450, 4, 64), (447, 2, 64),
              (450, 2, 64), (450, 1, 64), (2208, 1, 64), (256, 4, 16), (192, 2, 8),
              (640, 8, 64), (640, 8, 60), (672, 3, 63), (675, 5, 65), (679, 7, 63),
              (672, 4, 62), (96, 16, 64), (2208, 2, 256), (1920, 6, 126),
              # exact and phase-periodic, but the TPU planner finds no tile
              (4096, 2, 256), (7680, 4, 256)]


@pytest.mark.parametrize("W,s,D", GEOMETRIES)
def test_predicates_equal_the_jax_dispatch(W, s, D):
    """The port's fused-CVC predicate is the JAX package's `fuse_cvc`
    decision (gif_pipeline.py:132-143) and its full-fusion predicate that
    and `cvc_wta_applicable`, except where the JAX ones fail only because
    their TPU on-chip memory planner finds no tile (checked here by asking
    the planner itself)."""
    H = 376
    h, w = H // s, W // s
    xi = nearest_indices(W, w)
    pp = poly_col_params(w, W)
    jax_fused = bool(pp is not None and pp["exact"] and jk4.cvc_lowmaps_applicable(
        W, w, xi, D, s, radius=8, out_wp=pp["out_wp"], out_margin=pp["margin"]))
    jax_full = jax_fused and jk10.cvc_wta_applicable(W, w, xi, D, s, H, h, radius=8)
    ours_fused, ours_full = fused_cvc_applies(W, D, s), full_fusion_applies(W, D, s)
    M = 2 * (8 // s)
    if ours_fused != jax_fused:
        WI = pp["out_wp"] + 2 * M
        assert ours_fused and jk4._plan_th(
            s, M, WI, D // s - 1 + WI, pp["margin"] + pp["out_wp"]) is None
    if ours_full != jax_full:
        pe = jk10._poly_exact_params(w, W)
        assert ours_full and pe is not None and (not jax_fused or jk10._plan_th(
            h, H, s, M, w, D // s - 1, pe["P"], pe["TWQ"]) is None)
    if s == 1 or W % s:
        assert not ours_fused and not ours_full


def test_tail_fusion_comes_across_and_is_validated():
    cfg = from_jax_config(dataclasses.asdict(JaxGIFConfig(tail_fusion="full")))
    assert cfg.tail_fusion == "full" and GIFConfig().tail_fusion == "maps"
    with pytest.raises(ValueError, match="tail_fusion"):
        from_jax_config({**dataclasses.asdict(JaxGIFConfig()), "tail_fusion": "fused"})
    with pytest.raises(ValueError, match="tail_fusion"):
        GIFConfig(tail_fusion="none")


def test_fused_wrappers_reject_what_the_kernels_do_not_take():
    views, grds = _pair(32, 64, 1)
    v, g = _t(views), _t(grds)
    stats = guide_stats(v, (8, 16), 5, 1e-4)
    for fn in (K.cvc_low_maps, K.cvc_wta):
        with pytest.raises(ValueError):
            fn(v[:1], g[:1], stats[:1], 8, 5)          # an odd number of views
        with pytest.raises(ValueError):
            fn(v, g[:, :-1], stats, 8, 5)
        with pytest.raises(ValueError):
            fn(v, g, stats[:, :11], 8, 5)
        with pytest.raises(TypeError):
            fn(v.double(), g, stats, 8, 5)
        with pytest.raises(ValueError):
            fn(v, g, stats, 300, 5)
        with pytest.raises(ValueError):
            fn(v, g, stats, 8, 4)                      # even box
