"""The port's third STEREO_GIF slice as a whole against the JAX pipeline on
the CPU: the exact-stride tails (`tail_fusion` maps and full), subsample=1
and the batch entry point. Inputs are crops of Teddy; the config is carried
across by `from_jax_config`, so both packages compute the same thing."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from primestereomatch_tpu.config import GIFConfig as JaxGIFConfig
from primestereomatch_tpu.models import stereo_gif_forward as jax_forward
from primestereomatch_tpu.models import stereo_gif_forward_batch as jax_forward_batch
from primestereomatch_tpu.utils import load_dataset as jax_load
from primestereomatch_torch import (
    GIFConfig,
    from_jax_config,
    stereo_gif_forward,
    stereo_gif_forward_batch,
)
from primestereomatch_torch.ops.geometry import full_fusion_applies, fused_cvc_applies


@pytest.fixture(scope="module")
def teddy():
    s = jax_load("Teddy")
    return s.left_f32, s.right_f32


def _mismatch(port, ref):
    return max(float((p.numpy() != np.asarray(r)).mean()) for p, r in zip(port, ref))


@pytest.mark.parametrize("run_postprocess", [False, True])
@pytest.mark.parametrize("tail_fusion", ["maps", "full"])
def test_exact_stride_crop_matches_jax_pipeline(teddy, tail_fusion, run_postprocess):
    """A 96x256 crop (exact stride: K4, or K10 with 'full', on the card;
    their plain versions here) against the JAX pipeline with the config
    carried across: WTA outputs within 2e-3 (argmin ties), final outputs
    within the same bound, as test_crop_matches_jax_pipeline holds."""
    left, right = (np.ascontiguousarray(a[120:216, 100:356]) for a in teddy)
    jax_cfg = JaxGIFConfig(max_dis=16, med_sz=7, tail_fusion=tail_fusion)
    cfg = from_jax_config(dataclasses.asdict(jax_cfg))
    assert fused_cvc_applies(256, 16, 4) and full_fusion_applies(256, 16, 4)
    ref = jax_forward(jnp.asarray(left), jnp.asarray(right), jax_cfg,
                      run_postprocess=run_postprocess)
    got = stereo_gif_forward(left, right, cfg, run_postprocess, device="cpu")
    assert all(g.dtype == torch.uint8 and g.shape == (96, 256) for g in got)
    assert _mismatch(got, ref) <= 2e-3
    assert min(int(g.min()) for g in got) >= 1


def test_subsample_1_crop_matches_jax_pipeline(teddy):
    """subsample=1: a 17x17 box, maps at full resolution and K2 at ratio 1
    (the TPU's generic kernel K5)."""
    left, right = (np.ascontiguousarray(a[150:198, 200:280]) for a in teddy)
    jax_cfg = JaxGIFConfig(max_dis=8, subsample=1, med_sz=7)
    cfg = from_jax_config(dataclasses.asdict(jax_cfg))
    assert cfg.fgf_low_radius == 17 and not fused_cvc_applies(80, 8, 1)
    for pp in (False, True):
        ref = jax_forward(jnp.asarray(left), jnp.asarray(right), jax_cfg, run_postprocess=pp)
        got = stereo_gif_forward(left, right, cfg, pp, device="cpu")
        assert _mismatch(got, ref) <= 2e-3


def _frames(teddy, W, H=64):
    x0s = (100, 150, 200)
    return (np.stack([teddy[0][120:120 + H, x0:x0 + W] for x0 in x0s]),
            np.stack([teddy[1][120:120 + H, x0:x0 + W] for x0 in x0s]))


@pytest.mark.parametrize("W,kw", [
    (160, {}), (154, {}), (160, {"tail_fusion": "full"}), (96, {"subsample": 1}),
], ids=["exact", "quasi", "full", "s1"])
def test_batch_equals_per_frame(teddy, W, kw):
    """B = 3 frames, each bitwise equal to the single-frame forward, on
    every tail: exact stride (K4), quasi ratio (K1), full fusion (K10) and
    subsample=1."""
    l, r = _frames(teddy, W)
    cfg = GIFConfig(max_dis=8, med_sz=7, **kw)
    ld, rd = stereo_gif_forward_batch(l, r, cfg, device="cpu")
    assert ld.shape == rd.shape == (3, 64, W) and ld.dtype == torch.uint8
    for b in range(3):
        one = stereo_gif_forward(l[b], r[b], cfg, device="cpu")
        assert torch.equal(one[0], ld[b]) and torch.equal(one[1], rd[b])


def test_batch_matches_jax_batch(teddy):
    """The batch entry point within the pipeline bound (2e-3, argmin ties)
    of the JAX package's, the config carried across."""
    l, r = _frames(teddy, 128)
    jax_cfg = JaxGIFConfig(max_dis=8, med_sz=7)
    got = stereo_gif_forward_batch(l, r, from_jax_config(dataclasses.asdict(jax_cfg)),
                                   device="cpu")
    ref = jax_forward_batch(jnp.asarray(l), jnp.asarray(r), jax_cfg)
    assert _mismatch(got, ref) <= 2e-3


def test_batch_rejects_what_it_does_not_run(teddy):
    l = np.stack([teddy[0][:64, :128]] * 2)
    cfg = GIFConfig(max_dis=16)
    # the toolchain and table mode run on single frames only, as in the JAX package
    for kw in (dict(pp_toolchain=True), dict(wmf_mode="table")):
        with pytest.raises(ValueError, match="exact-WMF"):
            stereo_gif_forward_batch(l, l, GIFConfig(max_dis=16, **kw), device="cpu")
    with pytest.raises(ValueError):
        stereo_gif_forward_batch(l, l[:, :, :-4], cfg, device="cpu")
    with pytest.raises(ValueError):
        stereo_gif_forward_batch(l[0], l[0], cfg, device="cpu")
    with pytest.raises(TypeError):
        stereo_gif_forward_batch((l * 255).astype(np.uint8), (l * 255).astype(np.uint8), cfg,
                                 device="cpu")
