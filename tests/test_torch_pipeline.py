"""The port's STEREO_GIF slice end to end against the JAX pipeline, its
config, device rules and import hygiene."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from primestereomatch_tpu.config import GIFConfig as JaxGIFConfig
from primestereomatch_tpu.models import stereo_gif_forward as jax_forward
from primestereomatch_tpu.utils import load_dataset as jax_load
from primestereomatch_torch import GIFConfig, StereoGIF, from_jax_config, stereo_gif_forward
from primestereomatch_torch.utils import bad_pixel_metrics, load_dataset

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_NONOCC = {"Teddy": 17.229, "Cones": 9.072}
TPU_SELECTORS = ("cvc_impl", "wta_impl", "wmf_impl", "upsample_impl", "wta_d_chunk")


@pytest.fixture(scope="module")
def crop():
    """A 96x160 crop of Teddy (left, right), float32 BGR in [0, 1]."""
    s = jax_load("Teddy")
    return (np.ascontiguousarray(s.left_f32[120:216, 150:310]),
            np.ascontiguousarray(s.right_f32[120:216, 150:310]))


def _mismatch(port, ref):
    return max(float((p.numpy() != np.asarray(r)).mean()) for p, r in zip(port, ref))


@pytest.mark.parametrize("run_postprocess", [False, True])
def test_crop_matches_jax_pipeline(crop, run_postprocess):
    """Without post-processing only WTA argmin ties may differ (<= 2e-3, the
    JAX package's kernel-vs-XLA bound). With JointWMF a tie flip can move a
    median; measured 0 differing pixels on this crop and 14 of 168750 (8e-5)
    on full Teddy, so the same 2e-3 bound holds with a wide margin."""
    cfg_kw = dict(max_dis=16, med_sz=7)
    ref = jax_forward(jnp.asarray(crop[0]), jnp.asarray(crop[1]), JaxGIFConfig(**cfg_kw),
                      run_postprocess=run_postprocess)
    got = stereo_gif_forward(crop[0], crop[1], GIFConfig(**cfg_kw), run_postprocess,
                             device="cpu")
    assert all(g.dtype == torch.uint8 and g.shape == crop[0].shape[:2] for g in got)
    assert _mismatch(got, ref) <= 2e-3
    assert min(int(g.min()) for g in got) >= 1


@pytest.mark.parametrize("jax_cfg", [
    JaxGIFConfig(),
    JaxGIFConfig(subsample=2, max_dis=32, tau1=0.3, tau2=0.05, med_sz=9,
                 wta_impl="xla", tail_fusion="full"),
    JaxGIFConfig(cvc_dtype="u8", wmf_mode="table", pp_toolchain=True, wmf_n_feat=128,
                 sig_clr=0.2, sig_dis=5.0),
], ids=["default", "s2_d32_tau", "variants"])
def test_from_jax_config_round_trips(jax_cfg):
    """Every field the port reads comes across, `tail_fusion` and the
    variants' fields included; the TPU selectors are dropped."""
    cfg = from_jax_config(dataclasses.asdict(jax_cfg))
    assert dataclasses.asdict(cfg) == {k: v for k, v in dataclasses.asdict(jax_cfg).items()
                                       if k not in TPU_SELECTORS}
    assert cfg.fgf_low_radius == jax_cfg.fgf_low_radius
    assert cfg.wmf_radius == jax_cfg.wmf_radius


def test_from_jax_config_gives_the_jax_result(crop):
    jax_cfg = JaxGIFConfig(subsample=2, max_dis=32, tau1=0.3, tau2=0.05, med_sz=9)
    ref = jax_forward(jnp.asarray(crop[0]), jnp.asarray(crop[1]), jax_cfg)
    got = stereo_gif_forward(crop[0], crop[1], from_jax_config(dataclasses.asdict(jax_cfg)),
                             device="cpu")
    assert _mismatch(got, ref) <= 2e-3


def test_from_jax_config_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown"):
        from_jax_config({**dataclasses.asdict(JaxGIFConfig()), "gif_radiu": 8})


@pytest.mark.parametrize("field,value", [
    ("tail_fusion", "fused"), ("cvc_impl", "pallas"), ("wta_impl", "triton"),
    ("wmf_impl", "cuda"), ("upsample_impl", "nearest"), ("cvc_dtype", "f16"),
    ("wmf_mode", "approx"), ("max_dis", 300), ("wta_d_chunk", 0),
])
def test_config_rejects_unknown_values(field, value):
    """Unknown values raise: the port's own fields (`tail_fusion` among
    them) in GIFConfig, the TPU selectors (which GIFConfig does not have) in
    from_jax_config."""
    with pytest.raises(ValueError):
        if field in TPU_SELECTORS:
            from_jax_config({**dataclasses.asdict(JaxGIFConfig()), field: value})
        else:
            GIFConfig(**{field: value})
    if field in TPU_SELECTORS:
        assert field not in {f.name for f in dataclasses.fields(GIFConfig)}


@pytest.mark.parametrize("field,value", [
    ("cvc_dtype", "u8"), ("wmf_mode", "table"), ("pp_toolchain", True),
])
def test_config_runs_every_value_the_jax_package_runs(crop, field, value):
    """The uint8 cost, table mode and the post-processing toolchain
    construct, come across from a JAX config, and run on a crop (against
    the JAX forward: tests/test_torch_variants.py)."""
    kw = dict(max_dis=16, med_sz=7, **{field: value})
    cfg = from_jax_config(dataclasses.asdict(JaxGIFConfig(**kw)))
    assert cfg == GIFConfig(**kw) and getattr(cfg, field) == value
    got = stereo_gif_forward(crop[0], crop[1], cfg, device="cpu")
    assert all(g.dtype == torch.uint8 and g.shape == crop[0].shape[:2] for g in got)
    assert min(int(g.min()) for g in got) >= 1 and max(int(g.max()) for g in got) < 16


def test_forward_without_device_needs_cuda(crop):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stereo_gif_forward(crop[0], crop[1], GIFConfig(max_dis=16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StereoGIF(GIFConfig(max_dis=16))


def test_module_matches_function_and_rejects_bad_input(crop):
    cfg = GIFConfig(max_dis=16, med_sz=7)
    model = StereoGIF(cfg, device="cpu")
    a = model(crop[0], crop[1])
    b = stereo_gif_forward(crop[0], crop[1], cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(TypeError):
        model((crop[0] * 255).astype(np.uint8), (crop[1] * 255).astype(np.uint8))
    with pytest.raises(ValueError):
        model(crop[0], crop[1][:, :-1])


def test_port_imports_nothing_of_jax():
    """Every module of the port, and the imports of chip_smoke.py,
    tune_wmf.py and tune_gif_tail.py, load in a fresh interpreter without
    any jax or primestereomatch_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import primestereomatch_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, tune_gif_tail, tune_wmf\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'primestereomatch_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('primestereomatch_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(GOLDEN_NONOCC))
def test_golden_bp_through_port_on_cpu(name):
    s = load_dataset(name)
    cfg = GIFConfig()
    ld, rd = stereo_gif_forward(s.left_f32, s.right_f32, cfg, device="cpu")
    res = bad_pixel_metrics(ld.numpy(), s.gt, s.scale_factor, cfg.max_dis,
                            mask=s.mask_nonocc)
    assert res.percent_bad_pixels == pytest.approx(GOLDEN_NONOCC[name], abs=0.3)
    assert int(rd.max()) < cfg.max_dis and int(ld.min()) >= 1
