"""The STEREO_GIF variants the port runs beside the default path, against
the JAX package on the CPU: the uint8 cost volume (`cvc_dtype='u8'`), the
post-processing toolchain (`pp_toolchain=True`), table-mode JointWMF, the
full-resolution filters and the staged engine `DispEst`."""

import dataclasses
import hashlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from primestereomatch_tpu.config import GIFConfig as JaxGIFConfig
from primestereomatch_tpu.models import stereo_gif_forward as jax_forward
from primestereomatch_tpu.models.gif_pipeline import DispEst as JaxDispEst
from primestereomatch_tpu.ops import color as jcolor
from primestereomatch_tpu.ops import cost_volume as jcv
from primestereomatch_tpu.ops import guided_filter as jgf
from primestereomatch_tpu.ops.resize import resize_nearest as jax_resize_nearest
from primestereomatch_tpu.utils import bad_pixel_metrics as jax_bp
from primestereomatch_tpu.utils import load_dataset as jax_load
from primestereomatch_tpu.utils.features import feature_index_color as jax_features
from primestereomatch_torch import DispEst, GIFConfig, from_jax_config, stereo_gif_forward
from primestereomatch_torch.models import gif_pipeline
from primestereomatch_torch.ops import color, cost_volume, guided_filter
from primestereomatch_torch.utils import feature_index_color, load_dataset
from primestereomatch_torch.utils.png import read_png


@pytest.fixture(scope="module")
def teddy():
    return jax_load("Teddy")


def _t(x):
    return torch.from_numpy(np.array(x))


def _mismatch(port, ref):
    return max(float((p.numpy() != np.asarray(r)).mean()) for p, r in zip(port, ref))


def _jax_u8_prep(img_u8):
    return jcolor.sobel_x_k1_u8(jcolor.bgr_to_gray_refquirk_u8(jnp.asarray(img_u8)))


def test_u8_gray_and_sobel_are_bitwise_jax():
    img = np.random.default_rng(2).integers(0, 256, (20, 33, 3), dtype=np.uint8)
    gray = color.bgr_to_gray_refquirk_u8(_t(img))
    assert gray.dtype == torch.uint8
    np.testing.assert_array_equal(gray.numpy(),
                                  np.asarray(jcolor.bgr_to_gray_refquirk_u8(jnp.asarray(img))))
    grad = color.sobel_x_k1_u8(gray)
    assert grad.dtype == torch.uint8
    np.testing.assert_array_equal(grad.numpy(), np.asarray(_jax_u8_prep(img)))


@pytest.mark.parametrize("alpha,tau", [(0.9, (1835, 524)), (0.6, (40, 30))])
def test_u8_cost_volumes_are_bitwise_jax(alpha, tau):
    """The full uint8 volumes, d = 0 and the borders (255 operands)
    included, equal the JAX op's, at the dead default clamps and at live
    ones."""
    rng = np.random.default_rng(int(alpha * 10))
    H, W, D = 14, 26, 9
    imgs = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(2)]
    grds = [rng.integers(0, 256, (H, W), dtype=np.uint8) for _ in range(2)]
    got = cost_volume.build_cost_volumes_u8(*map(_t, imgs + grds), D, alpha, *tau)
    want = jcv.build_cost_volumes_u8(*map(jnp.asarray, imgs + grds), D, alpha, *tau)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and g.shape == (D, H, W)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("H,W,s", [(48, 90, 4), (40, 128, 4), (30, 40, 1)],
                         ids=["quasi", "exact", "s1"])
def test_u8_sampled_costs_are_the_full_volume_downsampled(teddy, H, W, s):
    """The pipeline's uint8 costs at the FGF grid, for a batch of two pairs,
    equal the JAX package's full uint8 volume nearest-downsampled, bit for
    bit (gray and Sobel on the uint8 views included)."""
    cfg = GIFConfig(max_dis=16, subsample=s)
    l2 = np.stack([teddy.left_f32[:H, :W], teddy.left_f32[100:100 + H, 200:200 + W]])
    r2 = np.stack([teddy.right_f32[:H, :W], teddy.right_f32[100:100 + H, 200:200 + W]])
    got = gif_pipeline.sampled_u8_costs(_t(np.concatenate([l2, r2])), cfg)
    assert got.shape == (4, 16, H // s, W // s) and got.dtype == torch.uint8
    for b in range(2):
        l8, r8 = (np.clip(np.rint(x[b] * 255.0), 0, 255).astype(np.uint8) for x in (l2, r2))
        lcv, rcv = jcv.build_cost_volumes_u8(jnp.asarray(l8), jnp.asarray(r8), _jax_u8_prep(l8),
                                             _jax_u8_prep(r8), 16, alpha=0.9)
        for v, cv in ((b, lcv), (b + 2, rcv)):
            np.testing.assert_array_equal(got[v].numpy(),
                                          np.asarray(jax_resize_nearest(cv, (H // s, W // s))))


def test_u8_cost_scale_is_the_ieee_quotient():
    """v / 255 for every uint8 value, as the JAX package divides."""
    v = np.arange(256, dtype=np.uint8)
    got = cost_volume.unit_cost(_t(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(v).astype(jnp.float32) / 255.0))
    np.testing.assert_array_equal(got, v.astype(np.float32) / np.float32(255.0))


def test_u8_sampled_cost_sha256_is_chip_smokes(teddy):
    """chip_smoke.U8_SHA256 is the sha256 of the JAX package's Teddy uint8
    volumes nearest-downsampled to the FGF grid, left then right; the port
    gives the same bytes."""
    l8, r8 = (np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)
              for x in (teddy.left_f32, teddy.right_f32))
    lcv, rcv = jcv.build_cost_volumes_u8(jnp.asarray(l8), jnp.asarray(r8), _jax_u8_prep(l8),
                                         _jax_u8_prep(r8), 64, alpha=0.9)
    low = (375 // 4, 450 // 4)
    want = b"".join(np.asarray(jax_resize_nearest(cv, low)).tobytes() for cv in (lcv, rcv))
    assert hashlib.sha256(want).hexdigest() == chip_smoke.U8_SHA256
    views = _t(np.stack([teddy.left_f32, teddy.right_f32]))
    got = gif_pipeline.sampled_u8_costs(views, GIFConfig())
    assert hashlib.sha256(got.numpy().tobytes()).hexdigest() == chip_smoke.U8_SHA256


def test_full_cost_volumes_match_jax(teddy):
    """DispEst's full-resolution f32 volumes (d = 0 included) against the
    JAX op, at the package's CVC bound."""
    H, W, D = 40, 70, 12
    li, ri = (np.ascontiguousarray(x[100:100 + H, 150:150 + W])
              for x in (teddy.left_f32, teddy.right_f32))
    lg, rg = (color.sobel_x_k1(color.bgr_to_gray_refquirk(_t(x))) for x in (li, ri))
    got = cost_volume.build_cost_volumes(_t(li), _t(ri), lg, rg, D, tau1=0.3)
    want = jcv.build_cost_volumes(jnp.asarray(li), jnp.asarray(ri), jnp.asarray(lg.numpy()),
                                  jnp.asarray(rg.numpy()), D, tau1=0.3)
    for g, w in zip(got, want):
        assert g.shape == (D, H, W)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("s", [4, 2])
def test_fast_guided_filter_color_matches_jax(s):
    """The filtered full volume, every slice (d = 0 included): atol 1e-5."""
    rng = np.random.default_rng(s)
    H, W, D = 48, 72, 20       # two chunks of the filter's 16 slices
    g = rng.random((H, W, 3), dtype=np.float32)
    p = rng.random((D, H, W), dtype=np.float32)
    got = guided_filter.fast_guided_filter_color(_t(g), _t(p), 8, 1e-4, s)
    want = jgf.fast_guided_filter_color(jnp.asarray(g), jnp.asarray(p), 8, 1e-4, s)
    assert got.shape == (D, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the low-res entry point, on slices already downsampled
    p_low = _t(p)[:, ::s, ::s]
    np.testing.assert_allclose(
        guided_filter.fast_guided_filter_color_low(_t(g), p_low, 8, 1e-4, s).numpy(),
        np.asarray(jgf.fast_guided_filter_color_low(jnp.asarray(g), jnp.asarray(p_low.numpy()),
                                                    8, 1e-4, s)), atol=1e-5)


@pytest.mark.parametrize("ksize", [8, 5])
def test_guided_filter_color_matches_jax(ksize):
    rng = np.random.default_rng(ksize)
    g = rng.random((30, 41, 3), dtype=np.float32)
    p = rng.random((4, 30, 41), dtype=np.float32)
    np.testing.assert_allclose(
        guided_filter.guided_filter_color(_t(g), _t(p), ksize).numpy(),
        np.asarray(jgf.guided_filter_color(jnp.asarray(g), jnp.asarray(p), ksize)), atol=1e-5)


@pytest.fixture(scope="module")
def crop(teddy):
    """A 96x150 crop (a quasi column ratio) and a 96x160 one (exact stride)."""
    return {w: tuple(np.ascontiguousarray(x[120:216, 150:150 + w])
                     for x in (teddy.left_f32, teddy.right_f32)) for w in (150, 160)}


def _tables(left, right):
    """Table-mode feature indexes of both views and the left view's table
    (seed 0), from the JAX package's clustering."""
    to_u8 = lambda x: np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)  # noqa: E731
    lf, wm = jax_features(to_u8(left), n_feat=128, seed=0)
    rf, _ = jax_features(to_u8(right), n_feat=128, seed=0)
    return lf, rf, wm


VARIANTS = {
    "u8": dict(cvc_dtype="u8"),
    "toolchain": dict(pp_toolchain=True),
    "table": dict(wmf_mode="table"),
    "toolchain_table": dict(pp_toolchain=True, wmf_mode="table"),
    "u8_s2_table": dict(cvc_dtype="u8", subsample=2, wmf_mode="table"),
}


@pytest.mark.parametrize("W", [150, 160])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_matches_jax_forward(crop, variant, W):
    """Each variant end to end against the JAX forward with the config
    carried across: mismatch <= 2e-3 (argmin ties of the filtered costs and
    JointWMF's last-ulp median ties, the JAX package's kernel-vs-XLA
    bound)."""
    jcfg = JaxGIFConfig(max_dis=16, med_sz=7, **VARIANTS[variant])
    cfg = from_jax_config(dataclasses.asdict(jcfg))
    left, right = crop[W]
    extra = _tables(left, right) if cfg.wmf_mode == "table" else ()
    ref = jax_forward(jnp.asarray(left), jnp.asarray(right), jcfg, True,
                      *map(jnp.asarray, extra))
    got = stereo_gif_forward(left, right, cfg, True, *extra, device="cpu")
    assert all(g.dtype == torch.uint8 and g.shape == left.shape[:2] for g in got)
    assert _mismatch(got, ref) <= 2e-3


def test_u8_takes_k1_at_exact_stride(crop, monkeypatch):
    """At an exact-stride width (160 = 4 * 40) the float cost takes K4, but
    the uint8 cost takes K1 -> K2 at every geometry and tail, as in the JAX
    package (its fused tails build the float cost)."""
    calls = []

    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"the u8 path reached {name}")
        return fn

    low_maps = gif_pipeline.low_maps
    monkeypatch.setattr(gif_pipeline, "cvc_low_maps", refuse("K4"))
    monkeypatch.setattr(gif_pipeline, "cvc_wta", refuse("K10"))
    monkeypatch.setattr(gif_pipeline, "low_maps",
                        lambda *a: calls.append("K1") or low_maps(*a))
    left, right = crop[160]
    for fusion in ("maps", "full"):
        stereo_gif_forward(left, right, GIFConfig(max_dis=16, cvc_dtype="u8",
                                                  tail_fusion=fusion), False, device="cpu")
    assert calls == ["K1", "K1"]


def test_table_mode_without_indexes_runs_exact_mode(crop):
    """Table mode applies only where the caller passes the indexes."""
    left, right = crop[150]
    a = stereo_gif_forward(left, right, GIFConfig(max_dis=16, med_sz=7, wmf_mode="table"),
                           device="cpu")
    b = stereo_gif_forward(left, right, GIFConfig(max_dis=16, med_sz=7), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    lf, rf, wm = _tables(left, right)
    with pytest.raises(ValueError, match="r_findex"):
        stereo_gif_forward(left, right, GIFConfig(max_dis=16, wmf_mode="table"), True, lf,
                           device="cpu")


def test_port_feature_indexes_give_the_jax_result(crop):
    """The port's own clustering (seed 0) feeds the same table mode."""
    left, right = crop[150]
    cfg = GIFConfig(max_dis=16, med_sz=7, wmf_mode="table")
    to_u8 = lambda x: np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)  # noqa: E731
    lf, wm = feature_index_color(to_u8(left), n_feat=128, seed=0)
    rf, _ = feature_index_color(to_u8(right), n_feat=128, seed=0)
    got = stereo_gif_forward(left, right, cfg, True, lf, rf, wm, device="cpu")
    want = stereo_gif_forward(left, right, cfg, True, *_tables(left, right), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.fixture(scope="module")
def staged(crop):
    """DispEst stages of both packages on the 96x150 crop, max_dis 16."""
    left, right = crop[150]
    jcfg = JaxGIFConfig(max_dis=16, med_sz=7)
    jeng, eng = JaxDispEst(jcfg), DispEst(from_jax_config(dataclasses.asdict(jcfg)), "cpu")
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    out = {"port": {}, "jax": {}}
    out["port"]["cvc"] = eng.cost_const(left, right)
    out["jax"]["cvc"] = jeng.cost_const(jl, jr)
    out["port"]["cvf"] = eng.cost_filter(left, out["port"]["cvc"][0])
    out["jax"]["cvf"] = jeng.cost_filter(jl, out["jax"]["cvc"][0])
    out["port"]["wta"] = eng.disp_select(out["port"]["cvf"])
    out["jax"]["wta"] = jeng.disp_select(out["jax"]["cvf"])
    out["port"]["pp"] = eng.post_process(out["port"]["wta"], left)
    out["jax"]["pp"] = jeng.post_process(out["jax"]["wta"], jl)
    out["port"]["compute"] = eng.compute(left, right)
    out["jax"]["compute"] = jeng.compute(jl, jr)
    return eng, out, left


def test_dispest_stages_match_jax(staged):
    """cost_const at the CVC bound (1e-6), cost_filter at the FGF maps'
    bound (atol 2e-4, rtol 1e-3; 1.9e-4 measured), disp_select
    bitwise on the same filtered volume, post_process on the same WTA
    output within the JointWMF tie class (1e-3), compute within the
    pipeline bound (2e-3)."""
    eng, out, left = staged
    p, j = out["port"], out["jax"]
    for g, w in zip(p["cvc"], j["cvc"]):
        assert g.shape == (16, 96, 150) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    # the real costs' flat windows (colour variance ~ eps) amplify the box
    # sums' rounding, which XLA orders otherwise: the FGF maps' bound
    np.testing.assert_allclose(p["cvf"].numpy(), np.asarray(j["cvf"]), atol=2e-4, rtol=1e-3)
    np.testing.assert_array_equal(eng.disp_select(_t(np.asarray(j["cvf"]))).numpy(),
                                  np.asarray(j["wta"]))
    assert (p["wta"].numpy() != np.asarray(j["wta"])).mean() <= 2e-3
    pp = eng.post_process(_t(np.asarray(j["wta"])), left).numpy()
    assert pp.dtype == np.uint8 and (pp != np.asarray(j["pp"])).mean() <= 1e-3
    assert _mismatch(p["compute"], j["compute"]) <= 2e-3


def test_dispest_compute_is_the_forward(crop):
    """The staged engine gives the fused forward's result (argmin ties of
    the two filter routes aside, the pipeline bound 2e-3)."""
    left, right = crop[160]
    cfg = GIFConfig(max_dis=16, med_sz=7)
    got = DispEst(cfg, device="cpu").compute(left, right)
    want = stereo_gif_forward(left, right, cfg, device="cpu")
    assert _mismatch(got, [w.numpy() for w in want]) <= 2e-3


def test_dump_cost_volume_round_trips(staged, tmp_path):
    """Every slice as `{prefix}{d:03d}.png`, rint(v * 255) clipped, read
    back by the port's PNG reader; equal to the JAX engine's dump."""
    eng, out, _ = staged
    cv = out["port"]["cvc"][0][:5]
    paths = eng.dump_cost_volume(cv, str(tmp_path / "l_"))
    assert paths == [str(tmp_path / f"l_{d:03d}.png") for d in range(5)]
    want = np.clip(np.rint(cv.numpy() * 255.0), 0, 255).astype(np.uint8)
    jpaths = JaxDispEst(JaxGIFConfig(max_dis=16)).dump_cost_volume(
        np.asarray(cv.numpy()), str(tmp_path / "jax_"))
    for d, (p, jp) in enumerate(zip(paths, jpaths)):
        np.testing.assert_array_equal(read_png(p, 1), want[d])
        np.testing.assert_array_equal(read_png(p, 1), read_png(jp, 1))


@pytest.mark.slow
def test_variant_bp_constants_are_the_jax_packages():
    """chip_smoke.VARIANT_BP is the JAX package's %BP(nonocc) of each
    variant at Teddy and Cones (table mode with the feature indexes of
    seed 0); the port on the CPU lands within the chip check's 0.3."""
    for name, per in chip_smoke.VARIANT_BP.items():
        s = jax_load(name)
        ps = load_dataset(name)
        for variant, want in per.items():
            kw = chip_smoke.VARIANT_CONFIGS[variant]
            extra = ()
            if variant == "table":
                lf, wm = jax_features(s.left_bgr, seed=0)
                rf, _ = jax_features(s.right_bgr, seed=0)
                extra = (lf, rf, wm)
            ld, _ = jax_forward(jnp.asarray(s.left_f32), jnp.asarray(s.right_f32),
                                JaxGIFConfig(**kw), True, *map(jnp.asarray, extra))
            bp = jax_bp(np.asarray(ld), s.gt, s.scale_factor, 64,
                        mask=s.mask_nonocc).percent_bad_pixels
            assert bp == pytest.approx(want, abs=0.02), (name, variant)
            pld, _ = stereo_gif_forward(ps.left_f32, ps.right_f32, GIFConfig(**kw), True,
                                        *extra, device="cpu")
            from primestereomatch_torch.utils import bad_pixel_metrics
            pbp = bad_pixel_metrics(pld.numpy(), ps.gt, ps.scale_factor, 64,
                                    mask=ps.mask_nonocc).percent_bad_pixels
            assert abs(pbp - want) <= 0.3, (name, variant, pbp)
