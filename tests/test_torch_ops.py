"""The port's plain ops, dataset loader and evaluation held against the JAX
package on the same numpy-seeded inputs (JAX on the CPU, torch on the CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from primestereomatch_tpu.ops import boxfilter as jbox
from primestereomatch_tpu.ops import color as jcolor
from primestereomatch_tpu.ops import cost_volume as jcv
from primestereomatch_tpu.ops import resize as jresize
from primestereomatch_tpu.ops import wta as jwta
from primestereomatch_tpu.utils import datasets as jdata
from primestereomatch_tpu.utils import eval as jeval
from primestereomatch_torch.ops import boxfilter, color, cost_volume, resize, wta
from primestereomatch_torch.utils import datasets, eval as teval


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("src,dst", [
    (112, 450), (552, 2208), (93, 375), (310, 1242), (375, 93), (450, 112),
    (160, 40), (7, 3), (5, 17), (96, 192),
])
def test_resize_tables_match_jax(src, dst):
    np.testing.assert_array_equal(resize.nearest_indices(src, dst),
                                  jresize.nearest_indices(src, dst))
    si, sf = resize.linear_coeffs(src, dst)
    ji, jf = jresize.linear_coeffs(src, dst)
    np.testing.assert_array_equal(si, ji)
    assert sf.dtype == jf.dtype == np.float32
    np.testing.assert_array_equal(sf, jf)


def test_device_tables_are_uploaded_once():
    """The index and weight tables of a geometry are made once per device
    and reused, and hold the host tables' values."""
    cpu = torch.device("cpu")
    lo, hi, f = resize.linear_tables(112, 450, cpu)
    assert all(a is b for a, b in zip((lo, hi, f), resize.linear_tables(112, 450, cpu)))
    si, sf = jresize.linear_coeffs(112, 450)
    np.testing.assert_array_equal(lo.numpy(), si)
    np.testing.assert_array_equal(hi.numpy(), np.minimum(si + 1, 111))
    np.testing.assert_array_equal(f.numpy(), sf)
    assert resize.linear_tables(112, 450, cpu, torch.int32)[0].dtype == torch.int32
    near = resize.nearest_table(450, 112, cpu)
    assert near is resize.nearest_table(450, 112, cpu)
    np.testing.assert_array_equal(near.numpy(), jresize.nearest_indices(450, 112))


@pytest.mark.parametrize("out_hw", [(24, 45), (70, 130)])
def test_resize_ops_match_jax(out_hw):
    x = np.random.default_rng(1).random((3, 35, 64), dtype=np.float32)
    for port, ref in ((resize.resize_nearest, jresize.resize_nearest),
                      (resize.resize_bilinear, jresize.resize_bilinear)):
        np.testing.assert_allclose(port(_t(x), out_hw).numpy(),
                                   np.asarray(ref(jnp.asarray(x), out_hw)), atol=1e-6)


def test_gray_and_sobel_match_jax():
    img = np.random.default_rng(2).random((40, 57, 3), dtype=np.float32)
    g_port = color.bgr_to_gray_refquirk(_t(img))
    g_ref = jcolor.bgr_to_gray_refquirk(jnp.asarray(img))
    np.testing.assert_allclose(g_port.numpy(), np.asarray(g_ref), atol=1e-6)
    np.testing.assert_allclose(color.sobel_x_k1(g_port).numpy(),
                               np.asarray(jcolor.sobel_x_k1(g_ref)), atol=1e-6)


@pytest.mark.parametrize("k", [3, 5, 8, 9])
def test_box_mean_matches_jax(k):
    x = np.random.default_rng(k).random((4, 23, 31), dtype=np.float32)
    np.testing.assert_allclose(boxfilter.box_mean(_t(x), k).numpy(),
                               np.asarray(jbox.box_mean(jnp.asarray(x), k)), atol=1e-6)
    np.testing.assert_allclose(boxfilter.box_sum(_t(x), k).numpy(),
                               np.asarray(jbox.box_sum(jnp.asarray(x), k)), atol=1e-5)


@pytest.mark.parametrize("H,W,s", [(48, 90, 4), (40, 128, 4)], ids=["quasi", "exact"])
@pytest.mark.parametrize("tau", [(None, None), (0.3, 0.05)], ids=["noclamp", "tau"])
def test_cost_volume_sampled_matches_jax(H, W, s, tau):
    rng = np.random.default_rng(H + W)
    l_img, r_img = (rng.random((H, W, 3), dtype=np.float32) for _ in range(2))
    l_grd, r_grd = (rng.random((H, W), dtype=np.float32) - 0.5 for _ in range(2))
    yi = jresize.nearest_indices(H, H // s)
    xi = jresize.nearest_indices(W, W // s)
    kw = dict(alpha=0.9, border_cost=1.0, tau1=tau[0], tau2=tau[1])
    ref = jcv.build_cost_volumes_sampled(*map(jnp.asarray, (l_img, r_img, l_grd, r_grd)),
                                         40, yi, xi, **kw)
    got = cost_volume.build_cost_volumes_sampled(*map(_t, (l_img, r_img, l_grd, r_grd)),
                                                 40, yi, xi, **kw)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (40, H // s, W // s)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def test_wta_disparity_matches_jax():
    cv = np.random.default_rng(3).random((12, 20, 30), dtype=np.float32)
    cv[5, :4] = cv[3, :4] = -1.0    # exact ties resolve to the lower d
    np.testing.assert_array_equal(wta.wta_disparity(_t(cv)).numpy(),
                                  np.asarray(jwta.wta_disparity(jnp.asarray(cv))))


@pytest.mark.parametrize("name", sorted(jdata.DATASETS))
def test_dataset_loader_matches_jax(name):
    """The zlib/numpy PNG reader gives the libpng loader's bytes for every
    bundled image, ground truth and mask."""
    ref = jdata.load_dataset(name)
    got = datasets.load_dataset(name)
    for field in ("left_bgr", "right_bgr", "gt", "mask_nonocc", "mask_disc"):
        r, g = getattr(ref, field), getattr(got, field)
        assert (r is None) == (g is None), field
        if r is not None:
            assert g.dtype == r.dtype and g.shape == r.shape, field
            np.testing.assert_array_equal(g, r, err_msg=field)
    assert (got.scale_factor, got.default_mask) == (ref.scale_factor, ref.default_mask)
    np.testing.assert_array_equal(got.left_f32, ref.left_f32)


@pytest.mark.parametrize("mask_is_disc", [False, True])
def test_bad_pixel_metrics_match_jax(mask_is_disc):
    rng = np.random.default_rng(4)
    disp = rng.integers(0, 64, (50, 120), dtype=np.uint8)
    gt = rng.integers(0, 256, (50, 120), dtype=np.uint8)
    mask = rng.choice(np.array([0, 128, 255], np.uint8), (50, 120))
    a = teval.bad_pixel_metrics(disp, gt, 4, 64, mask=mask, mask_is_disc=mask_is_disc)
    b = jeval.bad_pixel_metrics(disp, gt, 4, 64, mask=mask, mask_is_disc=mask_is_disc)
    assert (a.percent_bad_pixels, a.avg_err, a.num_bad_pixels) == \
        (b.percent_bad_pixels, b.avg_err, b.num_bad_pixels)
    np.testing.assert_array_equal(a.err_map, b.err_map)
