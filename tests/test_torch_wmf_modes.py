"""JointWMF's table mode, its `valid` mask, the float-input path and the
host feature clustering of the port against the JAX package's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from primestereomatch_tpu.ops import jointwmf as jw
from primestereomatch_tpu.utils import features as jfeat
from primestereomatch_tpu.utils import load_dataset as jax_load
from primestereomatch_torch.ops import jointwmf as pw
from primestereomatch_torch.utils import features as pfeat


@pytest.fixture(scope="module")
def teddy_bgr():
    return jax_load("Teddy").left_bgr


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, n_bins):
    """The JointWMF tie class: XLA adds the cumulative weights in another
    order than bin by bin, so at most 1e-3 of the medians may move, by one
    occupied bin."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got != want).mean() <= 1e-3
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert got.max() < n_bins


@pytest.mark.parametrize("crop", [(100, 164, 100, 164), (0, 40, 380, 450)])
def test_feature_index_color_is_bitwise_jax(teddy_bgr, crop):
    """k-means++ over the unique 6-bit colours (seed 0): the same indexes
    and weight table as the JAX package's copy."""
    y0, y1, x0, x1 = crop
    g = np.ascontiguousarray(teddy_bgr[y0:y1, x0:x1])
    fi, wm = pfeat.feature_index_color(g, n_feat=64, seed=0)
    jfi, jwm = jfeat.feature_index_color(g, n_feat=64, seed=0)
    assert fi.dtype == np.int32 and wm.dtype == np.float32
    np.testing.assert_array_equal(fi, jfi)
    np.testing.assert_array_equal(wm, jwm)


def test_feature_index_color_few_colours_is_lossless():
    rng = np.random.default_rng(42)
    palette = rng.integers(0, 256, (8, 3), dtype=np.uint8)
    guide = palette[rng.integers(0, 8, (32, 40))]
    fi, wm = pfeat.feature_index_color(guide)
    jfi, jwm = jfeat.feature_index_color(guide)
    np.testing.assert_array_equal(fi, jfi)
    np.testing.assert_array_equal(wm, jwm)
    assert wm.shape == (len(np.unique(fi)),) * 2


@pytest.mark.parametrize("op", pfeat.WEIGHT_OPS)
def test_weight_ops_are_bitwise_jax(op):
    """All six wMap ops, on the 1-channel table and on colour centres."""
    np.testing.assert_array_equal(pfeat.feature_index_gray(weight_type=op),
                                  jfeat.feature_index_gray(weight_type=op))
    centers = np.random.default_rng(5).integers(0, 64, (24, 3)).astype(np.float32)
    np.testing.assert_array_equal(pfeat.weight_table(centers, 6.375, op),
                                  jfeat.weight_table(centers, 6.375, op))


def test_feature_weight_table_is_bitwise_jax():
    np.testing.assert_array_equal(pw.feature_weight_table(64, 9.0),
                                  jw.feature_weight_table(64, 9.0))


@pytest.mark.parametrize("radius,n_bins", [(4, 16), (9, 64)])
def test_table_mode_matches_jax(teddy_bgr, radius, n_bins):
    """Table mode (findex, wmap from the port's clustering) against the JAX
    op fed the same tables, within the tie class."""
    H, W = (32, 48) if radius == 4 else (48, 64)
    g = np.ascontiguousarray(teddy_bgr[150:150 + H, 200:200 + W])
    fi, wm = pfeat.feature_index_color(g, n_feat=128, seed=0)
    disp = np.random.default_rng(radius).integers(0, n_bins, (H, W), dtype=np.uint8)
    got = pw.joint_wmf(_t(disp), radius=radius, n_bins=n_bins, findex=_t(fi), wmap=_t(wm))
    want = jw.joint_wmf(jnp.asarray(disp), radius=radius, n_bins=n_bins,
                        findex=jnp.asarray(fi), wmap=jnp.asarray(wm))
    _close(got.numpy(), want, n_bins)


@pytest.mark.parametrize("mode", ["exact", "table"])
def test_valid_mask_matches_jax(teddy_bgr, mode):
    """A participation mask (0, 1 and a fractional weight) in both modes;
    masked-out neighbours add nothing, as out-of-image ones."""
    H, W, radius, n_bins = 30, 44, 5, 24
    rng = np.random.default_rng(9)
    g = np.ascontiguousarray(teddy_bgr[60:60 + H, 90:90 + W])
    disp = rng.integers(0, n_bins, (H, W), dtype=np.uint8)
    valid = (rng.random((H, W)) < 0.7).astype(np.float32)
    valid[5:9, 10:20] = 0.5
    kw = dict(radius=radius, n_bins=n_bins)
    if mode == "table":
        fi, wm = pfeat.feature_index_color(g, n_feat=64, seed=0)
        got = pw.joint_wmf(_t(disp), findex=_t(fi), wmap=_t(wm), valid=_t(valid), **kw)
        want = jw.joint_wmf(jnp.asarray(disp), findex=jnp.asarray(fi), wmap=jnp.asarray(wm),
                            valid=jnp.asarray(valid), **kw)
    else:
        got = pw.joint_wmf(_t(disp), _t(g), valid=_t(valid), **kw)
        want = jw.joint_wmf(jnp.asarray(disp), jnp.asarray(g), valid=jnp.asarray(valid), **kw)
    _close(got.numpy(), want, n_bins)
    # an all-ones mask is no mask
    ones = pw.joint_wmf(_t(disp), _t(g), valid=torch.ones(H, W), **kw)
    assert torch.equal(ones, pw.joint_wmf(_t(disp), _t(g), **kw))


def test_table_mode_needs_both_tables():
    disp = torch.zeros(8, 8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="findex and wmap"):
        pw.joint_wmf(disp, findex=torch.zeros(8, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="guide_u8"):
        pw.joint_wmf(disp)


@pytest.mark.parametrize("n_levels", [16, 64, 256])
def test_from32f_to_32s_is_bitwise_jax(n_levels):
    """The adaptive quantiser's indexes, level values and count, and the
    map back, equal the JAX package's."""
    rng = np.random.default_rng(n_levels)
    img = (rng.random((23, 31)) * 40.0).astype(np.float32)
    img[3:6, 4:9] = 7.25                                 # a run of equal values
    got = pw.from32f_to_32s(img, n_levels)
    want = jw.from32f_to_32s(img, n_levels)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2] <= n_levels
    np.testing.assert_array_equal(pw.from32s_to_32f(got[0], got[1]),
                                  jw.from32s_to_32f(want[0], want[1]))


def test_from32f_to_32s_constant_image():
    img = np.full((5, 7), 3.25, np.float32)
    idx, mapping, n_used = pw.from32f_to_32s(img, 16)
    want = jw.from32f_to_32s(img, 16)
    assert n_used == want[2] == 1 and np.all(idx == 0) and mapping[0] == np.float32(3.25)
    np.testing.assert_array_equal(idx, want[0])
    np.testing.assert_array_equal(mapping, want[1])


@pytest.mark.parametrize("mode", ["exact", "table"])
def test_joint_wmf_float_matches_jax(teddy_bgr, mode):
    """The float path (quantise, filter the levels, map back) against the
    JAX package's on a float disparity map, within the tie class; exact
    mode goes through K3's wrapper, which takes its plain version here."""
    H, W, radius, n_levels = 24, 30, 3, 32
    rng = np.random.default_rng(4)
    g = np.ascontiguousarray(teddy_bgr[:H, :W])
    disp = (rng.random((H, W)) * 20.0).astype(np.float32)
    kw = dict(radius=radius, n_levels=n_levels)
    if mode == "table":
        fi, wm = pfeat.feature_index_color(g, n_feat=64, seed=0)
        got = pw.joint_wmf_float(disp, findex=_t(fi), wmap=_t(wm), device="cpu", **kw)
        want = jw.joint_wmf_float(disp, findex=jnp.asarray(fi), wmap=jnp.asarray(wm), **kw)
    else:
        got = pw.joint_wmf_float(disp, _t(g), device="cpu", **kw)
        want = jw.joint_wmf_float(disp, jnp.asarray(g), **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = np.asarray(want)
    assert (got.numpy() != want).mean() <= 1e-3
    levels = pw.from32f_to_32s(disp, n_levels)[1]
    assert np.isin(got.numpy(), levels).all()


def test_joint_wmf_float_of_integral_values_is_the_integer_filter(teddy_bgr):
    """Integral values get a level each, so the float path equals the
    integer filter; a tensor input keeps its device."""
    guide = np.ascontiguousarray(teddy_bgr[:24, :30])
    disp = np.random.default_rng(2).integers(0, 16, (24, 30), dtype=np.uint8)
    want = pw.joint_wmf(_t(disp), _t(guide), radius=3, n_bins=16)
    got = pw.joint_wmf_float(_t(disp.astype(np.float32)), _t(guide), radius=3, n_levels=16)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want.numpy().astype(np.float32))
