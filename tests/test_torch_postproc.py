"""The port's post-processing toolchain (ops/postproc.py) against the JAX
package's ops and the reference oracle, on seeded inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from primestereomatch_tpu.ops import postproc as jpp
from primestereomatch_tpu.utils import load_dataset as jax_load
from primestereomatch_torch.ops import postproc


@pytest.fixture(scope="module")
def teddy_f32():
    return jax_load("Teddy").left_f32


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("H,W,n", [(17, 33, 16), (9, 64, 64), (4, 5, 8)])
def test_lr_check_is_bitwise_jax(H, W, n):
    """The LR check (lookups wrapped mod W) equals the JAX op and the
    oracle bit for bit, disparities beyond the width included."""
    rng = np.random.default_rng(H * W)
    ld = rng.integers(0, n, size=(H, W), dtype=np.uint8)
    rd = rng.integers(0, n, size=(H, W), dtype=np.uint8)
    got = postproc.lr_check(_t(ld), _t(rd))
    want = jpp.lr_check(jnp.asarray(ld), jnp.asarray(rd))
    for g, w, o in zip(got, want, oracle.lr_check_oracle(ld, rd)):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), o)


@pytest.mark.parametrize("share", [0.6, 0.05, 1.0])
def test_fill_invalid_is_bitwise_jax(share):
    """Invalid pixels take min(nearest valid left, right) or the one that
    exists; a row with none keeps its values. Bitwise the JAX op's two
    associative scans and the oracle's while-walks."""
    rng = np.random.default_rng(int(share * 100))
    H, W = 11, 29
    dis = rng.integers(0, 16, size=(H, W), dtype=np.uint8)
    valid = (rng.random((H, W)) < share).astype(np.uint8)
    valid[3] = 0                    # a fully invalid row
    valid[5, :4] = 0                # a run at the row start
    got = postproc.fill_invalid(_t(dis), _t(valid))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpp.fill_invalid(jnp.asarray(dis), jnp.asarray(valid))))
    np.testing.assert_array_equal(got.numpy(), oracle.fill_inv_oracle(dis, valid))


@pytest.mark.parametrize("use_sqrt", [False, True])
def test_weighted_median_is_bitwise_jax_and_oracle(teddy_f32, use_sqrt):
    """At the JAX package's oracle size (16 x 18, 12 bins, 7 x 7 window)
    the port's median equals the JAX op's and the oracle's bit for bit:
    there no cumulative weight lands within rounding of its half total."""
    rng = np.random.default_rng(7 + use_sqrt)
    H, W = 16, 18
    img = np.ascontiguousarray(teddy_f32[:H, :W])
    dis = rng.integers(0, 12, size=(H, W), dtype=np.uint8)
    valid = (rng.random((H, W)) < 0.5).astype(np.uint8)
    got = postproc.weighted_median(_t(img), _t(dis), _t(valid), 12, 7, use_sqrt=use_sqrt)
    want = jpp.weighted_median(jnp.asarray(img), jnp.asarray(dis), jnp.asarray(valid),
                               max_dis=12, med_sz=7, use_sqrt=use_sqrt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), oracle.wgt_median_oracle(img, dis, valid, max_dis=12, med_sz=7,
                                              use_sqrt=use_sqrt))


@pytest.mark.parametrize("use_sqrt", [False, True])
def test_weighted_median_matches_jax_at_its_window(teddy_f32, use_sqrt):
    """At the reference's 19 x 19 window, 64 bins, on a 48 x 64 crop: XLA
    sums the cumulative weights in another order than bin by bin, so a
    median may move where a cumulative sum lies within rounding of half the
    total (the JointWMF tie class: at most 1e-3 of the pixels). Valid
    pixels and disparity 0 come through unchanged."""
    rng = np.random.default_rng(11 + use_sqrt)
    H, W = 48, 64
    img = np.ascontiguousarray(teddy_f32[100:100 + H, 120:120 + W])
    dis = rng.integers(0, 64, size=(H, W), dtype=np.uint8)
    valid = (rng.random((H, W)) < 0.4).astype(np.uint8)
    got = postproc.weighted_median(_t(img), _t(dis), _t(valid), 64, 19, 0.1, 9.0,
                                   use_sqrt=use_sqrt).numpy()
    want = np.asarray(jpp.weighted_median(jnp.asarray(img), jnp.asarray(dis),
                                          jnp.asarray(valid), 64, 19, 0.1, 9.0,
                                          use_sqrt=use_sqrt))
    assert (got != want).mean() <= 1e-3
    np.testing.assert_array_equal(got[valid == 1], dis[valid == 1])


def test_ops_take_leading_batch_axes():
    """lr_check and fill_invalid work on (B, H, W) stacks row by row."""
    rng = np.random.default_rng(3)
    ld = rng.integers(0, 12, size=(3, 7, 21), dtype=np.uint8)
    rd = rng.integers(0, 12, size=(3, 7, 21), dtype=np.uint8)
    lv, rv = postproc.lr_check(_t(ld), _t(rd))
    filled = postproc.fill_invalid(_t(ld), lv)
    for b in range(3):
        one = postproc.lr_check(_t(ld[b]), _t(rd[b]))
        assert torch.equal(lv[b], one[0]) and torch.equal(rv[b], one[1])
        assert torch.equal(filled[b], postproc.fill_invalid(_t(ld[b]), one[0]))
