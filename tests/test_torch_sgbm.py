"""The port's STEREO_SGBM slice held against the JAX package on the CPU: the
plain versions of K6-K9 against the JAX ops, the NumPy oracle
(tests/oracle_sgbm.py) and the Pallas kernels in interpret mode, and the
pipeline end to end. Tolerance: exact equality everywhere (every stage is
integer). The CUDA kernels are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses
import hashlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import tests.oracle_sgbm as oracle
from primestereomatch_tpu.config import SGBMConfig as JaxSGBMConfig
from primestereomatch_tpu.kernels.select_pallas import select_disparity_partials_pallas
from primestereomatch_tpu.kernels.sgbm_pallas import (
    bt_block_cost_pallas,
    sgbm_aggregate_partials_pallas,
)
from primestereomatch_tpu.kernels.speckle_pallas import segmin_sweep_pallas
from primestereomatch_tpu.models.sgbm_pipeline import sgbm_display_u8 as jax_display
from primestereomatch_tpu.models.sgbm_pipeline import stereo_sgbm_forward as jax_forward
from primestereomatch_tpu.ops import sgbm as jops
from primestereomatch_tpu.utils import load_dataset as jax_load
from primestereomatch_torch import (
    SGBMConfig,
    StereoSGBM,
    from_jax_sgbm_config,
    kernels as K,
    sgbm_display_u8,
    stereo_sgbm_forward,
)
from primestereomatch_torch.ops import sgbm as ops

CAP = 63


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pair():
    """tests/test_sgbm.py's pair: 16x24, right = left shifted ~3 px + noise."""
    rng = np.random.default_rng(7)
    left = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    right = np.clip(right.astype(np.int32) + rng.integers(-6, 7, right.shape), 0, 255)
    return left, right.astype(np.uint8)


def _features(seed, H, W, C=3, cap=CAP):
    rng = np.random.default_rng(seed)
    img = [rng.integers(0, 256, (H, W, C), dtype=np.uint8) for _ in range(2)]
    return [oracle.sobel_xclip(i, cap).astype(np.int32) for i in img]


def test_sobel_xclip(pair):
    for img in pair:
        got = ops.sobel_xclip(_t(img), CAP)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jops.sobel_xclip(jnp.asarray(img),
                                                                              CAP)))
        np.testing.assert_array_equal(got.numpy(), oracle.sobel_xclip(img, CAP))


@pytest.mark.parametrize("D", [8, 24])
@pytest.mark.parametrize("k", [3, 5])
def test_bt_block_cost_matches_jax_and_pallas(D, k):
    lf, rf = _features(D + k, 20, 30)
    bound = k * k * 3 * 2 * CAP
    got = ops.bt_block_cost(_t(lf), _t(rf), D, k, bound)
    want = np.asarray(jops.bt_block_cost(jnp.asarray(lf), jnp.asarray(rf), D, k,
                                         cost_bound=bound, feat_bound=2 * CAP))
    assert got.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)
    dhw = ops.bt_block_cost(_t(lf), _t(rf), D, k, bound, out_layout="dhw")
    np.testing.assert_array_equal(dhw.permute(1, 2, 0).numpy(), want)
    pallas = np.asarray(bt_block_cost_pallas(jnp.asarray(lf), jnp.asarray(rf), D, k,
                                             cost_bound=bound, interpret=True))
    np.testing.assert_array_equal(dhw.numpy(), pallas[:, :20, :30])
    # the kernel wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(K.bt_cost(_t(lf), _t(rf), D, k, bound).numpy(), want)


@pytest.mark.parametrize("k,C,cap", [(11, 3, CAP), (5, 3, 100), (4, 1, CAP)])
def test_bt_block_cost_wide_ranges(k, C, cap):
    """The ranges the TPU kernel leaves to XLA: a cost bound >= 2**15 (int32
    out), features above 127, one channel, an even window."""
    lf, rf = _features(k + C, 18, 26, C, cap)
    bound = k * k * C * 2 * cap
    got = ops.bt_block_cost(_t(lf), _t(rf), 12, k, bound)
    want = np.asarray(jops.bt_block_cost(jnp.asarray(lf), jnp.asarray(rf), 12, k,
                                         cost_bound=bound, feat_bound=2 * cap))
    assert got.numpy().dtype == want.dtype == (np.int16 if bound < 2**15 else np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy().astype(np.int64), oracle.block_cost(oracle.bt_cost(lf, rf, 12), k))


@pytest.mark.parametrize("nd", [3, 5, 8])
def test_aggregate_matches_jax_and_pallas(nd):
    rng = np.random.default_rng(nd)
    H, W, D, bound = 26, 44, 16, 9450
    C = rng.integers(0, bound, (H, W, D)).astype(np.int32)
    got = ops.aggregate(_t(C).to(torch.int16), 600, 2400, nd)
    assert got.dtype == torch.int32
    want = np.asarray(jops.aggregate(jnp.asarray(C), 600, 2400, nd, cost_bound=bound))
    np.testing.assert_array_equal(got.numpy(), want)
    parts = sgbm_aggregate_partials_pallas(jnp.asarray(C), 600, 2400, nd, cost_bound=bound,
                                           interpret=True)
    S = sum(np.asarray(q)[:H, :, :W].astype(np.int64) for q in parts)
    np.testing.assert_array_equal(got.permute(0, 2, 1).numpy(), S)
    np.testing.assert_array_equal(K.sgbm_aggregate(_t(C), 600, 2400, nd).numpy(), want)


@pytest.mark.parametrize("nd", [3, 5, 8])
def test_aggregate_partials_match_jax_and_pallas(nd):
    """K7's main-path entry on the CPU: two uint16 group partials (the plain
    version; at D = 16 the path families' groups), each below 2**16 by the
    bound, whose sum is the JAX `aggregate` and the sum of the Pallas
    kernel's partials."""
    rng = np.random.default_rng(nd + 40)
    H, W, D, bound = 22, 36, 16, 9450
    C = rng.integers(0, bound + 1, (H, W, D)).astype(np.int32)
    C[3:9, 5:20] = bound                      # L reaches cost_bound + p2 somewhere
    cost = _t(C).to(torch.int16)
    parts = K.sgbm_aggregate_partials(cost, 600, 2400, nd, bound)
    assert len(parts) == 2 and all(q.dtype == torch.uint16 and q.shape == cost.shape
                                   for q in parts)
    plain = K.sgbm_aggregate_partials_plain(cost, 600, 2400, nd, bound)
    assert all(torch.equal(a, b) for a, b in zip(parts, plain))
    g = {8: 4, 5: 4, 3: 2}[nd]
    assert max(int(q.int().max()) for q in parts) <= g * (bound + 2400) < 2**16
    S = sum(q.int() for q in parts)
    want = np.asarray(jops.aggregate(jnp.asarray(C), 600, 2400, nd, cost_bound=bound))
    np.testing.assert_array_equal(S.numpy(), want)
    np.testing.assert_array_equal(S.numpy(), ops.aggregate(cost, 600, 2400, nd).numpy())
    jparts = sgbm_aggregate_partials_pallas(jnp.asarray(C), 600, 2400, nd, cost_bound=bound,
                                            interpret=True)
    Sj = sum(np.asarray(q)[:H, :, :W].astype(np.int64) for q in jparts)
    np.testing.assert_array_equal(S.permute(0, 2, 1).numpy(), Sj)


@pytest.mark.parametrize("route", ["sweeps", "paths"])
@pytest.mark.parametrize("nd", [3, 5, 8])
def test_partial_groups_follow_the_bound(nd, route):
    """uint16 partials exactly where g * (cost_bound + p2) < 2**16 for the
    largest group of directions of the route, a sweep's (4 of 8, 4 of 5, 2
    of 3) or the path families' (4 of 8, 3 of 5, 2 of 3); the int32 S beyond
    it, for an int32 cost and without a bound."""
    g = {"sweeps": {8: 4, 5: 4, 3: 2}, "paths": {8: 4, 5: 3, 3: 2}}[route][nd]
    edge = (2**16 - 1) // g
    for bound in (0, 100, 9450, 16000, 2**15 - 1, 2**15, 40000):
        for p2 in (0, 96, 2400, edge - bound, edge - bound + 1, 2**16):
            if p2 < 0:
                continue
            groups = K.partial_groups(nd, bound, p2, torch.int16, route)
            assert (groups is not None) == (g * (bound + p2) < 2**16), (bound, p2)
            if groups is not None:
                dirs = [d for grp in groups for d in grp]
                assert len(groups) == 2 and len(set(dirs)) == len(dirs) == nd
                assert max(len(grp) for grp in groups) == g
                if route == "sweeps":
                    # the top-down sweep, then the bottom-up one: no
                    # direction of the first walks up, none of the second
                    # down
                    assert not any(rev for _, _, rev in groups[0])
                    assert all(rev for _, _, rev in groups[1])
    assert K.partial_groups(nd, None, 2400, torch.int16, route) is None
    assert K.partial_groups(nd, 9450, 2400, torch.int32, route) is None


@pytest.mark.parametrize("nd", [3, 5, 8])
def test_sweeps_take_only_what_their_16_bit_halves_hold(nd):
    """The sweeps step two disparities to a 32-bit word, 16 bits each: over a
    grid of cost bounds and penalties (negative ones, P1 = P2, P1 > P2, and
    the largest P2 the groups admit), the route sends a cost to the sweeps
    only where no half can carry: no penalty negative, every L (at most
    cost_bound + P2) and BIG + P1 below 2**16 with the P1 the step takes,
    BIG above every L, minL + P2 in a half, the costs past D (a step adds
    0 to P2 to them) at or above every L and below 2**16 after a step, and
    every group's sum below 2**16; elsewhere to the path families or the
    int32 S. A P1 above P2, which the step takes as P2, leaves every plain
    group as it was."""
    from primestereomatch_torch.kernels import sgbm_scan

    half = sgbm_scan.HALF
    assert half == 2**16
    g = {8: 4, 5: 4, 3: 2}[nd]
    cost = torch.empty((1, 1600, 256), dtype=torch.int16)
    assert sgbm_scan.takes_sweeps(1600, 256)
    taken = set()
    for bound in (0, 100, 9450, 16000, 2**15 - 1):
        edge = (half - 1) // g - bound
        for p2 in (-1, 0, 96, 2400, edge, edge + 1, 40000):
            for p1 in (-1, 0, 8, p2 - 1, p2, p2 + 1, 5000, 40000, 2**16):
                r = sgbm_scan.route(cost, nd, bound, p1, p2)
                groups = K.partial_groups(nd, bound, p2, torch.int16)
                if r != "sweeps":
                    assert r in ("paths", "int32")
                    assert groups is None or not sgbm_scan.halves_hold(bound, p1, p2)
                    continue
                q1 = sgbm_scan.sweep_p1(p1, p2)
                big, pad_cost = sgbm_scan.pads(p1, p2)
                lmax = bound + p2
                assert q1 == min(p1, p2) and min(p1, p2, bound) >= 0
                assert lmax + q1 < half and big + q1 < half and lmax < big
                assert lmax + p2 < half and lmax <= pad_cost and pad_cost + p2 < half
                assert all(len(grp) * lmax < half for grp in groups)
                taken.add(("p1>p2" if p1 > p2 else "p1=p2" if p1 == p2 else "p1<p2",
                           p2 == edge))
    assert {("p1>p2", True), ("p1=p2", True), ("p1<p2", True), ("p1>p2", False)} <= taken
    assert sgbm_scan.route(cost, nd, 9450, 600, 2400) == "sweeps"
    assert sgbm_scan.route(cost, nd, 9450, -1, 2400) == "paths"
    rng = np.random.default_rng(nd)
    small = _t(rng.integers(0, 9451, (6, 9, 20))).to(torch.int16)
    groups = sgbm_scan._GROUPS[nd]
    for p1, p2 in ((5000, 2400), (2400, 600), (40000, 0)):
        q1 = sgbm_scan.sweep_p1(p1, p2)
        assert all(torch.equal(a, b) for a, b in zip(
            sgbm_scan.sum_groups_plain(small, p1, p2, groups),
            sgbm_scan.sum_groups_plain(small, q1, p2, groups)))


@pytest.mark.parametrize("route,cost_itemsize,want", [
    ("sweeps", 2, {3: 8, 5: 8, 8: 8}), ("paths", 2, {3: 14, 5: 26, 8: 44}),
    ("int32", 2, {3: 26, 5: 46, 8: 76}), ("int32", 4, {3: 32, 5: 56, 8: 92})])
def test_scan_bytes_per_value_by_route(route, cost_itemsize, want):
    """K7 moves per (pixel, d) what its passes read and write: on the
    sweeps the cost and a uint16 partial each, 8 bytes; on the path
    families the cost and the sums each pass (44 bytes for 8 directions
    into the uint16 partials, 76 into the int32 S), the first pass into a
    tensor only writing them."""
    from primestereomatch_torch.kernels import sgbm_scan

    for nd in (3, 5, 8):
        assert sgbm_scan.bytes_per_value(nd, cost_itemsize, route) == want[nd]


@pytest.mark.parametrize("W,D", [(13, 200), (1599, 256), (1600, 256), (1600, 128),
                                 (1600, 129), (1600, 257)])
def test_partials_route_by_disparities(W, D):
    """The sweeps' groups (top-down, bottom-up) at 128 < D <= 256 and W >=
    1600 (on a card, where it holds them), else the path families' (rows and
    columns, the two diagonals): either pair sums to the JAX aggregate, and
    each route counts its own kernel's bytes."""
    from primestereomatch_torch.kernels import sgbm_scan

    rng = np.random.default_rng(W + D)
    H, bound = 2, 9450
    C = rng.integers(0, bound + 1, (H, W, D)).astype(np.int32)
    cost = _t(C).to(torch.int16)
    route = sgbm_scan.route(cost, 8, bound, 600, 2400)
    assert route == ("sweeps" if 128 < D <= 256 and W >= 1600 else "paths")
    assert sgbm_scan.takes_sweeps(W, D) == (route == "sweeps")
    groups = K.partial_groups(8, bound, 2400, torch.int16, route)
    assert groups == (sgbm_scan._GROUPS if route == "sweeps" else sgbm_scan._PATH_GROUPS)[8]
    parts = K.sgbm_aggregate_partials(cost, 600, 2400, 8, bound)
    assert all(torch.equal(a, b) for a, b in zip(parts, sgbm_scan.sum_groups_plain(
        cost, 600, 2400, groups)))
    want = np.asarray(jops.aggregate(jnp.asarray(C), 600, 2400, 8, cost_bound=bound))
    np.testing.assert_array_equal(sum(q.int() for q in parts).numpy(), want)
    assert sgbm_scan.bytes_per_value(8, 2, route) == (8 if route == "sweeps" else 44)


@pytest.mark.parametrize("why", ["p2_beyond_the_bound", "int32_cost", "no_bound"])
def test_aggregate_partials_fall_back_to_int32(why):
    rng = np.random.default_rng(8)
    C = _t(rng.integers(0, 9451, (14, 20, 8)).astype(np.int32))
    cost = C if why == "int32_cost" else C.to(torch.int16)
    p2 = 2**16 if why == "p2_beyond_the_bound" else 2400
    bound = None if why == "no_bound" else 9450
    parts = K.sgbm_aggregate_partials(cost, 600, p2, 8, bound)
    assert len(parts) == 1 and parts[0].dtype == torch.int32
    want = np.asarray(jops.aggregate(jnp.asarray(C.numpy()), 600, p2, 8))
    np.testing.assert_array_equal(parts[0].numpy(), want)
    np.testing.assert_array_equal(K.select_disparity_partials(parts, 10, 1).numpy(),
                                  K.select_disparity(parts[0], 10, 1).numpy())


@pytest.mark.parametrize("nd", [3, 5, 8])
def test_aggregate_matches_oracle(pair, nd):
    lf, rf = (oracle.sobel_xclip(i, CAP) for i in pair)
    C = oracle.block_cost(oracle.bt_cost(lf, rf, 8), 5)
    got = ops.aggregate(_t(C.astype(np.int32)), 24, 96, nd)
    np.testing.assert_array_equal(got.numpy(), oracle.aggregate(C, 24, 96, nd))


def _random_S(seed, H=20, W=96, D=16):
    return np.random.default_rng(seed).integers(0, 5000, (H, W, D)).astype(np.int32)


@pytest.mark.parametrize("min_d", [-3, 0, 3, 7])
@pytest.mark.parametrize("uniq,d12", [(0, -1), (0, 0), (0, 1), (10, -1), (10, 0), (10, 1)])
def test_select_matches_jax(min_d, uniq, d12):
    S = _random_S(21 + min_d)
    got = ops.select_disparity_hdw(_t(S.transpose(0, 2, 1)), uniq, d12, min_d)
    assert got.dtype == torch.int16
    want = np.asarray(jops.select_disparity_hdw(jnp.asarray(S.transpose(0, 2, 1)), uniq, d12,
                                                min_d))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.select_disparity(jnp.asarray(S), uniq, d12, min_d)))
    np.testing.assert_array_equal(K.select_disparity(_t(S), uniq, d12, min_d).numpy(), want)


@pytest.mark.parametrize("min_d", [-20, -3, 0, 7])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_select_partials_equals_select_of_sum(min_d, n_parts):
    """K8's main-path entry on the CPU: the selection on one or two uint16
    partials is the selection on their int32 sum, which is the JAX op's."""
    rng = np.random.default_rng(30 + min_d + n_parts)
    parts = tuple(_t(rng.integers(0, 47400, (18, 80, 16)).astype(np.uint16))
                  for _ in range(n_parts))
    S = sum(q.int() for q in parts)
    got = K.select_disparity_partials(parts, 10, 1, min_d)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), K.select_disparity(S, 10, 1, min_d).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.select_disparity(jnp.asarray(S.numpy()), 10, 1, min_d)))
    if min_d >= 0:
        jparts = tuple(jnp.asarray(q.numpy().transpose(0, 2, 1)) for q in parts)
        pallas = select_disparity_partials_pallas(jparts, (18, 80), 10, 1, min_d,
                                                  interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("min_d,uniq,d12", [(0, 10, 1), (0, 0, -1), (3, 10, 1), (7, 10, 0)])
def test_select_matches_pallas(min_d, uniq, d12):
    """Both TPU select kernels (two-pass, and one-pass with a value bound)
    where they run: min_disparity >= 0."""
    S = _random_S(5 + min_d, H=18, W=80)
    got = ops.select_disparity_hdw(_t(S.transpose(0, 2, 1)), uniq, d12, min_d).numpy()
    part = (jnp.asarray(S.transpose(0, 2, 1)),)
    for vb in (None, 5000):
        pallas = select_disparity_partials_pallas(part, (18, 80), uniq, d12, min_d,
                                                  value_bound=vb, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(pallas))


def test_select_far_negative_min_disparity_follows_oracle():
    """min_disparity = -20 (< -D): left pixels with x < d_best scatter to
    right pixels in the image. The port keeps them as the oracle and the
    JAX package's `select_disparity` do."""
    S = _random_S(21)
    for d12 in (1, 0):
        got = ops.select_disparity_hdw(_t(S.transpose(0, 2, 1)), 10, d12, -20).numpy()
        np.testing.assert_array_equal(got, oracle.select_disparity(S.astype(np.int64), 10, d12,
                                                                   -20))
        np.testing.assert_array_equal(got, np.asarray(jops.select_disparity(jnp.asarray(S), 10,
                                                                            d12, -20)))


def test_select_degenerate_tiles():
    """A constant winner everywhere, and a flat volume where nothing is
    unique (no scatter candidates at all)."""
    H, W, D = 16, 80, 8
    d_idx = np.arange(D)[None, None, :]
    for S in (np.broadcast_to(np.abs(d_idx - 3) * 1000 + 10, (H, W, D)),
              np.full((H, W, D), 100)):
        S = np.ascontiguousarray(S, dtype=np.int32)
        got = ops.select_disparity_hdw(_t(S.transpose(0, 2, 1)), 10, 1, 0).numpy()
        want = np.asarray(jops.select_disparity_hdw(jnp.asarray(S.transpose(0, 2, 1)), 10, 1, 0))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, oracle.select_disparity(S.astype(np.int64), 10, 1, 0))
    assert (got == -16).all()


@pytest.mark.parametrize("H,W", [(24, 40), (17, 150), (130, 33)])
def test_segmin_sweep_plain_matches_pallas(H, W):
    rng = np.random.default_rng(H * W)
    m = rng.integers(0, H * W, (H, W)).astype(np.int32)
    conn_lf = rng.random((H, W)) < 0.7
    conn_lf[:, 0] = False
    conn_up = rng.random((H, W)) < 0.7
    conn_up[0] = False
    for axis, conn in ((1, conn_lf), (0, conn_up)):
        got = K.segmin_sweep(_t(m), _t(conn.astype(np.uint8)), axis)
        want = segmin_sweep_pallas(jnp.asarray(m), jnp.asarray(conn), axis=axis, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_sweep(m, links):
    """The JAX package's sweep (ops/sgbm.py::filter_speckles' hook, then
    segmin_sweep_pallas in interpret mode on rows and columns) on numpy
    labels and a packed link mask."""
    H, W = m.shape
    big = H * W
    lbl = jnp.asarray(m)
    conn_up, conn_dn, conn_lf, conn_rt = (jnp.asarray((links & b) != 0) for b in (1, 2, 4, 8))
    col = lbl[:1] * 0 + big
    row = lbl[:, :1] * 0 + big
    up = jnp.concatenate([col, lbl[:-1]], axis=0)
    dn = jnp.concatenate([lbl[1:], col], axis=0)
    lf = jnp.concatenate([row, lbl[:, :-1]], axis=1)
    rt = jnp.concatenate([lbl[:, 1:], row], axis=1)
    h = lbl
    for c, nb in ((conn_up, up), (conn_dn, dn), (conn_lf, lf), (conn_rt, rt)):
        h = jnp.minimum(h, jnp.where(c, nb, big))
    h = segmin_sweep_pallas(h, conn_lf, axis=1, interpret=True)
    return np.asarray(segmin_sweep_pallas(h, conn_up, axis=0, interpret=True))


@pytest.mark.parametrize("H,W", [(24, 40), (17, 150), (130, 33), (1, 70)])
@pytest.mark.parametrize("kind", ["random", "from_disparities"])
def test_speckle_sweep_plain_matches_jax(H, W, kind):
    """One sweep, hook included, exactly the JAX package's; the changed flag
    takes the stamp iff a label moved."""
    rng = np.random.default_rng(H * W + len(kind))
    if kind == "random":
        m = rng.integers(0, H * W + 1, (H, W)).astype(np.int32)
        links = rng.integers(0, 16, (H, W)).astype(np.uint8)
    else:
        d = (rng.integers(0, 3, (H, W)) * 16).astype(np.int16)
        d[rng.random((H, W)) < 0.2] = -16
        _, lab, conns = ops.speckle_graph(_t(d), 16, -16)
        m, links = lab.numpy(), K.pack_links(*conns).numpy()
    changed = torch.zeros(1, dtype=torch.int32)
    got = K.speckle_sweep(_t(m), _t(links), changed, 5).numpy()
    np.testing.assert_array_equal(got, _jax_sweep(m, links))
    np.testing.assert_array_equal(K.speckle_sweep_plain(_t(m), _t(links)).numpy(), got)
    assert (int(changed[0]) == 5) == bool((got != m).any())


def test_hook_as_torch_ops_is_the_plain_hook():
    """chip_smoke.py's timing of the hook as the plain-torch ops it was
    computes what the sweep's hook computes, on a real link graph."""
    rng = np.random.default_rng(3)
    d = (rng.integers(0, 3, (30, 41)) * 16).astype(np.int16)
    d[rng.random((30, 41)) < 0.2] = -16
    _, labels, conns = ops.speckle_graph(_t(d), 16, -16)
    assert torch.equal(chip_smoke.hook_as_torch_ops(labels, conns),
                       K.speckle.hook_plain(labels, K.pack_links(*conns)))


def test_speckle_inputs_on_the_cpu(pair):
    """chip_smoke.py's speckle start: the filter's labels and links of the
    pipeline's disparities."""
    cfg = SGBMConfig(num_disparities=8, speckle_window_size=10)
    labels, links, conns = chip_smoke.speckle_inputs(cfg, _t(pair[0]), _t(pair[1]))
    assert labels.shape == pair[0].shape[:2] and links.dtype == torch.uint8
    assert torch.equal(links, K.pack_links(*conns))


def _serpentine(H=32, W=32):
    d = np.full((H, W), -16, np.int16)
    d[0::2] = 160
    for i, y in enumerate(range(1, H - 1, 2)):
        d[y, W - 1 if i % 2 == 0 else 0] = 160
    return d


def test_filter_speckles_matches_jax_and_oracle():
    rng = np.random.default_rng(7)
    d = (rng.integers(0, 6, (48, 64)) * 48).astype(np.int16)
    d[rng.random((48, 64)) < 0.3] = -16
    want = oracle.filter_speckles(d, 24, 32, -16)
    np.testing.assert_array_equal(np.asarray(jops.filter_speckles(jnp.asarray(d), 24, 32, -16)),
                                  want)
    for spc in (1, 2, 3):
        got = ops.filter_speckles(_t(d), 24, 32, -16, steps_per_check=spc)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), want)


def test_filter_speckles_serpentine():
    """One 527-pixel component whose path bends 31 times: it converges
    without a cap and survives; with `max_iters` the sweeps stop where the
    JAX op's do."""
    d = _serpentine()
    got = ops.filter_speckles(_t(d), 400, 32, -16).numpy()
    np.testing.assert_array_equal(got, oracle.filter_speckles(d, 400, 32, -16))
    assert (got != -16).sum() == 527
    for cap in (2, 6):
        got = ops.filter_speckles(_t(d), 400, 32, -16, max_iters=cap).numpy()
        want = jops.filter_speckles(jnp.asarray(d), 400, 32, -16, max_iters=cap)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("spc", [1, 2, 3])
@pytest.mark.parametrize("cap", [None, 2, 6])
@pytest.mark.parametrize("kind", ["serpentine", "random"])
def test_filter_speckles_caps_and_checks(spc, cap, kind):
    """Every steps_per_check and max_iters cap gives the JAX op's output
    exactly (and, run to convergence, the oracle's)."""
    if kind == "serpentine":
        d, size = _serpentine(), 400
    else:
        rng = np.random.default_rng(spc)
        d = (rng.integers(0, 4, (40, 56)) * 40).astype(np.int16)
        d[rng.random((40, 56)) < 0.25] = -16
        size = 12
    got = ops.filter_speckles(_t(d), size, 32, -16, max_iters=cap, steps_per_check=spc).numpy()
    want = np.asarray(jops.filter_speckles(jnp.asarray(d), size, 32, -16, max_iters=cap,
                                           steps_per_check=spc))
    np.testing.assert_array_equal(got, want)
    if cap is None:
        np.testing.assert_array_equal(got, oracle.filter_speckles(d, size, 32, -16))


@pytest.mark.parametrize("mode", ["hh", "sgbm", "3way"])
def test_forward_matches_jax_and_oracle(pair, mode):
    kw = dict(num_disparities=8, block_size=5, p1=24, p2=96, speckle_window_size=10,
              speckle_range=2, mode=mode)
    got = stereo_sgbm_forward(*pair, SGBMConfig(**kw), device="cpu")
    assert got.dtype == torch.int16 and got.shape == pair[0].shape[:2]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_forward(*map(jnp.asarray, pair), JaxSGBMConfig(**kw))))
    lf, rf = (oracle.sobel_xclip(i, CAP) for i in pair)
    S = oracle.aggregate(oracle.block_cost(oracle.bt_cost(lf, rf, 8), 5), 24, 96,
                         SGBMConfig(**kw).num_directions)
    want = oracle.filter_speckles(oracle.select_disparity(S, 10, 1, 0), 10, 32, -16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["hh", "sgbm", "3way"])
def test_forward_partials_route_equals_the_int32_route(pair, mode):
    """The pipeline goes through the partials entries; its output is that of
    the same stages through the int32 S, and a P2 beyond the uint16 bound
    (the int32 fallback inside the partials entry) still equals JAX."""
    cfg = SGBMConfig(num_disparities=8, p1=24, p2=96, speckle_window_size=10, mode=mode)
    got = stereo_sgbm_forward(*pair, cfg, device="cpu")
    lf, rf = (ops.sobel_xclip(_t(i), CAP) for i in pair)
    bound = 25 * 3 * 2 * CAP
    cost = K.bt_cost(lf, rf, 8, 5, bound)
    assert K.partial_groups(cfg.num_directions, bound, cfg.p2) is not None
    S = K.sgbm_aggregate(cost, cfg.p1, cfg.p2, cfg.num_directions)
    want = ops.filter_speckles(K.select_disparity(S, 10, 1, 0), 10, 32, -16)
    assert torch.equal(got, want)
    kw = dict(num_disparities=8, p1=24, p2=2**16, speckle_window_size=10, mode=mode)
    assert K.partial_groups(cfg.num_directions, bound, 2**16) is None
    wide = stereo_sgbm_forward(*pair, SGBMConfig(**kw), device="cpu")
    np.testing.assert_array_equal(
        wide.numpy(), np.asarray(jax_forward(*map(jnp.asarray, pair), JaxSGBMConfig(**kw))))


@pytest.mark.parametrize("mode,min_d", [("hh", 0), ("3way", 4)])
def test_teddy_crop_matches_jax(mode, min_d):
    s = jax_load("Teddy")
    left = np.ascontiguousarray(s.left_bgr[120:216, 150:310])
    right = np.ascontiguousarray(s.right_bgr[120:216, 150:310])
    kw = dict(num_disparities=16, mode=mode, min_disparity=min_d)
    got = stereo_sgbm_forward(left, right, SGBMConfig(**kw), device="cpu")
    want = np.asarray(jax_forward(jnp.asarray(left), jnp.asarray(right), JaxSGBMConfig(**kw)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_teddy_default_matches_jax_and_chip_constants():
    """Full Teddy with SGBMConfig(): the port equals JAX bit for bit, and
    JAX's Teddy and Cones outputs hash to the constants chip_smoke.py holds
    the card's outputs to."""
    outs = {}
    for name in ("Teddy", "Cones"):
        s = jax_load(name)
        outs[name] = np.asarray(jax_forward(jnp.asarray(s.left_bgr), jnp.asarray(s.right_bgr),
                                            JaxSGBMConfig()))
        assert hashlib.sha256(outs[name].tobytes()).hexdigest() == chip_smoke.SGBM_SHA256[name]
    s = jax_load("Teddy")
    got = stereo_sgbm_forward(s.left_bgr, s.right_bgr, SGBMConfig(), device="cpu")
    np.testing.assert_array_equal(got.numpy(), outs["Teddy"])


@pytest.mark.parametrize("mode", ["canonical", "reference"])
def test_display_matches_jax(mode):
    rng = np.random.default_rng(5)
    for sf in (1, 3, 4):
        d16 = rng.integers(-16, 64 * 16, (37, 53)).astype(np.int16)
        got = sgbm_display_u8(_t(d16), sf, 64, mode=mode)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_display(jnp.asarray(d16), sf, 64, mode)))


@pytest.mark.parametrize("jax_cfg", [
    JaxSGBMConfig(),
    JaxSGBMConfig(mode="3way", num_disparities=24, min_disparity=-3, agg_impl="xla",
                  speckle_window_size=0),
], ids=["default", "3way_d24"])
def test_from_jax_sgbm_config_round_trips(jax_cfg):
    cfg = from_jax_sgbm_config(dataclasses.asdict(jax_cfg))
    want = {k: v for k, v in dataclasses.asdict(jax_cfg).items() if k != "agg_impl"}
    assert dataclasses.asdict(cfg) == want
    assert cfg.num_directions == jax_cfg.num_directions


@pytest.mark.parametrize("fields", [
    {"agg_impl": "cuda"}, {"agg_impl": None}, {"block_sz": 5}, {"mode": "full"},
], ids=["agg_impl", "agg_impl_none", "unknown_key", "mode"])
def test_sgbm_config_rejections(fields):
    with pytest.raises(ValueError):
        from_jax_sgbm_config({**dataclasses.asdict(JaxSGBMConfig()), **fields})


def test_forward_rejects_bad_input(pair):
    left, right = pair
    with pytest.raises(TypeError):
        stereo_sgbm_forward(left.astype(np.float32), right.astype(np.float32), device="cpu")
    with pytest.raises(TypeError):
        stereo_sgbm_forward(left[..., 0], right[..., 0], device="cpu")     # (H, W)
    with pytest.raises(ValueError):
        stereo_sgbm_forward(left, right[:, :-1], device="cpu")
    with pytest.raises(ValueError):
        stereo_sgbm_forward(left[..., :1], right[..., :1], device="cpu")   # 1 channel, cfg 3


def test_forward_without_device_needs_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stereo_sgbm_forward(*pair)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StereoSGBM()


def test_module_matches_function(pair):
    cfg = SGBMConfig(num_disparities=8, p1=24, p2=96, speckle_window_size=10)
    a = StereoSGBM(cfg, device="cpu")(*pair)
    assert torch.equal(a, stereo_sgbm_forward(*pair, cfg, device="cpu"))


def test_sgbm_wrappers_reject_what_the_kernels_do_not_take():
    f = torch.zeros((8, 12, 3), dtype=torch.int32)
    S = torch.zeros((8, 12, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        K.bt_cost(f.float(), f, 4, 3)
    with pytest.raises(ValueError):
        K.bt_cost(f, f[:, :-1], 4, 3)
    with pytest.raises(ValueError):
        K.bt_cost(f, f, 0, 3)
    with pytest.raises(TypeError):
        K.sgbm_aggregate(S.float(), 8, 32)
    with pytest.raises(ValueError):
        K.sgbm_aggregate(S, 8, 32, num_directions=4)
    with pytest.raises(TypeError):
        K.select_disparity(S.to(torch.int16), 10, 1)
    with pytest.raises(ValueError):
        K.select_disparity(S[0], 10, 1)
    with pytest.raises(TypeError):
        K.sgbm_aggregate_partials(S.float(), 8, 32, 8, 100)
    with pytest.raises(ValueError):
        K.sgbm_aggregate_partials(S, 8, 32, 4, 100)
    u16 = S.to(torch.uint16)
    with pytest.raises(ValueError):
        K.select_disparity_partials((u16, u16, u16), 10, 1)
    with pytest.raises(ValueError):
        K.select_disparity_partials((u16, u16[:, :-1]), 10, 1)
    with pytest.raises(TypeError):
        K.select_disparity_partials((u16, S), 10, 1)
    with pytest.raises(TypeError):
        K.select_disparity_partials((S.to(torch.int16),), 10, 1)
    with pytest.raises(TypeError):
        K.segmin_sweep(S[..., 0], S[..., 0], 1)
    with pytest.raises(ValueError):
        K.segmin_sweep(S[..., 0], S[..., 0].to(torch.uint8), 2)
    links = S[..., 0].to(torch.uint8)
    with pytest.raises(TypeError):
        K.speckle_sweep(S[..., 0], S[..., 0], None)
    with pytest.raises(ValueError):
        K.speckle_sweep(S[..., 0], links[:, :-1])
    with pytest.raises(ValueError):
        K.speckle_sweep(S[..., 0], links, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        K.speckle_sweep(S[..., 0], links, torch.zeros(1, dtype=torch.int64))
