"""K3's participation-weight mode (`valid`) on the planes its unit path takes,
on the CPU: the plain version against the JAX op and the TPU kernel
(interpret mode), and the kernel's block counters (`unit_plane_blocks`,
`bin_window_passes` and `range_window_passes`, with and without `valid`)
against a numpy brute force. The CUDA kernel
itself is held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from primestereomatch_tpu.kernels.wmf_pallas import joint_wmf_pallas
from primestereomatch_tpu.ops.jointwmf import joint_wmf as jax_joint_wmf
from primestereomatch_torch import kernels as K
from primestereomatch_torch.kernels.wmf import (
    NB,
    TILE_H,
    TILE_W,
    bin_window_passes,
    range_window_passes,
    unit_plane_blocks,
)

NEAR_ONE = (0.99999994, 1.0000001, -0.0)


def _plane(kind: str, shape, r: int, rng) -> np.ndarray:
    """'zero_halos': ones with r zero rows at both ends (a row tile's global
    edges, as the mesh makes them); 'ones'; 'mixed': the zero-halo plane
    with 8x8 squares of fractions on a checkerboard and single values near
    1 (and -0) in the unit squares."""
    v = np.ones(shape, np.float32)
    if kind == "ones":
        return v
    v[:, :r] = 0.0
    v[:, -r:] = 0.0
    if kind == "mixed":
        yy, xx = np.meshgrid(np.arange(shape[1]) // 8, np.arange(shape[2]) // 8, indexing="ij")
        square = np.broadcast_to((yy + xx) % 2 == 1, shape)
        v = np.where(square, rng.random(shape, dtype=np.float32), v)
        for value in NEAR_ONE:
            at = tuple(rng.integers(0, n, 6) for n in shape)
            v[at] = np.where(square[at], v[at], np.float32(value))
    return v


@pytest.mark.parametrize("kind", ["zero_halos", "ones", "mixed"])
@pytest.mark.parametrize("shape,r,n_bins", [((2, 28, 36), 4, 32), ((1, 30, 44), 3, 256)],
                         ids=["r4_32bins", "r3_256bins"])
def test_valid_mode_plain_matches_jax_on_unit_path_planes(kind, shape, r, n_bins):
    """The plain valid mode, view by view, is the JAX op's bits and within
    the TPU kernel's last-ulp tie budget (1e-3 of pixels, as
    tests/test_torch_parallel.py holds it); a plane of ones gives the
    valid-less medians."""
    rng = np.random.default_rng(len(kind) * r)
    disp = rng.integers(0, n_bins, shape, dtype=np.uint8)
    guide = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    valid = _plane(kind, shape, r, rng)
    got = K.weighted_median(torch.from_numpy(disp), torch.from_numpy(guide), r, n_bins,
                            valid=torch.from_numpy(valid)).numpy()
    for b in range(shape[0]):
        args = (jnp.asarray(disp[b]), jnp.asarray(guide[b]))
        want = np.asarray(jax_joint_wmf(*args, radius=r, n_bins=n_bins,
                                        valid=jnp.asarray(valid[b])))
        np.testing.assert_array_equal(got[b], want)
        pallas = np.asarray(joint_wmf_pallas(*args, radius=r, n_bins=n_bins,
                                             valid=jnp.asarray(valid[b]), interpret=True))
        assert float((got[b] != pallas).mean()) <= 1e-3
    if kind == "ones":
        less = K.weighted_median(torch.from_numpy(disp), torch.from_numpy(guide), r, n_bins)
        np.testing.assert_array_equal(got, less.numpy())


def _haloed_tiles(shape, r):
    """(b, ty, tx, rows, cols) of every block's haloed tile, clipped to the
    image, as the kernel's grid covers (B, H, W)."""
    B, H, W = shape
    for b in range(B):
        for ty in range(-(-H // TILE_H)):
            for tx in range(-(-W // TILE_W)):
                y0, x0 = ty * TILE_H, tx * TILE_W
                yield (b, ty, tx, slice(max(y0 - r, 0), min(y0 + TILE_H + r, H)),
                       slice(max(x0 - r, 0), min(x0 + TILE_W + r, W)))


def _grid(shape):
    return (shape[0], -(-shape[1] // TILE_H), -(-shape[2] // TILE_W))


# (shape, radius): whole tiles, ragged sides, a halo wider than a tile, radius 0
COUNTER_CASES = [((1, 40, 96), 9), ((2, 37, 101), 9), ((1, 60, 150), 17), ((2, 19, 45), 0)]


@pytest.mark.parametrize("shape,r", COUNTER_CASES, ids=lambda c: str(c))
def test_unit_plane_blocks_matches_brute_force(shape, r):
    """A block takes the unit path iff every plane value of its haloed tile
    inside the image is exactly 0 or 1: -0 counts, 0.99999994, 1.0000001,
    a subnormal and NaN do not. The values other than 0 and 1 lie in the
    top-left corner, so blocks far from it take the unit path."""
    rng = np.random.default_rng(shape[1] * 7 + r)
    B, H, W = shape
    valid = np.where(rng.random(shape) < 0.5, 0.0, 1.0).astype(np.float32)
    odd = (-0.0, 0.99999994, 1.0000001, 1e-40, np.nan, 0.5)
    for i, value in enumerate(odd):
        n = 1 + i % 2
        valid[rng.integers(0, B, n), rng.integers(0, H // 3, n), rng.integers(0, W // 4, n)] = \
            np.float32(value)
    want = np.zeros(_grid(shape), bool)
    for b, ty, tx, rows, cols in _haloed_tiles(shape, r):
        t = valid[b, rows, cols]
        want[b, ty, tx] = bool(((t == 0) | (t == 1)).all())
    got = unit_plane_blocks(torch.from_numpy(valid), r).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def _sparse_levels(shape, rng) -> np.ndarray:
    """Disparities whose 8 x 16 cells each draw from 1, 2, 40, 64, 65 or 129
    levels of 0-255: haloed tiles whose distinct levels take 1 to 4 rank
    windows, over ranges that take up to 4."""
    B, H, W = shape
    disp = np.empty(shape, np.uint8)
    counts = (1, 2, 40, 64, 65, 129)
    for b in range(B):
        for i, y in enumerate(range(0, H, 8)):
            for j, x in enumerate(range(0, W, 16)):
                levels = rng.choice(256, counts[(i + 2 * j + b) % len(counts)], replace=False)
                block = disp[b, y:y + 8, x:x + 16]
                block[...] = rng.choice(levels, block.shape)
    return disp


# the range count on full-range disparities (the ids of its first cases);
# the ranked count on sparse levels, with and without a plane
PASS_CASES = ([pytest.param(s, r, "range", True, id=f"{s}-{r}") for s, r in COUNTER_CASES]
              + [pytest.param(s, r, "ranked", v, id=f"ranked-{'' if v else 'no_'}valid-{s}-{r}")
                 for s, r in COUNTER_CASES for v in (True, False)])


@pytest.mark.parametrize("shape,r,count,with_valid", PASS_CASES)
def test_bin_window_passes_with_valid_matches_brute_force(shape, r, count, with_valid):
    """The kernel's passes a block: `range_window_passes`, one per window of
    NB bins between the least and greatest binned disparity of the haloed
    tile; `bin_window_passes`, one per window of NB of the distinct binned
    disparities it holds (the ranks); each one more where there are
    several. A pixel of weight 0 lies in no bin window, like one with
    d >= n_bins. The ranked count is never above the range count."""
    rng = np.random.default_rng(shape[2] + r + len(count))
    n_bins = 200
    if count == "range":
        disp = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        disp = _sparse_levels(shape, rng)
    valid = rng.random(shape, dtype=np.float32)
    valid[rng.random(shape) < 0.3] = 0.0
    valid[:, : shape[1] * 3 // 5, : shape[2] * 3 // 4] = 0.0    # whole tiles of weight 0
    if not with_valid:
        valid = np.ones(shape, np.float32)
    want = np.zeros(_grid(shape), np.int64)
    for b, ty, tx, rows, cols in _haloed_tiles(shape, r):
        d = disp[b, rows, cols][(disp[b, rows, cols] < n_bins) & (valid[b, rows, cols] != 0)]
        if d.size:
            n = ((int(d.max()) - int(d.min())) // NB + 1 if count == "range"
                 else -(-np.unique(d).size // NB))
            want[b, ty, tx] = n + (n > 1)
    counter = range_window_passes if count == "range" else bin_window_passes
    plane = torch.from_numpy(valid) if with_valid else None
    got = counter(torch.from_numpy(disp), r, n_bins, plane)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any() >= with_valid
    ranked = bin_window_passes(torch.from_numpy(disp), r, n_bins, plane).numpy()
    spans = range_window_passes(torch.from_numpy(disp), r, n_bins, plane).numpy()
    assert (ranked <= spans).all()
    assert (want > 2).any() if count == "range" else (ranked < spans).any()
    if with_valid:
        # without a plane, the weight-0 pixels count again
        assert (counter(torch.from_numpy(disp), r, n_bins).numpy() >= want).all()
