"""The port's calibration, rectification and depth (`primestereomatch_torch.
calib`, `ops/remap.py`, `ops/depth.py`) and the SGBM ops it adds, against
the JAX package on the CPU, on the same NumPy inputs made from a seed.

The host solvers are NumPy in both packages and must agree exactly. The
remap, the maps, the Rectifier and depth must be bitwise equal to the JAX
package's eager calls (the JAX app calls the Rectifier eagerly; under
jax.jit XLA contracts the blend into FMAs). The slice as a whole (raw
frames -> Rectifier -> STEREO_GIF or STEREO_SGBM -> depth) is held at
384x216 and 320x180 with the shipped ZED HD720 calibration: rectified frames
bitwise, GIF disparities within the WTA tie class, SGBM bitwise."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import port_helpers
import tests.oracle_sgbm as oracle
from primestereomatch_tpu import calib as jcalib
from primestereomatch_tpu.calib import calibrate as jcal
from primestereomatch_tpu.calib import chessboard as jcb
from primestereomatch_tpu.calib import distortion as jdist
from primestereomatch_tpu.calib import uncalibrated as junc
from primestereomatch_tpu.calib.ymlio import read_imagelist as jax_read_imagelist
from primestereomatch_tpu.config import GIFConfig as JaxGIFConfig
from primestereomatch_tpu.config import SGBMConfig as JaxSGBMConfig
from primestereomatch_tpu.models import stereo_gif_forward as jax_gif
from primestereomatch_tpu.models import stereo_sgbm_forward as jax_sgbm
from primestereomatch_tpu.ops import boxfilter as jbox
from primestereomatch_tpu.ops import depth as jdepth
from primestereomatch_tpu.ops import sgbm as jops
from primestereomatch_tpu.ops.remap import remap_bilinear as jax_remap
from primestereomatch_torch import calib, from_jax_config, from_jax_sgbm_config
from primestereomatch_torch import stereo_gif_forward, stereo_sgbm_forward
from primestereomatch_torch.calib import calibrate as tcal
from primestereomatch_torch.calib import chessboard as tcb
from primestereomatch_torch.calib import distortion as tdist
from primestereomatch_torch.calib import uncalibrated as tunc
from primestereomatch_torch.calib.ymlio import read_imagelist
from primestereomatch_torch.models import gif_pipeline
from primestereomatch_torch.ops import (
    block_cost,
    clipped_xderiv,
    disparity_to_depth,
    remap_bilinear,
    reproject_disparity,
    select_disparity,
    window_sum_1d,
)
from primestereomatch_torch.utils.datasets import data_root
from tests.test_calibrate import D_ZERO, IMG, K_TRUE, PATTERN, _poses, _render

HD720 = (1280, 720)    # the shipped YMLs' per-eye size


@pytest.fixture(scope="module")
def cal():
    root = data_root()
    return calib.load_stereo_calibration(str(root / "intrinsics.yml"),
                                         str(root / "extrinsics.yml"))


def _same_rect(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=f.name)


# ---- ymlio -------------------------------------------------------------------

def test_yml_read_and_roundtrip_equal_jax(cal, tmp_path):
    """Both shipped YMLs read alike; a file written by either package is
    byte-identical and reads back unchanged in both."""
    root = data_root()
    for name in ("intrinsics.yml", "extrinsics.yml"):
        a = calib.read_opencv_yml(str(root / name))
        b = jcalib.read_opencv_yml(str(root / name))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert cal["D1"].shape == (1, 14) and cal["T"].shape == (3, 1)
    entries = {"M1": cal["M1"], "D1": cal["D1"], "n": 3, "f": np.float32([[1.5, -2.25]])}
    calib.write_opencv_yml(str(tmp_path / "port.yml"), entries)
    jcalib.write_opencv_yml(str(tmp_path / "jax.yml"), entries)
    assert (tmp_path / "port.yml").read_bytes() == (tmp_path / "jax.yml").read_bytes()
    for read in (calib.read_opencv_yml, jcalib.read_opencv_yml):
        back = read(str(tmp_path / "port.yml"))
        for k in ("M1", "D1", "f"):
            np.testing.assert_array_equal(back[k], entries[k])
        assert back["n"] == 3 and back["f"].dtype == np.float32


@pytest.mark.parametrize("text", [
    '<?xml version="1.0"?>\n<opencv_storage>\n<images>\n  a0L.png a0R.png\n'
    "  a1L.png a1R.png</images>\n</opencv_storage>\n",
    '%YAML:1.0\n---\nimages:\n  - "a_L.png"\n  - "a_R.png"\n',
    '%YAML:1.0\n---\nimages: [ "b_L.png", "b_R.png" ]\n',
], ids=["xml", "yml_items", "yml_flow"])
def test_read_imagelist_equals_jax(tmp_path, text):
    p = tmp_path / "list"
    p.write_text(text)
    got = read_imagelist(str(p))
    assert got == jax_read_imagelist(str(p)) and len(got) in (2, 4)


# ---- distortion --------------------------------------------------------------

@pytest.mark.parametrize("iterations", [5, 40])
def test_distortion_equals_jax(cal, iterations):
    """distort_points / undistort_points (with and without R and P) equal
    the JAX package's, and the inverse model undoes the forward one."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.3, 0.3, (100, 2))
    for D in (cal["D1"], cal["D2"], np.zeros((1, 5))):
        np.testing.assert_array_equal(tdist.distort_points(xy, D), jdist.distort_points(xy, D))
    A, D = cal["M1"], cal["D1"]
    uv = rng.uniform([0, 0], [1279, 719], (7, 9, 2))
    for kw in ({}, {"R": cal["R1"]}, {"R": cal["R1"], "P": cal["P1"]}, {"P": cal["P2"][:, :3]}):
        np.testing.assert_array_equal(
            tdist.undistort_points(uv, A, D, iterations=iterations, **kw),
            jdist.undistort_points(uv, A, D, iterations=iterations, **kw))
    d = tdist.distort_points(xy, D)
    uv = np.stack([A[0, 0] * d[..., 0] + A[0, 2], A[1, 1] * d[..., 1] + A[1, 2]], -1)
    np.testing.assert_allclose(tdist.undistort_points(uv, A, D), xy, atol=2e-5)
    with pytest.raises(NotImplementedError):
        tdist.distort_points(xy, np.r_[np.zeros(12), 0.1, 0.0])


def test_rodrigues_equals_jax_and_roundtrips():
    rng = np.random.default_rng(0)
    vecs = [rng.normal(size=3) * 0.8 for _ in range(10)]
    vecs += [np.zeros(3), np.array([np.pi, 0, 0]), np.array([0, -np.pi + 1e-8, 0]),
             np.array([0.3, 0.4, np.pi - 1e-7]) / np.linalg.norm([0.3, 0.4, np.pi - 1e-7]) * np.pi]
    for v in vecs:
        R = tdist.rodrigues(v)
        np.testing.assert_array_equal(R, jdist.rodrigues(v))
        np.testing.assert_array_equal(tdist.rodrigues(R), jdist.rodrigues(R))
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    for v in vecs[:10]:
        np.testing.assert_allclose(tdist.rodrigues(tdist.rodrigues(v)), v, atol=1e-9)


# ---- rectify -----------------------------------------------------------------

@pytest.mark.parametrize("alpha,zero_disparity", [(1.0, True), (0.0, True), (0.5, False)])
def test_stereo_rectify_equals_jax(cal, alpha, zero_disparity):
    args = (cal["M1"], cal["D1"], cal["M2"], cal["D2"], HD720, cal["R"], cal["T"])
    got = calib.stereo_rectify(*args, alpha=alpha, zero_disparity=zero_disparity)
    _same_rect(got, jcalib.stereo_rectify(*args, alpha=alpha, zero_disparity=zero_disparity))
    assert got.crop_box == jcalib.stereo_rectify(*args, alpha=alpha).crop_box or not zero_disparity


def test_stereo_rectify_matches_golden_and_aligns_rows(cal):
    """The golden R1/R2/P1/P2/Q of data/extrinsics.yml at the JAX test's
    tolerance, the HD720 crop box, and a world point lands on one row in
    both rectified views with a positive disparity."""
    rect = calib.stereo_rectify(cal["M1"], cal["D1"], cal["M2"], cal["D2"], HD720, cal["R"],
                                cal["T"])
    np.testing.assert_allclose(rect.R1, cal["R1"], atol=1e-8)
    np.testing.assert_allclose(rect.R2, cal["R2"], atol=1e-8)
    for k in ("P1", "P2", "Q"):
        np.testing.assert_allclose(getattr(rect, k), cal[k], rtol=3e-4, atol=0.15)
    assert rect.crop_box == (143, 101, 1159, 627)
    rng = np.random.default_rng(1)
    pts = rng.uniform([-1, -1, 3], [1, 1, 8], (50, 3))

    def project(A, D, X):
        d = tdist.distort_points(X[..., :2] / X[..., 2:3], D)
        return np.stack([A[0, 0] * d[..., 0] + A[0, 2], A[1, 1] * d[..., 1] + A[1, 2]], -1)

    uv1 = project(cal["M1"], cal["D1"], pts)
    uv2 = project(cal["M2"], cal["D2"], pts @ cal["R"].T + cal["T"].reshape(3))
    r1 = tdist.undistort_points(uv1, cal["M1"], cal["D1"], R=rect.R1, P=rect.P1, iterations=40)
    r2 = tdist.undistort_points(uv2, cal["M2"], cal["D2"], R=rect.R2, P=rect.P2, iterations=40)
    np.testing.assert_allclose(r1[:, 1], r2[:, 1], atol=0.05)
    assert np.all(r1[:, 0] - r2[:, 0] > 0)


def test_init_undistort_rectify_map_bitwise(cal):
    rect = calib.stereo_rectify(cal["M1"], cal["D1"], cal["M2"], cal["D2"], HD720, cal["R"],
                                cal["T"])
    for A, D, R, P in ((cal["M1"], cal["D1"], rect.R1, rect.P1),
                       (cal["M2"], cal["D2"], rect.R2, rect.P2)):
        got = calib.init_undistort_rectify_map(A, D, R, P, HD720)
        assert got.dtype == np.float32 and got.shape == (720, 1280, 2)
        np.testing.assert_array_equal(got, jcalib.init_undistort_rectify_map(A, D, R, P, HD720))


# ---- remap -------------------------------------------------------------------

def _remap_case(case, cal, rng):
    """(image size (H, W), map (Ho, Wo, 2) float32) of each remap case."""
    gy, gx = np.mgrid[0:10, 0:12].astype(np.float32)
    if case == "identity":
        return (10, 12), np.stack([gx, gy], -1)
    if case == "half_shift":
        return (10, 12), np.stack([gx + 0.5, gy + 0.25], -1)
    if case == "out_of_image":
        xy = rng.uniform(-4, 16, (20, 24, 2)).astype(np.float32)
        xy[:4] = np.round(xy[:4])            # whole-pixel taps on and off the edges
        return (10, 12), xy
    rect = calib.stereo_rectify(cal["M1"], cal["D1"], cal["M2"], cal["D2"], HD720, cal["R"],
                                cal["T"])
    full = calib.init_undistort_rectify_map(cal["M1"], cal["D1"], rect.R1, rect.P1, HD720)
    # the HD720 map at the middle of the crop, and at the frame's corner
    # (taps outside the raw image)
    rows, cols = ((slice(300, 364), slice(600, 664)) if case == "hd720_centre"
                  else (slice(0, 48), slice(0, 64)))
    return (720, 1280), np.ascontiguousarray(full[rows, cols])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("case", ["identity", "half_shift", "out_of_image", "hd720_centre",
                                  "hd720_corner"])
def test_remap_bitwise_jax(cal, case, dtype):
    """remap_bilinear equals the eager JAX op bit for bit on (H, W, 3)
    images, and on (H, W) ones with out-of-image taps."""
    rng = np.random.default_rng(2)
    (H, W), xy = _remap_case(case, cal, rng)
    img = (rng.integers(0, 256, (H, W, 3)) if dtype == np.uint8
           else rng.random((H, W, 3))).astype(dtype)
    images = [img] + ([np.ascontiguousarray(img[..., 2])] if case == "out_of_image" else [])
    for im in images:
        got = remap_bilinear(torch.from_numpy(im), torch.from_numpy(xy)).numpy()
        want = np.asarray(jax_remap(jnp.asarray(im), jnp.asarray(xy)))
        assert got.dtype == want.dtype == dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if case == "identity":
        np.testing.assert_array_equal(got, img)
    if case == "hd720_corner":
        assert (got == 0).any()               # the taps outside the image weigh 0


def test_remap_half_pixel_properties():
    """The JAX test's properties: a half-pixel shift averages neighbours, and
    the last column (half outside) keeps half the intensity."""
    img = np.random.default_rng(0).random((10, 12, 3), dtype=np.float32)
    gy, gx = np.mgrid[0:10, 0:12].astype(np.float32)
    out = remap_bilinear(torch.from_numpy(img),
                         torch.from_numpy(np.stack([gx + 0.5, gy], -1))).numpy()
    np.testing.assert_allclose(out[:, :-1], 0.5 * (img[:, :-1] + img[:, 1:]), atol=1e-6)
    np.testing.assert_allclose(out[:, -1], 0.5 * img[:, -1], atol=1e-6)


# ---- Rectifier ---------------------------------------------------------------

@pytest.mark.parametrize("size,crop_hw", [((384, 216), (156, 304)), ((320, 180), (130, 253))],
                         ids=["384x216", "320x180"])
def test_rectifier_bitwise_jax(cal, size, crop_hw):
    """The Rectifier at calib_size 1280x720: the maps, Q and the crop equal
    the JAX one's, and the rectified pair of uint8 and float32 colour
    frames and of uint8 gray ones (numpy or tensors) equals its eager
    output bit for bit; a frame of another size is refused."""
    port = calib.Rectifier(cal, size, calib_size=HD720, device="cpu")
    ref = jcalib.Rectifier(cal, size, calib_size=HD720)
    _same_rect(port.rect, ref.rect)
    np.testing.assert_array_equal(port.map_l.numpy(), np.asarray(ref.map_l))
    np.testing.assert_array_equal(port.map_r.numpy(), np.asarray(ref.map_r))
    x0, y0, x1, y1 = port.crop
    assert port.crop == ref.crop and (y1 - y0, x1 - x0) == crop_hw
    rng = np.random.default_rng(3)
    w, h = size
    raw = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(2)]
    gray = [np.ascontiguousarray(a[..., 1]) for a in raw]
    for frames in (raw, [a.astype(np.float32) * np.float32(1 / 255.0) for a in raw], gray):
        want = ref(*(jnp.asarray(a) for a in frames))
        for inputs in (frames, [torch.from_numpy(a) for a in frames]):
            got = port(*inputs)
            for g, r in zip(got, want):
                assert g.is_contiguous() and g.dtype == torch.from_numpy(frames[0]).dtype
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(ValueError, match="expected two"):
        port(raw[0][1:], raw[1][1:])


def test_rectifier_needs_a_card_by_default(cal):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calib.Rectifier(cal, (320, 180), calib_size=HD720)


# ---- depth -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16])
def test_depth_bitwise_jax(cal, dtype):
    """disparity_to_depth and reproject_disparity equal the eager JAX ops on
    disparities with zeros, negatives, tiny and large values, at the
    default max_depth (inf) and a finite one with another invalid value."""
    Q = calib.stereo_rectify(cal["M1"], cal["D1"], cal["M2"], cal["D2"], HD720, cal["R"],
                             cal["T"]).Q
    rng = np.random.default_rng(4)
    if dtype == np.float32:
        d = rng.uniform(-8, 300, (37, 53)).astype(np.float32)
        d[0, :6] = [0, -0.0, 1e-30, -1e-3, 1e-5, np.float32(3e-41)]
    else:
        d = rng.integers(-5 if dtype == np.int16 else 0, 256, (37, 53)).astype(dtype)
    t = torch.from_numpy(d)
    np.testing.assert_array_equal(disparity_to_depth(t, Q).numpy(),
                                  np.asarray(jdepth.disparity_to_depth(jnp.asarray(d), Q)))
    np.testing.assert_array_equal(disparity_to_depth(t, Q, invalid_value=-1.0).numpy(),
                                  np.asarray(jdepth.disparity_to_depth(jnp.asarray(d), Q, -1.0)))
    for kw in ({}, {"max_depth": 300.0, "invalid_value": -7.5}):
        got = reproject_disparity(t, Q, **kw).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jdepth.reproject_disparity(jnp.asarray(d), Q, **kw)))
        assert got.dtype == np.float32 and got.shape == (37, 53, 3)


def test_depth_geometry(cal):
    """The JAX test's geometry: Z = f * B / d, X grows along x and Y along y,
    and a zero disparity maps to zeros."""
    Q = calib.stereo_rectify(cal["M1"], cal["D1"], cal["M2"], cal["D2"], HD720, cal["R"],
                             cal["T"]).Q
    disp = torch.full((10, 12), 16.0)
    depth = disparity_to_depth(disp, Q).numpy()
    np.testing.assert_allclose(depth, Q[2, 3] / abs(Q[3, 2]) / 16.0, rtol=1e-5)
    pts = reproject_disparity(disp, Q).numpy()
    np.testing.assert_allclose(pts[..., 2], depth, rtol=1e-5)
    assert np.all(np.diff(pts[0, :, 0]) > 0) and np.all(np.diff(pts[:, 0, 1]) > 0)
    np.testing.assert_array_equal(reproject_disparity(torch.zeros(4, 4), Q).numpy(), 0.0)


# ---- the solvers -------------------------------------------------------------

@pytest.fixture(scope="module")
def views():
    obj = tcal.chessboard_object_points(PATTERN)
    return [(_render(K_TRUE, rv, tv), tcal._project(obj, rv, tv, K_TRUE, D_ZERO), rv, tv)
            for rv, tv in _poses(6)]


def test_find_chessboard_corners_equals_jax(views):
    for img, gt, _, _ in views:
        got = tcb.find_chessboard_corners(img, PATTERN)
        np.testing.assert_array_equal(got, jcb.find_chessboard_corners(img, PATTERN))
        if np.linalg.norm(got[0] - gt[0]) > np.linalg.norm(got[-1] - gt[0]):
            got = got[::-1]
        assert np.linalg.norm(got - gt, axis=1).mean() < 0.5
    img = views[0][0]
    guess = views[0][1] + 0.7
    np.testing.assert_array_equal(tcb.corner_subpix(img, guess), jcb.corner_subpix(img, guess))
    assert tcb.find_chessboard_corners(np.full((240, 320), 128.0), PATTERN) is None


def _same_calibration(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(np.asarray(getattr(a, f.name), dtype=object),
                                      np.asarray(getattr(b, f.name), dtype=object),
                                      err_msg=f.name)


@pytest.mark.parametrize("n_dist", [2, 8])
def test_calibrate_camera_equals_jax(n_dist):
    """Zhang's method on exact projections of a rational lens (n_dist = 8,
    the reference's flags) and of a plain one."""
    d_true = np.zeros((1, 14))
    if n_dist == 8:
        d_true[0, :8] = [0.08, -0.12, 1e-3, -8e-4, 0.02, 0.15, -0.06, 0.01]
    obj = tcal.chessboard_object_points(PATTERN)
    imgs = [tcal._project(obj, rv, tv, K_TRUE, d_true) for rv, tv in _poses(8)]
    np.testing.assert_array_equal(imgs[3], jcal._project(obj, *_poses(8)[3], K_TRUE, d_true))
    got = tcal.calibrate_camera([obj] * 8, imgs, IMG, n_dist=n_dist)
    _same_calibration(got, jcal.calibrate_camera([obj] * 8, imgs, IMG, n_dist=n_dist))
    assert got.rms < 1e-3 and abs(got.K[0, 0] - K_TRUE[0, 0]) < 1.0


def _stereo_observations(views, R_true, T_true, noise):
    obj = tcal.chessboard_object_points(PATTERN)
    rng = np.random.default_rng(0)
    lpts, rpts = [], []
    for _, gl, rv, tv in views:
        gr = tcal._project(obj, tdist.rodrigues(R_true @ tdist.rodrigues(rv)), R_true @ tv + T_true,
                           K_TRUE, D_ZERO)
        lpts.append(gl + rng.normal(0, noise, gl.shape))
        rpts.append(gr + rng.normal(0, noise, gr.shape))
    return [obj] * len(views), lpts, rpts


@pytest.mark.parametrize("fix_intrinsics", [True, False])
def test_stereo_calibrate_equals_jax(views, fix_intrinsics):
    R_true = tdist.rodrigues(np.array([0.0, 0.03, 0.0]))
    objs, lpts, rpts = _stereo_observations(views, R_true, np.array([-2.0, 0.0, 0.05]), 0.05)
    got = tcal.stereo_calibrate(objs, lpts, rpts, IMG, fix_intrinsics=fix_intrinsics)
    want = jcal.stereo_calibrate(objs, lpts, rpts, IMG, fix_intrinsics=fix_intrinsics)
    _same_calibration(got, want)
    assert tcal.epipolar_rms(got, lpts, rpts) == jcal.epipolar_rms(want, lpts, rpts)
    assert got.rms < 0.2


def test_calibrate_stereo_from_images_equals_jax(views, tmp_path):
    """Rendered chessboard pairs -> detection, solve, rectify -> the same
    result and byte-identical YMLs in both packages."""
    R_true = tdist.rodrigues(np.array([0.0, 0.02, 0.0]))
    T_true = np.array([-2.0, 0.0, 0.0])
    lefts = [v[0] for v in views]
    rights = [_render(K_TRUE, tdist.rodrigues(R_true @ tdist.rodrigues(rv)), R_true @ tv + T_true)
              for _, _, rv, tv in views]
    got = calib.calibrate_stereo_from_images(lefts, rights, IMG, out_dir=str(tmp_path / "port"))
    want = jcalib.calibrate_stereo_from_images(lefts, rights, IMG, out_dir=str(tmp_path / "jax"))
    _same_calibration(got.calib, want.calib)
    assert (got.epipolar_rms, got.n_views_used) == (want.epipolar_rms, want.n_views_used)
    assert got.n_views_used >= 3 and abs(got.calib.K1[0, 0] - K_TRUE[0, 0]) < 0.03 * K_TRUE[0, 0]
    for name in ("intrinsics.yml", "extrinsics.yml"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    with pytest.raises(ValueError, match="usable pairs"):
        calib.calibrate_stereo_from_images(lefts[:2], rights[:2], IMG)


def test_stereo_rectify_uncalibrated_equals_jax(views):
    R_true = tdist.rodrigues(np.array([0.01, 0.03, 0.005]))
    _, lpts, rpts = _stereo_observations(views, R_true, np.array([-2.0, 0.05, 0.1]), 0.0)
    p1, p2 = np.concatenate(lpts), np.concatenate(rpts)
    F = tunc.fundamental_8point(p1, p2)
    np.testing.assert_array_equal(F, junc.fundamental_8point(p1, p2))
    H1, H2 = tunc.stereo_rectify_uncalibrated(p1, p2, F, IMG)
    J1, J2 = junc.stereo_rectify_uncalibrated(p1, p2, F, IMG)
    np.testing.assert_array_equal(H1, J1)
    np.testing.assert_array_equal(H2, J2)
    for a, b in zip(tunc.rectify_rotations_from_homographies(H1, H2, K_TRUE, K_TRUE),
                    junc.rectify_rotations_from_homographies(H1, H2, K_TRUE, K_TRUE)):
        np.testing.assert_array_equal(a, b)

    def apply(H, p):
        ph = np.hstack([p, np.ones((len(p), 1))]) @ H.T
        return ph[:, :2] / ph[:, 2:3]

    assert np.abs(apply(H1, p1)[:, 1] - apply(H2, p2)[:, 1]).mean() < 1.0


# ---- the SGBM ops this slice adds --------------------------------------------

CAP = 15


@pytest.fixture(scope="module")
def pair_u8():
    rng = np.random.default_rng(7)
    left = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1) // 2 + rng.integers(0, 128, (24, 40, 3), dtype=np.uint8)
    return left, right


@pytest.mark.parametrize("cap", [CAP, 63])
def test_clipped_xderiv_bitwise(pair_u8, cap):
    for img in pair_u8:
        got = clipped_xderiv(torch.from_numpy(img), cap).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(jops.clipped_xderiv(jnp.asarray(img), cap)))
        np.testing.assert_array_equal(got, oracle.clipped_xderiv(img, cap))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_block_cost_bitwise(pair_u8, k):
    lf, rf = (oracle.clipped_xderiv(i, CAP) for i in pair_u8)
    pix = oracle.bt_cost(lf, rf, 12).astype(np.int32)
    got = block_cost(torch.from_numpy(pix), k).numpy()
    assert got.dtype == np.int32 and got.shape == pix.shape
    np.testing.assert_array_equal(got, np.asarray(jops.block_cost(jnp.asarray(pix), k)))
    np.testing.assert_array_equal(got, oracle.block_cost(pix, k))


@pytest.mark.parametrize("d12", [1, -1, 0])
@pytest.mark.parametrize("min_disparity", [-4, 0, 3])
def test_select_disparity_bitwise(min_disparity, d12):
    """The (H, W, D) selection equals the JAX `select_disparity` and the
    oracle at negative, zero and positive min_disparity."""
    rng = np.random.default_rng(8 + min_disparity)
    S = rng.integers(0, 400, (20, 48, 16)).astype(np.int32)
    S[:, :, 5] -= 150                       # a clear minimum in part of the image
    S[3, :, 9] = S[3, :, 5]                 # ties for the first-minimum rule
    got = select_disparity(torch.from_numpy(S), 10, d12, min_disparity).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(
        got, np.asarray(jops.select_disparity(jnp.asarray(S), 10, d12, min_disparity)))
    np.testing.assert_array_equal(
        got, oracle.select_disparity(S.astype(np.int64), 10, d12, min_disparity))


@pytest.mark.parametrize("engine", ["window", "scan"])
def test_window_sum_1d_equals_jax(engine):
    rng = np.random.default_rng(9)
    xi = rng.integers(-50, 50, (6, 30)).astype(np.int32)
    xf = rng.random((6, 30)).astype(np.float32)
    for axis, k in ((0, 3), (1, 5), (1, 1)):
        np.testing.assert_array_equal(
            window_sum_1d(torch.from_numpy(xi), k, axis, engine).numpy(),
            np.asarray(jbox.window_sum_1d(jnp.asarray(xi), k, axis, engine)))
        np.testing.assert_allclose(
            window_sum_1d(torch.from_numpy(xf), k, axis, engine).numpy(),
            np.asarray(jbox.window_sum_1d(jnp.asarray(xf), k, axis, engine)), atol=1e-5)


# ---- the calibrated slice as a whole -------------------------------------------

def _raw_pair(cal, size, levels):
    """Raw frames (uint8) of the known scene of port_helpers.py through the port's
    Rectifier geometry, and the rectangle of the field in crop coordinates."""
    rec = calib.Rectifier(cal, size, calib_size=HD720, device="cpu")
    scene_l, scene_r, rect = port_helpers.calibrated_scene(rec.crop, size, levels, 5)
    return port_helpers.raw_frames(cal, rec.rect, size, HD720, (scene_l, scene_r)), rect


SLICE_CASES = [((384, 216), 304, "cvc_low_maps"), ((320, 180), 253, "low_maps")]


@pytest.mark.parametrize("size,crop_w,tail", SLICE_CASES, ids=["384x216", "320x180"])
def test_calibrated_slice_gif_matches_jax(cal, monkeypatch, size, crop_w, tail):
    """Raw pair -> Rectifier -> stereo_gif_forward (D = 16) ->
    disparity_to_depth in both packages, each on its CPU path. The exact
    stride (304) takes K4's plain version, the quasi width (253) K1's.
    Rectified frames bitwise, disparities within the WTA tie class (2e-3),
    depth bitwise wherever the disparities agree, and the known field."""
    levels = (10, 5)
    raw, rect = _raw_pair(cal, size, levels)
    port, ref = (calib.Rectifier(cal, size, calib_size=HD720, device="cpu"),
                 jcalib.Rectifier(cal, size, calib_size=HD720))
    l8, r8 = port(*raw)
    jl8, jr8 = ref(*(jnp.asarray(a) for a in raw))
    np.testing.assert_array_equal(l8.numpy(), np.asarray(jl8))
    np.testing.assert_array_equal(r8.numpy(), np.asarray(jr8))
    assert l8.shape[1] == crop_w

    calls = []
    for name in ("cvc_low_maps", "low_maps"):
        fn = getattr(gif_pipeline, name)
        monkeypatch.setattr(gif_pipeline, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    jax_cfg = JaxGIFConfig(max_dis=16)
    cfg = from_jax_config(dataclasses.asdict(jax_cfg))
    scale = np.float32(1 / 255.0)
    got = stereo_gif_forward(l8.to(torch.float32) * float(scale), r8.to(torch.float32)
                             * float(scale), cfg, device="cpu")
    assert calls == [tail]
    want = jax_gif(jnp.asarray(np.asarray(jl8).astype(np.float32) * scale),
                   jnp.asarray(np.asarray(jr8).astype(np.float32) * scale), jax_cfg)
    agree = [g.numpy() == np.asarray(w) for g, w in zip(got, want)]
    assert max(1 - float(a.mean()) for a in agree) <= 2e-3

    Q = port.rect.Q
    z = disparity_to_depth(got[0], Q).numpy()
    zj = np.asarray(jdepth.disparity_to_depth(want[0], Q))
    np.testing.assert_array_equal(z[agree[0]], zj[agree[0]])
    regions = port_helpers.field_regions(rect, levels, cfg.max_dis, m=6)
    port_helpers.check_field("gif", got[0].numpy().astype(np.float64), z, regions, Q)


@pytest.mark.parametrize("size,crop_w,tail", SLICE_CASES, ids=["384x216", "320x180"])
def test_calibrated_slice_sgbm_matches_jax(cal, size, crop_w, tail):
    """The same raw pairs through stereo_sgbm_forward (D = 16): bitwise end
    to end (rectified frames, int16 disparities, depth)."""
    levels = (10, 5)
    raw, rect = _raw_pair(cal, size, levels)
    port, ref = (calib.Rectifier(cal, size, calib_size=HD720, device="cpu"),
                 jcalib.Rectifier(cal, size, calib_size=HD720))
    pair = port(*raw)
    jpair = ref(*(jnp.asarray(a) for a in raw))
    jax_cfg = JaxSGBMConfig(num_disparities=16)
    got = stereo_sgbm_forward(*pair, from_jax_sgbm_config(dataclasses.asdict(jax_cfg)),
                              device="cpu")
    want = np.asarray(jax_sgbm(*jpair, jax_cfg))
    np.testing.assert_array_equal(got.numpy(), want)
    assert pair[0].shape[1] == crop_w
    Q = port.rect.Q
    d = got.to(torch.float32) * (1 / 16)
    z = disparity_to_depth(d, Q).numpy()
    np.testing.assert_array_equal(
        z, np.asarray(jdepth.disparity_to_depth(jnp.asarray(want.astype(np.float32) * (1 / 16)),
                                                Q)))
    dn = d.numpy().astype(np.float64)
    dn[dn <= 0] = np.nan
    port_helpers.check_field("sgbm", dn, z, port_helpers.field_regions(rect, levels, 16, m=6), Q)
