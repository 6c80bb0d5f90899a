"""The benchmark's plain STEREO_SGBM reference (portbench/reference/sgbm.py)
on the CPU at small sizes: bit for bit the oracle (tests/oracle_sgbm.py)
composed as the pipeline composes it, in every mode and at a negative
min_disparity; its speckle step on the propagation's worst case; its display
bit for bit the port's on a layered scene; and a process that imports it
loads nothing of either package."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tests.oracle_sgbm as oracle
from portbench.reference import sgbm as ref
from portbench.traffic import scene
from primestereomatch_torch import SGBMConfig, sgbm_display_u8, stereo_sgbm_forward

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the configuration's parameters (SGBMConfig's defaults), as its `sgbm` block holds them
BLOCK = {"min_disparity": 0, "num_disparities": 16, "block_size": 5, "p1": 600, "p2": 2400,
         "disp12_max_diff": 1, "pre_filter_cap": 63, "uniqueness_ratio": 10,
         "speckle_window_size": 100, "speckle_range": 32, "mode": "hh", "num_channels": 3}


def _oracle16(left, right, b) -> np.ndarray:
    """The oracle's stages as stereo_sgbm_forward composes them."""
    lf, rf = (oracle.sobel_xclip(v, b["pre_filter_cap"]) for v in (left, right))
    C = oracle.block_cost(oracle.bt_cost(lf, rf, b["num_disparities"]), b["block_size"])
    S = oracle.aggregate(C, b["p1"], b["p2"], ref.MODE_DIRECTIONS[b["mode"]])
    d = oracle.select_disparity(S, b["uniqueness_ratio"], b["disp12_max_diff"],
                                b["min_disparity"])
    return oracle.filter_speckles(d, b["speckle_window_size"], 16 * b["speckle_range"],
                                  (b["min_disparity"] - 1) * 16)


def _pair(seed, H=20, W=36):
    """Seeded 3-channel views, the right one the left shifted ~3 px plus noise."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1).astype(np.int32) + rng.integers(-6, 7, (H, W, 3))
    return left, np.clip(right, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("min_d", [0, -3])
@pytest.mark.parametrize("mode", ["hh", "sgbm", "3way"])
@pytest.mark.parametrize("D", [8, 16])
def test_disparity16_equals_the_oracle(D, mode, min_d):
    left, right = _pair(100 * D + 10 * len(mode) - min_d)
    b = {**BLOCK, "num_disparities": D, "mode": mode, "min_disparity": min_d, "p1": 24,
         "p2": 96, "speckle_window_size": 10, "speckle_range": 2}
    got = ref.disparity16(torch.from_numpy(left), torch.from_numpy(right), b)
    assert got.dtype == torch.int16 and got.shape == left.shape[:2]
    want = _oracle16(left, right, b)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want != (min_d - 1) * 16).sum() < want.size    # valid and invalid pixels both


def _serpentine(H=32, W=32):
    """One 527-pixel component whose path bends 31 times."""
    d = np.full((H, W), -16, np.int16)
    d[0::2] = 160
    for i, y in enumerate(range(1, H - 1, 2)):
        d[y, W - 1 if i % 2 == 0 else 0] = 160
    return d


@pytest.mark.parametrize("size", [400, 527, 600])
def test_speckles_on_a_serpentine_equal_the_oracle(size):
    """The component survives a window of 400 pixels and falls at 527 and 600."""
    d = _serpentine()
    got = ref.speckles(torch.from_numpy(d), size, 32, -16).numpy()
    want = oracle.filter_speckles(d, size, 32, -16)
    np.testing.assert_array_equal(got, want)
    assert (got != -16).sum() == (0 if size >= 527 else 527)


@pytest.mark.parametrize("D", [16, 32])
def test_disparities_equal_the_ports_display(D):
    """A layered textured scene of the benchmark's generator at 48x80: the
    left view is the port's canonical display bit for bit, the right view
    zeros."""
    (left, right), _ = scene.scene_pairs(
        48, 80, 1, {"regions": 4, "disp_range": f"2-{D - 4}", "side_px": "8-30"}, 7 + D,
        "cpu")[0]
    left, right = scene.to_u8(left), scene.to_u8(right)
    b = {**BLOCK, "num_disparities": D}
    got = ref.disparities(left, right, b)
    d16 = stereo_sgbm_forward(left, right, SGBMConfig(**b), device="cpu")
    want = sgbm_display_u8(d16, 1, D)
    assert got.dtype == torch.uint8 and got.shape == (2, 48, 80)
    assert torch.equal(got[0], want) and not got[1].any()
    assert len(torch.unique(want)) > 3


def test_the_reference_loads_neither_package():
    code = (
        "import sys, torch\n"
        "from portbench import reference\n"
        "mod = reference.algorithm({'algorithm': 'STEREO_SGBM'})\n"
        "v = torch.randint(0, 256, (12, 20, 3), dtype=torch.uint8)\n"
        "block = " + repr(BLOCK) + "\n"
        "assert mod.disparities(v, v, block).shape == (2, 12, 20)\n"
        "print(sorted({m.partition('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    loaded = out.stdout.strip()
    for banned in ("'jax'", "'jaxlib'", "'primestereomatch_tpu'", "'primestereomatch_torch'"):
        assert banned not in loaded, banned
    assert "'torch'" in loaded
