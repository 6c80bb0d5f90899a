"""The frozen bound functions equal `chip_smoke.py`'s at the cells' shapes."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from portbench import bounds
from portbench.tests.tiny import ROOT

# (H, W, D): the 2K frame and the calibrated ZED-VGA crop, s = 4, k = 5, r = 9
SHAPES = [(1242, 2208, 256), (274, 530, 64)]


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("H, W, D", SHAPES)
def test_bounds_equal_chip_smokes(smoke, H, W, D):
    s, k, r = 4, 5, 9
    h, w = H // s, W // s
    views, grds = torch.empty(2, H, W, 3), torch.empty(2, H, W)
    stats, maps = torch.empty(2, 12, h, w), torch.empty(2, 4, D, h, w)
    p = torch.empty(2, D, h, w)
    assert bounds.frame_k4_ms(H, W, D, s, k) == smoke.bound_cvc_lowmaps(views, grds, stats, D, k)[0]
    assert bounds.frame_k2_ms(H, W, D, s) == smoke.bound_wta(views, maps)[0]
    assert bounds.bound_lowmaps(p, k) == smoke.bound_lowmaps(p, k)
    out = np.random.default_rng(0).integers(0, D, (2, H, W), dtype=np.uint8)
    assert bounds.frame_k3_ms(out, r, D) == smoke.bound_wmf(
        torch.empty(2, H, W, dtype=torch.uint8), torch.from_numpy(out), r, D)[0]
    for name in ("HBM_BYTES_PER_S", "FP32_FLOP_PER_S"):
        assert getattr(bounds, name) == getattr(smoke, name)
