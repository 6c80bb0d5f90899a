"""The CUDA kernels against their plain versions on the card. These tests
import nothing of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA card they skip. chip_smoke.py checks the same at the main
path's full shapes."""

import numpy as np
import pytest
import torch

from primestereomatch_torch import GIFConfig, kernels as K, stereo_gif_forward
from primestereomatch_torch.ops.guided_filter import guide_stats

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, B=2, D=16, H=72, W=150, s=4, k=5, seed=0):
    rng = np.random.default_rng(seed)
    g = torch.as_tensor(rng.random((B, H, W, 3)).astype(np.float32), device=dev)
    p = torch.as_tensor(rng.random((B, D, H // s, W // s)).astype(np.float32), device=dev)
    return g, p, guide_stats(g, (H // s, W // s), k, 1e-4).contiguous()


@pytest.mark.parametrize("s,k", [(4, 5), (2, 9), (8, 3)])
def test_low_maps_kernel_matches_plain(dev, s, k):
    _, p, stats = _inputs(dev, s=s, k=k)
    K.reset_launches()
    got = K.low_maps(p, stats, k)
    assert K.LAUNCHES["lowmaps"] == 1
    assert torch.allclose(got, K.low_maps_plain(p, stats, k), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("W", [150, 160])   # quasi and exact column ratios
def test_upsample_wta_kernel_matches_plain(dev, W):
    g, p, stats = _inputs(dev, W=W)
    maps = K.low_maps_plain(p, stats, 5)
    got = K.upsample_wta(g, maps)
    assert (got != K.upsample_wta_plain(g, maps)).float().mean() <= 2e-3


@pytest.mark.parametrize("radius,n_bins", [(9, 64), (4, 256), (3, 10)])
def test_weighted_median_kernel_matches_plain(dev, radius, n_bins):
    rng = np.random.default_rng(n_bins)
    disp = torch.as_tensor(rng.integers(0, n_bins, (2, 40, 70), dtype=np.uint8), device=dev)
    guide = torch.as_tensor(rng.integers(0, 256, (2, 40, 70, 3), dtype=np.uint8), device=dev)
    got = K.weighted_median(disp, guide, radius, n_bins, 25.5)
    want = K.weighted_median_plain(disp, guide, radius, n_bins, 25.5)
    diff = (got.int() - want.int()).abs()
    assert (diff > 0).float().mean() <= 1e-3 and int(diff.max()) <= 1


def test_kernels_reject_non_contiguous(dev):
    g, p, stats = _inputs(dev)
    with pytest.raises(ValueError):
        K.low_maps(p.transpose(2, 3), stats.transpose(2, 3), 5)


def test_forward_on_card_matches_cpu(dev):
    rng = np.random.default_rng(5)
    left = rng.random((64, 160, 3)).astype(np.float32)
    right = np.roll(left, -6, axis=1)
    cfg = GIFConfig(max_dis=16, med_sz=7)
    K.reset_launches()
    got = stereo_gif_forward(left, right, cfg)
    assert min(K.LAUNCHES.values()) == 1
    want = stereo_gif_forward(left, right, cfg, device="cpu")
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        assert (a.cpu() != b).float().mean() <= 2e-3
