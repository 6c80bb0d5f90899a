"""STEREO_GIF end-to-end pipeline on PyTorch (port of the JAX package's
models/gif_pipeline.py::stereo_gif_forward with `GIFConfig()` semantics).

Stage map (reference call stack, src/StereoMatch.cpp:207-242 -> src/DispEst.cpp):

  CVC  cost volume at the FGF sample grid         ops/cost_volume.py
  CVF  low-res FGF coefficient chain      (K1)    kernels/lowmaps.py
  WTA  upsample + guide combine + argmin  (K2)    kernels/wta.py
  PP   joint weighted median              (K3)    kernels/wmf.py

The two views fold into one launch per kernel. On CUDA tensors every
stage of K1-K3 is a hand-written kernel; on the CPU (device="cpu", as the
tests run) the wrappers take their plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from primestereomatch_torch.config import GIFConfig
from primestereomatch_torch.kernels import (
    fgf_low_maps_batched,
    upsample_wta,
    weighted_median,
)
from primestereomatch_torch.ops.color import bgr_to_gray_refquirk, sobel_x_k1
from primestereomatch_torch.ops.cost_volume import build_cost_volumes_sampled
from primestereomatch_torch.ops.resize import nearest_table
from primestereomatch_torch.utils.device import resolve_device


def _to_u8(img01: torch.Tensor) -> torch.Tensor:
    """cv::Mat::convertTo(CV_8UC3, 255): saturate(round-half-to-even(v*255))."""
    return torch.round(img01 * 255.0).clamp(0, 255).to(torch.uint8)


def _as_image(x, dev: torch.device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    if not t.is_floating_point():
        raise TypeError(
            f"images must be floating point in [0,1] (got {t.dtype}); "
            "scale uint8 inputs by 1/255 first"
        )
    return t.to(device=dev, dtype=torch.float32).contiguous()


def sampled_cost_volumes(l_img: torch.Tensor, r_img: torch.Tensor,
                         cfg: GIFConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """CVC at the FGF's nearest-downsample grid, the cost only at the
    sampled pixels. Returns the stacked views (2, H, W, 3) and their cost
    volumes (2, D, H//s, W//s)."""
    H, W, _ = l_img.shape
    s = cfg.subsample
    l_grd = sobel_x_k1(bgr_to_gray_refquirk(l_img))
    r_grd = sobel_x_k1(bgr_to_gray_refquirk(r_img))
    if cfg.grad_offset:   # OpenCL-variant +0.5 (src/CVC_cl.cpp:108-111)
        l_grd = l_grd + cfg.grad_offset
        r_grd = r_grd + cfg.grad_offset
    lcv, rcv = build_cost_volumes_sampled(
        l_img, r_img, l_grd, r_grd, cfg.max_dis,
        nearest_table(H, H // s, l_img.device), nearest_table(W, W // s, l_img.device),
        alpha=cfg.alpha, border_cost=cfg.border_cost,
        tau1=cfg.tau1, tau2=cfg.tau2,
    )
    return torch.stack([l_img, r_img]), torch.stack([lcv, rcv])


def stereo_gif_forward(
    l_img,                         # (H, W, 3) float in [0,1], BGR order
    r_img,
    cfg: GIFConfig = GIFConfig(),
    run_postprocess: bool = True,
    *,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full STEREO_GIF forward: returns (l_disp, r_disp) uint8 (H, W) on
    `device` (default: the CUDA card; raises if there is none)."""
    dev = resolve_device(device)
    l_img = _as_image(l_img, dev)
    r_img = _as_image(r_img, dev)
    if l_img.shape != r_img.shape or l_img.dim() != 3 or l_img.shape[-1] != 3:
        raise ValueError(
            f"expected matching (H, W, 3) images, got {tuple(l_img.shape)} "
            f"vs {tuple(r_img.shape)}"
        )
    g2, p2 = sampled_cost_volumes(l_img, r_img, cfg)

    # --- CVF (K1) + upsample/WTA (K2), both views in one launch each -------
    maps = fgf_low_maps_batched(
        g2, p2, radius=cfg.gif_radius, eps=cfg.gif_eps, subsample=cfg.subsample,
    )
    d2 = upsample_wta(g2, maps)

    # --- PP: JointWMF (K3) --------------------------------------------------
    if run_postprocess:
        d2 = weighted_median(
            d2, _to_u8(g2), radius=cfg.wmf_radius, n_bins=cfg.max_dis,
            sigma=cfg.wmf_sigma,
        )
    return d2[0], d2[1]


class StereoGIF(torch.nn.Module):
    """Binds a config (and a device) once per engine; call per frame. It
    owns no parameters: the config is the engine's whole state."""

    def __init__(self, cfg: GIFConfig = GIFConfig(),
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)

    def forward(self, l_img, r_img, run_postprocess: bool = True):
        return stereo_gif_forward(
            l_img, r_img, self.cfg, run_postprocess, device=self.device
        )
