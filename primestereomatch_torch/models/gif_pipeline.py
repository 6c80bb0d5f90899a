"""STEREO_GIF end-to-end pipeline on PyTorch (port of the JAX package's
models/gif_pipeline.py::stereo_gif_forward and ::stereo_gif_forward_batch).

Stage map (reference call stack, src/StereoMatch.cpp:207-242 -> src/DispEst.cpp):

  CVC  cost volume at the FGF sample grid         ops/cost_volume.py
  CVF  low-res FGF coefficient chain      (K1)    kernels/lowmaps.py
  WTA  upsample + guide combine + argmin  (K2)    kernels/wta.py
  PP   joint weighted median              (K3)    kernels/wmf.py

The geometry picks the tail (ops/geometry.py), as in the JAX package:

  exact-stride columns (2K, HD720, ZED)   K4 (CVC inside the chain) -> K2
  ... and `tail_fusion='full'`            K10 (CVC + chain + WTA in one kernel)
  any other (Middlebury, subsample=1)     CVC in plain torch -> K1 -> K2

The views of all frames fold into one launch per kernel, the B left views
first and then the B right ones. On CUDA tensors every kernel stage is a
hand-written kernel; on the CPU (device="cpu", as the tests run) the
wrappers take their plain PyTorch versions. The Sobel gradients and the
guide statistics are plain torch on both, as the JAX package computes them
outside its kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from primestereomatch_torch.config import GIFConfig
from primestereomatch_torch.kernels import (
    cvc_low_maps,
    cvc_wta,
    low_maps,
    upsample_wta,
    weighted_median,
)
from primestereomatch_torch.ops.color import bgr_to_gray_refquirk, sobel_x_k1
from primestereomatch_torch.ops.cost_volume import sampled_cost_volumes
from primestereomatch_torch.ops.geometry import fused_cvc_applies, full_fusion_applies
from primestereomatch_torch.ops.guided_filter import guide_stats
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


def stacked_views(l_imgs: torch.Tensor, r_imgs: torch.Tensor,
                  cfg: GIFConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) left and right frames -> the stacked views (2B, H, W, 3),
    lefts first, and their Sobel-x gradients (2B, H, W)."""
    views = torch.cat([l_imgs, r_imgs])
    grds = sobel_x_k1(bgr_to_gray_refquirk(views))
    if cfg.grad_offset:   # OpenCL-variant +0.5 (src/CVC_cl.cpp:108-111)
        grds = grds + cfg.grad_offset
    return views, grds.contiguous()


def _forward_views(l_imgs: torch.Tensor, r_imgs: torch.Tensor, cfg: GIFConfig,
                   run_postprocess: bool) -> torch.Tensor:
    """(B, H, W, 3) pairs on one device -> (2B, H, W) uint8, lefts first."""
    H, W = l_imgs.shape[1:3]
    s, k, D = cfg.subsample, cfg.fgf_low_radius, cfg.max_dis
    views, grds = stacked_views(l_imgs, r_imgs, cfg)
    stats = guide_stats(views, (H // s, W // s), k, cfg.gif_eps).contiguous()
    cost = dict(alpha=cfg.alpha, border_cost=cfg.border_cost, tau1=cfg.tau1, tau2=cfg.tau2)

    if cfg.tail_fusion == "full" and full_fusion_applies(W, D, s):
        disp = cvc_wta(views, grds, stats, D, k, **cost)                      # K10
    else:
        if fused_cvc_applies(W, D, s):
            maps = cvc_low_maps(views, grds, stats, D, k, **cost)             # K4
        else:
            p = sampled_cost_volumes(views, grds, D, (H // s, W // s), **cost)
            maps = low_maps(p, stats, k)                                      # K1
        disp = upsample_wta(views, maps)                                      # K2

    if run_postprocess:
        disp = weighted_median(                                               # K3
            disp, _to_u8(views), radius=cfg.wmf_radius, n_bins=D, sigma=cfg.wmf_sigma,
        )
    return disp


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
    disp = _forward_views(l_img[None], r_img[None], cfg, run_postprocess)
    return disp[0], disp[1]


def stereo_gif_forward_batch(
    l_imgs,                        # (B, H, W, 3) float in [0,1], BGR order
    r_imgs,
    cfg: GIFConfig = GIFConfig(),
    run_postprocess: bool = True,
    *,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """STEREO_GIF over a batch of frames: returns two (B, H, W) uint8
    tensors on `device`. All 2B views share one launch per kernel; each
    frame's result is bitwise equal to `stereo_gif_forward` of that frame."""
    if cfg.pp_toolchain or cfg.wmf_mode != "exact":
        raise ValueError(
            "stereo_gif_forward_batch supports the default exact-WMF path only; "
            "run pp_toolchain/table-mode frames through stereo_gif_forward"
        )
    dev = resolve_device(device)
    l_imgs = _as_image(l_imgs, dev)
    r_imgs = _as_image(r_imgs, dev)
    if (l_imgs.shape != r_imgs.shape or l_imgs.dim() != 4 or l_imgs.shape[-1] != 3
            or l_imgs.shape[0] < 1):
        raise ValueError(
            f"expected matching (B, H, W, 3) batches, got {tuple(l_imgs.shape)} "
            f"vs {tuple(r_imgs.shape)}"
        )
    B = l_imgs.shape[0]
    disp = _forward_views(l_imgs, r_imgs, cfg, run_postprocess)
    return disp[:B], disp[B:]


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
