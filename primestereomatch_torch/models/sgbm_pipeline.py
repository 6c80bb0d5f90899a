"""STEREO_SGBM end-to-end pipeline on PyTorch (port of the JAX package's
models/sgbm_pipeline.py; the reference's second matching algorithm, its
cv::StereoSGBM with the parameter set of src/StereoMatch.cpp:639-660).

Stage map, all integer:

  prefilter  [1,2,1]-smoothed clipped Sobel-x             ops/sgbm.py
  cost       BT pixel cost + k x k window sum     (K6)    kernels/bt_cost.py
  aggregate  SGM scans over 3/5/8 directions,     (K7)    kernels/sgbm_scan.py
             as uint16 group partials
  select     sum of the partials, WTA, uniqueness,(K8)    kernels/select.py
             sub-pixel, LR check
  speckle    small components invalidated         (K9)    ops/sgbm.py + kernels/speckle.py

The volumes pass between the kernels as (H, W, D) with D contiguous. On
CUDA tensors K6-K9 are hand-written kernels; on the CPU (device="cpu", as
the tests run) the wrappers take their plain PyTorch versions. Either way
the output is bitwise that of the JAX pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from primestereomatch_torch.config import SGBMConfig
from primestereomatch_torch.kernels import (
    bt_cost,
    select_disparity_partials,
    sgbm_aggregate_partials,
)
from primestereomatch_torch.ops.sgbm import DISP_SCALE, filter_speckles, sobel_xclip
from primestereomatch_torch.utils.device import resolve_device
from primestereomatch_torch.utils.profiling import span

# the SGBM entry's host spans (utils/profiling.py::span), its stages in order
# inside SPAN_FORWARD
SPAN_FORWARD = "psm.sgbm.forward"
SPAN_PREFILTER = "psm.sgbm.prefilter"    # both views' sobel_xclip
SPAN_COST = "psm.sgbm.cost"              # K6
SPAN_AGGREGATE = "psm.sgbm.aggregate"    # K7
SPAN_SELECT = "psm.sgbm.select"          # K8
SPAN_SPECKLE = "psm.sgbm.speckle"        # K9's sweeps, their host checks, the areas


def _as_u8(x, dev: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.dtype != torch.uint8 or t.dim() != 3:
        raise TypeError(f"SGBM takes uint8 (H, W, C) images, got {t.dtype} "
                        f"{tuple(t.shape)}")
    return t.to(dev).contiguous()


def stereo_sgbm_forward(
    l_img_u8,                      # (H, W, C) uint8, BGR as the reference loads
    r_img_u8,
    cfg: SGBMConfig = SGBMConfig(),
    *,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Returns (H, W) int16 disparity x 16 on `device` (default: the CUDA
    card; raises if there is none). Invalid pixels are
    (min_disparity - 1) * 16. While a profiler runs, records SPAN_FORWARD
    around the call and each stage's span inside it."""
    with span(SPAN_FORWARD):
        dev = resolve_device(device)
        left, right = _as_u8(l_img_u8, dev), _as_u8(r_img_u8, dev)
        if left.shape != right.shape:
            raise ValueError(f"expected matching (H, W, C) images, got {tuple(left.shape)} "
                             f"vs {tuple(right.shape)}")
        ch = left.shape[2]
        if ch != cfg.num_channels:
            raise ValueError(f"images have {ch} channels, the config {cfg.num_channels}")
        with span(SPAN_PREFILTER):
            l_ftr = sobel_xclip(left, cfg.pre_filter_cap)
            r_ftr = sobel_xclip(right, cfg.pre_filter_cap)
        # static bound on the window cost (BT per channel <= 2 * cap): int16
        # volumes when it fits, as in the JAX pipeline
        cost_bound = cfg.block_size**2 * ch * 2 * cfg.pre_filter_cap
        with span(SPAN_COST):
            C = bt_cost(l_ftr, r_ftr, cfg.num_disparities, cfg.block_size, cost_bound)
        # two uint16 group partials where the bound allows (S is never formed),
        # else the int32 S as the only partial
        with span(SPAN_AGGREGATE):
            parts = sgbm_aggregate_partials(C, cfg.p1, cfg.p2, cfg.num_directions, cost_bound)
        del C
        with span(SPAN_SELECT):
            disp16 = select_disparity_partials(parts, cfg.uniqueness_ratio,
                                               cfg.disp12_max_diff, cfg.min_disparity)
        del parts
        if cfg.speckle_window_size > 0:
            with span(SPAN_SPECKLE):
                disp16 = filter_speckles(
                    disp16, cfg.speckle_window_size, DISP_SCALE * cfg.speckle_range,
                    (cfg.min_disparity - 1) * DISP_SCALE,
                )
        return disp16


def sgbm_display_u8(disp16: torch.Tensor, scale_factor: int, max_dis: int,
                    mode: str = "canonical") -> torch.Tensor:
    """Display/eval conversion of the 16x fixed-point disparity map.

    'canonical' (the %BP input): disp16 // 16 with invalid -> 0, clipped to
    [0, max_dis - 1]. 'reference' reproduces the reference's display path
    (src/StereoMatch.cpp:181-186): minMaxLoc over the raw map,
    convertTo(CV_8U, 255/(max-min)) with round-half-to-even and
    saturation, then the rounded /4 and the saturating *scale_factor of the
    u8 Mat ops (per-frame normalisation: for viewing, not for metrics)."""
    if mode == "reference":
        minv = disp16.min().to(torch.float32)
        maxv = disp16.max().to(torch.float32)
        denom = maxv - minv
        alpha = torch.where(denom > 0, 255.0 / torch.clamp(denom, min=1e-30),
                            torch.zeros_like(denom))
        u8 = torch.clamp(torch.round(disp16.to(torch.float32) * alpha), 0, 255)
        u8 = torch.round(u8 / 4.0)
        return torch.clamp(u8 * scale_factor, 0, 255).to(torch.uint8)
    if mode != "canonical":
        raise ValueError(f"mode must be 'canonical' or 'reference', got {mode!r}")
    d = torch.clamp(disp16.to(torch.int32), min=0) // DISP_SCALE
    return torch.clamp(d, 0, max_dis - 1).to(torch.uint8)


class StereoSGBM(torch.nn.Module):
    """Binds a config (and a device) once, as the reference keeps one
    cv::StereoSGBM instance (setupOpenCVSGBM); call per frame. It owns no
    parameters: the config is the engine's whole state."""

    def __init__(self, cfg: SGBMConfig = SGBMConfig(),
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)

    def forward(self, l_img_u8, r_img_u8) -> torch.Tensor:
        return stereo_sgbm_forward(l_img_u8, r_img_u8, self.cfg, device=self.device)
