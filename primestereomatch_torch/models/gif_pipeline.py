"""STEREO_GIF end-to-end pipeline on PyTorch (port of the JAX package's
models/gif_pipeline.py: stereo_gif_forward, stereo_gif_forward_batch and
the staged engine DispEst).

Stage map (reference call stack, src/StereoMatch.cpp:207-242 -> src/DispEst.cpp):

  CVC  cost volume at the FGF sample grid         ops/cost_volume.py
  CVF  low-res FGF coefficient chain      (K1)    kernels/lowmaps.py
  WTA  upsample + guide combine + argmin  (K2)    kernels/wta.py
  PP   joint weighted median              (K3)    kernels/wmf.py

The geometry picks the tail (ops/geometry.py), as in the JAX package:

  exact-stride columns (2K, HD720, ZED)   K4 (CVC inside the chain) -> K2
  ... and `tail_fusion='full'`            K10 (CVC + chain + WTA in one kernel)
  any other (Middlebury, subsample=1)     CVC in plain torch -> K1 -> K2
  `cvc_dtype='u8'`, every geometry        uint8 CVC in plain torch, /255 -> K1 -> K2

Post-processing: JointWMF in exact mode (K3), or in table mode (plain
torch) when the caller passes feature indexes; `pp_toolchain=True` runs
the reference's LR check, invalid fill and bilateral weighted median
(ops/postproc.py, plain torch) ahead of it, on single frames only.

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
from primestereomatch_torch.ops import postproc
from primestereomatch_torch.ops.color import (
    bgr_to_gray_refquirk,
    bgr_to_gray_refquirk_u8,
    sobel_x_k1,
    sobel_x_k1_u8,
)
from primestereomatch_torch.ops.cost_volume import (
    build_cost_volumes,
    sampled_cost_volumes,
    sampled_cost_volumes_u8,
    unit_cost,
)
from primestereomatch_torch.ops.geometry import fused_cvc_applies, full_fusion_applies
from primestereomatch_torch.ops.guided_filter import fast_guided_filter_color, guide_stats
from primestereomatch_torch.ops.jointwmf import joint_wmf
from primestereomatch_torch.ops.wta import wta_disparity
from primestereomatch_torch.utils.device import resolve_device
from primestereomatch_torch.utils.png import write_png
from primestereomatch_torch.utils.profiling import span

# the GIF entry's host spans (utils/profiling.py::span): the whole entry,
# and its stages as children
SPAN_FORWARD = "psm.gif.forward"
SPAN_PREP = "psm.gif.prep"            # guide statistics, gradients
SPAN_COST_MAPS = "psm.gif.cost_maps"  # the cost and low maps: K4, plain cost -> K1, or K10
SPAN_WTA = "psm.gif.wta"              # K2
SPAN_WMF = "psm.gif.wmf"              # K3, table mode, the toolchain


def _to_u8(img01: torch.Tensor) -> torch.Tensor:
    """cv::Mat::convertTo(CV_8UC3, 255): saturate(round-half-to-even(v*255))."""
    return torch.round(img01 * 255.0).clamp(0, 255).to(torch.uint8)


def _on(x, dev: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A tensor or any array-like (NumPy, JAX, ...) as a tensor on `dev`."""
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x), dtype=dtype,
                           device=dev)


def _as_image(x, dev: torch.device) -> torch.Tensor:
    t = _on(x, None)
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
    return views, view_gradients(views, cfg)


def view_gradients(views: torch.Tensor, cfg: GIFConfig) -> torch.Tensor:
    """Sobel-x of the reference's gray, plus the OpenCL variant's offset."""
    grds = sobel_x_k1(bgr_to_gray_refquirk(views))
    if cfg.grad_offset:   # OpenCL-variant +0.5 (src/CVC_cl.cpp:108-111)
        grds = grds + cfg.grad_offset
    return grds.contiguous()


def sampled_u8_costs(views: torch.Tensor, cfg: GIFConfig) -> torch.Tensor:
    """`cvc_dtype='u8'`: the stacked views' uint8 costs (uint8 images and
    their saturated uint8 gradients, the uchar kernel's host prep) at the
    FGF grid, (2B, D, h, w) uint8. Only `alpha` applies: the float cost's
    border cost, clamps and gradient offset do not."""
    H, W = views.shape[1:3]
    s = cfg.subsample
    views_u8 = _to_u8(views)
    grds_u8 = sobel_x_k1_u8(bgr_to_gray_refquirk_u8(views_u8))
    return sampled_cost_volumes_u8(views_u8, grds_u8, cfg.max_dis, (H // s, W // s),
                                   alpha=cfg.alpha)


def _forward_views(l_imgs: torch.Tensor, r_imgs: torch.Tensor, cfg: GIFConfig,
                   run_postprocess: bool, findex=None, wmap=None) -> torch.Tensor:
    """(B, H, W, 3) pairs on one device -> (2B, H, W) uint8, lefts first.
    `findex` holds the 2B views' feature indexes for table mode."""
    with span(SPAN_FORWARD):
        H, W = l_imgs.shape[1:3]
        s, k, D = cfg.subsample, cfg.fgf_low_radius, cfg.max_dis
        u8 = cfg.cvc_dtype == "u8"
        with span(SPAN_PREP):
            views = torch.cat([l_imgs, r_imgs])
            stats = guide_stats(views, (H // s, W // s), k, cfg.gif_eps).contiguous()
            grds = None if u8 else view_gradients(views, cfg)

        maps = None
        with span(SPAN_COST_MAPS):
            if u8:
                # the fused tails build the float cost: every geometry takes K1
                maps = low_maps(unit_cost(sampled_u8_costs(views, cfg)), stats, k)  # K1
            else:
                cost = dict(alpha=cfg.alpha, border_cost=cfg.border_cost, tau1=cfg.tau1,
                            tau2=cfg.tau2)
                if cfg.tail_fusion == "full" and full_fusion_applies(W, D, s):
                    disp = cvc_wta(views, grds, stats, D, k, **cost)              # K10
                elif fused_cvc_applies(W, D, s):
                    maps = cvc_low_maps(views, grds, stats, D, k, **cost)         # K4
                else:
                    p = sampled_cost_volumes(views, grds, D, (H // s, W // s), **cost)
                    maps = low_maps(p, stats, k)                                  # K1
        if maps is not None:
            with span(SPAN_WTA):
                disp = upsample_wta(views, maps)                                  # K2

        if not run_postprocess:
            return disp
        with span(SPAN_WMF):
            if cfg.pp_toolchain:
                disp = _toolchain(disp, views, cfg)
            if cfg.wmf_mode == "table" and findex is not None:
                # the plain op: table mode has no kernel in either package
                return torch.stack([
                    joint_wmf(d, radius=cfg.wmf_radius, n_bins=D, sigma=cfg.wmf_sigma,
                              findex=f, wmap=wmap) for d, f in zip(disp, findex)])
            return weighted_median(                                               # K3
                disp, _to_u8(views), radius=cfg.wmf_radius, n_bins=D, sigma=cfg.wmf_sigma,
            )


def _toolchain(disp: torch.Tensor, views: torch.Tensor, cfg: GIFConfig) -> torch.Tensor:
    """The reference's full PP toolchain on one pair (src/PP.cpp:405-413):
    LR check, invalid fill, then the bilateral weighted median of the
    invalid pixels (squared distances on the left view, their roots on the
    right), plain torch as in the JAX package."""
    (l_disp, r_disp), (l_img, r_img) = disp, views
    l_valid, r_valid = postproc.lr_check(l_disp, r_disp)
    out = []
    for img, d, valid, use_sqrt in ((l_img, l_disp, l_valid, False),
                                    (r_img, r_disp, r_valid, True)):
        out.append(postproc.weighted_median(
            img, postproc.fill_invalid(d, valid), valid, cfg.max_dis, cfg.med_sz,
            cfg.sig_clr, cfg.sig_dis, use_sqrt=use_sqrt))
    return torch.stack(out)


def stereo_gif_forward(
    l_img,                         # (H, W, 3) float in [0,1], BGR order
    r_img,
    cfg: GIFConfig = GIFConfig(),
    run_postprocess: bool = True,
    l_findex=None,                 # (H, W) feature indexes for table-mode JointWMF
    r_findex=None,
    wmap=None,                     # (nF, nF) float32 weight table
    *,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full STEREO_GIF forward: returns (l_disp, r_disp) uint8 (H, W) on
    `device` (default: the CUDA card; raises if there is none). JointWMF
    runs in table mode when `cfg.wmf_mode == 'table'` and `l_findex` is
    given (utils/features.py::feature_index_color makes the indexes and
    the table), else in exact mode, as in the JAX package."""
    dev = resolve_device(device)
    l_img = _as_image(l_img, dev)
    r_img = _as_image(r_img, dev)
    if l_img.shape != r_img.shape or l_img.dim() != 3 or l_img.shape[-1] != 3:
        raise ValueError(
            f"expected matching (H, W, 3) images, got {tuple(l_img.shape)} "
            f"vs {tuple(r_img.shape)}"
        )
    findex = None
    if cfg.wmf_mode == "table" and l_findex is not None:
        if r_findex is None or wmap is None:
            raise ValueError("table mode needs l_findex, r_findex and wmap")
        findex = [_on(f, dev) for f in (l_findex, r_findex)]
        wmap = _on(wmap, dev, torch.float32)
    disp = _forward_views(l_img[None], r_img[None], cfg, run_postprocess, findex, wmap)
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

    def forward(self, l_img, r_img, run_postprocess: bool = True, l_findex=None,
                r_findex=None, wmap=None):
        return stereo_gif_forward(
            l_img, r_img, self.cfg, run_postprocess, l_findex, r_findex, wmap,
            device=self.device,
        )


class DispEst:
    """The reference's four-stage engine (src/DispEst.cpp:199-344), stage
    by stage, for per-stage timing and debugging; `stereo_gif_forward` is
    the fast path. The volumes are full resolution, (D, H, W) float32.

    cost_const   -> CostConst   (CVC, d = 0 included)         plain torch
    cost_filter  -> CostFilter  (the FastGuidedFilter's output) plain torch
    disp_select  -> DispSelect  (WTA, d >= 1)                   plain torch
    post_process -> PostProcess (JointWMF, exact mode)          K3

    Images are (H, W, 3) float in [0, 1], BGR order. Stages run on
    `device` (default: the CUDA card), which holds no state of its own.
    """

    def __init__(self, cfg: GIFConfig = GIFConfig(),
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _image(self, x) -> torch.Tensor:
        img = _as_image(x, self.device)
        if img.dim() != 3 or img.shape[-1] != 3:
            raise ValueError(f"expected an (H, W, 3) image, got {tuple(img.shape)}")
        return img

    def cost_const(self, l_img, r_img) -> tuple[torch.Tensor, torch.Tensor]:
        """The left and right cost volumes, (D, H, W) each."""
        l_img, r_img = self._image(l_img), self._image(r_img)
        if l_img.shape != r_img.shape:
            raise ValueError(f"images differ in shape: {tuple(l_img.shape)} vs "
                             f"{tuple(r_img.shape)}")
        cfg = self.cfg
        l_grd, r_grd = view_gradients(torch.stack([l_img, r_img]), cfg)
        return build_cost_volumes(
            l_img, r_img, l_grd, r_grd, cfg.max_dis, alpha=cfg.alpha,
            border_cost=cfg.border_cost, tau1=cfg.tau1, tau2=cfg.tau2,
        )

    def cost_filter(self, img, cv) -> torch.Tensor:
        """The filtered volume: FastGuidedFilter(img, r, eps, s) on every slice."""
        cfg = self.cfg
        return fast_guided_filter_color(
            self._image(img), _on(cv, self.device),
            cfg.gif_radius, cfg.gif_eps, cfg.subsample,
        )

    def disp_select(self, cv) -> torch.Tensor:
        """(H, W) uint8 winners over d >= 1."""
        return wta_disparity(_on(cv, self.device))

    def post_process(self, disp, img) -> torch.Tensor:
        """JointWMF of `disp` guided by `img` in exact mode (K3)."""
        cfg = self.cfg
        disp = _on(disp, self.device)
        return weighted_median(
            disp[None].contiguous(), _to_u8(self._image(img))[None].contiguous(),
            radius=cfg.wmf_radius, n_bins=cfg.max_dis, sigma=cfg.wmf_sigma,
        )[0]

    def dump_cost_volume(self, cv, prefix: str) -> list[str]:
        """Write every slice as an 8-bit grey PNG `{prefix}{d:03d}.png`,
        the values scaled by 255, rounded and clipped (printCV,
        src/DispEst.cpp:181-194; its sprintf early return is not kept).
        Returns the paths."""
        slices = _on(cv, "cpu").numpy()
        paths = []
        for d, v in enumerate(slices):
            path = f"{prefix}{d:03d}.png"
            write_png(path, np.clip(np.rint(v * 255.0), 0, 255).astype(np.uint8))
            paths.append(path)
        return paths

    def compute(self, l_img, r_img) -> tuple[torch.Tensor, torch.Tensor]:
        """Stage by stage: the same result as `stereo_gif_forward` with its
        default exact JointWMF, but for argmin ties of the filtered volume."""
        l_img, r_img = self._image(l_img), self._image(r_img)
        lcv, rcv = self.cost_const(l_img, r_img)
        l_disp = self.disp_select(self.cost_filter(l_img, lcv))
        del lcv
        r_disp = self.disp_select(self.cost_filter(r_img, rcv))
        return self.post_process(l_disp, l_img), self.post_process(r_disp, r_img)
