"""Plain STEREO_GIF in PyTorch: the reference that judges the port's disparities.

A frozen, self-contained copy of the published pipeline (the reference
binary's CVC -> FastGuidedFilter s -> WTA d >= 1 -> JointWMF r, as
src/StereoMatch.cpp and src/DispEst.cpp run it), written out op by op in the
term order of the port's plain versions so that at float32 it reads the same
disparities. It imports nothing of the program: no kernel, no cached table,
no configuration object. Every index table is made here from the sizes.

`dtype` is the precision of every floating-point stage (the frames' scale,
cost, guide statistics, chain, upsample and the JointWMF weights and
histogram): float32 is the configuration's, bfloat16 the control that
`correct` has to fail.
"""

from __future__ import annotations

import numpy as np
import torch

# OpenCV's CV_RGB2GRAY weights applied to B, G, R as stored (the reference's quirk)
GRAY_W = (0.299, 0.587, 0.114)
U8_TO_F32 = float(np.float32(1 / 255.0))   # convertTo(CV_32F, 1/255.0f)
COST_D_CHUNK = 32                            # disparities gathered at once
WTA_D_CHUNK = 16                             # disparities upsampled at once above D = 64
MAX_DIS = 256                                # disparities in 8 bits, as the port's kernels hold them


def reflect101(n: int, lo: int, hi: int) -> np.ndarray:
    i = np.abs(np.arange(-lo, n + hi))
    return np.where(i >= n, 2 * (n - 1) - i, i)


def nearest_idx(src: int, dst: int) -> np.ndarray:
    """INTER_NEAREST: floor(dx * src / dst)."""
    return np.minimum(np.floor(np.arange(dst, dtype=np.float64) * (src / dst)).astype(np.int64),
                      src - 1)


def linear_coeffs(src: int, dst: int):
    """INTER_LINEAR: (low index, high index, float32 fraction) per dst index."""
    fx = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    sx = np.floor(fx).astype(np.int64)
    f = fx - sx
    f = np.where(sx < 0, 0.0, f)
    sx = np.maximum(sx, 0)
    f = np.where(sx >= src - 1, 0.0, f)
    sx = np.minimum(sx, src - 1)
    return sx, np.minimum(sx + 1, src - 1), f.astype(np.float32)


def _t(a, dev, dtype=torch.long):
    return torch.as_tensor(a, dtype=dtype, device=dev)


def box_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    """cv::blur(k, k): reflect-101, k-term sums tap by tap, rows then columns."""
    lo = k // 2
    hi = k - 1 - lo
    h, w = x.shape[-2:]
    p = x.index_select(-2, _t(reflect101(h, lo, hi), x.device)).index_select(
        -1, _t(reflect101(w, lo, hi), x.device))
    for dim in (-2, -1):
        n = p.shape[dim] - k + 1
        s = p.narrow(dim, 0, n)
        for i in range(1, k):
            s = s + p.narrow(dim, i, n)
        p = s
    return p * (1.0 / (k * k))


def gradients(views: torch.Tensor) -> torch.Tensor:
    """Sobel-x (ksize 1, reflect-101) of the reference's gray: (V, H, W)."""
    g = views[..., 0] * GRAY_W[0] + views[..., 1] * GRAY_W[1] + views[..., 2] * GRAY_W[2]
    left = torch.cat([g[..., 1:2], g[..., :-1]], dim=-1)
    right = torch.cat([g[..., 1:], g[..., -2:-1]], dim=-1)
    return right - left


def _pair_cost(a, b, ga, gb, alpha):
    d = (a - b).abs()
    clr = d[..., 0] + d[..., 1] + d[..., 2]
    return alpha * clr + (1.0 - alpha) * (ga - gb).abs()


def sampled_costs(views, grds, D: int, s: int, alpha: float, border: float) -> torch.Tensor:
    """Both views' costs at the FGF's nearest grid, (2, D, h, w): the left
    view matched at x - d, the right at x + d, every operand of the other
    view `border` where that column leaves the image."""
    _, H, W, _ = views.shape
    dev = views.device
    yi = _t(nearest_idx(H, H // s), dev)
    xi = _t(nearest_idx(W, W // s), dev)
    rows, grows = views[:, yi], grds[:, yi]                  # (2, h, W, 3), (2, h, W)
    smp, gsmp = rows[:, :, xi], grows[:, :, xi]              # (2, h, w, 3), (2, h, w)
    out = []
    for v, o in ((0, 1), (1, 0)):
        a, ga = smp[v], gsmp[v]
        edge = _pair_cost(a, torch.full_like(a, border), ga, torch.full_like(ga, border), alpha)
        parts = []
        for d0 in range(0, D, COST_D_CHUNK):
            d = torch.arange(d0, min(d0 + COST_D_CHUNK, D), device=dev)[:, None]
            sign = -1 if v == 0 else 1
            cols = (xi[None] + sign * d).clamp(0, W - 1)     # (dc, w)
            b = rows[o][:, cols].movedim(1, 0)               # (dc, h, w, 3)
            gb = grows[o][:, cols].movedim(1, 0)
            c = _pair_cost(a[None], b, ga[None], gb, alpha)
            dt, xs = d[:, :, None], xi[None, None, :]
            inside = xs >= dt if v == 0 else xs < W - dt
            parts.append(torch.where(inside, c, edge[None]))
        out.append(torch.cat(parts))
    return torch.stack(out)


def guide_stats(views: torch.Tensor, s: int, k: int, eps: float):
    """The downsampled channels, their box means and the inverse colour
    covariance (adjugate / det) at the low grid."""
    _, H, W, _ = views.shape
    dev = views.device
    yi = _t(nearest_idx(H, H // s), dev)
    xi = _t(nearest_idx(W, W // s), dev)
    ch = tuple(views[..., c].index_select(-2, yi).index_select(-1, xi) for c in range(3))
    m = [box_mean(c, k) for c in ch]
    v_rr = box_mean(ch[0] * ch[0], k) - m[0] * m[0] + eps
    v_rg = box_mean(ch[0] * ch[1], k) - m[0] * m[1]
    v_rb = box_mean(ch[0] * ch[2], k) - m[0] * m[2]
    v_gg = box_mean(ch[1] * ch[1], k) - m[1] * m[1] + eps
    v_gb = box_mean(ch[1] * ch[2], k) - m[1] * m[2]
    v_bb = box_mean(ch[2] * ch[2], k) - m[2] * m[2] + eps
    inv_rr = v_gg * v_bb - v_gb * v_gb
    inv_rg = v_gb * v_rb - v_rg * v_bb
    inv_rb = v_rg * v_gb - v_gg * v_rb
    inv_gg = v_rr * v_bb - v_rb * v_rb
    inv_gb = v_rb * v_rg - v_rr * v_gb
    inv_bb = v_rr * v_gg - v_rg * v_rg
    det = inv_rr * v_rr + inv_rg * v_rg + inv_rb * v_rb
    inv = tuple(t / det for t in (inv_rr, inv_rg, inv_rb, inv_gg, inv_gb, inv_bb))
    return ch, m, inv


def low_maps(p: torch.Tensor, ch, means, inv, k: int) -> torch.Tensor:
    """(D, h, w) costs of one view -> (4, D, h, w) box-averaged [a_r, a_g, a_b, b]."""
    ch = [c[None] for c in ch]
    means = [c[None] for c in means]
    inv_rr, inv_rg, inv_rb, inv_gg, inv_gb, inv_bb = (c[None] for c in inv)
    mean_p = box_mean(p, k)
    cov = [box_mean(ch[c] * p, k) - means[c] * mean_p for c in range(3)]
    a_r = inv_rr * cov[0] + inv_rg * cov[1] + inv_rb * cov[2]
    a_g = inv_rg * cov[0] + inv_gg * cov[1] + inv_gb * cov[2]
    a_b = inv_rb * cov[0] + inv_gb * cov[1] + inv_bb * cov[2]
    b = mean_p - a_r * means[0] - a_g * means[1] - a_b * means[2]
    return torch.stack([box_mean(t, k) for t in (a_r, a_g, a_b, b)])


def upsample_wta(guide: torch.Tensor, maps: torch.Tensor) -> torch.Tensor:
    """Each map lerped to (H, W) (rows, then columns), q = a_r I0 + a_g I1 +
    a_b I2 + b, and the first minimum over d >= 1: (H, W) uint8."""
    H, W, _ = guide.shape
    D, h, w = maps.shape[1:]
    dev = guide.device
    y0, y1, yf = linear_coeffs(h, H)
    x0, x1, xf = linear_coeffs(w, W)
    y0, y1, x0, x1 = (_t(a, dev) for a in (y0, y1, x0, x1))
    yf = _t(yf, dev, maps.dtype)[:, None]
    xf = _t(xf, dev, maps.dtype)
    ch = [guide[..., c] for c in range(3)]
    dc = WTA_D_CHUNK if D > 64 else D
    best = arg = None
    for d0 in range(1, D, dc):
        m = maps[:, d0:d0 + dc]
        ry = m.index_select(-2, y0) * (1.0 - yf) + m.index_select(-2, y1) * yf
        up = ry.index_select(-1, x0) * (1.0 - xf) + ry.index_select(-1, x1) * xf
        q = up[0] * ch[0] + up[1] * ch[1] + up[2] * ch[2] + up[3]
        c_min, c_arg = q.min(dim=0)
        c_arg = c_arg + d0
        if best is None:
            best, arg = c_min, c_arg
        else:
            take = c_min < best
            best = torch.where(take, c_min, best)
            arg = torch.where(take, c_arg, arg)
    return arg.to(torch.uint8)


def joint_wmf(disp: torch.Tensor, guide_u8: torch.Tensor, radius: int, n_bins: int,
              sigma: float, dtype=torch.float32) -> torch.Tensor:
    """Exact-mode joint weighted median: weights exp(-|c6(p) - c6(q)|^2 /
    (2 sig^2)) on 6-bit colours, sig = sigma / 256 * 64; each pixel's
    smallest bin whose cumulative weight reaches half the window's."""
    H, W = disp.shape
    r = radius
    dev = disp.device
    pad = (r, r, r, r)
    d = disp.to(torch.int64)
    part = (d < n_bins).to(dtype)
    d_pad = torch.nn.functional.pad(d.clamp(max=n_bins - 1), pad)
    v_pad = torch.nn.functional.pad(part, pad)
    c6 = (guide_u8.to(torch.int32) >> 2).to(dtype).movedim(-1, 0)
    c_pad = torch.nn.functional.pad(c6, pad)
    sig_q = sigma / 256.0 * 64.0
    inv_two_sig2 = 1.0 / (2.0 * sig_q * sig_q)

    def window_row(x_pad, oy):
        return x_pad[..., oy:oy + H, :].unfold(-1, W, 1)

    hist = torch.zeros((n_bins, H, W), dtype=dtype, device=dev)
    for oy in range(2 * r + 1):
        diff = c6[:, :, None, :] - window_row(c_pad, oy)
        dist2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
        wgt = torch.exp(-dist2 * inv_two_sig2) * window_row(v_pad, oy)
        bins = window_row(d_pad, oy)
        for ox in range(2 * r + 1):
            hist.scatter_add_(0, bins[None, :, ox], wgt[None, :, ox])
    for b in range(1, n_bins):
        hist[b] += hist[b - 1]
    half = hist[-1] * 0.5
    return (hist < half).sum(dim=0).to(torch.uint8)


def disparities(left_u8: torch.Tensor, right_u8: torch.Tensor, gif: dict,
                dtype=torch.float32) -> torch.Tensor:
    """One (H, W, 3) uint8 BGR pair on a device -> (2, H, W) uint8, the left
    view's disparities and the right's. `gif` holds the configuration's
    parameters: max_dis, alpha, border_cost, gif_radius, gif_eps, subsample,
    med_sz, wmf_sigma. STEREO_GIF holds its disparities in 8 bits, as the
    port's GIF kernels do: max_dis past 256 raises."""
    D, s = gif["max_dis"], gif["subsample"]
    if D > MAX_DIS:
        raise ValueError(f"STEREO_GIF holds at most {MAX_DIS} disparities, not {D}")
    k = 2 * (gif["gif_radius"] // s) + 1
    u8 = torch.stack([left_u8, right_u8])
    views = (u8.to(torch.float32) * U8_TO_F32).to(dtype)
    grds = gradients(views)
    costs = sampled_costs(views, grds, D, s, gif["alpha"], gif["border_cost"])
    del grds
    ch, means, inv = guide_stats(views, s, k, gif["gif_eps"])
    wta = []
    for v in range(2):
        maps = low_maps(costs[v], [c[v] for c in ch], [c[v] for c in means],
                        [c[v] for c in inv], k)
        wta.append(upsample_wta(views[v], maps))
        del maps
    del costs
    guide_u8 = torch.round(views.float() * 255.0).clamp(0, 255).to(torch.uint8)
    return torch.stack([joint_wmf(d, g, gif["med_sz"] // 2, D, gif["wmf_sigma"], dtype)
                        for d, g in zip(wta, guide_u8)])
