"""Joint weighted median filter, exact mode: the plain PyTorch version of
the JointWMF kernel (kernels/wmf.py).

Reference: include/JointWMF.h (CVPR'14 "100+ Times Faster Weighted Median
Filter"), called from PP::processDM (src/PP.cpp:402-425) with r = 9,
sigma = 25.5. For each pixel p, over the window q in [p-r, p+r]^2 clamped
to the image, with w(p, q) = exp(-|c6(p) - c6(q)|^2 / (2 sig_q^2)) on
6-bit colours c6 = c >> 2 and sig_q = sigma/256*64, the output is the
smallest bin v with sum_{q: d(q) <= v} w(p, q) >= (total weight)/2.

Each bin's weight is summed over the window in row-major offset order and
the cumulative sum runs bin by bin, the order the kernel follows.
"""

from __future__ import annotations

import torch


def joint_wmf(
    disp: torch.Tensor,        # (H, W) integer disparities
    guide_u8: torch.Tensor,    # (H, W, 3) uint8 colour guide
    *,
    radius: int = 9,
    n_bins: int = 64,
    sigma: float = 25.5,
) -> torch.Tensor:
    """Weighted median of `disp` guided by `guide_u8`. Returns (H, W)
    uint8 (int32 beyond 256 bins)."""
    H, W = disp.shape
    r = radius
    dev = disp.device
    c6 = (guide_u8.to(torch.int32) >> 2).to(torch.float32).movedim(-1, 0)  # (3, H, W)
    sig_q = sigma / 256.0 * 64.0
    inv_two_sig2 = 1.0 / (2.0 * sig_q * sig_q)

    d = disp.to(torch.int64)
    in_range = d < n_bins
    d_pad = torch.nn.functional.pad(d.clamp(max=n_bins - 1), (r, r, r, r))
    v_pad = torch.nn.functional.pad(in_range.to(torch.float32), (r, r, r, r))
    c_pad = torch.nn.functional.pad(c6, (r, r, r, r))

    hist = torch.zeros((n_bins, H, W), dtype=torch.float32, device=dev)
    for oy in range(2 * r + 1):
        for ox in range(2 * r + 1):
            c_q = c_pad[:, oy:oy + H, ox:ox + W]
            diff = c6 - c_q
            dist2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
            # out-of-image and out-of-range neighbours add an exact +0.0
            w = torch.exp(-dist2 * inv_two_sig2) * v_pad[oy:oy + H, ox:ox + W]
            hist.scatter_add_(0, d_pad[None, oy:oy + H, ox:ox + W], w[None])
    for b in range(1, n_bins):                       # sequential cumulative sum
        hist[b] += hist[b - 1]
    half = hist[-1] * 0.5
    # cum is monotone in the bin, so the first bin with cum >= half is the
    # number of bins below half
    out = (hist < half).sum(dim=0)
    return out.to(torch.uint8 if n_bins <= 256 else torch.int32)
