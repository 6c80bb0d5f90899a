"""Which STEREO_GIF tail a geometry takes.

The sampled cost can be built inside the low-maps kernel (K4) when the
FGF's column sample grid is an exact stride of the image width, and cost,
chain and WTA can share one kernel (K10) when the upsampling ratio is also
phase-periodic. These predicates are the geometric part of the JAX
package's `cvc_lowmaps_applicable` / `poly_col_params(w, W)["exact"]` and
`cvc_wta_applicable`, so both packages dispatch alike on the same inputs;
the TPU's on-chip memory planners have no counterpart here.
"""

from __future__ import annotations

import numpy as np

from primestereomatch_torch.ops.resize import linear_coeffs, nearest_indices


def fused_cvc_applies(W: int, max_dis: int, subsample: int) -> bool:
    """True when the FGF samples every `subsample`-th column exactly
    (W = s * w, xi = arange(w) * s), 2 <= s <= 8, and s divides max_dis:
    the 2K / HD720 / ZED geometries. Middlebury's widths (450 = 4 * 112 + 2)
    and subsample=1 are not."""
    s = subsample
    w = W // s
    if not 2 <= s <= 8 or w == 0 or W % w or W // w != s:
        return False
    if not np.array_equal(nearest_indices(W, w), np.arange(w) * s):
        return False
    return max_dis >= s and max_dis % s == 0


def phase_periodic(w: int, W: int) -> bool:
    """True when W = P * w and every interior output column P * k + r takes
    its low tap at k + floor((r + 0.5) / P - 0.5), as computed by the
    float64 INTER_LINEAR tables (an odd P can land one column of a phase on
    the other side of an integer)."""
    if w <= 0 or W % w:
        return False
    P = W // w
    if not 2 <= P <= 8:
        return False
    sx, _ = linear_coeffs(w, W)
    ks = np.arange(1, w - 1)
    return all(
        np.array_equal(sx[P * ks + r], ks + int(np.floor((r + 0.5) / P - 0.5)))
        for r in range(P)
    )


def full_fusion_applies(W: int, max_dis: int, subsample: int) -> bool:
    """True when `tail_fusion='full'` runs the one-kernel tail: the fused
    CVC geometry with a phase-periodic column ratio."""
    return (fused_cvc_applies(W, max_dis, subsample)
            and phase_periodic(W // subsample, W))
