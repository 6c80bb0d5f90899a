"""Joint weighted median filter: exact mode (the plain PyTorch version of
the JointWMF kernel, kernels/wmf.py), table mode, and the float-input path.

Reference: include/JointWMF.h (CVPR'14 "100+ Times Faster Weighted Median
Filter"), called from PP::processDM (src/PP.cpp:402-425) with r = 9,
sigma = 25.5. For each pixel p, over the window q in [p-r, p+r]^2 clamped
to the image, with weight w(p, q), the output is the smallest bin v with
sum_{q: d(q) <= v} w(p, q) >= (total weight)/2.

  exact : w(p, q) = exp(-|c6(p) - c6(q)|^2 / (2 sig_q^2)) on 6-bit colours
          c6 = c >> 2 and sig_q = sigma/256*64.
  table : w(p, q) = wmap[findex(p), findex(q)], the reference's clustered
          contract (the host-side clustering is utils/features.py).

`valid` weights each neighbour's participation (1 = participates).
Each bin's weight is summed over the window in row-major offset order and
the cumulative sum runs bin by bin, the order the kernel follows.

The float path (include/JointWMF.h:670-775) quantises a float32 map on
the host into at most `n_levels` integer levels, filters the level image
and maps the medians back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from primestereomatch_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=None)
def feature_weight_table(n_feat: int = 256, sigma: float = 25.5) -> np.ndarray:
    """1-channel-guide weight table: w[i,j] = exp(-(i-j)^2 / (2 sigma^2))
    (include/JointWMF.h:525-541, op 'exp', 1-channel branch)."""
    i = np.arange(n_feat, dtype=np.float32)
    d = i[:, None] - i[None, :]
    return np.exp(-(d * d) / (2.0 * sigma * sigma)).astype(np.float32)


def median_from_hist(hist: torch.Tensor) -> torch.Tensor:
    """(n_bins, H, W) float32 weights -> (H, W) int64: the smallest bin
    whose cumulative weight reaches half the total. The cumulative sum runs
    bin by bin in float32 (torch.cumsum accumulates in float64 on the
    CPU); it is monotone, so the first bin with cum >= half is the number
    of bins below half. `hist` is summed in place."""
    for b in range(1, hist.shape[0]):
        hist[b] += hist[b - 1]
    half = hist[-1] * 0.5
    return (hist < half).sum(dim=0)


def joint_wmf(
    disp: torch.Tensor,                    # (H, W) integer disparities
    guide_u8: torch.Tensor | None = None,  # (H, W, 3) uint8 colour guide ('exact')
    *,
    radius: int = 9,
    n_bins: int = 64,
    sigma: float = 25.5,
    findex: torch.Tensor | None = None,    # (H, W) integer feature index ('table')
    wmap: torch.Tensor | None = None,      # (nF, nF) float32 weight table
    valid: torch.Tensor | None = None,     # (H, W) float32 participation weights
) -> torch.Tensor:
    """Weighted median of `disp`, guided by the colours (`guide_u8`) or by
    feature indexes and their table (`findex`, `wmap`). Returns (H, W)
    uint8 (int32 beyond 256 bins)."""
    H, W = disp.shape
    r = radius
    dev = disp.device
    pad = (r, r, r, r)

    d = disp.to(torch.int64)
    part = (d < n_bins).to(torch.float32)
    if valid is not None:
        part = valid.to(device=dev, dtype=torch.float32) * part
    d_pad = torch.nn.functional.pad(d.clamp(max=n_bins - 1), pad)
    # out-of-image and out-of-range neighbours add an exact +0.0
    v_pad = torch.nn.functional.pad(part, pad)

    def window_row(x_pad, oy):
        """[..., y, k, x] of the padded plane: the neighbour (y + oy - r,
        x + k - r) for every offset k of the window row at once."""
        return x_pad[..., oy:oy + H, :].unfold(-1, W, 1)

    if findex is not None:
        if wmap is None:
            raise ValueError("'table' mode needs both findex and wmap")
        wmap = torch.as_tensor(wmap, dtype=torch.float32, device=dev)
        n_feat = wmap.shape[0]
        f_c = torch.as_tensor(findex, device=dev).to(torch.int64)
        f_pad = torch.nn.functional.pad(f_c, pad)
        row = (f_c * n_feat)[:, None, :]
        wflat = wmap.reshape(-1)

        def weight(oy):
            idx = row + window_row(f_pad, oy)
            return wflat.index_select(0, idx.reshape(-1)).view(idx.shape)
    else:
        if guide_u8 is None:
            raise ValueError("'exact' mode needs guide_u8")
        c6 = (guide_u8.to(torch.int32) >> 2).to(torch.float32).movedim(-1, 0)  # (3, H, W)
        c_pad = torch.nn.functional.pad(c6, pad)
        sig_q = sigma / 256.0 * 64.0
        inv_two_sig2 = 1.0 / (2.0 * sig_q * sig_q)

        def weight(oy):
            diff = c6[:, :, None, :] - window_row(c_pad, oy)
            dist2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
            return torch.exp(-dist2 * inv_two_sig2)

    # a window row's weights at once, element by element as one offset at
    # a time would; the bins summed offset after offset
    hist = torch.zeros((n_bins, H, W), dtype=torch.float32, device=dev)
    for oy in range(2 * r + 1):
        w = weight(oy) * window_row(v_pad, oy)
        bins = window_row(d_pad, oy)
        for ox in range(2 * r + 1):
            hist.scatter_add_(0, bins[None, :, ox], w[None, :, ox])
    out = median_from_hist(hist)
    return out.to(torch.uint8 if n_bins <= 256 else torch.int32)


# --- float-input path: adaptive quantization ------------------------------
# Reference: include/JointWMF.h:670-775 (from32FTo32S / from32STo32F). Host
# NumPy, bitwise the JAX package's copy: it sorts the whole image.


def from32f_to_32s(
    img: np.ndarray, n_levels: int = 256
) -> tuple[np.ndarray, np.ndarray, int]:
    """Adaptive quantization of a float32 image to integer level indexes
    (include/JointWMF.h:670-745): a binary search (threshold 1e-5, float32
    arithmetic) for the smallest error bound m such that greedily
    clustering the sorted values (a new cluster whenever a value exceeds
    cluster base + m) needs at most `n_levels` clusters; each pixel maps to
    its cluster index and each cluster to the median of its values. Each
    cluster boundary is a searchsorted over the sorted values.

    Returns (index image int32, mapping float32 (n_levels,), n_used);
    mapping[k] for k >= n_used repeats the last used value."""
    flat = np.ascontiguousarray(img, dtype=np.float32).ravel()
    n = flat.size
    order = np.argsort(flat, kind="stable")
    v = flat[order]
    max_range = np.float32(v[-1] - v[0])
    th = np.float32(1e-5)

    def boundaries(m: np.float32, cap: int) -> list[int] | None:
        """Start indices of clusters 1..K-1 under bound m; None if more
        than `cap` clusters would be needed."""
        starts: list[int] = []
        i = int(np.searchsorted(v, np.float32(v[0] + m), side="right"))
        while i < n:
            if len(starts) + 1 == cap:
                return None
            starts.append(i)
            i = int(np.searchsorted(v, np.float32(v[i] + m), side="right"))
        return starts

    lo = np.float32(0)
    hi = np.float32(max_range * np.float32(2.0) / np.float32(n_levels))
    while hi - lo > th:
        m = np.float32((hi + lo) * np.float32(0.5))
        if boundaries(m, n_levels) is not None:
            hi = m
        else:
            lo = m

    starts = boundaries(hi, n_levels + 1)
    if starts is None:
        raise AssertionError("the bound the search ended on needs too many levels")
    edges = np.asarray([0, *starts, n], dtype=np.int64)
    n_used = len(edges) - 1
    # per-cluster median value: sorted element at (start + next_start - 1) >> 1
    mapping = np.empty(n_levels, np.float32)
    mapping[:n_used] = v[(edges[:-1] + edges[1:] - 1) >> 1]
    mapping[n_used:] = mapping[n_used - 1]
    # cluster id of sorted position j = #boundaries <= j
    ids_sorted = np.searchsorted(edges[1:-1], np.arange(n), side="right")
    idx = np.empty(n, np.int32)
    idx[order] = ids_sorted
    return idx.reshape(img.shape), mapping, n_used


def from32s_to_32f(idx: np.ndarray, mapping: np.ndarray) -> np.ndarray:
    """Map quantization indexes back to float32 values
    (include/JointWMF.h:751-775)."""
    return mapping.astype(np.float32)[idx]


def joint_wmf_float(
    disp_f32,                               # (H, W) float32 map (NumPy or tensor)
    guide_u8: torch.Tensor | None = None,
    *,
    radius: int = 9,
    n_levels: int = 256,
    sigma: float = 25.5,
    findex: torch.Tensor | None = None,
    wmap: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Weighted median of a float disparity or depth map (the reference's
    CV_32F branch, include/JointWMF.h:94-143): quantise to at most
    `n_levels` levels on the host, filter the level image on the device,
    map the median levels back. Returns (H, W) float32 on the device of
    `disp_f32` if it is a tensor, else on `device` (default: the card).

    Exact mode with at most 256 levels goes through the JointWMF kernel
    (K3: `kernels.weighted_median`, its participation-weight mode with
    `valid`; CPU tensors take its plain version); table mode takes the
    plain op."""
    from primestereomatch_torch.kernels.wmf import weighted_median  # kernels import this module

    if isinstance(disp_f32, torch.Tensor):
        dev = disp_f32.device
        host = disp_f32.detach().cpu().numpy()
    else:
        dev = resolve_device(device)
        host = np.asarray(disp_f32)
    idx, mapping, _ = from32f_to_32s(host, n_levels)
    idx_t = torch.as_tensor(idx, device=dev)
    guide = None if guide_u8 is None else torch.as_tensor(guide_u8, device=dev)
    if findex is None and n_levels <= 256:
        if guide is None:
            raise ValueError("'exact' mode needs guide_u8")
        v = None if valid is None else torch.as_tensor(
            valid, dtype=torch.float32, device=dev)[None].contiguous()
        med = weighted_median(idx_t.to(torch.uint8)[None].contiguous(),
                              guide[None].contiguous(), radius, n_levels, sigma, valid=v)[0]
    else:
        med = joint_wmf(idx_t, guide, radius=radius, n_bins=n_levels, sigma=sigma,
                        findex=findex, wmap=wmap, valid=valid)
    return torch.as_tensor(mapping, device=dev)[med.to(torch.int64)]
