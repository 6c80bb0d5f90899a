"""Semi-global matching (STEREO_SGBM): the plain PyTorch versions of the
stages (port of primestereomatch_tpu/ops/sgbm.py, cv::StereoSGBM
semantics as specified by tests/oracle_sgbm.py).

Every stage is integer arithmetic, so each is bitwise equal to the JAX op:

  sobel_xclip            prefilter (no kernel; the JAX op is XLA)
  clipped_xderiv         the simpler prefilter variant (not on the pipeline)
  block_cost             k x k window sum of an (H, W, D) pixel cost
  bt_block_cost          BT pixel cost + k x k window sum   (plain K6)
  aggregate              SGM directional DP, 3/5/8 dirs     (plain K7)
  select_disparity_hdw   WTA, uniqueness, sub-pixel, LR     (plain K8)
  select_disparity       the same on (H, W, D) costs
  filter_speckles        connected components by min-label propagation;
                         its segmented min sweeps are K9 (kernels/speckle.py)

The pipeline (models/sgbm_pipeline.py) calls the kernel wrappers, which
run these plain versions for CPU tensors.
"""

from __future__ import annotations

import torch

from primestereomatch_torch.kernels.speckle import pack_links, speckle_sweep

BIG = 1 << 28       # the JAX package's sentinel; never wins a min
DISP_SCALE = 16     # OpenCV StereoMatcher::DISP_SCALE fixed-point factor


def _clamped(a: torch.Tensor, dim: int, off: int) -> torch.Tensor:
    """a[clamp(i + off)] along `dim`: shifted with the edge replicated."""
    n = a.shape[dim]
    # made on the device: a host-made index would be a synchronising copy
    return a.index_select(dim, (torch.arange(n, device=a.device) + off).clamp(0, n - 1))


def _shifted(a: torch.Tensor, dim: int, off: int, fill) -> torch.Tensor:
    """a[i + off] along `dim` where that index exists, else `fill`."""
    n = a.shape[dim]
    out = torch.full_like(a, fill)
    if abs(off) < n:
        out.narrow(dim, max(-off, 0), n - abs(off)).copy_(a.narrow(dim, max(off, 0),
                                                                   n - abs(off)))
    return out


def clipped_xderiv(img_u8: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-channel horizontal central difference with replicated border
    columns, clipped to [-cap, cap] and shifted to [0, 2*cap] (a simpler
    prefilter variant; the pipeline's is `sobel_xclip`). (H, W, C) uint8 ->
    (H, W, C) int32."""
    x = img_u8.to(torch.int32)
    d = _clamped(x, 1, 1) - _clamped(x, 1, -1)
    return d.clamp(-cap, cap) + cap


def sobel_xclip(img_u8: torch.Tensor, cap: int) -> torch.Tensor:
    """cv::StereoSGBM prefilter: per-channel x-Sobel with [1,2,1] vertical
    smoothing and replicated borders, clipped to [-cap, cap] and shifted to
    [0, 2*cap]. (H, W, C) uint8 -> (H, W, C) int32."""
    x = img_u8.to(torch.int32)
    d = _clamped(x, 1, 1) - _clamped(x, 1, -1)
    sob = 2 * d + _clamped(d, 0, -1) + _clamped(d, 0, 1)
    return sob.clamp(-cap, cap) + cap


def _interp(f: torch.Tensor):
    """Half-sample BT interpolants along W of (..., W) features: the min
    and max of f and its two half-way values (floor division)."""
    lo = torch.div(f + _clamped(f, -1, -1), 2, rounding_mode="floor")
    hi = torch.div(f + _clamped(f, -1, 1), 2, rounding_mode="floor")
    return (torch.minimum(torch.minimum(lo, hi), f),
            torch.maximum(torch.maximum(lo, hi), f))


def _window_sum(p: torch.Tensor, k: int) -> torch.Tensor:
    """k x k sum with replicated borders over the last two axes."""
    if k == 1:
        return p
    lo = k // 2
    for dim in (-2, -1):
        n = p.shape[dim]
        idx = torch.arange(-lo, n + k - 1 - lo, device=p.device).clamp(0, n - 1)
        pp = p.index_select(dim, idx)
        acc = pp.narrow(dim, 0, n)
        for i in range(1, k):
            acc = acc + pp.narrow(dim, i, n)
        p = acc
    return p


def block_cost(pixel_cost: torch.Tensor, block_size: int) -> torch.Tensor:
    """Sum the (H, W, D) per-pixel cost over a block_size x block_size
    window with replicated borders; the dtype is kept (int32 in, int32
    out)."""
    if block_size == 1:
        return pixel_cost
    return _window_sum(pixel_cost.permute(2, 0, 1), block_size).permute(1, 2, 0).contiguous()


def cost_dtype(cost_bound: int | None) -> torch.dtype:
    """int16 when the static window-cost bound fits, else int32 (the JAX
    op's rule)."""
    return torch.int16 if cost_bound is not None and cost_bound < 2**15 else torch.int32


def bt_block_cost(
    l_ftr: torch.Tensor,           # (H, W, C) int32 prefiltered features
    r_ftr: torch.Tensor,
    max_dis: int,
    block_size: int,
    cost_bound: int | None = None,
    out_layout: str = "hwd",
) -> torch.Tensor:
    """Birchfield-Tomasi pixel cost summed over channels, then summed over
    a block_size x block_size window of the pixel-cost plane with
    replicated borders. Disparity d compares left column x with right
    column x - d; columns x - d < 0 read right column 0. Returns (H, W, D)
    ('hwd') or (D, H, W) ('dhw'), int16 when `cost_bound` < 2**15."""
    if out_layout not in ("hwd", "dhw"):
        raise ValueError(f"out_layout must be 'hwd' or 'dhw', got {out_layout!r}")
    H, W, C = l_ftr.shape
    dev = l_ftr.device
    lc = l_ftr.to(torch.int32).permute(2, 0, 1)         # (C, H, W)
    rc = r_ftr.to(torch.int32).permute(2, 0, 1)
    l_mn, l_mx = _interp(lc)
    r_mn, r_mx = _interp(rc)
    out = torch.empty((max_dis, H, W), dtype=cost_dtype(cost_bound), device=dev)
    # d chunks keep a chunk's (C, dc, H, W) temporaries near 2**27 values
    dc = max(1, min(max_dis, (1 << 27) // max(1, C * H * W)))
    xs = torch.arange(W, device=dev)
    for d0 in range(0, max_dis, dc):
        ds = torch.arange(d0, min(d0 + dc, max_dis), device=dev)
        xr = (xs[None, :] - ds[:, None]).clamp(min=0)     # (dc, W)

        def right(a):                                     # (C, H, W) -> (C, dc, H, W)
            return a[:, :, xr].permute(0, 2, 1, 3)

        rm, rM, rf = right(r_mn), right(r_mx), right(rc)
        lf, lm, lM = (t[:, None] for t in (lc, l_mn, l_mx))
        c1 = torch.maximum(lf - rM, rm - lf).clamp(min=0)
        c2 = torch.maximum(rf - lM, lm - rf).clamp(min=0)
        pix = torch.minimum(c1, c2).sum(0, dtype=torch.int32)    # (dc, H, W)
        out[d0:d0 + len(ds)] = _window_sum(pix, block_size).to(out.dtype)
    if out_layout == "dhw":
        return out
    return out.permute(1, 2, 0).contiguous()


def _scan_direction(cost: torch.Tensor, S: torch.Tensor, p1: int, p2: int,
                    shift: int, reverse: bool) -> None:
    """One SGM direction as a scan over the leading axis of (T, N, D)
    `cost`, adding its L into the (T, N, D) view `S`. The state is a whole
    line; `shift` = +1 / -1 makes the predecessor of lane n lane n-1 / n+1
    of the previous step (a diagonal as a shear, zero state shifted in at
    the edge), as the JAX package's `_dp_line_stack` does. Missing
    predecessors are L = 0, minL = 0."""
    T, N, D = cost.shape
    dev = cost.device
    L = torch.zeros((N, D), dtype=torch.int32, device=dev)
    minL = torch.zeros((N, 1), dtype=torch.int32, device=dev)
    big = torch.full((N, 1), BIG, dtype=torch.int32, device=dev)
    zl = torch.zeros((1, D), dtype=torch.int32, device=dev)
    zm = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if shift == 1:
            L, minL = torch.cat([zl, L[:-1]]), torch.cat([zm, minL[:-1]])
        elif shift == -1:
            L, minL = torch.cat([L[1:], zl]), torch.cat([minL[1:], zm])
        d_lo = torch.cat([big, L[:, :-1]], 1)
        d_hi = torch.cat([L[:, 1:], big], 1)
        best = torch.minimum(torch.minimum(L, torch.minimum(d_lo, d_hi) + p1), minL + p2)
        L = cost[t].to(torch.int32) + best - minL
        minL = L.amin(1, keepdim=True)
        S[t] += L


def aggregate(cost: torch.Tensor, p1: int, p2: int, num_directions: int = 8) -> torch.Tensor:
    """Sum of the SGM directional DP over the directions of a mode:
    8 (MODE_HH): W<->E, N<->S and both diagonals both ways; 5 (MODE_SGBM):
    W->E, E->W, N->S, NW->SE, NE->SW; 3 (MODE_SGBM_3WAY): W->E, E->W, N->S.
    Per direction L'(p, d) = C(p, d) + min(L(d), L(d+-1) + P1, minL + P2)
    - minL. cost (H, W, D) integer -> S (H, W, D) int32."""
    if num_directions not in (3, 5, 8):
        raise ValueError(f"num_directions must be 3, 5 or 8, got {num_directions}")
    H, W, D = cost.shape
    S = torch.zeros((H, W, D), dtype=torch.int32, device=cost.device)
    cx, sx = cost.transpose(0, 1), S.transpose(0, 1)      # x-scans: (W, H, D)
    _scan_direction(cx, sx, p1, p2, 0, reverse=False)     # W -> E
    _scan_direction(cx, sx, p1, p2, 0, reverse=True)      # E -> W
    down = {3: (0,), 5: (0, 1, -1), 8: (0, 1, -1)}[num_directions]
    for sh in down:                                       # N->S, NW->SE, NE->SW
        _scan_direction(cost, S, p1, p2, sh, reverse=False)
    if num_directions == 8:
        for sh in (0, 1, -1):                             # S->N, SW->NE, SE->NW
            _scan_direction(cost, S, p1, p2, sh, reverse=True)
    return S


def _subpixel_frac(s_m, s_p, s_best, d_best, D):
    """OpenCV's integer sub-pixel step: trunc(((S[d-1] - S[d+1]) * 16 +
    denom2) / (2 * denom2)), denom2 = max(curvature, 1); 0 at the d ends."""
    interior = (d_best > 0) & (d_best < D - 1)
    denom2 = torch.clamp(s_m + s_p - 2 * s_best, min=1)
    num = (s_m - s_p) * DISP_SCALE + denom2
    return torch.where(interior, torch.div(num, 2 * denom2, rounding_mode="trunc"), 0)


def _lr_dual_check(disp16, disp2, inv_val: int, disp12_max_diff: int, min_disparity: int):
    """OpenCV's floor/ceil dual LR check: a valid pixel is invalidated only
    if BOTH rounded disparities look up a valid, inconsistent disp2 entry.
    disp2 holds actual disparities (invalid = min_disparity - 1)."""
    if disp12_max_diff < 0:
        return disp16
    H, W = disp16.shape
    x = torch.arange(W, device=disp16.device)[None, :]
    valid = disp16 != inv_val
    d_f = disp16 >> 4
    d_c = (disp16 + DISP_SCALE - 1) >> 4

    def look(dd):
        xi = x - dd
        ok = (xi >= 0) & (xi < W)
        v = torch.gather(disp2, 1, xi.clamp(0, W - 1))
        return ok & (v >= min_disparity), v

    okf, vf = look(d_f)
    okc, vc = look(d_c)
    lr_bad = (valid & okf & ((vf - d_f).abs() > disp12_max_diff)
              & okc & ((vc - d_c).abs() > disp12_max_diff))
    return torch.where(lr_bad, inv_val, disp16)


def select_disparity_hdw(
    S: torch.Tensor,               # (H, D, W) int32 aggregated cost
    uniqueness_ratio: int,
    disp12_max_diff: int,
    min_disparity: int = 0,
) -> torch.Tensor:
    """cv::StereoSGBM's selection on (H, D, W) costs: first-min WTA,
    uniqueness (a far d with S[d]*(100-u) < minS*100 rejects the pixel),
    truncating integer sub-pixel, the minX band, the scatter-based pseudo
    right disparity (right pixel x - (d + minD) takes the lowest cost among
    unique left pixels, ties to the smaller d) and the floor/ceil dual LR
    check. Returns (H, W) int16 disparity x 16; invalid pixels are
    (min_disparity - 1) * 16.

    The scatter follows tests/oracle_sgbm.py for every min_disparity: a
    candidate whose right pixel lies in [0, W) is kept. (The JAX package's
    `select_disparity_hdw` drops candidates with x < d_best, which only
    exist when min_disparity < 0; its `select_disparity` keeps them.)"""
    H, D, W = S.shape
    dev = S.device
    S = S.to(torch.int32)
    minD = min_disparity
    minX1 = max(minD + D, 0)
    maxX1 = W + min(minD, 0)
    s_best, d_best = S.min(1)                     # first minimum
    d_best = d_best.to(torch.int32)
    d_idx = torch.arange(D, device=dev, dtype=torch.int32)[None, :, None]
    far = (d_idx - d_best[:, None]).abs() > 1
    s_alt = torch.where(far, S, BIG).amin(1)     # d_best itself adds BIG
    not_unique = (s_alt < BIG) & (s_alt * (100 - uniqueness_ratio) < s_best * 100)
    s_m = S.gather(1, (d_best - 1).clamp(0, D - 1)[:, None].long())[:, 0]
    s_p = S.gather(1, (d_best + 1).clamp(0, D - 1)[:, None].long())[:, 0]
    frac = _subpixel_frac(s_m, s_p, s_best, d_best, D)
    disp16 = (d_best + minD) * DISP_SCALE + frac

    x = torch.arange(W, device=dev)[None, :]
    valid0 = (x >= minX1) & (x < maxX1) & ~not_unique
    inv_val = (minD - 1) * DISP_SCALE
    disp16 = torch.where(valid0, disp16, inv_val)

    # pseudo right disparity: ascending d, strict < keeps the smaller d
    cand = torch.where(valid0, s_best, BIG)
    d2cost = torch.full((H, W), BIG, dtype=torch.int32, device=dev)
    disp2 = torch.full((H, W), minD - 1, dtype=torch.int32, device=dev)
    for d in range(D):
        cd = _shifted(torch.where(d_best == d, cand, BIG), 1, d + minD, BIG)
        take = cd < d2cost
        d2cost = torch.where(take, cd, d2cost)
        disp2 = torch.where(take, d + minD, disp2)
    return _lr_dual_check(disp16, disp2, inv_val, disp12_max_diff, minD).to(torch.int16)


def select_disparity(
    S: torch.Tensor,               # (H, W, D) int32 aggregated cost
    uniqueness_ratio: int,
    disp12_max_diff: int,
    min_disparity: int = 0,
) -> torch.Tensor:
    """`select_disparity_hdw` on (H, W, D) costs (the JAX package's
    `select_disparity`, which follows tests/oracle_sgbm.py at every
    min_disparity as the port does). Returns (H, W) int16 disparity x 16."""
    return select_disparity_hdw(S.permute(0, 2, 1), uniqueness_ratio, disp12_max_diff,
                                min_disparity)


def speckle_graph(disp16: torch.Tensor, max_diff: int, invalid_value: int):
    """The speckle filter's start: the valid mask, the initial labels (the
    linear index of a valid pixel, H * W elsewhere) and the links to the
    up, down, left and right neighbours (both valid, |diff| <= max_diff)."""
    H, W = disp16.shape
    d = disp16.to(torch.int32)
    valid = d != invalid_value
    labels = torch.where(
        valid, torch.arange(H * W, dtype=torch.int32, device=d.device).view(H, W), H * W)

    def conn(dim, off):
        return valid & _shifted(valid, dim, off, False) & (
            (d - _shifted(d, dim, off, 0)).abs() <= max_diff)

    return valid, labels, (conn(0, -1), conn(0, 1), conn(1, -1), conn(1, 1))


# the sweeps (K9's) filter_speckles ran, for the app's `stream_counts`; it
# reads one int (a host sync) every `steps_per_check` of them
SPECKLE_SWEEPS = {"count": 0}


def filter_speckles(
    disp16: torch.Tensor,          # (H, W) int16 fixed-point disparities
    max_speckle_size: int,
    max_diff: int,                 # on the same scale as disp16 (16 * range)
    invalid_value: int,
    max_iters: int | None = None,
    steps_per_check: int = 2,
) -> torch.Tensor:
    """cv::filterSpeckles: 4-connected components of valid pixels whose
    neighbours differ by at most `max_diff`; components of at most
    `max_speckle_size` pixels become `invalid_value`.

    Components by min-label propagation: each sweep is a hook step (the
    min label over linked neighbours) and then segmented min scans along
    rows and along columns (K9, kernels/speckle.py::speckle_sweep: two
    launches, the links packed into one uint8 mask), so a label crosses a
    whole straight run in one sweep. The loop runs until a check finds no
    label changed; a check follows every `steps_per_check` sweeps and reads
    one int that the sweeps stamp where a label changed (one host sync),
    and the result is the same for any value.
    `max_iters` caps the sweeps (None: run to convergence). Areas by
    scatter_add_."""
    H, W = disp16.shape
    dev = disp16.device
    valid, labels, conns = speckle_graph(disp16, max_diff, invalid_value)
    links = pack_links(*conns)
    changed = torch.zeros(1, dtype=torch.int32, device=dev)

    it = 0
    while max_iters is None or it < max_iters:
        stamp = it // steps_per_check + 1
        for _ in range(steps_per_check):
            labels = speckle_sweep(labels, links, changed, stamp)
        it += steps_per_check
        SPECKLE_SWEEPS["count"] += steps_per_check
        if int(changed.item()) != stamp:
            break

    areas = torch.zeros(H * W + 1, dtype=torch.int32, device=dev)
    areas.scatter_add_(0, labels.reshape(-1).long(), valid.reshape(-1).to(torch.int32))
    speckle = valid & (areas[labels.long()] <= max_speckle_size)
    return disp16.masked_fill(speckle, invalid_value)
