"""The plain reference of STEREO_SGBM: cv::StereoSGBM with the parameter set of
the reference (src/StereoMatch.cpp:639-660), in plain torch on the device the
frames are on, importing nothing of the program.

It is a vectorised transcription of `tests/oracle_sgbm.py`, the executable
specification of the semantics, composed as the pipeline composes it:

  prefilter  per channel the x-derivative with [1,2,1] vertical smoothing,
             replicated borders, clipped to [-cap, cap] and shifted by cap
  cost       Birchfield-Tomasi over the channels (left column x against
             right column max(x - d, 0), d in [0, D)), summed over a k x k
             window with replicated borders
  aggregate  one SGM recurrence a direction (8: MODE_HH, 5: MODE_SGBM, 3:
             MODE_SGBM_3WAY), a step at a time over whole lines of (., D); a
             pixel without a predecessor starts at its cost
  select     the first minimum, uniqueness over the disparities more than one
             away, OpenCV's truncating sub-pixel step, d labelled d +
             min_disparity; the band x < minX1, x >= maxX1 invalid; the
             pseudo-right view by scatter (the lowest cost wins, ties to the
             lowest x); the floor / ceil dual LR check
  speckle    4-connected components of valid pixels whose neighbours differ
             by at most 16 * speckle_range; those of at most
             speckle_window_size pixels become invalid

Departures from the oracle, none of them in the integers: the speckle
components are found by min-label propagation over the links, each label's
own pixel hooked to the smaller label too (scatter with `amin`), then pointer
jumping, until no label changes, in place of the oracle's flood fill; the
pseudo-right view's "lowest cost, then lowest x" is one `amin` over a packed
int64 key (cost, x) in place of the oracle's walk in x; the window sums are
differences of running sums. Each gives the oracle's integers
(tests/test_sgbm_plain_reference.py holds them to it bit for bit).

`disparity16` gives the (h, w) int16 disparities x 16, invalid (min_disparity
- 1) * 16; `disparities` the app's canonical display of them, max(d16, 0) //
16 clipped to [0, num_disparities - 1], beside an all-zero right view: the
reference's SGBM is left-only. The display comes in the smallest unsigned
type that holds it (`reference.disparity_dtype`): uint8 up to 256
disparities, uint16 past them, where a uint8 would wrap 256 and up.
"""

from __future__ import annotations

import torch

from portbench.reference import disparity_dtype

DISP_SCALE = 16          # OpenCV's fixed-point factor of the disparities
BIG = 1 << 30            # beyond any aggregated cost; never wins a minimum
# the SGM directions (dy, dx): a pixel's predecessor is (y - dy, x - dx); a
# mode takes the first n
DIRECTIONS = ((0, 1), (0, -1), (1, 0), (1, 1), (1, -1), (-1, 0), (-1, -1), (-1, 1))
MODE_DIRECTIONS = {"hh": 8, "sgbm": 5, "3way": 3}
CHUNK_VALUES = 1 << 26   # values of the largest temporary the cost and selection hold


def _clamped(n: int, off: int, dev) -> torch.Tensor:
    """Indices i + off of an axis of length n, clamped to it."""
    return (torch.arange(n, device=dev) + off).clamp(0, n - 1)


def prefilter(img: torch.Tensor, cap: int) -> torch.Tensor:
    """(H, W, C) uint8 -> (H, W, C) int32 in [0, 2 cap]."""
    H, W, _ = img.shape
    x = img.to(torch.int32)
    dx = x[:, _clamped(W, 1, x.device)] - x[:, _clamped(W, -1, x.device)]
    sob = 2 * dx + dx[_clamped(H, -1, x.device)] + dx[_clamped(H, 1, x.device)]
    return sob.clamp(-cap, cap) + cap


def _half_range(f: torch.Tensor):
    """The least and greatest of f and its two half-way values along x."""
    W = f.shape[1]
    lo = (f + f[:, _clamped(W, -1, f.device)]) // 2
    hi = (f + f[:, _clamped(W, 1, f.device)]) // 2
    return torch.minimum(torch.minimum(lo, hi), f), torch.maximum(torch.maximum(lo, hi), f)


def _box(p: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Sum over a window of k along `dim` with the edge replicated, as the
    difference of running sums."""
    n = p.shape[dim]
    lo = k // 2
    idx = torch.arange(-lo, n + k - 1 - lo, device=p.device).clamp(0, n - 1)
    cs = p.index_select(dim, idx).cumsum(dim, dtype=torch.int32)
    zero = torch.zeros_like(cs.narrow(dim, 0, 1))
    cs = torch.cat([zero, cs], dim)
    return cs.narrow(dim, k, n) - cs.narrow(dim, 0, n)


def cost_volume(lf: torch.Tensor, rf: torch.Tensor, D: int, k: int) -> torch.Tensor:
    """(H, W, C) int32 features -> (H, W, D) int32 window costs."""
    H, W, C = lf.shape
    dev = lf.device
    l_min, l_max = _half_range(lf)
    r_min, r_max = _half_range(rf)
    out = torch.empty((H, W, D), dtype=torch.int32, device=dev)
    step = max(1, min(D, CHUNK_VALUES // (H * W * C)))
    xs = torch.arange(W, device=dev)
    for d0 in range(0, D, step):
        ds = torch.arange(d0, min(d0 + step, D), device=dev)
        xr = (xs[:, None] - ds[None, :]).clamp(min=0)          # (W, d)
        r, rn, rx = (t[:, xr] for t in (rf, r_min, r_max))      # (H, W, d, C)
        lv, ln, lx = (t[:, :, None] for t in (lf, l_min, l_max))
        c1 = torch.maximum(lv - rx, rn - lv).clamp(min=0)
        c2 = torch.maximum(r - lx, ln - r).clamp(min=0)
        pix = torch.minimum(c1, c2).sum(-1, dtype=torch.int32)  # (H, W, d)
        out[:, :, d0:d0 + len(ds)] = _box(_box(pix, k, 0), k, 1)
    return out


def _step(prev: torch.Tensor, cost: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """L = C + min(L'(d), L'(d +- 1) + P1, min L' + P2) - min L' over lines of
    (., D); `prev` holds L' padded with BIG at both ends of D."""
    core = prev[..., 1:-1]
    m = core.amin(-1, keepdim=True)
    best = torch.minimum(prev[..., :-2], prev[..., 2:]) + p1
    best = torch.minimum(torch.minimum(best, core), m + p2)
    return best - m + cost


def aggregate(cost: torch.Tensor, p1: int, p2: int, n_dirs: int) -> torch.Tensor:
    """(H, W, D) costs -> (H, W, D) int32 sums over the first `n_dirs`
    DIRECTIONS of each direction's L."""
    H, W, D = cost.shape
    dev = cost.device
    dirs = DIRECTIONS[:n_dirs]
    S = torch.zeros((H, W, D), dtype=torch.int32, device=dev)
    # along x, the directions with dy = 0 at once: step t is column t going
    # east and column W - 1 - t going west; the state is (dirs, H, D + 2)
    dxs = [dx for dy, dx in dirs if dy == 0]
    cols = torch.stack([torch.arange(W, device=dev) if dx > 0
                        else torch.arange(W - 1, -1, -1, device=dev) for dx in dxs], 1)
    state = torch.zeros((len(dxs), H, D + 2), dtype=torch.int32, device=dev)
    state[..., 0] = state[..., -1] = BIG
    for t in range(W):
        c = cost.index_select(1, cols[t]).transpose(0, 1)        # (dirs, H, D)
        L = _step(state, c, p1, p2)
        state[..., 1:-1] = L
        S.index_add_(1, cols[t], L.transpose(0, 1))
    # along y, the directions of one dy at once, row by row: a direction's
    # predecessor of column x is column x - dx of the previous row, read from
    # a state with a zero column at each side (no predecessor)
    for sign in (1, -1):
        dxs = [dx for dy, dx in dirs if dy == sign]
        if not dxs:
            continue
        G = len(dxs)
        state = torch.zeros((G, W + 2, D + 2), dtype=torch.int32, device=dev)
        state[..., 0] = state[..., -1] = BIG
        pred = torch.stack([g * (W + 2) + torch.arange(W, device=dev) - dx + 1
                            for g, dx in enumerate(dxs)])        # (dirs, W)
        flat = state.view(G * (W + 2), D + 2)
        for y in (range(H) if sign > 0 else range(H - 1, -1, -1)):
            L = _step(flat[pred], cost[y], p1, p2)
            state[:, 1:-1, 1:-1] = L
            S[y] += L.sum(0, dtype=torch.int32)
    return S


def select(S: torch.Tensor, uniqueness: int, disp12_max_diff: int,
           min_disparity: int) -> torch.Tensor:
    """(H, W, D) int32 aggregated costs -> (H, W) int32 disparities x 16."""
    H, W, D = S.shape
    dev = S.device
    minD = min_disparity
    inv = (minD - 1) * DISP_SCALE
    minX1, maxX1 = max(minD + D, 0), W + min(minD, 0)
    x = torch.arange(W, device=dev)
    ds = torch.arange(D, device=dev, dtype=torch.int32)
    s_best = torch.empty((H, W), dtype=torch.int32, device=dev)
    d_best = torch.empty((H, W), dtype=torch.int32, device=dev)
    unique = torch.empty((H, W), dtype=torch.bool, device=dev)
    frac = torch.empty((H, W), dtype=torch.int32, device=dev)
    rows = max(1, CHUNK_VALUES // (W * D))
    for y0 in range(0, H, rows):
        s = S[y0:y0 + rows]
        sb = s.amin(-1)
        db = torch.where(s == sb[..., None], ds, D).amin(-1)     # the first minimum
        far = (ds - db[..., None]).abs() > 1
        unique[y0:y0 + rows] = ~(far & (s * (100 - uniqueness) < sb[..., None] * 100)).any(-1)
        sm = s.gather(-1, (db - 1).clamp(0, D - 1)[..., None].long())[..., 0]
        sp = s.gather(-1, (db + 1).clamp(0, D - 1)[..., None].long())[..., 0]
        denom2 = (sm + sp - 2 * sb).clamp(min=1)
        f = torch.div((sm - sp) * DISP_SCALE + denom2, 2 * denom2, rounding_mode="trunc")
        frac[y0:y0 + rows] = torch.where((db > 0) & (db < D - 1), f, 0)
        s_best[y0:y0 + rows], d_best[y0:y0 + rows] = sb, db
    valid = (x >= minX1) & (x < maxX1) & unique
    disp = torch.where(valid, (d_best + minD) * DISP_SCALE + frac, inv)

    # the pseudo-right view: right pixel x - (d + minD) takes the lowest cost
    # of the valid left pixels that land on it, ties to the lowest x
    x2 = x - (d_best + minD)
    land = valid & (x2 >= 0) & (x2 < W)
    bits = W.bit_length()
    key = (s_best.long() << bits) | x.expand(H, W)
    target = torch.arange(H, device=dev)[:, None] * W + x2
    none = torch.iinfo(torch.int64).max
    won = torch.full((H * W,), none, dtype=torch.int64, device=dev)
    won.scatter_reduce_(0, target[land], key[land], "amin")
    won = won.view(H, W)
    disp2 = torch.where(won != none, (won & ((1 << bits) - 1)) - x, minD - 1)

    def inconsistent(dd):
        xi = x - dd
        v = disp2.gather(1, xi.clamp(0, W - 1))
        return (xi >= 0) & (xi < W) & (v >= minD) & ((v - dd).abs() > disp12_max_diff)

    if disp12_max_diff >= 0:
        bad = valid & inconsistent(disp >> 4) & inconsistent((disp + DISP_SCALE - 1) >> 4)
        disp = torch.where(bad, inv, disp)
    return disp


def speckles(disp: torch.Tensor, max_size: int, max_diff: int, inv: int) -> torch.Tensor:
    """(H, W) disparities with the 4-connected components (|diff| <=
    max_diff between neighbours) of at most max_size valid pixels set to inv."""
    H, W = disp.shape
    dev = disp.device
    d = disp.to(torch.int32)
    valid = d != inv
    idx = torch.arange(H * W, device=dev).view(H, W)
    ends = []
    for a, b in ((idx[:, :-1], idx[:, 1:]), (idx[:-1], idx[1:])):
        da, db = d.view(-1)[a], d.view(-1)[b]
        link = valid.view(-1)[a] & valid.view(-1)[b] & ((da - db).abs() <= max_diff)
        ends.append((a[link], b[link]))
    a = torch.cat([e[0] for e in ends])
    b = torch.cat([e[1] for e in ends])
    label = torch.arange(H * W, device=dev)
    while True:
        la, lb = label[a], label[b]
        m = torch.minimum(la, lb)
        new = label.clone()
        for at in (a, b, la, lb):
            new.scatter_reduce_(0, at, m, "amin")
        new = new[new]
        if torch.equal(new, label):
            break
        label = new
    flat_valid = valid.view(-1)
    areas = torch.bincount(label[flat_valid], minlength=H * W)
    small = flat_valid & (areas[label] <= max_size)
    return torch.where(small.view(H, W), inv, d)


def disparity16(left_u8: torch.Tensor, right_u8: torch.Tensor, block: dict) -> torch.Tensor:
    """(h, w, C) uint8 views on one device and the configuration's `sgbm`
    block -> (h, w) int16 disparities x 16."""
    b = block
    lf, rf = (prefilter(v, b["pre_filter_cap"]) for v in (left_u8, right_u8))
    cost = cost_volume(lf, rf, b["num_disparities"], b["block_size"])
    del lf, rf
    S = aggregate(cost, b["p1"], b["p2"], MODE_DIRECTIONS[b["mode"]])
    del cost
    disp = select(S, b["uniqueness_ratio"], b["disp12_max_diff"], b["min_disparity"])
    del S
    if b["speckle_window_size"] > 0:
        disp = speckles(disp, b["speckle_window_size"], DISP_SCALE * b["speckle_range"],
                        (b["min_disparity"] - 1) * DISP_SCALE)
    return disp.to(torch.int16)


def disparities(left_u8: torch.Tensor, right_u8: torch.Tensor, block: dict,
                dtype=torch.float32) -> torch.Tensor:
    """Both views as the app hands them back: (2, h, w) in
    `disparity_dtype(num_disparities)`, the left view's canonical display and
    an all-zero right view. Every stage is integer, so `dtype` changes
    nothing."""
    D = block["num_disparities"]
    d16 = disparity16(left_u8, right_u8, block).to(torch.int32)
    left = (d16.clamp(min=0) // DISP_SCALE).clamp(0, D - 1)
    return torch.stack([left, torch.zeros_like(left)]).to(disparity_dtype(D))
