"""Host-side feature clustering for the 'table'-mode joint WMF (own copy
of the JAX package's utils/features.py, bitwise the same NumPy).

Reimplements the reference's featureIndexing contract
(include/JointWMF.h:494-660): quantize guide colors to 6 bits/channel,
k-means++ cluster the UNIQUE quantized colors (unweighted samples, hash
iteration order B,G,R) into nF feature indexes, and tabulate the pairwise
weight wMap[i][j] from the cluster centers with sigma rescaled to the
6-bit range (nSigma = sigma/256*64). The per-pixel index map + wMap feed
ops/jointwmf.py::joint_wmf in table mode (`findex`, `wmap`).

This is offline preprocessing (once per guide image), NumPy on the host;
the clustering approximates the exact pairwise color weights that exact
mode computes directly on the device.
"""

from __future__ import annotations

import numpy as np

WEIGHT_OPS = ("exp", "iv1", "iv2", "cos", "jac", "off")


def _kmeans_pp(samples: np.ndarray, k: int, rng: np.random.Generator,
               max_iter: int = 100) -> tuple[np.ndarray, np.ndarray]:
    """k-means with k-means++ seeding (Lloyd iterations to convergence)."""
    n = samples.shape[0]
    centers = np.empty((k, samples.shape[1]), np.float32)
    centers[0] = samples[rng.integers(n)]
    d2 = np.sum((samples - centers[0]) ** 2, axis=1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        centers[i] = samples[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.sum((samples - centers[i]) ** 2, axis=1))

    labels = np.zeros(n, np.int32)
    for _ in range(max_iter):
        # chunked distance computation keeps memory bounded
        d = (
            np.sum(samples * samples, axis=1)[:, None]
            - 2.0 * samples @ centers.T
            + np.sum(centers * centers, axis=1)[None, :]
        )
        new_labels = np.argmin(d, axis=1).astype(np.int32)
        if np.array_equal(new_labels, labels) and _ > 0:
            break
        labels = new_labels
        for c in range(k):
            m = labels == c
            if m.any():
                centers[c] = samples[m].mean(axis=0)
    return labels, centers


def weight_table(centers: np.ndarray, sigma: float, weight_type: str = "exp") -> np.ndarray:
    """(nF, nF) pairwise weights between cluster centers — the reference's
    wMap ops exp/iv1/iv2/cos/jac/off (include/JointWMF.h:637-648)."""
    if weight_type not in WEIGHT_OPS:
        weight_type = "exp"
    c = centers.astype(np.float32)
    diff = c[:, None, :] - c[None, :, :]
    if weight_type == "exp":
        divider = 1.0 / (2.0 * sigma * sigma)
        return np.exp(-np.sum(diff * diff, axis=-1) * divider).astype(np.float32)
    if weight_type == "iv2":
        return (1.0 / (np.sum(diff * diff, axis=-1) + sigma * sigma)).astype(np.float32)
    if weight_type == "iv1":
        return (1.0 / (np.sum(np.abs(diff), axis=-1) + sigma)).astype(np.float32)
    if weight_type == "cos":
        length = np.linalg.norm(c, axis=1)
        denom = np.maximum(length[:, None] * length[None, :], 1e-12)
        return ((c @ c.T) / denom).astype(np.float32)
    if weight_type == "jac":
        mn = np.minimum(c[:, None, :], c[None, :, :]).sum(-1)
        mx = np.maximum(c[:, None, :], c[None, :, :]).sum(-1)
        return (mn / np.maximum(mx, 1e-12)).astype(np.float32)
    return np.ones((c.shape[0], c.shape[0]), np.float32)  # 'off'


def feature_index_color(
    guide_bgr_u8: np.ndarray,      # (H, W, 3) uint8, BGR (imread order)
    n_feat: int = 256,
    sigma: float = 25.5,
    weight_type: str = "exp",
    seed: int = 0,
    max_iter: int = 100,
) -> tuple[np.ndarray, np.ndarray]:
    """3-channel featureIndexing: returns (findex (H, W) int32, wmap (nF, nF)).

    Mirrors include/JointWMF.h:545-660: 6-bit quantization, unique-color
    k-means++ (samples ordered by the B,G,R hash sweep), centers-based
    weight table with nSigma = sigma/256*64.
    """
    g = np.asarray(guide_bgr_u8, np.uint8)
    H, W, _ = g.shape
    low = (g >> 2).astype(np.int32)                      # 6-bit B,G,R
    code = (low[..., 0] * 64 + low[..., 1]) * 64 + low[..., 2]  # hash[B][G][R]
    uniq, inverse = np.unique(code.reshape(-1), return_inverse=True)
    cand = np.stack([uniq // 4096, (uniq // 64) % 64, uniq % 64], axis=1)
    k = min(n_feat, len(uniq))

    if len(uniq) <= k:
        labels = np.arange(len(uniq), dtype=np.int32)
        centers = cand.astype(np.float32)
    else:
        rng = np.random.default_rng(seed)
        labels, centers = _kmeans_pp(cand.astype(np.float32), k, rng, max_iter)

    findex = labels[inverse].reshape(H, W).astype(np.int32)
    n_sigma = sigma / 256.0 * 64.0
    wmap = weight_table(centers, n_sigma, weight_type)
    return findex, wmap


def feature_index_gray(
    n_feat: int = 256, sigma: float = 25.5, weight_type: str = "exp"
) -> np.ndarray:
    """1-channel wMap (include/JointWMF.h:518-541): indexes ARE the 256
    intensity levels; returns the (256, 256) weight table (sigma unscaled)."""
    centers = np.arange(n_feat, dtype=np.float32)[:, None]
    return weight_table(centers, sigma, weight_type)
