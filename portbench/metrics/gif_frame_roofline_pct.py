"""The GIF frame's least time on the card, the sum of the K4, K2 and K3
bounds of its shapes (and K3's of its output), over the wall ms a frame of
the traced window, in %. It reads the same work whatever kernels do it."""

from portbench import bounds
from portbench.metrics.k3_roofline_pct import frames_bound_ms


def read(w):
    if not w.frames or not w.k3_outputs or not w.device:
        return None
    g = w.geometry
    per_frame = (bounds.frame_k4_ms(g["H"], g["W"], g["D"], g["s"], g["k"])
                 + bounds.frame_k2_ms(g["H"], g["W"], g["D"], g["s"])
                 + frames_bound_ms(w) / len(w.k3_outputs))
    return 100.0 * per_frame / (w.window_s * 1e3 / w.frames)
