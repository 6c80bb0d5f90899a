"""K2 (upsample + WTA, csrc/wta.cu): its bound for the frame's shapes
(portbench/bounds.py) over its profiler device time a frame, in %."""

from portbench import bounds

KERNELS = ("upsample_wta_kernel", "upsample_wta_staged_kernel")


def read(w):
    ms = w.device_ms(KERNELS)
    if not ms or not w.frames:
        return None
    g = w.geometry
    return 100.0 * bounds.frame_k2_ms(g["H"], g["W"], g["D"], g["s"]) * w.frames / ms
