"""K4 (cost + low-maps, csrc/cvc_lowmaps.cu): its bound for the frame's shapes
(portbench/bounds.py) over its profiler device time a frame, in %."""

from portbench import bounds

KERNELS = ("cvc_lowmaps_kernel",)


def read(w):
    ms = w.device_ms(KERNELS)
    if not ms or not w.frames:
        return None
    g = w.geometry
    return 100.0 * bounds.frame_k4_ms(g["H"], g["W"], g["D"], g["s"], g["k"]) * w.frames / ms
