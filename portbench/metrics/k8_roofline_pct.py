"""K8 (the selection, csrc/select.cu): its bound for the frame's shapes
(portbench/bounds_sgbm.py) over its profiler device time a frame, in %."""

from portbench import bounds_sgbm

KERNELS = ("select_kernel",)


def read(w):
    ms = w.device_ms(KERNELS)
    if not ms or not w.frames:
        return None
    g = w.geometry
    return 100.0 * bounds_sgbm.frame_k8_ms(g["H"], g["W"], g["D"]) * w.frames / ms
