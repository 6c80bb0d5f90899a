"""K6 (BT cost + window sum, csrc/bt_cost.cu): its bound for the frame's shapes
(portbench/bounds_sgbm.py) over its profiler device time a frame, in %."""

from portbench import bounds_sgbm

KERNELS = ("bt_cost_kernel",)


def read(w):
    ms = w.device_ms(KERNELS)
    if not ms or not w.frames or "sgbm" not in w.config:
        return None
    g, b = w.geometry, w.config["sgbm"]
    return 100.0 * bounds_sgbm.frame_k6_ms(g["H"], g["W"], g["D"], b["block_size"]) * w.frames / ms
