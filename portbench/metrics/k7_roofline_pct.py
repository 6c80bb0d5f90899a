"""K7 (the SGM scans, csrc/sgbm_scan.cu, both launches of a frame): its bound
for the frame's shapes and the mode's directions (portbench/bounds_sgbm.py)
over its profiler device time a frame, in %."""

from portbench import bounds_sgbm

KERNELS = ("sgm_scan_kernel",)


def read(w):
    ms = w.device_ms(KERNELS)
    if not ms or not w.frames or "sgbm" not in w.config:
        return None
    g, b = w.geometry, w.config["sgbm"]
    per_frame = bounds_sgbm.frame_k7_ms(g["H"], g["W"], g["D"], b["block_size"], b["mode"])
    return 100.0 * per_frame * w.frames / ms
