"""K3 (JointWMF, csrc/wmf.cu, its weight table included): its bound for each
frame's shapes and output (portbench/bounds.py) over its profiler device
time, summed over the traced frames, in %."""

from portbench import bounds

KERNELS = ("joint_wmf_kernel", "wmf_weights_kernel")


def frames_bound_ms(w) -> float:
    """K3's bound summed over the traced frames (a pool frame's once)."""
    g = w.geometry
    by_id: dict = {}
    for out in w.k3_outputs:
        if id(out) not in by_id:
            by_id[id(out)] = bounds.frame_k3_ms(out, g["radius"], g["D"])
    return sum(by_id[id(out)] for out in w.k3_outputs)


def read(w):
    ms = w.device_ms(KERNELS)
    if not ms or not w.k3_outputs:
        return None
    return 100.0 * frames_bound_ms(w) / ms
