"""Profiler device ms a frame of every kernel that is not one of the port's
csrc/ kernels and is not a copy: the plain-torch stages (gradients, guide
statistics, the quasi-width cost, the u8 to f32 scale, the Rectifier)."""

from portbench.trace import kernel_pattern


def read(w):
    if not w.frames:
        return None
    pat = kernel_pattern(w.port_kernels)
    ms = sum(e - s for n, s, e in w.kernels() if not pat.search(n)) / 1e3
    return ms / w.frames if ms else None
