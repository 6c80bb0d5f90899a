"""K9 (the speckle filter's sweeps, csrc/speckle.cu, a row and a column launch
a sweep): one sweep's bound (portbench/bounds_sgbm.py) times the sweeps the
window's frames ran (`StereoMatchApp.stream_counts["speckle_sweeps"]`) over
the kernels' profiler device time, in %."""

from portbench import bounds_sgbm

KERNELS = ("speckle_rows_kernel", "speckle_cols_kernel")


def read(w):
    ms = w.device_ms(KERNELS)
    sweeps = (w.counts or {}).get("speckle_sweeps")
    if not ms or not sweeps:
        return None
    g = w.geometry
    return 100.0 * bounds_sgbm.sweep_ms(g["H"], g["W"]) * sweeps / ms
