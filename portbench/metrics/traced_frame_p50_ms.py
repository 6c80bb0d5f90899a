"""The median of the traced window's frame latencies, in ms, taken as the
untraced `frame_p50_ms` is. It stands for that median in a cell where it
follows the shared host's pace too closely to hold a bound
(`gif_zed2k.max`: the host keeps level with the device at 2K, and a slower
host sets the pace of a whole run)."""

import numpy as np


def read(w):
    if not w.latency_ms:
        return None
    return float(np.percentile(w.latency_ms, 50))
