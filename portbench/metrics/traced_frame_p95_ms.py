"""The 95th percentile of the traced window's frame latencies, in ms, taken
as the untraced `frame_p95_ms` is. It stands for that tail in a cell where
the tail follows the shared host's pace too closely to hold a bound
(`gif_zed2k.max`: since the host keeps level with the device at 2K)."""

import numpy as np


def read(w):
    if not w.latency_ms:
        return None
    return float(np.percentile(w.latency_ms, 95))
