"""The share of the window's frames whose result was already done on the
device when the stream came to wait for it (`StereoMatchApp.stream_counts`),
in %: at 100% the host, not the device, sets the pace."""


def read(w):
    if not w.counts or not w.counts.get("frames"):
        return None
    return 100.0 * w.counts["ready_at_wait"] / w.counts["frames"]
