"""K9 sweeps a frame: the change of `StereoMatchApp.stream_counts
["speckle_sweeps"]` over the window, per frame. It follows the scene: as many
sweeps as its components need to settle, a host sync every two."""


def read(w):
    sweeps = (w.counts or {}).get("speckle_sweeps")
    if sweeps is None or not w.frames or "sgbm" not in w.config:
        return None
    return sweeps / w.frames
