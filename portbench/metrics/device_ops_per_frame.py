"""Device operations (kernels, copies and fills in the profiler's trace) a
frame: the host's dispatch work the app, the GIF entry and the tail
dispatch cost each frame."""


def read(w):
    if not w.frames or not w.device:
        return None
    return len(w.device) / w.frames
