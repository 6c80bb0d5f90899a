"""Host ms a frame of the GIF entry, `psm.gif.forward` whole: its Python,
the plain-torch prep (guide statistics, gradients) and the launches of the
cost, low-maps, WTA and JointWMF kernels."""


def read(w):
    return w.program_ms("psm.gif.forward")
