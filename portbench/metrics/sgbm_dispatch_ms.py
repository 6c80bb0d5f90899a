"""Host ms a frame of the SGBM entry, `psm.sgbm.forward` whole: its Python,
the prefilter, the launches of K6, K7, K8 and K9, and the waits of K9's host
checks for the device."""


def read(w):
    return w.program_ms("psm.sgbm.forward")
