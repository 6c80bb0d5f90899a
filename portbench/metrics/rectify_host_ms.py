"""Host ms a frame of the Rectifier, `psm.rectify` whole: both eyes' taps
gathered over the crop box on the card."""


def read(w):
    return w.program_ms("psm.rectify")
