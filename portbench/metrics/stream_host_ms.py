"""Host ms a frame of the app's stream itself: `psm.stream.dispatch` less
the program spans inside it (the Rectifier, the GIF entry), plus
`psm.stream.fetch`. The staging copies into the pinned slots, the upload,
the u8 to f32 scale, the result copies and the event; the clones out of the
slots and the FrameResult."""


def read(w):
    dispatch = w.program_ms("psm.stream.dispatch", own=True)
    fetch = w.program_ms("psm.stream.fetch")
    if dispatch is None or fetch is None:
        return None
    return dispatch + fetch
