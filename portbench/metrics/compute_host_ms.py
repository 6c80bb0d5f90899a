"""Host ms a frame of the app's compute() around the algorithm:
`psm.compute.upload` (both views' pageable uploads) plus `psm.compute.fetch`
(the results and frames brought back as host arrays)."""


def read(w):
    upload = w.program_ms("psm.compute.upload")
    fetch = w.program_ms("psm.compute.fetch")
    if upload is None or fetch is None:
        return None
    return upload + fetch
