"""The mean over frames of the part of a frame's latency in which the app sat
blocked in the source's next (the benchmark's span around the call): the
stream reads frame n + 1 before it fetches frame n, so at a camera's rate
frame n's finished result waits for the next grab."""


def read(w):
    if not w.source_blocked_ms:
        return None
    return sum(w.source_blocked_ms) / len(w.source_blocked_ms)
