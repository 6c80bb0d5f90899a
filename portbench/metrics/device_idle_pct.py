"""The share of the traced window in which no kernel, copy or fill ran on
the card, in %."""


def read(w):
    if not w.window_s or not w.device:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.window_s)
