"""Device: the share of the traced window in which no kernel, copy or
fill ran on the card, in percent."""


def read(m):
    if m.kind != "train" or m.trace is None or m.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
