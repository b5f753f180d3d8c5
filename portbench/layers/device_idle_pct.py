"""Device: 100 minus the share of the traced window in which a kernel or a
copy ran (their union), in percent."""


def read(tr):
    span = tr.window[1] - tr.window[0]
    return 100.0 * (1.0 - tr.busy_s() / span) if span > 0 else None
