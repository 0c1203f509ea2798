"""``device.idle_share.article_encode_eval``: the percent of the traced window in which no operation (kernel, copy or set) ran on the device; the window is one article encode-then-rank unit with Kimi-Linear after the measured window."""


def read(r):
    if r.kind != "article_encode_eval" or r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
