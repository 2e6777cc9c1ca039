"""``device_idle.serve``: the share of the traced stretch of a serving
window in which no operation (kernel, copy or set) ran on the card: the
union of their intervals against the stretch's length."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
