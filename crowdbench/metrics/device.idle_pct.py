"""device.idle_pct: the share of the profiled part's window in which no
kernel, copy or set runs on the card: the union of their intervals, not
the sum of their times."""


def read(run):
    if run.trace is None or not run.trace.device or run.trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
