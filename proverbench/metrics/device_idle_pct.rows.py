"""Layer: device (one H100).  One minus the union of the device
operations' intervals over the traced window, from one profiler
timeline, in percent."""


def read(run):
    if run.trace is None or not run.trace.window_s or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
