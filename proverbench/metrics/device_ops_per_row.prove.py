"""Layer: executor and ops.  Device operations (kernels, memcpys and
memsets of the profiler's device timeline) in the traced window per row
of the window's proofs."""


def read(run):
    if run.trace is None or not run.trace.device_ops or not run.rows:
        return None
    return run.trace.device_ops / run.rows
