"""Layer: executor and ops. Time of the ``host.wait`` spans, where the host
blocks on the device: each fetch and each blocking upload from pageable
memory, per request (each ``prover.prove`` call of the traced window), from
the program's own spans (``utils/timer.per_request``: recorded while the
profiler runs, on ``time.time_ns()``)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ligero_prover_tpu_torch.utils.timer import per_request
    except ImportError:             # a program without spans
        return None
    return per_request("host.wait", "total_s")
