"""Layer: front end (the host modules, the ``vbn254fr`` arena). Self time of
the ``vm.hostcall`` spans, each imported function the guest calls: the host
modules' work and the arena's kernel launches, less the flushes and waits
inside it, per request (each ``prover.prove`` call of the traced window),
from the program's own spans (``utils/timer.per_request``: recorded while the
profiler runs, on ``time.time_ns()``)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ligero_prover_tpu_torch.utils.timer import per_request
    except ImportError:             # a program without spans
        return None
    return per_request("vm.hostcall", "self_s")
