"""Layer: executor and ops. Time of the ``executor.init`` spans: the
``TorchExecutor`` each call builds, the codec's domain tables for k, 2k and
n included, per request (each ``verifier.verify`` call of the traced
window), from the program's own spans (``utils/timer.per_request``: recorded
while the profiler runs, on ``time.time_ns()``)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ligero_prover_tpu_torch.utils.timer import per_request
    except ImportError:             # a program without spans
        return None
    return per_request("executor.init", "total_s")
