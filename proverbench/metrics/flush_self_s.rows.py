"""Layer: contexts (``zkp/context.py``). Self time of the ``ctx.flush``
spans, each batch a context hands to the executor and each mask step:
stacking and packing the batch and enqueueing the executor's step, less the
waits inside it, per request (each ``prover.prove`` call of the traced
window), from the program's own spans (``utils/timer.per_request``: recorded
while the profiler runs, on ``time.time_ns()``)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ligero_prover_tpu_torch.utils.timer import per_request
    except ImportError:             # a program without spans
        return None
    return per_request("ctx.flush", "self_s")
