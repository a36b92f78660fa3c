"""Layer: contexts (``zkp/context.py``).  Time of the ``ctx.limbs`` spans,
each row of Python ints (a witness row, its linear-test randomness row, a
mask row) turned into limbs, per request (each ``prover.prove`` call of
the traced window), from the program's own spans
(``utils/timer.per_request``: recorded while the profiler runs)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ligero_prover_tpu_torch.utils.timer import per_request
    except ImportError:             # a program without spans
        return None
    return per_request("ctx.limbs", "total_s")
