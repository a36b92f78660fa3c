"""Layer: executor and ops. Bytes the program uploads from host memory to
the device (``fo.upload``: the executor's batches, indices and scalars, the
arena's rows, the codec's tables, the column hash's initial state), over the
rows of the window's proofs, from the program's counter ``htod.bytes``
(``utils/timer.summary``: counted while the profiler runs)."""


def read(run):
    if run.trace is None or not run.rows:
        return None
    try:
        from ligero_prover_tpu_torch.utils.timer import summary
    except ImportError:             # a program without counters
        return None
    n = summary()["counters"].get("htod.bytes")
    return None if n is None else n / run.rows
