"""Layer: front end (``vm/*``, ``zkp/{witness,backend}.py``).  The witness
path's unit cost: the self time of the ``vm.run`` spans per request (the
interpreter's dispatch and the witness manager, less the host calls,
flushes, limb conversions and waits inside it), in microseconds, over the
witness elements per request (the counter ``witness.elements``: each row
the witness manager flushes adds its elements, a quadratic row's three
times), both from the program's own record (``utils/timer``: recorded
while the profiler runs)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ligero_prover_tpu_torch.utils.timer import per_request, summary
    except ImportError:             # a program without spans
        return None
    s = summary()
    vm = per_request("vm.run", "self_s")
    elements = s["counters"].get("witness.elements")
    if vm is None or not elements:
        return None                 # a program without the counter
    return 1e6 * vm / (elements / s["requests"])
