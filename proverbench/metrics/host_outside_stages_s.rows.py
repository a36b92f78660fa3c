"""Layer: drivers (``prover.py``).  Mean per proof of the prove's wall less
its ``stage1``, ``stage2`` and ``stage3`` timers (``utils/timer``, program
spans): the transcript seed, column sampling, ``tree.decommit``, the three
decodes fetched and turned into Python ints, ``serialize_proof`` and the
self-check, with the traced run's profiler running."""


def read(run):
    rest = [r["wall"] - sum(r["stages"].get(s, 0.0)
                            for s in ("stage1", "stage2", "stage3"))
            for r in run.records if r["stages"]]
    return sum(rest) / len(rest) if rest else None
