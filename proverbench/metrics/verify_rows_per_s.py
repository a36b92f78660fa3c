"""Rows of every proof verified in the window over the window's whole
elapsed time (host clock)."""


def read(run):
    return run.rows / run.elapsed_s if run.records else None
