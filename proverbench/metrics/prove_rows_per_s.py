"""Committed rows (``ProveResult.num_rows``) of every proof of the window
over the window's whole elapsed time (host clock).  Moves itself."""


def read(run):
    return run.rows / run.elapsed_s if run.records else None
