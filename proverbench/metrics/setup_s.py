"""Process start to the window's first call (host clock): imports, the
kernel library's load (its build, in a checkout's first run), the guest's
parse, the mode's set-up proofs and the warm-up call."""


def read(run):
    return run.setup_s
