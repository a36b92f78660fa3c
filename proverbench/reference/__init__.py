"""The benchmark's plain reference: the protocol's prover and verifier on
plain PyTorch (``field``, ``prover``) over frozen copies of the prover's
pure-Python protocol modules (``ligero``).  It imports nothing of the
program."""
