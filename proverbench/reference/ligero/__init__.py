"""Frozen copies of the prover's pure-Python protocol modules: the WASM
front end (``vm``), the witness manager, Merkle tree, transcript, sampling,
CSPRNG and proof format (``zkp``), the field's host model (``field``) and
the wire format (``proto``).  They import nothing outside this package;
``vm/hostmods/vbn254fr.py`` is the benchmark's own, on plain torch."""

# The prover version the proof's metadata carries.
__version__ = "0.1.0"
