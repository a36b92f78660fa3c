"""ligero_prover_tpu_torch — the Ligero prover on PyTorch and CUDA.

A port of ``ligero_prover_tpu`` (JAX) to PyTorch, with the field and hash
kernels written by hand in CUDA C++ for Hopper (``csrc/``).  The WASM
front end, witness manager, transcript and proof format are the same
modules; the executor, RS codec, field arithmetic, column SHA-256 and the
``vbn254fr`` arena run on torch tensors on an explicit device.  Proofs are
byte-identical to the JAX package's for the same encoding seed.
"""

__version__ = "0.1.0"
