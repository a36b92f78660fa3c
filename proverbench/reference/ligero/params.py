"""Protocol parameters for the Ligero-on-TPU proof system.

Mirrors the reference constants in ``include/params.hpp:24-42`` of
ligeroinc/ligero-prover: one code/linear/quadratic test each, 192 column
openings, default row geometry k=8192 (packing l = k-192, encoding n = 4k),
SHA-256 transcript hasher, and fixed AES-CTR IVs (values irrelevant for CTR
mode security; kept for proof parity).
"""

from dataclasses import dataclass

NUM_CODE_TEST = 1
NUM_LINEAR_TEST = 1
NUM_QUADRATIC_TEST = 1
SAMPLE_SIZE = 192

DEFAULT_ROW_SIZE = 8192                       # k (padded row)
DEFAULT_PACKING_SIZE = DEFAULT_ROW_SIZE - SAMPLE_SIZE   # l (message slots)
DEFAULT_ENCODING_SIZE = DEFAULT_ROW_SIZE * 4  # n (codeword)

# AES-256-CTR IVs (reference: params.hpp:37-42).  CTR-mode security does not
# depend on the IV value; these exact bytes matter only for bit-level parity.
IV_ANY = bytes(16)
IV_ENCODING = bytes(16)
IV_CODE = bytes([1] + [0] * 15)
IV_LINEAR = bytes([2] + [0] * 15)
IV_QUADRATIC = bytes([3] + [0] * 15)

SECURITY_LEVEL = 128
PROOF_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class RowGeometry:
    """Row geometry derived from a packing size, matching
    ``src/webgpu_prover.cpp:88-99``: k = packing, l = k - 192, n = 4k."""

    k: int = DEFAULT_ROW_SIZE

    @property
    def l(self) -> int:  # noqa: E743  (match protocol naming)
        return self.k - SAMPLE_SIZE

    @property
    def n(self) -> int:
        return self.k * 4

    def __post_init__(self):
        if self.k & (self.k - 1):
            raise ValueError("row size k must be a power of two")
        if self.k <= SAMPLE_SIZE:
            raise ValueError("row size k must exceed sample size")


DEFAULT_GEOMETRY = RowGeometry()
