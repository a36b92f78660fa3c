"""BN254 scalar field (Fr) — host-side golden model over Python integers.

Constants and scalar semantics mirror the reference implementation
(``src/bn254.cpp:21-64``, ``include/zkp/finite_field_gmp.hpp:30-78``):

* two primitive (p-1)-th roots: ``ROOT1 = 7``-derived and
  ``ROOT2 = 7**(2**61 - 1)``-derived, each with a 2^28 power-of-two subgroup.
  The NTT message domains (k, 2k) come from ROOT1 and the codeword domain (n)
  from ROOT2 so evaluation points never coincide with message points.
* Montgomery factor J = -p^{-1} mod 2^256 (beta = 256) and Barrett factor
  floor(2^508 / p).
* rejection-free random sampling: draw 256 bits, shift right by 2, single
  conditional subtract (``finite_field_gmp.hpp:70-78``).

All host-side protocol arithmetic (witness manager, randomness calculus)
uses these plain-int routines; the TPU kernels must agree limb-for-limb.
"""

from __future__ import annotations

MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617
MODULUS_2X = 2 * MODULUS
MODULUS_4X = 4 * MODULUS
MODULUS_MIDDLE = (MODULUS + 1) // 2

ROOT1 = 1748695177688661943023146337482803886740723238769601073607632802312037301404
ROOT2 = 2037444462055058054189478067370099086220733342011840546702672064072905551290
ROOT1_POW2_DEGREE = 28
ROOT2_POW2_DEGREE = 28

BETA = 256  # Montgomery radix 2^256
R = 1 << BETA
# J = p^-1 mod 2^256, the subtractive-Montgomery factor used by the device
# shaders (``shader/bn254fr.wgsl.in:30-35``).  (The unused GMP-side constant
# in ``src/bn254.cpp:46`` differs and belongs to dead code paths.)
MONTGOMERY_FACTOR = pow(MODULUS, -1, R)
# J_NEG = -p^-1 mod 2^256 for the additive variant t = (U + m*p) / 2^256,
# which our TPU kernels use; both variants yield x*y*R^-1 mod p exactly.
MONTGOMERY_FACTOR_NEG = R - MONTGOMERY_FACTOR
BARRETT_FACTOR = 38284845454613504619394467267190322316714506535725634610690744705837986343205

NUM_BITS = 254
NUM_BYTES = 32
NUM_U32_LIMBS = 8
NUM_U64_LIMBS = 4

assert (MODULUS * MONTGOMERY_FACTOR) % R == 1
assert BARRETT_FACTOR == (1 << 508) // MODULUS


def addmod(x: int, y: int) -> int:
    z = x + y
    return z - MODULUS if z >= MODULUS else z


def submod(x: int, y: int) -> int:
    z = x - y
    return z + MODULUS if z < 0 else z


def mulmod(x: int, y: int) -> int:
    return (x * y) % MODULUS


def negate(x: int) -> int:
    return 0 if x == 0 else MODULUS - x


def invmod(x: int) -> int:
    return pow(x, MODULUS - 2, MODULUS)


def divmod_(x: int, y: int) -> int:
    return (x * invmod(y)) % MODULUS


def powmod(x: int, e: int) -> int:
    return pow(x, e, MODULUS)


def reduce(x: int) -> int:
    return x % MODULUS


def reduce_u256(x: int) -> int:
    """Lazy reduction of a 256-bit value: conditional subtract of 4p, 2p, p
    (``src/bn254.cpp:70-78``)."""
    if x >= MODULUS_4X:
        x -= MODULUS_4X
    if x >= MODULUS_2X:
        x -= MODULUS_2X
    if x >= MODULUS:
        x -= MODULUS
    return x


def mont_mul(x: int, y: int) -> int:
    """Montgomery multiplication with beta=2^256: returns x*y/2^256 mod p.

    Matches ``src/bn254.cpp:123-147``; output canonical in [0, p).
    """
    u = x * y
    m = ((u & (R - 1)) * MONTGOMERY_FACTOR_NEG) & (R - 1)
    t = (u + m * MODULUS) >> BETA
    return t - MODULUS if t >= MODULUS else t


def barrett_mul(x: int, y: int) -> int:
    """Barrett multiplication as in ``src/bn254.cpp:110-121``."""
    z = x * y
    q = (z * BARRETT_FACTOR) >> 508
    out = z - q * MODULUS
    if out >= MODULUS:
        out -= MODULUS
    return out


def to_mont(x: int) -> int:
    return (x << BETA) % MODULUS


def generate_omegas(k: int, n: int) -> tuple[int, int, int]:
    """Roots of unity for the k / 2k / n NTT domains (``src/bn254.cpp:52-64``)."""
    assert n == 4 * k
    w_k = pow(ROOT1, (1 << ROOT1_POW2_DEGREE) // k, MODULUS)
    w_2k = pow(ROOT1, (1 << ROOT1_POW2_DEGREE) // (2 * k), MODULUS)
    w_n = pow(ROOT2, (1 << ROOT2_POW2_DEGREE) // n, MODULUS)
    return w_k, w_2k, w_n


def generate_random(engine) -> int:
    """Sample a field element: 256-bit draw, >>2, one conditional subtract
    (``finite_field_gmp.hpp:70-78``).  `engine` is an mpz-style engine
    returning ints from byte counts."""
    out = engine.draw_int(NUM_BYTES)
    out >>= 2
    if out >= MODULUS:
        out -= MODULUS
    return out
