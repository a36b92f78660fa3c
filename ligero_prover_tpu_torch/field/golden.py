"""Golden (pure-Python) NTT and Reed-Solomon codec over BN254-Fr.

Defines the mathematical contract the TPU kernels must reproduce:

* ``ntt(x, w)``      : X[j] = sum_i x[i] * w^(i*j) mod p  (natural order)
* ``intt(X, w)``     : x[i] = N^-1 * sum_j X[j] * w^(-i*j) mod p
* ``encode``         : iNTT over the k-domain (ROOT1), zero-extend
                       coefficients to n, NTT over the n-domain (ROOT2)
                       — mirrors ``engine.cpp:755-771``.
* ``encode_2k``      : same with the 2k-domain (used for mask rows,
                       ``nonbatch_context.hpp:482-494``).
* ``decode``         : iNTT(n), fold c[i] += c[i+k] for i < k
                       (``kernels.wgsl.in:104-116``), NTT(k); positions
                       [k, n) keep the raw iNTT coefficients — the code
                       test checks they are all zero
                       (``webgpu_prover.cpp:465-467``).

These run the protocol end-to-end on small geometries in tests, and act as
the differential oracle for the JAX/Pallas kernels.
"""

from __future__ import annotations

from . import bn254 as F


def bit_reverse_permutation(n: int) -> list[int]:
    bits = n.bit_length() - 1
    return [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(n)]


def ntt(x: list[int], w: int) -> list[int]:
    """Iterative radix-2 DIT NTT, natural order in/out."""
    n = len(x)
    assert n & (n - 1) == 0
    p = F.MODULUS
    rev = bit_reverse_permutation(n)
    out = [x[rev[i]] for i in range(n)]
    length = 2
    while length <= n:
        wl = pow(w, n // length, p)
        half = length // 2
        for start in range(0, n, length):
            wj = 1
            for j in range(half):
                a = out[start + j]
                b = out[start + j + half] * wj % p
                out[start + j] = (a + b) % p
                out[start + j + half] = (a - b) % p
                wj = wj * wl % p
        length *= 2
    return out


def intt(x: list[int], w: int) -> list[int]:
    n = len(x)
    w_inv = pow(w, F.MODULUS - 2, F.MODULUS)
    out = ntt(x, w_inv)
    n_inv = pow(n, F.MODULUS - 2, F.MODULUS)
    return [v * n_inv % F.MODULUS for v in out]


def encode(row: list[int], k: int, n: int, w_k: int, w_n: int) -> list[int]:
    """RS-encode a k-row to an n-codeword (degree-<k interpolation on the
    ROOT1 k-domain, evaluation on the ROOT2 n-domain)."""
    assert len(row) == k
    coeffs = intt(row, w_k)
    return ntt(coeffs + [0] * (n - k), w_n)


def encode_2k(row2k: list[int], k: int, n: int, w_2k: int, w_n: int) -> list[int]:
    """RS-encode a 2k mask row (degree <2k)."""
    assert len(row2k) == 2 * k
    coeffs = intt(row2k, w_2k)
    return ntt(coeffs + [0] * (n - 2 * k), w_n)


def decode(codeword: list[int], k: int, n: int, w_k: int, w_n: int) -> list[int]:
    """Inverse of encode (tolerating degree <2k): returns an n-vector whose
    first k entries are evaluations on the k-domain and whose [k, n) entries
    are the raw polynomial coefficients c[k..n) (zero for honest codewords)."""
    assert len(codeword) == n
    coeffs = intt(codeword, w_n)
    folded = [(coeffs[i] + coeffs[i + k]) % F.MODULUS for i in range(k)]
    return ntt(folded, w_k) + coeffs[k:]
