"""BN254-Fr arithmetic and the Reed-Solomon code in plain PyTorch.

The benchmark's own field, written from the definitions and independent of
the prover: an element is 16 limbs of 16 bits, little-endian, held in
int64, canonical (below p).  A product is the schoolbook product of the
limbs (a float64 outer product, exact below 2^53, and a float64 matmul
that sums its anti-diagonals), reduced by a table of 2^(256+16i) mod p and
one quotient estimated in float64, then made canonical by conditional
adds and subtracts of p.  Carries are propagated limb by limb.  Nothing
here is fast; it runs on whatever device its tensors are on.

The code (``ligero`` ``include/params.hpp``, ``src/bn254.cpp:52-64``):
message domains of k and 2k points from ROOT1's 2^28 subgroup, codeword
domain of n = 4k points from ROOT2's, so

    encode(row of w) = NTT_n(zero-extend(iNTT_w(row)))   (natural order)
    decode(cw)[0:k]  = NTT_k(fold_k(iNTT_n(cw))),  decode(cw)[k:n] =
                       the coefficients k..n-1 of iNTT_n(cw)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
ROOT1 = 1748695177688661943023146337482803886740723238769601073607632802312037301404
ROOT2 = 2037444462055058054189478067370099086220733342011840546702672064072905551290
ROOT_POW2 = 28
L = 16                      # limbs of 16 bits
MASK = 0xFFFF


def _limbs_of(x: int) -> list[int]:
    return [(x >> (16 * i)) & MASK for i in range(L)]


@functools.lru_cache(maxsize=None)
def _tables(device: str) -> dict:
    dev = torch.device(device)
    # anti-diagonal sums of a 16 x 16 outer product: 256 -> 31 columns
    diag = torch.zeros((L * L, 2 * L - 1), dtype=torch.float64)
    for i in range(L):
        for j in range(L):
            diag[i * L + j, i + j] = 1.0
    fold = torch.tensor([_limbs_of(pow(2, 256 + 16 * i, P))
                         for i in range(L)], dtype=torch.float64)
    weights = torch.tensor([[2.0 ** (16 * i)] for i in range(L)],
                           dtype=torch.float64)
    return {"diag": diag.to(dev), "fold": fold.to(dev),
            "weights": weights.to(dev),
            "p": torch.tensor(_limbs_of(P) + [0], dtype=torch.int64,
                              device=dev)}


def _pass(t: torch.Tensor) -> torch.Tensor:
    """One carry step over all limbs at once (in place, signed): each limb
    but the last keeps its low 16 bits and hands the rest up."""
    c = t[..., :-1] >> 16
    t[..., :-1] &= MASK
    t[..., 1:] += c
    return t


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Carry steps until every limb but the last is in [0, 2^16): exact,
    the value unchanged."""
    while bool((t[..., :-1] >> 16).any()):
        _pass(t)
    return t


def _canon(t: torch.Tensor, below: int, above: int) -> torch.Tensor:
    """(..., 17) carried limbs of a value in [-below p, (above + 1) p) ->
    (..., 16) in [0, p)."""
    p = _tables(str(t.device))["p"]
    for _ in range(below):
        t = torch.where(t[..., -1:] < 0, _carry(t + p), t)
    for _ in range(above):
        d = _carry(t - p)
        t = torch.where(d[..., -1:] < 0, t, d)
    return t[..., :L].contiguous()


def _widen(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 1))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _canon(_carry(_widen(a + b)), 0, 1)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _canon(_carry(_widen(a - b)), 1, 0)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p, broadcasting over the leading axes."""
    tab = _tables(str(a.device))
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    outer = (a.to(torch.float64)[..., :, None]
             * b.to(torch.float64)[..., None, :]).reshape(-1, L * L)
    cols = (outer @ tab["diag"]).to(torch.int64)           # < 2^36 each
    del outer
    # one step leaves limbs below 2^21, so that folding limbs 16..31 back
    # with 2^(256+16i) mod p sums products below 2^41, exact in float64
    t = _pass(torch.nn.functional.pad(cols, (0, 1)))       # 32 limbs
    r = t[:, :L] + (t[:, L:].to(torch.float64) @ tab["fold"]).to(torch.int64)
    del t, cols
    # r < 2^285: one quotient by p estimated in float64, off by at most one
    v = (r.to(torch.float64) @ tab["weights"])[:, 0]
    q = torch.floor(v / float(P)).to(torch.int64)
    r = _carry(torch.nn.functional.pad(r, (0, 1)) - q[:, None] * tab["p"])
    return _canon(r, 1, 1).reshape(shape)


def total(x: torch.Tensor) -> torch.Tensor:
    """Sum over the first axis, by pairwise folds."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        folded = add(x[:h], x[h:2 * h])
        x = torch.cat([folded, x[2 * h:]]) if x.shape[0] % 2 else folded
    return x[0]


def scale(a: torch.Tensor, s: int) -> torch.Tensor:
    return mul(a, const(s, a.device))


def const(x: int, device) -> torch.Tensor:
    return torch.tensor(_limbs_of(x % P), dtype=torch.int64, device=device)


def from_ints(xs, device) -> torch.Tensor:
    raw = b"".join((int(x) % P).to_bytes(32, "little") for x in xs)
    arr = np.frombuffer(raw, dtype="<u2").reshape(len(xs), L)
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def to_ints(x: torch.Tensor) -> list[int]:
    raw = x.reshape(-1, L).cpu().numpy().astype("<u2").tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]


def from_u32(x) -> torch.Tensor:
    """(..., 8) 32-bit limbs (any integer dtype) -> (..., 16)."""
    x = torch.as_tensor(np.asarray(x, np.int64) if not
                        isinstance(x, torch.Tensor) else x).to(torch.int64)
    x = x & 0xFFFFFFFF
    return torch.stack([x & MASK, x >> 16], dim=-1).reshape(
        *x.shape[:-1], L)


def to_u32(x: torch.Tensor) -> np.ndarray:
    """(..., 16) -> (..., 8) uint32 numpy."""
    return words(x).cpu().numpy().view(np.uint32)


def words(x: torch.Tensor) -> torch.Tensor:
    """(..., 16) -> (..., 8) int32 bit patterns of the 32-bit limbs, on
    x's device."""
    x = x.reshape(*x.shape[:-1], 8, 2)
    w = x[..., 0] | (x[..., 1] << 16)
    return (w - ((w >> 31) << 32)).to(torch.int32)


# ---- the number-theoretic transform ------------------------------------

def _bitrev(m: int) -> np.ndarray:
    bits = m.bit_length() - 1
    idx = np.arange(m)
    rev = np.zeros(m, np.int64)
    for _ in range(bits):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev


@functools.lru_cache(maxsize=None)
def _twiddles(m: int, root: int, device: str):
    """Per stage s (half = 2^s): root^(m / (2 half))^j for j < half."""
    out = []
    half = 1
    while half < m:
        w = pow(root, m // (2 * half), P)
        vals, acc = [], 1
        for _ in range(half):
            vals.append(acc)
            acc = acc * w % P
        out.append(from_ints(vals, device))
        half *= 2
    return out, torch.from_numpy(_bitrev(m)).to(device)


def ntt(x: torch.Tensor, root: int) -> torch.Tensor:
    """(B, m, 16) -> (B, m, 16): y_j = sum_i x_i root^(ij), natural order
    in and out (radix 2, decimation in time)."""
    b_, m = x.shape[0], x.shape[1]
    tws, rev = _twiddles(m, root, str(x.device))
    x = x.index_select(1, rev)
    half = 1
    for tw in tws:
        v = x.reshape(b_, m // (2 * half), 2, half, L)
        u, t = v[:, :, 0], mul(v[:, :, 1], tw)
        x = torch.stack([add(u, t), sub(u, t)], dim=2).reshape(b_, m, L)
        half *= 2
    return x


def intt(x: torch.Tensor, root: int) -> torch.Tensor:
    m = x.shape[1]
    y = ntt(x, pow(root, P - 2, P))
    return scale(y, pow(m, P - 2, P))


def roots(k: int) -> tuple[int, int, int]:
    """(w_k, w_2k, w_n) for n = 4k."""
    return (pow(ROOT1, (1 << ROOT_POW2) // k, P),
            pow(ROOT1, (1 << ROOT_POW2) // (2 * k), P),
            pow(ROOT2, (1 << ROOT_POW2) // (4 * k), P))


def encode(rows: torch.Tensor, k: int) -> torch.Tensor:
    """(B, w, 16) message rows, w = k or 2k -> (B, 4k, 16) codewords."""
    w_k, w_2k, w_n = roots(k)
    w = rows.shape[1]
    coeffs = intt(rows, w_k if w == k else w_2k)
    ext = torch.nn.functional.pad(coeffs, (0, 0, 0, 4 * k - w))
    return ntt(ext, w_n)


def decode(cw: torch.Tensor, k: int) -> torch.Tensor:
    """(B, 4k, 16) -> (B, 4k, 16): evaluations on the k-domain of the
    codeword's polynomial folded mod X^k - 1, then its coefficients k..n."""
    w_k, _, w_n = roots(k)
    coeffs = intt(cw, w_n)
    folded = coeffs[:, :k]
    for j in range(1, 4):
        folded = add(folded, coeffs[:, j * k:(j + 1) * k])
    return torch.cat([ntt(folded, w_k), coeffs[:, k:]], dim=1)
