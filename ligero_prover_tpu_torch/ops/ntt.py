"""Batched constant-geometry NTT / Reed-Solomon codec over BN254-Fr.

Port of the AoS constant-geometry path of ``ligero_prover_tpu.ops.ntt``
(``encode_rows_cg`` / ``decode_rows_cg``, ``ntt.py:250-325``).  Every stage
has the same shape, so a stage is a plain Python loop iteration:

  DIT stage t:  a = x[0::2]; b = x[1::2]; wb = tw*b
                x = [a + wb ; a - wb]            (halves)
  DIF stage t:  a = x[:h];   b = x[h:]
                x = interleave(a + b, (a - b)*tw)

DIT consumes bit-reversed input and produces natural output; DIF is its
transpose.  Zero-extension k -> n is a tile (concatenated copies), after
which the first log2(n/k) DIT stages are identities and are skipped.
Twiddles are in Montgomery form, so each butterfly does one ``mont_mul``
(kernel K1 on CUDA tensors) and values stay in the plain domain.

Mathematical contract:
  encode    = NTT_n(zero_extend(iNTT_k(row)))
  encode_2k = NTT_n(zero_extend(iNTT_2k(mask_row)))
  decode    = NTT_k(fold_k(iNTT_n(codeword))), coefficients [k, n) passed
              through for the degree check.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import bn254 as F
from ..field.limbs import int_to_limbs, ints_to_limbs
from . import fieldops as fo

NLIMB = 8


def _bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    out = np.arange(n)
    rev = np.zeros(n, np.int64)
    for _ in range(bits):
        rev = (rev << 1) | (out & 1)
        out >>= 1
    return rev


def build_domain_tables(n: int, w: int, device=None) -> dict:
    """Constant-geometry twiddles of one domain as tensors on `device`:
    ``cg_fwd``/``cg_inv`` are (log2 n, n/2, 8) int32 in Montgomery form
    (stage t uses root^((j >> s) << s) with s = log2n-1-t), ``rev`` the
    bit-reversal permutation, ``n_inv_mont`` 1/n in Montgomery form."""
    assert pow(w, n, F.MODULUS) == 1 and pow(w, n // 2, F.MODULUS) != 1
    log2n = n.bit_length() - 1
    w_inv = pow(w, F.MODULUS - 2, F.MODULUS)
    n_inv = pow(n, F.MODULUS - 2, F.MODULUS)

    def cg_tws(root):
        h = n // 2
        out = np.empty((log2n, h, NLIMB), np.uint32)
        for t in range(log2n):
            s = log2n - 1 - t
            step = pow(root, 1 << s, F.MODULUS)
            vals = [0] * (1 << t)
            acc = F.R % F.MODULUS                  # 1 in Montgomery form
            for i in range(1 << t):
                vals[i] = acc
                acc = acc * step % F.MODULUS
            out[t] = np.repeat(ints_to_limbs(vals), 1 << s, axis=0)
        return fo.to_torch(out, device)

    return {
        "rev": torch.from_numpy(_bitrev(n)).to(device),
        "cg_fwd": cg_tws(w),
        "cg_inv": cg_tws(w_inv),
        "n_inv_mont": fo.to_torch(int_to_limbs(n_inv * F.R % F.MODULUS),
                                  device),
    }


def _cg_dit_scan(x, tws, first_stage: int = 0):
    """x (B, N, 8) bit-reversed -> natural; tws (log2N, N/2, 8)."""
    b_, n = x.shape[0], x.shape[1]
    h = n // 2
    for t in range(first_stage, tws.shape[0]):
        v = x.reshape(b_, h, 2, NLIMB)
        a, b = v[:, :, 0], v[:, :, 1]
        wb = fo.mont_mul(b, tws[t])
        x = torch.cat([fo.addmod(a, wb), fo.submod(a, wb)], dim=1)
    return x


def _cg_dif_scan(x, tws):
    """x (B, N, 8) natural -> bit-reversed; consumes tws back-to-front."""
    b_, n = x.shape[0], x.shape[1]
    h = n // 2
    for t in range(tws.shape[0] - 1, -1, -1):
        a, b = x[:, :h], x[:, h:]
        s = fo.addmod(a, b)
        d = fo.mont_mul(fo.submod(a, b), tws[t])
        x = torch.stack([s, d], dim=2).reshape(b_, n, NLIMB)
    return x


def encode_rows_cg(rows, dom_msg, dom_n, n: int):
    """(B, w, 8) message-domain rows -> (B, n, 8) codewords: iNTT_w (DIF),
    scale by 1/w, zero-extend (tile), NTT_n (DIT)."""
    w = rows.shape[1]
    x = _cg_dif_scan(rows, dom_msg["cg_inv"])
    x = fo.mont_mul(x, dom_msg["n_inv_mont"])
    ratio = n // w
    x = x.repeat(1, ratio, 1)
    return _cg_dit_scan(x, dom_n["cg_fwd"],
                        first_stage=ratio.bit_length() - 1)


def decode_rows_cg(codewords, dom_k, dom_n, k: int):
    """(B, n, 8) -> (B, n, 8): [0,k) k-domain evaluations, [k,n) raw
    coefficients (degree check).

    In the bit-reversed n-domain, natural coefficients {c, c+k, c+2k, c+3k}
    (c < k, n = 4k) sit at consecutive positions {4t, 4t+2, 4t+1, 4t+3}
    with t = bitrev_k(c), so the fold c[i] += c[i+k] is an add of lanes 0
    and 2 that lands in bit-reversed k-order, ready for the DIT k-NTT."""
    b_, n = codewords.shape[0], codewords.shape[1]
    assert n == 4 * k
    coeffs = _cg_dif_scan(codewords, dom_n["cg_inv"])
    coeffs = fo.mont_mul(coeffs, dom_n["n_inv_mont"])
    v = coeffs.reshape(b_, k, 4, NLIMB)
    folded = fo.addmod(v[:, :, 0], v[:, :, 2])
    evals = _cg_dit_scan(folded, dom_k["cg_fwd"])
    coeffs_nat = coeffs.index_select(1, dom_n["rev"])
    return torch.cat([evals, coeffs_nat[:, k:]], dim=1)


class RSCodec:
    """Encode/decode between k-rows (or 2k mask rows) and n-codewords."""

    def __init__(self, k: int, n: int, device=None):
        assert n == 4 * k
        w_k, w_2k, w_n = F.generate_omegas(k, n)
        self.k, self.n = k, n
        self.dom_k = build_domain_tables(k, w_k, device)
        self.dom_2k = build_domain_tables(2 * k, w_2k, device)
        self.dom_n = build_domain_tables(n, w_n, device)

    def encode(self, rows):
        return encode_rows_cg(rows, self.dom_k, self.dom_n, self.n)

    def decode(self, codewords):
        return decode_rows_cg(codewords, self.dom_k, self.dom_n, self.k)
