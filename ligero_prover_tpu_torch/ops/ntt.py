"""Batched constant-geometry NTT / Reed-Solomon codec over BN254-Fr.

Port of the constant-geometry paths of ``ligero_prover_tpu.ops.ntt``: the
AoS one (``encode_rows_cg`` / ``decode_rows_cg``, ``ntt.py:270-325``) and
the planar one (``encode_rows_cg_planar_core``, ``encode_rows_cg_planar``,
``decode_rows_cg_planar``, ``ntt.py:328-407``).  Every stage has the same
shape, so a stage is a plain Python loop iteration:

  DIT stage t:  a = x[0::2]; b = x[1::2]; wb = tw*b
                x = [a + wb ; a - wb]            (halves)
  DIF stage t:  a = x[:h];   b = x[h:]
                x = interleave(a + b, (a - b)*tw)

DIT consumes bit-reversed input and produces natural output; DIF is its
transpose.  Zero-extension k -> n is a tile (concatenated copies), after
which the first log2(n/k) DIT stages are identities and are skipped.
Twiddles are in Montgomery form, so each butterfly does one Montgomery
product and values stay in the plain domain.

The AoS path holds rows as (B, N, 8) and runs a stage as K1 (``mont_mul``)
plus the plain limb ``addmod``/``submod``.  The planar path holds them as
(8, B, N) limb planes and runs a stage as one launch of KB
(``fieldmul.butterfly_dit``/``butterfly_dif``) into ping-pong buffers
allocated once per scan; the zero-extension tile is read in place by the
first DIT stage.  :data:`USE_PLANAR` selects the path: None (auto) means
planar for CUDA tensors and AoS for CPU tensors, the reference's "planar
off the CPU" rule (``ntt.py:174-182``) applied per device.

A third engine serves the k-width encode of commit, check and open: the
int8 four-step encode of ``ops/mxu_ntt.py`` (three int8 matrix products and
the KR renormalisation kernels), selected by :data:`USE_MXU` and fed by
:attr:`RSCodec.mxu_tabs`; the reference's ``USE_MXU`` (``ntt.py:181-189,
484-501``).  2k mask rows, decode and the verifier stay on the butterfly
paths.

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
from . import fieldmul as fm
from . import fieldops as fo

NLIMB = 8

USE_PLANAR: bool | None = None   # None = auto: planar off the CPU


def _planar_use(device) -> bool:
    """Whether tensors on `device` take the planar path."""
    if USE_PLANAR is not None:
        return USE_PLANAR
    return torch.device(device).type != "cpu"


USE_MXU: bool | None = None      # None = auto, see MXU_ON_CUDA
# What None means for CUDA tensors.  Off: on the card the int8 engine has
# not measured faster than the butterflies (PERF.md, section 6, has the
# walls, the card and its power limit).  CPU tensors: always off.
MXU_ON_CUDA = False


def _mxu_use(device) -> bool:
    """Whether k-width encodes of tensors on `device` take the int8
    engine."""
    if USE_MXU is not None:
        return USE_MXU
    return MXU_ON_CUDA and torch.device(device).type != "cpu"


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
    (stage t uses root^((j >> s) << s) with s = log2n-1-t), and
    ``cg_fwd_pl``/``cg_inv_pl`` the same as contiguous (log2 n, 8, n/2)
    limb planes; ``rev`` the bit-reversal permutation, ``n_inv_mont`` 1/n
    in Montgomery form."""
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

    cg_fwd, cg_inv = cg_tws(w), cg_tws(w_inv)
    return {
        "rev": torch.from_numpy(_bitrev(n)).to(device),
        "cg_fwd": cg_fwd,
        "cg_inv": cg_inv,
        "cg_fwd_pl": cg_fwd.transpose(1, 2).contiguous(),
        "cg_inv_pl": cg_inv.transpose(1, 2).contiguous(),
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


def _cg_dit_scan_planar(x, tws_pl, first_stage: int = 0):
    """Planar twin of :func:`_cg_dit_scan`: x (8, B, w) bit-reversed ->
    (8, B, N) natural with N = 2 * tws_pl.shape[2], tws_pl
    (log2N, 8, N/2).  A narrower x (w < N) is the head of its own tile:
    the first stage reads it tiled, so the skipped identity stages
    (before `first_stage`) and the tile cost nothing."""
    n = 2 * tws_pl.shape[2]
    bufs = [torch.empty((NLIMB, x.shape[1], n), dtype=torch.int32,
                        device=x.device) for _ in range(2)]
    for i, t in enumerate(range(first_stage, tws_pl.shape[0])):
        x = fm.butterfly_dit(x, tws_pl[t], out=bufs[i % 2])
    return x


def _cg_dif_scan_planar(x, tws_pl):
    """Planar twin of :func:`_cg_dif_scan`: x (8, B, N) natural ->
    bit-reversed; consumes tws_pl back to front."""
    bufs = [torch.empty_like(x) for _ in range(2)]
    for i, t in enumerate(range(tws_pl.shape[0] - 1, -1, -1)):
        x = fm.butterfly_dif(x, tws_pl[t], out=bufs[i % 2])
    return x


def encode_rows_cg_planar_core(rows, dom_msg, dom_n, n: int):
    """Planar encode: (B, w, 8) rows -> (8, B, n) limb-plane codewords
    (iNTT_w by DIF, scale by 1/w, zero-extend, NTT_n by DIT).  Callers that
    consume planes (the SHA absorb, the check accumulators) skip the
    transpose back."""
    w = rows.shape[1]
    x = _cg_dif_scan_planar(rows.movedim(-1, 0).contiguous(),
                            dom_msg["cg_inv_pl"])
    x = fm.mont_mul_scalar_planar(x, dom_msg["n_inv_mont"])
    ratio = n // w
    return _cg_dit_scan_planar(x, dom_n["cg_fwd_pl"],
                               first_stage=ratio.bit_length() - 1)


def encode_rows_cg_planar(rows, dom_msg, dom_n, n: int):
    """Planar encode with the reference's (B, n, 8) result."""
    return encode_rows_cg_planar_core(rows, dom_msg, dom_n, n) \
        .movedim(0, -1).contiguous()


def decode_rows_cg_planar(codewords, dom_k, dom_n, k: int):
    """Planar decode; same contract as :func:`decode_rows_cg`.  The fold's
    lanes 0 and 2 are strided views of the coefficients, made contiguous
    for KE."""
    b_, n = codewords.shape[0], codewords.shape[1]
    assert n == 4 * k
    x = _cg_dif_scan_planar(codewords.movedim(-1, 0).contiguous(),
                            dom_n["cg_inv_pl"])
    x = fm.mont_mul_scalar_planar(x, dom_n["n_inv_mont"])
    v = x.reshape(NLIMB, b_, k, 4)
    folded = fm.addmod_planar(v[..., 0].contiguous(), v[..., 2].contiguous())
    evals = _cg_dit_scan_planar(folded, dom_k["cg_fwd_pl"])
    coeffs_nat = x.movedim(0, -1).index_select(1, dom_n["rev"])
    return torch.cat([evals.movedim(0, -1), coeffs_nat[:, k:]], dim=1)


def encode_rows(rows, dom_msg, dom_n, n: int, use_planar: bool | None = None):
    """(B, w, 8) -> (B, n, 8) by the planar or the AoS path (None: by
    :func:`_planar_use` for the rows' device)."""
    if use_planar is None:
        use_planar = _planar_use(rows.device)
    if use_planar:
        return encode_rows_cg_planar(rows, dom_msg, dom_n, n)
    return encode_rows_cg(rows, dom_msg, dom_n, n)


def decode_rows(codewords, dom_k, dom_n, k: int,
                use_planar: bool | None = None):
    """Dispatcher of the decode, as :func:`encode_rows`."""
    if use_planar is None:
        use_planar = _planar_use(codewords.device)
    if use_planar:
        return decode_rows_cg_planar(codewords, dom_k, dom_n, k)
    return decode_rows_cg(codewords, dom_k, dom_n, k)


class RSCodec:
    """Encode/decode between k-rows (or 2k mask rows) and n-codewords."""

    def __init__(self, k: int, n: int, device=None):
        assert n == 4 * k
        w_k, w_2k, w_n = F.generate_omegas(k, n)
        self.k, self.n = k, n
        self.device = torch.device(device if device is not None else "cpu")
        self._omegas = (w_k, w_2k, w_n)
        self._mxu_tabs = None
        self.dom_k = build_domain_tables(k, w_k, device)
        self.dom_2k = build_domain_tables(2 * k, w_2k, device)
        self.dom_n = build_domain_tables(n, w_n, device)

    _MXU_TAB_CACHE: dict = {}

    @property
    def mxu_tabs(self) -> dict:
        """Device tables of the int8 engine for the k -> n encode, built at
        first use and cached per (k, n, device) across codecs: the host
        build takes seconds and the tables tens of megabytes."""
        if self._mxu_tabs is None:
            key = (self.k, self.n, str(self.device))
            if key not in RSCodec._MXU_TAB_CACHE:
                from .mxu_ntt import build_codec_tables, tables_to_device
                RSCodec._MXU_TAB_CACHE[key] = tables_to_device(
                    build_codec_tables(self.k, self.n, self._omegas[0],
                                       self._omegas[2]), self.device)
            self._mxu_tabs = RSCodec._MXU_TAB_CACHE[key]
        return self._mxu_tabs

    def encode(self, rows):
        return encode_rows(rows, self.dom_k, self.dom_n, self.n)

    def encode_2k(self, rows):
        return encode_rows(rows, self.dom_2k, self.dom_n, self.n)

    def decode(self, codewords):
        return decode_rows(codewords, self.dom_k, self.dom_n, self.k)
