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
(8, B, N) limb planes and runs a transform as a few passes
(:func:`pass_plan`), each one launch of KB
(``fieldmul.butterfly_dit_pass``/``butterfly_dif_pass``) that takes up to
`max_pass` consecutive stages through shared memory, into ping-pong
buffers allocated once per scan; the zero-extension tile is read in place
by the first DIT pass.  ``max_pass=1`` is the one-stage-per-launch path.  :data:`USE_PLANAR` selects the path: None (auto) means
planar for CUDA tensors and AoS for CPU tensors, the reference's "planar
off the CPU" rule (``ntt.py:174-182``) applied per device.

A third engine serves the k-width encode of commit, check and open: the
int8 four-step encode of ``ops/mxu_ntt.py`` (three int8 matrix products and
the KR renormalisation kernels), selected by :data:`USE_MXU` and fed by
:attr:`RSCodec.mxu_tabs`; the reference's ``USE_MXU`` (``ntt.py:181-189,
484-501``).  2k mask rows, decode and the verifier stay on the butterfly
paths.

The column-sharded executor (``parallel/mesh.py``) encodes with the coset
functions: shard d of D owns the codeword columns j = d + D*t (t < m =
n/D), which are the evaluations of the row's polynomial on a coset of the
subgroup of order m, so each shard computes its own columns with no
exchange (:func:`encode_rows_coset_planar_core`,
:func:`encode_rows_coset`, tables from :func:`coset_tables`).

Mathematical contract:
  encode    = NTT_n(zero_extend(iNTT_k(row)))
  encode_2k = NTT_n(zero_extend(iNTT_2k(mask_row)))
  decode    = NTT_k(fold_k(iNTT_n(codeword))), coefficients [k, n) passed
              through for the degree check.
  coset     = with c = iNTT_w(row)/w (w = k or 2k) and root r = w_n^D:
              encode[d + D*t] = NTT_m(fold_m(c * w_n^(i*d)))[t], where
              fold_m(x)[i0] = sum over i = i0 (mod m) of x[i] (m < w), or
              zero_extend to m (m > w).
"""

from __future__ import annotations

import functools

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


# Most stages per KB pass on the planar path: 13-15 stages (every
# transform at k=8192) take 3 passes, and a pass's group of 2^5 elements
# leaves 8 groups per 256-element tile, so the strided side of a pass
# moves 32-byte runs.
LARGEST_PASS = 5


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
        "rev": fo.upload(torch.from_numpy(_bitrev(n)), device),
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


@functools.lru_cache(maxsize=None)
def pass_plan(log2n: int, first_stage: int, count: int,
              max_pass: int) -> tuple[tuple[int, int], ...]:
    """The KB passes of `count` stages from `first_stage` of an N = 2^log2n
    transform: (t0, s) pairs covering the stages in ascending order, each
    s <= max_pass (and <= log2n), the fewest passes, sizes as even as
    possible (larger first).  DIT runs them in this order, DIF in reverse.
    Cached per geometry."""
    largest = min(max_pass, log2n, fm.MAX_PASS)
    if count < 0 or first_stage < 0 or first_stage + count > log2n \
            or largest < 1:
        raise ValueError(f"no pass plan for stages {first_stage}.."
                         f"{first_stage + count - 1} of 2^{log2n} with "
                         f"passes of at most {max_pass}")
    passes = -(-count // largest)
    plan, t0 = [], first_stage
    for i in range(passes):
        s = count // passes + (i < count % passes)
        plan.append((t0, s))
        t0 += s
    return tuple(plan)


def _cg_dit_scan_planar(x, tws_pl, first_stage: int = 0,
                        max_pass: int = LARGEST_PASS):
    """Planar twin of :func:`_cg_dit_scan`: x (8, B, w) bit-reversed ->
    (8, B, N) natural with N = 2 * tws_pl.shape[2], tws_pl
    (log2N, 8, N/2), by the passes of :func:`pass_plan`.  A narrower x
    (w < N) is the head of its own tile: the first pass reads it tiled, so
    the skipped identity stages (before `first_stage`) and the tile cost
    nothing."""
    log2n = tws_pl.shape[0]
    plan = pass_plan(log2n, first_stage, log2n - first_stage, max_pass)
    bufs = [torch.empty((NLIMB, x.shape[1], 2 * tws_pl.shape[2]),
                        dtype=torch.int32, device=x.device)
            for _ in range(min(len(plan), 2))]
    for i, (t0, s) in enumerate(plan):
        x = fm.butterfly_dit_pass(x, tws_pl, t0, s, out=bufs[i % 2])
    return x


def _cg_dif_scan_planar(x, tws_pl, max_pass: int = LARGEST_PASS):
    """Planar twin of :func:`_cg_dif_scan`: x (8, B, N) natural ->
    bit-reversed; consumes tws_pl back to front, by the passes of
    :func:`pass_plan` in reverse."""
    log2n = tws_pl.shape[0]
    plan = pass_plan(log2n, 0, log2n, max_pass)
    bufs = [torch.empty_like(x) for _ in range(min(len(plan), 2))]
    for i, (t0, s) in enumerate(reversed(plan)):
        x = fm.butterfly_dif_pass(x, tws_pl, t0, s, out=bufs[i % 2])
    return x


def encode_rows_cg_planar_core(rows, dom_msg, dom_n, n: int,
                               max_pass: int = LARGEST_PASS):
    """Planar encode: (B, w, 8) rows -> (8, B, n) limb-plane codewords
    (iNTT_w by DIF, scale by 1/w, zero-extend, NTT_n by DIT), in KB passes
    of at most `max_pass` stages.  Callers that consume planes (the SHA
    absorb, the check accumulators) skip the transpose back.

    The coset encode at D = 1 gives the same limbs; this path stays for
    the single device because its one scalar (KE mont_scalar, 0.0069 ms)
    and the coset encode's tiled twist (0.0068 ms since its redesign)
    take the same time at the (8, 16, 8192) call (chip_smoke phase 3,
    PERF.md §6), so the switch gains nothing there, and the int8 engine
    replaces this scaling for the k-width rows."""
    w = rows.shape[1]
    x = _cg_dif_scan_planar(rows.movedim(-1, 0).contiguous(),
                            dom_msg["cg_inv_pl"], max_pass)
    x = fm.mont_mul_scalar_planar(x, dom_msg["n_inv_mont"])
    ratio = n // w
    return _cg_dit_scan_planar(x, dom_n["cg_fwd_pl"],
                               ratio.bit_length() - 1, max_pass)


def encode_rows_cg_planar(rows, dom_msg, dom_n, n: int):
    """Planar encode with the reference's (B, n, 8) result."""
    return encode_rows_cg_planar_core(rows, dom_msg, dom_n, n) \
        .movedim(0, -1).contiguous()


def decode_rows_cg_planar(codewords, dom_k, dom_n, k: int,
                          max_pass: int = LARGEST_PASS):
    """Planar decode; same contract as :func:`decode_rows_cg`.  The fold's
    lanes 0 and 2 are strided views of the coefficients, made contiguous
    for KE."""
    b_, n = codewords.shape[0], codewords.shape[1]
    assert n == 4 * k
    x = _cg_dif_scan_planar(codewords.movedim(-1, 0).contiguous(),
                            dom_n["cg_inv_pl"], max_pass)
    x = fm.mont_mul_scalar_planar(x, dom_n["n_inv_mont"])
    v = x.reshape(NLIMB, b_, k, 4)
    folded = fm.addmod_planar(v[..., 0].contiguous(), v[..., 2].contiguous())
    evals = _cg_dit_scan_planar(folded, dom_k["cg_fwd_pl"], 0, max_pass)
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


# ---- coset encode: one shard's columns of the codeword -------------------

_COSET_DOMAINS: dict = {}      # (k, n, D, device) -> m-point domain tables
_COSET_TABLES: dict = {}       # (k, n, D, d, device) -> coset_tables()


def coset_tables(k: int, n: int, D: int, d: int, device=None) -> dict:
    """Tables of shard d of D for the coset encode of k- and 2k-width rows
    (cached per (k, n, D, d, device)):

    * ``m``: the shard's n/D columns j = d + D*t, t < m;
    * ``dom``: :func:`build_domain_tables` of the m-point domain with root
      w_n^D.  It must be that power of the codec's n-point root: the
      codec's own roots of other orders (``F.generate_omegas``) are not
      powers of one another, and tables of a fresh root of order m give
      other columns;
    * ``twist``: per width w, the (8, w) limb planes at position pos of
      w^-1 * w_n^(d * bitrev_w(pos)) in Montgomery form, which scale the
      bit-reversed coefficients of iNTT_w by 1/w and twist them onto the
      coset in one product; ``twist_aos`` the same as (w, 8)."""
    device = torch.device(device if device is not None else "cpu")
    key = (k, n, D, d, str(device))
    if key in _COSET_TABLES:
        return _COSET_TABLES[key]
    if D < 1 or D & (D - 1) or n % D or not 0 <= d < D or n // D < 2:
        raise ValueError(f"no coset {d} of {D} shards over n={n}")
    p = F.MODULUS
    w_n = F.generate_omegas(k, n)[2]
    m = n // D
    dom_key = key[:3] + key[4:]
    if dom_key not in _COSET_DOMAINS:
        _COSET_DOMAINS[dom_key] = build_domain_tables(m, pow(w_n, D, p),
                                                      device)
    step = pow(w_n, d, p)
    twist, twist_aos = {}, {}
    for w in (k, 2 * k):
        acc = pow(w, p - 2, p) * F.R % p
        powers = [0] * w
        for i in range(w):
            powers[i] = acc
            acc = acc * step % p
        limbs = ints_to_limbs(powers)[_bitrev(w)]
        twist_aos[w] = fo.to_torch(np.ascontiguousarray(limbs), device)
        twist[w] = twist_aos[w].T.contiguous()
    tabs = {"m": m, "dom": _COSET_DOMAINS[dom_key], "twist": twist,
            "twist_aos": twist_aos}
    _COSET_TABLES[key] = tabs
    return tabs


def coset_coeffs(rows, dom_msg, use_planar: bool):
    """iNTT_w of (B, w, 8) rows by DIF, not scaled: the bit-reversed
    coefficients (times w) that every shard's coset encode takes, as
    (8, B, w) limb planes (planar) or (B, w, 8) (AoS)."""
    if use_planar:
        return _cg_dif_scan_planar(rows.movedim(-1, 0).contiguous(),
                                   dom_msg["cg_inv_pl"])
    return _cg_dif_scan(rows, dom_msg["cg_inv"])


def _first_stage(m: int, w: int) -> int:
    """DIT stages that the zero-extension of w to m makes identities."""
    return (m // w).bit_length() - 1 if m > w else 0


def encode_rows_coset_planar_core(coeffs, tabs: dict,
                                  max_pass: int = LARGEST_PASS):
    """One shard's columns of the planar encode: coeffs (8, B, w) from
    :func:`coset_coeffs` -> (8, B, m), column t being codeword column
    d + D*t, for the shard whose :func:`coset_tables` are `tabs`.

    One KE launch twists and scales (``mont_mul_tiled_planar`` by the
    (8, w) twist table); for m < w the w/m bit-reversed coefficients
    i0 + m*q of one fold sit in adjacent lanes, summed by pairwise KE
    adds; then the KB DIT passes of the m-point domain, which read a
    narrower input (m > w) tiled, the zero-extension."""
    w = coeffs.shape[2]
    m = tabs["m"]
    x = fm.mont_mul_tiled_planar(coeffs, tabs["twist"][w])
    if m < w:
        v = x.reshape(NLIMB, x.shape[1], m, w // m)
        while v.shape[3] > 1:
            h = v.shape[3] // 2
            v = fm.addmod_planar(v[..., :h], v[..., h:])
        x = v.reshape(NLIMB, x.shape[1], m)
    return _cg_dit_scan_planar(x, tabs["dom"]["cg_fwd_pl"],
                               _first_stage(m, w), max_pass)


def encode_rows_coset(coeffs, tabs: dict):
    """AoS twin of :func:`encode_rows_coset_planar_core`: coeffs
    (B, w, 8) -> (B, m, 8)."""
    b_, w = coeffs.shape[0], coeffs.shape[1]
    m = tabs["m"]
    x = fo.mont_mul(coeffs, tabs["twist_aos"][w])
    if m < w:
        v = x.reshape(b_, m, w // m, NLIMB)
        while v.shape[2] > 1:
            h = v.shape[2] // 2
            v = fo.addmod(v[:, :, :h], v[:, :, h:])
        x = v.reshape(b_, m, NLIMB)
    elif m > w:
        x = x.repeat(1, m // w, 1)
    return _cg_dit_scan(x, tabs["dom"]["cg_fwd"], _first_stage(m, w))
