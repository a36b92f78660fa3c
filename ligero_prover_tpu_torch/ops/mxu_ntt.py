"""The int8 four-step encode engine: the k -> n Reed-Solomon encode as
three exact int8 matrix products with renormalisation kernels between them.

Port of ``ligero_prover_tpu/ops/mxu_ntt.py``.  For a size-N domain split
N = R*C with input index i = r*C + c and output index j = q*R + s:

    A[s,c]   = sum_r  W1[s,r] * x[r*C+c],   W1[s,r] = w^(C*r*s)
    B[s,c]   = w^(s*c) * A[s,c]                       (mid twiddle)
    X[q*R+s] = sum_c  W2[q,c] * B[s,c],     W2[q,c] = w^(R*q*c)

Field elements travel between levels as 32 signed base-256 digits (int8,
four per int32 word).  A modular matrix W is expanded on the host into a
block-Toeplitz int8 matrix WT[(e,s),(u,r)] = digit_{e-u}(W[s,r] * 2^256 mod
p), so one (64*S, 32*R) @ (32*R, cols) int8 -> int32 product leaves, for
every output element, 64 slot accumulators S_e with sum_e S_e*256^e =
2^256 * sum_r W[s,r]*x[r] exactly, |S_e| <= 32*R*128^2.  The KR kernels
(``ops/mxu_renorm.py``) reduce the slots to canonical form by one REDC,
which cancels the premultiplied 2^256; the mid twiddle rides in the same
kernel.  The encode is iNTT_w level 1, a merged middle level (iNTT's
level 2 composed on the host with NTT_n's level 1, whose zero-extension
drops the zero block columns) and NTT_n level 2:

  encode = NTT_n(zero_extend(iNTT_w(row)))

the contract of ``ops/ntt.py``.  The level products are a library call
(``torch._int_mm``), as they are ``dot_general`` outside any kernel in the
reference; digitize and the three renormalisations are the port's CUDA
kernels.  A packed (8, ...) int32 tensor viewed as ``torch.int8`` is
already its 32 digit planes, so the digit unpack and the corner turn
between two levels are one ``view -> permute -> contiguous()``.  That copy
lays the operand out column-major, (columns, 32 * contraction) contiguous
and handed to the product transposed: on an H100 cuBLASLt's int8 product
runs several times faster on a row-major first and a column-major second
operand than on two row-major ones (PERF.md, section 6).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import bn254 as F
from ..field.limbs import int_to_limbs
from . import mxu_renorm as mr

NLIMB = 8
DX = 32            # signed base-256 digits per element
SLOTS = 64         # output digit slots per product (2*DX)
SLOT_LIMIT = 1 << 28    # the KR sweep is exact for |S_e| below this
TABLE_KEYS = ("w1", "tw1", "wm", "tw3", "w4")


# ---- tables (host, pure Python / numpy) ----------------------------------

def _signed_digits(value: int, count: int = DX) -> np.ndarray:
    """Exact signed base-256 digit decomposition, digits in [-128, 127]."""
    out = np.zeros(count, np.int64)
    v = value
    for i in range(count):
        d = v & 0xFF
        if d > 127:
            d -= 256
        out[i] = d
        v = (v - d) >> 8
    assert v == 0, "value does not fit in signed digit count"
    return out.astype(np.int8)


def _toeplitz_digits(w_mat: np.ndarray) -> np.ndarray:
    """(S, R) matrix of field elements -> block-Toeplitz int8
    (SLOTS*S, DX*R) with block (e, u) = digit_{e-u}(W)."""
    s_dim, r_dim = w_mat.shape
    dig = np.zeros((DX, s_dim, r_dim), np.int8)
    for s in range(s_dim):
        for r in range(r_dim):
            dig[:, s, r] = _signed_digits(int(w_mat[s, r]))
    wt = np.zeros((SLOTS * s_dim, DX * r_dim), np.int8)
    for e in range(SLOTS):
        for u in range(max(0, e - DX + 1), min(DX, e + 1)):
            wt[e * s_dim:(e + 1) * s_dim, u * r_dim:(u + 1) * r_dim] = \
                dig[e - u]
    return wt


def _split_rc(size: int) -> tuple[int, int]:
    lg = size.bit_length() - 1
    c = 1 << (lg // 2)
    return size // c, c


def _pow_table(root: int) -> tuple[list[int], int]:
    cycle = 1
    acc = root
    while acc != 1:
        acc = acc * root % F.MODULUS
        cycle += 1
    pows = [1] * cycle
    for m in range(1, cycle):
        pows[m] = pows[m - 1] * root % F.MODULUS
    return pows, cycle


def _dft_matrix(root: int, order_step: int, s_dim: int, r_dim: int,
                scale: int = 1) -> np.ndarray:
    """W[s, r] = scale * root^(order_step*r*s) mod p (object array)."""
    pows, cycle = _pow_table(pow(root, order_step, F.MODULUS))
    out = np.empty((s_dim, r_dim), object)
    for s in range(s_dim):
        for r in range(r_dim):
            out[s, r] = pows[(r * s) % cycle] * scale % F.MODULUS
    return out


def _twiddle_mont_planar(root: int, s_dim: int, c_dim: int) -> np.ndarray:
    """(8, s_dim, 1, c_dim) uint32 Montgomery-form mid twiddles
    t[s,c] = root^(s*c) * 2^256 mod p."""
    pows, cycle = _pow_table(root)
    out = np.zeros((NLIMB, s_dim, 1, c_dim), np.uint32)
    for s in range(s_dim):
        for c in range(c_dim):
            t = pows[(s * c) % cycle] * F.R % F.MODULUS
            out[:, s, 0, c] = int_to_limbs(t)
    return out


def build_codec_tables(w: int, n: int, root_w: int, root_n: int) -> dict:
    """Host tables of the encode from width w to n, as numpy arrays: the
    block-Toeplitz int8 matrices ``w1`` (iNTT_w level 1, contracting r over
    R1), ``wm`` (the merged middle, contracting c1, its M axis stacked over
    h in [0, g)) and ``w4`` (NTT_n level 2, contracting c2), the uint32
    Montgomery-form mid twiddles ``tw1`` (8, R1, 1, C1) and ``tw3``
    (8, R2, 1, C2), and ``geom`` = (R1, C1, R2, C2, n // w).  1/w is folded
    into the middle level and every matrix carries the factor 2^256 mod p
    that the REDC of the KR kernels cancels.

    The middle two levels, iNTT's level 2 (contract c1) and NTT_n's level 1
    (contract r, cut to r < R2/ratio by the zero-extension), are adjacent
    linear maps joined by the index remap j = r*C2 + c2 =
    (r*g + c2//R1)*R1 + (c2 % R1) with g = C2/R1, so they compose on the
    host into WM[h][s2, c1] = sum_r W_n[s2, r] * W_inv[r*g + h, c1]."""
    r1, c1 = _split_rc(w)
    r2, c2 = _split_rc(n)
    ratio = n // w
    g = c2 // r1
    assert g >= 1 and c2 % r1 == 0
    # the largest contraction keeps every slot inside the sweep's contract
    assert DX * max(r1, c1, c2) * 128 * 128 < SLOT_LIMIT, (r1, c1, c2)
    w_inv = pow(root_w, F.MODULUS - 2, F.MODULUS)
    inv_w = pow(w, F.MODULUS - 2, F.MODULUS)
    rmod = F.R % F.MODULUS

    w2t = _dft_matrix(w_inv, r1, c1, c1, scale=inv_w)       # (q1, c1)
    w3t = _dft_matrix(root_n, c2, r2, r2)[:, :r2 // ratio]  # (s2, r)
    wm = np.empty((g, r2, c1), object)
    for h in range(g):
        for s2 in range(r2):
            for c in range(c1):
                acc = 0
                for r in range(r2 // ratio):
                    acc += int(w3t[s2, r]) * int(w2t[r * g + h, c])
                wm[h, s2, c] = acc * rmod % F.MODULUS

    tabs = {
        "w1": _toeplitz_digits(_dft_matrix(w_inv, c1, r1, r1, scale=rmod)),
        "tw1": _twiddle_mont_planar(w_inv, r1, c1),
        "wm": np.concatenate(
            [_toeplitz_digits(wm[h]) for h in range(g)], axis=0),
        "tw3": _twiddle_mont_planar(root_n, r2, c2),
        "w4": _toeplitz_digits(_dft_matrix(root_n, r2, c2, c2, scale=rmod)),
    }
    tabs = {key: np.ascontiguousarray(v) for key, v in tabs.items()}
    tabs["geom"] = (r1, c1, r2, c2, ratio)
    return tabs


def tables_to_device(tabs: dict, device=None) -> dict:
    """Host tables (numpy: int8 matrices, uint32 twiddles, ``geom``) ->
    tensors on `device`: ``torch.int8`` matrices and int32 bit patterns of
    the twiddles.  ``slots`` is the engine's slot buffer, made at first
    use and kept: one flat int32 tensor that every level product of every
    encode through these tables writes into."""
    out = {"geom": tuple(int(v) for v in tabs["geom"]), "slots": None}
    for key in ("w1", "wm", "w4"):
        arr = np.ascontiguousarray(np.asarray(tabs[key], np.int8))
        out[key] = torch.from_numpy(arr.copy()).to(device)
    for key in ("tw1", "tw3"):
        arr = np.ascontiguousarray(np.asarray(tabs[key], np.uint32))
        out[key] = torch.from_numpy(arr.view(np.int32).copy()).to(device)
    return out


def table_bytes(tabs: dict) -> int:
    """Bytes the device tables hold, the slot buffer included."""
    return sum(t.numel() * t.element_size() for t in tabs.values()
               if isinstance(t, torch.Tensor))


# ---- pipeline ------------------------------------------------------------

def _digit_operand(packed: torch.Tensor, turn: bool) -> torch.Tensor:
    """Packed digits (8, A, B, C) int32 -> the next level's int8 operand,
    column-major: (B*C, 32*A) contiguous, element [(b, c), (digit, a)], or
    with `turn` the corner turn (B*A, 32*C), element [(b, a), (digit, c)].
    Its transpose is the (32 * contraction, columns) matrix of digit
    planes."""
    a, b, c = packed.shape[1:]
    d = packed.view(torch.int8).unflatten(-1, (c, 4))      # (8, A, B, C, 4)
    d = d.permute(2, 1, 0, 4, 3) if turn else d.permute(2, 3, 0, 4, 1)
    return d.reshape(b * (a if turn else c), DX * (c if turn else a))


def _level_matmul(w_toep: torch.Tensor, x_digits: torch.Tensor,
                  tabs: dict) -> torch.Tensor:
    """(M, DX*R) int8 @ the transpose of `x_digits` (cols, DX*R) int8 ->
    (M, cols) int32, exact, into the head of the tables' slot buffer (grown
    when too small).  A CUDA product needs more than 16 rows and inner and
    column counts that are multiples of 8; anything else raises here."""
    m, cols = w_toep.shape[0], x_digits.shape[0]
    if w_toep.device.type == "cuda" and (
            m <= 16 or w_toep.shape[1] % 8 or cols % 8):
        raise ValueError(
            f"int8 level product ({m}, {w_toep.shape[1]}) @ "
            f"({x_digits.shape[1]}, {cols}) is outside what torch._int_mm "
            f"takes on CUDA (rows > 16, inner and column counts multiples "
            f"of 8)")
    buf = tabs.get("slots")
    if buf is None or buf.numel() < m * cols or buf.device != w_toep.device:
        buf = torch.empty(m * cols, dtype=torch.int32, device=w_toep.device)
        tabs["slots"] = buf
    out = buf[:m * cols].view(m, cols)
    torch._int_mm(w_toep, x_digits.contiguous().t(), out=out)
    return out


def level1_slots(xp: torch.Tensor, tabs: dict) -> torch.Tensor:
    """iNTT level 1, contracting r over R1: packed digits (8, B, R1, C1)
    (input index i = r1*C1 + c1) -> slots (64, R1, B, C1) indexed
    (s1, b, c1).  The slots live in the tables' buffer until the next
    level product."""
    b, r1, c1 = xp.shape[1:]
    xd = _digit_operand(xp.transpose(1, 2), turn=False)    # (B*c1, 32*r1)
    return _level_matmul(tabs["w1"], xd, tabs).view(SLOTS, r1, b, c1)


def level2_slots(b1: torch.Tensor, tabs: dict) -> torch.Tensor:
    """The merged middle level, contracting c1: packed digits
    (8, R1, B, C1) -> slots (64, R2, B, C2) indexed (s2, b, c2), with
    c2 = h*R1 + s1 and the product's M axis stacked over h: a copy out of
    the buffer only when g = C2/R1 > 1."""
    r1, b, _ = b1.shape[1:]
    _, _, r2, c2, _ = tabs["geom"]
    xd = _digit_operand(b1, turn=True)                     # (B*r1, 32*c1)
    s2 = _level_matmul(tabs["wm"], xd, tabs).view(c2 // r1, SLOTS, r2, b, r1)
    return s2.movedim(0, 3).reshape(SLOTS, r2, b, c2)


def level3_slots(a2: torch.Tensor, tabs: dict) -> torch.Tensor:
    """NTT_n level 2, contracting c2: packed digits (8, R2, B, C2) ->
    slots (64, C2, B, R2) indexed (q, b, s2), output index j = q*R2 + s2."""
    r2, b, c2 = a2.shape[1:]
    xd = _digit_operand(a2, turn=True)                     # (B*r2, 32*c2)
    return _level_matmul(tabs["w4"], xd, tabs).view(SLOTS, c2, b, r2)


def encode_rows_mxu_core(rows: torch.Tensor, tabs: dict, n: int):
    """(B, w, 8) int32 AoS rows -> (8, B, n) planar canonical codewords.

    Three level products (iNTT level 1, merged middle, NTT_n level 2) with
    the two mid twiddles fused into ``renorm_mid``.  Each product's slots
    are consumed by its renormalisation before the next product overwrites
    the shared slot buffer (one stream)."""
    r1, c1, r2, c2, _ = tabs["geom"]
    b = rows.shape[0]
    if rows.shape[1] != r1 * c1 or n != r2 * c2:
        raise ValueError(f"rows {tuple(rows.shape)} -> n={n} do not match "
                         f"the tables' geometry {tabs['geom']}")
    # (8, B, w) planes viewed in place: digitize reads the AoS rows
    xp = mr.digitize(rows.movedim(-1, 0)).view(NLIMB, b, r1, c1)
    b1 = mr.renorm_mid(level1_slots(xp, tabs), tabs["tw1"])
    a2 = mr.renorm_mid(level2_slots(b1, tabs), tabs["tw3"])
    v = mr.renorm_final(level3_slots(a2, tabs))            # (8, c2, B, r2)
    return v.transpose(1, 2).reshape(NLIMB, b, n)


def encode_rows_mxu(rows: torch.Tensor, tabs: dict, n: int):
    """AoS-out variant: (B, w, 8) -> (B, n, 8)."""
    return encode_rows_mxu_core(rows, tabs, n).movedim(0, -1).contiguous()
