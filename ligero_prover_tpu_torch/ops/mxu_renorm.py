"""Renormalisation kernels of the int8 four-step encode engine (KR):
``digitize``, ``renorm_mid``, ``renorm_final`` and ``renorm_pack``.

Ports of the Pallas kernels of ``ligero_prover_tpu/ops/pallas/mxu_renorm.py``
(``_k_digitize`` :146, ``_k_renorm_mid`` :130, ``_k_renorm_final`` :124,
``_k_renorm_pack`` :139).  The CUDA source is ``csrc/renorm.cu``; this
module holds the wrappers and, beside each kernel, its plain PyTorch
version.  As in :mod:`.fieldmul`, a wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel (counted in
:data:`LAUNCHES`) or raises.  Plain calls are counted by device type in
:data:`PLAIN_CALLS`.

A level product (``ops/mxu_ntt.py``) leaves each output element as 64 int32
base-256 slot accumulators S_e with V = sum_e S_e * 256^e, the true value
times R = 2^256 mod p.  The reduction to t = V * 2^-256 mod p in [0, p):

  1. signed byte sweep, 66 steps: acc += S_e; b = acc & 0xFF;
     acc = (acc - b) >> 8 (arithmetic); exact for |S_e| < 2^28, V >= 0;
  2. uh = bits [504, 528) of the 528-bit V;
  3. U' = V mod 2^504 + uh * (2^504 mod p)      (< 2^256 * p for V < 2^516);
  4. Montgomery REDC and its one conditional subtract.

``renorm_final`` returns t's limbs; ``renorm_pack`` t as 32 signed base-256
digits in [-128, 127] packed four per int32 word, little-endian (viewed as
``torch.int8`` the words are the next level's matmul operand);
``renorm_mid`` the digits of mont_mul(t, tw) for a per-position twiddle in
Montgomery form; ``digitize`` the digits of given canonical limbs.

Shapes: slots (64, ...) int32, limbs and digits (8, ...) int32 bit patterns.
``renorm_mid`` takes the twiddle either at the slots' trailing shape or
unbroadcast, (8, S, 1, C) against slots (64, S, B, C): the kernel reads the
table by index (with shifts: on a CUDA tensor B and C must be powers of
two, as every call of the engine has them) and no (8, S, B, C) copy is
made.
"""

from __future__ import annotations

from collections import Counter

import torch

from ..field import bn254 as F
from .. import kernels
from . import fieldmul as fm
from .fieldops import MASK32, NLIMB

SLOTS = 64
RENORM_MODE = {"renorm_final": 0, "renorm_mid": 1, "renorm_pack": 2}
LAUNCHES = {name: 0 for name in ("digitize", *RENORM_MODE)}
PLAIN_CALLS = {name: Counter() for name in LAUNCHES}     # by device type

_K504 = pow(2, 504, F.MODULUS)
K504_LIMBS = [(_K504 >> (32 * i)) & MASK32 for i in range(NLIMB)]


def reset_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0
        PLAIN_CALLS[key].clear()


# ---- plain versions ------------------------------------------------------

def _slots_to_canonical(slots: torch.Tensor) -> torch.Tensor:
    """(64, ...) int32 slots -> (..., 8) int32 limbs of V * 2^-256 mod p.
    The sweep holds int32 values in int64, where the arithmetic shift and
    the byte mask act as they do on int32."""
    s = slots.to(torch.int64)
    acc = torch.zeros_like(s[0])
    byts = []
    for e in range(66):
        if e < SLOTS:
            acc = acc + s[e]
        b = acc & 0xFF
        byts.append(b)
        acc = (acc - b) >> 8
    u = [byts[4 * i] | (byts[4 * i + 1] << 8) | (byts[4 * i + 2] << 16)
         | (byts[4 * i + 3] << 24) for i in range(15)]
    u.append(byts[60] | (byts[61] << 8) | (byts[62] << 16))
    uh = byts[63] | (byts[64] << 8) | (byts[65] << 16)
    # U' = V mod 2^504 + uh * (2^504 mod p); each term stays below 2^57
    carry = torch.zeros_like(uh)
    for i in range(16):
        v = u[i] + carry + (uh * K504_LIMBS[i] if i < NLIMB else 0)
        u[i] = v & MASK32
        carry = v >> 32
    return fm._redc_plain(u)


def _canonical_to_packed(limbs: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 canonical limbs -> (..., 8) int32 packed signed
    base-256 digits (two's-complement bytes, four per word)."""
    x = limbs.to(torch.int64) & MASK32
    carry = torch.zeros_like(x[..., 0])
    words = []
    for i in range(NLIMB):
        w = torch.zeros_like(carry)
        for j in range(4):
            b = ((x[..., i] >> (8 * j)) & 0xFF) + carry
            carry = (b > 127).to(torch.int64)
            w = w | (((b - (carry << 8)) & 0xFF) << (8 * j))
        words.append(w)
    return torch.stack(words, -1).to(torch.int32)


def _planes(aos: torch.Tensor) -> torch.Tensor:
    return aos.movedim(-1, 0).contiguous()


def digitize_plain(x):
    """Plain version of KR digitize."""
    PLAIN_CALLS["digitize"][x.device.type] += 1
    return _planes(_canonical_to_packed(x.movedim(0, -1)))


def renorm_final_plain(slots):
    """Plain version of KR final."""
    PLAIN_CALLS["renorm_final"][slots.device.type] += 1
    return _planes(_slots_to_canonical(slots))


def renorm_pack_plain(slots):
    """Plain version of KR pack."""
    PLAIN_CALLS["renorm_pack"][slots.device.type] += 1
    return _planes(_canonical_to_packed(_slots_to_canonical(slots)))


def renorm_mid_plain(slots, tw):
    """Plain version of KR mid; `tw` broadcasts over the slots' trailing
    shape."""
    PLAIN_CALLS["renorm_mid"][slots.device.type] += 1
    t = _slots_to_canonical(slots)
    y = fm._mont_plain(t, tw.expand((NLIMB,) + slots.shape[1:])
                       .movedim(0, -1))
    return _planes(_canonical_to_packed(y))


# ---- kernel wrappers -----------------------------------------------------

def _check(name: str, t: torch.Tensor, planes: int, device=None):
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: operands must be CUDA tensors on one "
                         f"device, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: operands must be int32, got {t.dtype}")
    if t.dim() < 2 or t.shape[0] != planes:
        raise ValueError(f"{name}: expected ({planes}, ...) planes, got "
                         f"{tuple(t.shape)}")


def twiddle_index(name: str, slot_shape, tw_shape) -> tuple[int, int]:
    """(tw_bc, tw_c) such that element i of the flattened trailing shape
    `slot_shape` reads the flattened table at (i // tw_bc) * tw_c +
    i % tw_c: a table of the same shape, or (S, 1, C) against (S, B, C)."""
    slot_shape, tw_shape = tuple(slot_shape), tuple(tw_shape)
    if tw_shape == slot_shape:
        x = 1
        for d in slot_shape:
            x *= d
        return max(x, 1), max(x, 1)
    if len(slot_shape) == 3 and tw_shape == (slot_shape[0], 1, slot_shape[2]):
        return slot_shape[1] * slot_shape[2], slot_shape[2]
    raise ValueError(f"{name}: twiddle {(NLIMB,) + tw_shape} neither matches "
                     f"slots {(SLOTS,) + slot_shape} nor is (8, S, 1, C) "
                     f"against (64, S, B, C)")


def twiddle_shifts(name: str, x: int, tw_bc: int, tw_c: int) -> tuple[int, int]:
    """(lbc, lc) for the kernel's index (i >> lbc) << lc | i & (2^lc - 1),
    equal to :func:`twiddle_index`'s (i // tw_bc) * tw_c + i % tw_c for
    every element i < x: the log2 of tw_bc and tw_c, which must be powers
    of two unless they are equal (the index is then i)."""
    if tw_bc == tw_c:
        bits = max(x - 1, 0).bit_length()
        return bits, bits
    if tw_bc & (tw_bc - 1) or tw_c & (tw_c - 1):
        raise ValueError(f"{name}: the kernel reads the twiddle table with "
                         f"shifts; B*C = {tw_bc} and C = {tw_c} must be "
                         f"powers of two")
    return tw_bc.bit_length() - 1, tw_c.bit_length() - 1


def _renorm(name: str, slots: torch.Tensor, tw: torch.Tensor | None):
    _check(name, slots, SLOTS)
    slots = slots.contiguous()
    x = slots[0].numel()
    tw_ptr, tw_ls, tw_lbc, tw_lc = None, 0, 0, 0
    if tw is not None:
        _check(name, tw, NLIMB, slots.device)
        tw_lbc, tw_lc = twiddle_shifts(
            name, x, *twiddle_index(name, slots.shape[1:], tw.shape[1:]))
        tw = tw.contiguous()
        tw_ptr, tw_ls = tw.data_ptr(), max(tw[0].numel(), 1)
    out = torch.empty((NLIMB,) + slots.shape[1:], dtype=torch.int32,
                      device=slots.device)
    rc = kernels.lib().ligero_renorm(
        slots.data_ptr(), tw_ptr, tw_ls, tw_lbc, tw_lc, out.data_ptr(), x,
        RENORM_MODE[name], kernels.stream_handle(slots.device))
    kernels.check(rc, name)
    LAUNCHES[name] += 1
    return out


def digitize(x):
    """KR digitize: (8, ...) canonical limbs -> (8, ...) packed signed
    base-256 digits."""
    if x.device.type == "cpu":
        return digitize_plain(x)
    _check("digitize", x, NLIMB)
    x = x.contiguous()
    out = torch.empty_like(x)
    rc = kernels.lib().ligero_digitize(
        x.data_ptr(), out.data_ptr(), x[0].numel(),
        kernels.stream_handle(x.device))
    kernels.check(rc, "digitize")
    LAUNCHES["digitize"] += 1
    return out


def renorm_final(slots):
    """KR final: (64, ...) int32 slots -> (8, ...) canonical limbs of
    V * 2^-256 mod p."""
    if slots.device.type == "cpu":
        return renorm_final_plain(slots)
    return _renorm("renorm_final", slots, None)


def renorm_pack(slots):
    """KR pack: (64, ...) slots -> (8, ...) packed signed digits of
    V * 2^-256 mod p."""
    if slots.device.type == "cpu":
        return renorm_pack_plain(slots)
    return _renorm("renorm_pack", slots, None)


def renorm_mid(slots, tw):
    """KR mid: (64, ...) slots and Montgomery-form twiddles -> (8, ...)
    packed signed digits of mont_mul(V * 2^-256 mod p, tw).  `tw` has the
    slots' trailing shape, or is (8, S, 1, C) against slots (64, S, B, C)."""
    if slots.device.type == "cpu" and tw.device.type == "cpu":
        twiddle_index("renorm_mid", slots.shape[1:], tw.shape[1:])
        return renorm_mid_plain(slots, tw)
    return _renorm("renorm_mid", slots, tw)
