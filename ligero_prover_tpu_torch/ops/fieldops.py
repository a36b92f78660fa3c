"""Vectorized BN254-Fr limb arithmetic in PyTorch (8 little-endian limbs).

Elements are ``torch.int32`` tensors of shape (..., 8) holding the u32 bit
patterns of the JAX package's (..., 8) uint32 ABI, so host marshaling is a
reinterpret (``torch.from_numpy(a.view(np.int32))``).  Arithmetic widens
each limb to int64 in [0, 2^32): sums and borrows then fit without
unsigned types, which torch does not support for ``+``, ``>>`` or ``<``.

Every function reproduces its ``ligero_prover_tpu.ops.fieldops`` twin bit
for bit on every input, canonical or not (carries out of 2^256 are dropped
exactly where the reference drops them).  ``addmod``, ``submod``,
``mont_mul`` and ``mulmod`` dispatch to :mod:`.fieldmul` (KA, K1, K2),
which launches the CUDA kernels for CUDA tensors and runs their plain
versions for CPU tensors.  ``negmod``, ``cond_sub``, ``add_cc`` and
``sub_cc`` stay plain limb chains: neither package calls them at run time
(only tests do).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import bn254 as F
from ..field.limbs import int_to_limbs

NLIMB = 8
MASK32 = 0xFFFFFFFF

P_LIMBS = int_to_limbs(F.MODULUS)
P_INTS = [int(v) for v in P_LIMBS]
R2_LIMBS = int_to_limbs(F.R * F.R % F.MODULUS)
R_MONT_LIMBS = int_to_limbs(F.R % F.MODULUS)      # 1 in Montgomery form


def to_torch(limbs: np.ndarray, device=None) -> torch.Tensor:
    """uint32 limbs (numpy) -> int32 bit patterns on `device`."""
    arr = np.ascontiguousarray(np.asarray(limbs, np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """int32 bit patterns -> uint32 limbs (numpy, host)."""
    return x.detach().cpu().contiguous().numpy().view(np.uint32)


def widen(x: torch.Tensor) -> list[torch.Tensor]:
    """(..., 8) int32 -> 8 int64 limb tensors in [0, 2^32)."""
    return list((x.to(torch.int64) & MASK32).unbind(-1))


def narrow(limbs) -> torch.Tensor:
    """8 int64 limb tensors in [0, 2^32) -> (..., 8) int32."""
    return torch.stack(limbs, -1).to(torch.int32)


def _add(xs, ys):
    """Limb-list add: (sum limbs mod 2^256, carry-out int64 0/1)."""
    outs, carry = [], None
    for a, b in zip(xs, ys):
        v = a + b if carry is None else a + b + carry
        carry = v >> 32
        outs.append(v & MASK32)
    return outs, carry


def _sub(xs, ys):
    """Limb-list subtract: (diff limbs mod 2^256, borrow-out int64 0/-1)."""
    outs, nb = [], None
    for a, b in zip(xs, ys):
        v = a - b if nb is None else a - b + nb
        nb = v >> 32                      # arithmetic: -1 on borrow, else 0
        outs.append(v & MASK32)
    return outs, nb


def _select(take, a_limbs, b_limbs):
    """Per element: a where `take` (bool (...,)) else b; returns a limb list."""
    return [torch.where(take, a, b) for a, b in zip(a_limbs, b_limbs)]


def _cond_sub(xs, m_ints):
    """x - m if x >= m else x, on limb lists (one conditional subtract)."""
    d, nb = _sub(xs, m_ints)
    return _select(nb == 0, d, xs)


def add_cc(x, y):
    """256-bit add with carry-out: (sum (..., 8) int32, carry (...,) int32)."""
    s, carry = _add(widen(x), widen(y))
    return narrow(s), carry.to(torch.int32)


def sub_cc(x, y):
    """256-bit subtract with borrow-out: (diff, borrow (...,) int32 0/1)."""
    d, nb = _sub(widen(x), widen(y))
    return narrow(d), (-nb).to(torch.int32)


def cond_sub(x, m_limbs: np.ndarray):
    """x - m if x >= m else x (single conditional subtract)."""
    return narrow(_cond_sub(widen(x), [int(v) for v in m_limbs]))


def addmod(x, y, out=None):
    """(x + y) mod p, the carry out of 2^256 dropped (KA on CUDA), into
    `out` when given (it may be x or y; see ``fieldmul.addmod_aos``)."""
    from . import fieldmul
    return fieldmul.addmod_aos(x, y, out)


def submod(x, y, out=None):
    """(x - y) mod p (KA on CUDA tensors), into `out` when given."""
    from . import fieldmul
    return fieldmul.submod_aos(x, y, out)


def negmod(x):
    xs = widen(x)
    d, _ = _sub(P_INTS, xs)
    return narrow(_select(torch.all(x == 0, dim=-1), xs, d))


def mont_mul(x, y):
    """Montgomery product x*y/2^256 mod p (kernel K1 on CUDA tensors)."""
    from . import fieldmul
    return fieldmul.mont_mul(x, y)


def mulmod(x, y):
    """x*y mod p = mont_mul(mont_mul(x, y), R^2) (kernel K2 on CUDA)."""
    from . import fieldmul
    return fieldmul.mulmod(x, y)


_PM2_BITS = [(F.MODULUS - 2) >> i & 1 for i in range(F.NUM_BITS)]


def invmod(x, mul=mont_mul):
    """Fermat inverse x^(p-2): the reference's 254-step Montgomery
    square-and-multiply ladder, with the exponent's bits known on the host
    (so a zero bit skips the multiply instead of selecting it away), on
    the Montgomery product `mul` (K1; a check passes its plain version).
    invmod(0) = 0."""
    r2 = to_torch(R2_LIMBS, x.device)
    xm = mul(x, r2)                                        # x*R
    acc = to_torch(R_MONT_LIMBS, x.device).expand(x.shape).contiguous()
    for i in range(F.NUM_BITS):
        acc = mul(acc, acc)
        if _PM2_BITS[F.NUM_BITS - 1 - i]:
            acc = mul(acc, xm)
    one = torch.zeros_like(x)
    one[..., 0] = 1
    return mul(acc, one)                                   # leave Montgomery
