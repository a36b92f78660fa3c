"""Montgomery multiply kernels K1 (``mont_mul``) and K2 (``mulmod``).

Ports of the Pallas kernels ``_k_mont_mul`` and ``_k_mulmod``
(``ligero_prover_tpu/ops/pallas/fieldmul.py:260,264``, reached through
``mont_mul_aos`` / ``mulmod_aos``).  The CUDA source is
``csrc/fieldmul.cu``; this module holds the wrappers and, beside each
kernel, its plain PyTorch version.

A wrapper runs the plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel (counted in :data:`LAUNCHES`) or raises;
there is no fallback.  The plain versions count their calls by device
type in :data:`PLAIN_CALLS`, so a run can show that its main path never
took them on the card.

Both compute exactly the reference's algorithm, so results are bit
identical on every input, including operands in [p, 2^256):
  U = x*y (512 bits); m = U_lo*J mod 2^256 (J = -p^-1);
  t = U_hi + (m*p)_hi + [U_lo != 0] mod 2^256; one conditional subtract p.
"""

from __future__ import annotations

import math
from collections import Counter

import torch
import torch.nn.functional as nnf

from ..field import bn254 as F
from .. import kernels
from .fieldops import MASK32, P_INTS, R2_LIMBS, NLIMB, _add, _cond_sub, \
    narrow, to_torch

LAUNCHES = {"mont_mul": 0, "mulmod": 0}
PLAIN_CALLS = {"mont_mul": Counter(), "mulmod": Counter()}  # by device type
MODE = {"mont_mul": 0, "mulmod": 1}   # the C entry point's `mode` argument


def reset_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0
        PLAIN_CALLS[key].clear()


# ---- plain versions ------------------------------------------------------

def _digits_of(value: int) -> list[int]:
    return [(value >> (16 * i)) & 0xFFFF for i in range(16)]


_CONST_CACHE: dict = {}


def _const_digits(device):
    key = str(device)
    if key not in _CONST_CACHE:
        _CONST_CACHE[key] = tuple(
            torch.tensor(_digits_of(v), dtype=torch.int64, device=device)
            for v in (F.MONTGOMERY_FACTOR_NEG, F.MODULUS))
    return _CONST_CACHE[key]


def _digits(limbs: torch.Tensor) -> torch.Tensor:
    """(..., L) int64 u32 limbs -> (..., 2L) 16-bit digits, little-endian."""
    return torch.stack([limbs & 0xFFFF, limbs >> 16], -1).flatten(-2)


def _conv(xd: torch.Tensor, yd: torch.Tensor) -> torch.Tensor:
    """16x16 digit convolution -> (..., 32) column sums (each < 2^36).

    The (..., 16, 16) outer product is skewed so that row i shifts right by
    i (pad each row to 33, flatten, re-cut rows of 32); summing the rows
    then adds every product into its anti-diagonal column i + j."""
    prod = xd.unsqueeze(-1) * yd.unsqueeze(-2)
    skew = nnf.pad(prod, (0, 17)).flatten(-2)[..., :16 * 32]
    return skew.unflatten(-1, (16, 32)).sum(-2)


def _carry(cols: torch.Tensor, nlimbs: int) -> list[torch.Tensor]:
    """Digit column sums -> `nlimbs` normalized u32 limbs (int64); the
    carry out of the top limb is dropped (result mod 2^(32*nlimbs))."""
    acc = cols[..., 0:2 * nlimbs:2] + (cols[..., 1:2 * nlimbs:2] << 16)
    outs, carry = [], None
    for i in range(nlimbs):
        v = acc[..., i] if carry is None else acc[..., i] + carry
        carry = v >> 32
        outs.append(v & MASK32)
    return outs


def _mont_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    j_dig, p_dig = _const_digits(x.device)
    xd = _digits(x.to(torch.int64) & MASK32)
    yd = _digits(y.to(torch.int64) & MASK32)
    u = _carry(_conv(xd, yd), 16)
    u_lo = torch.stack(u[:NLIMB], -1)
    m = _carry(_conv(_digits(u_lo), j_dig), NLIMB)
    mp = _carry(_conv(_digits(torch.stack(m, -1)), p_dig), 16)
    nz = (u_lo != 0).any(-1).to(torch.int64)
    t, _ = _add(u[NLIMB:], [mp[NLIMB] + nz] + mp[NLIMB + 1:])
    return narrow(_cond_sub(t, P_INTS))


def mont_mul_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1 (any device, broadcasting)."""
    PLAIN_CALLS["mont_mul"][x.device.type] += 1
    return _mont_plain(x, y)


def mulmod_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2 (any device, broadcasting)."""
    PLAIN_CALLS["mulmod"][x.device.type] += 1
    return _mont_plain(_mont_plain(x, y), to_torch(R2_LIMBS, x.device))


# ---- kernel wrappers -----------------------------------------------------

def _tiled(t: torch.Tensor, shape) -> torch.Tensor | None:
    """`t` as contiguous (R, 8) rows whose element i of the broadcast
    `shape` is row i % R, or None when broadcasting is not such a tiling
    (a broadcast (h, 8) twiddle over (B, h, 8) rows tiles with R = h)."""
    dims = (1,) * (len(shape) - t.dim()) + tuple(t.shape)
    d = 0
    while d < len(shape) - 1 and dims[d] == 1:
        d += 1
    if dims[d:] != tuple(shape[d:]):
        return None
    flat = t.reshape(-1, NLIMB).contiguous()
    if flat.data_ptr() % 16:
        flat = flat.clone()
    return flat


def _launch(name: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"{name}: operands must be CUDA tensors on one "
                         f"device, got {x.device} and {y.device}")
    if x.dtype != torch.int32 or y.dtype != torch.int32:
        raise TypeError(f"{name}: operands must be int32 limbs")
    shape = torch.broadcast_shapes(x.shape, y.shape)
    if shape[-1] != NLIMB:
        raise ValueError(f"{name}: last dimension must be {NLIMB}")
    n = math.prod(shape[:-1])
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    xt, yt = _tiled(x, shape), _tiled(y, shape)
    if (xt is None or xt.shape[0] != n) and yt is not None \
            and yt.shape[0] == n:
        # x*y is symmetric in its operands: put the full-size one first
        x, y, xt, yt = y, x, yt, xt
    if xt is None or xt.shape[0] != n:
        xt = x.expand(shape).reshape(-1, NLIMB).contiguous()
    if yt is None:
        yt = y.expand(shape).reshape(-1, NLIMB).contiguous()
    rc = kernels.lib().ligero_mont_mul(
        xt.data_ptr(), yt.data_ptr(), out.data_ptr(), n, yt.shape[0],
        MODE[name], kernels.stream_handle(x.device))
    kernels.check(rc, name)
    LAUNCHES[name] += 1
    return out


def mont_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K1: x*y*2^-256 mod p over (..., 8) int32 limbs, broadcasting."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return mont_mul_plain(x, y)
    return _launch("mont_mul", x, y)


def mulmod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K2: x*y mod p over (..., 8) int32 limbs, broadcasting."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return mulmod_plain(x, y)
    return _launch("mulmod", x, y)
