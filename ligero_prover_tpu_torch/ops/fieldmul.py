"""BN254-Fr field kernels: K1 (``mont_mul``) and K2 (``mulmod``) over AoS
(..., 8) limbs, and the planar family over (8, ...) limb planes: KB (one
constant-geometry butterfly stage, ``butterfly_dit``/``butterfly_dif``)
and KE (``addmod_planar``, ``submod_planar``, ``mont_mul_planar``,
``mulmod_planar``, ``mont_mul_scalar_planar``, ``mulmod_fma_planar``).

Ports of the Pallas kernels of ``ligero_prover_tpu/ops/pallas/fieldmul.py``
(``_k_mont_mul``/``_k_mulmod`` :260,264 through ``mont_mul_aos`` /
``mulmod_aos``; ``_k_butterfly_dit``/``_dif`` :238,245; ``_k_addmod``,
``_k_submod``, ``_k_mont_scalar``, ``_k_mulmod_fma`` :252,256,269,278 and
the planar entries of :351-383).  The CUDA sources are ``csrc/fieldmul.cu`` and
``csrc/planar.cu``; this module holds the wrappers and, beside each
kernel, its plain PyTorch version.

A wrapper runs the plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel (counted in :data:`LAUNCHES`) or raises;
there is no fallback.  The plain versions count their calls by device
type in :data:`PLAIN_CALLS`, so a run can show that its main path never
took them on the card.

All compute exactly the reference's algorithms, so results are bit
identical on every input, including operands in [p, 2^256):
  mont_mul: U = x*y (512 bits); m = U_lo*J mod 2^256 (J = -p^-1);
            t = U_hi + (m*p)_hi + [U_lo != 0] mod 2^256; one conditional
            subtract p.
  addmod:   x + y mod 2^256, one conditional subtract p.
  submod:   x - y mod 2^256, + p (mod 2^256) on borrow.

The planar butterflies take a whole batch of rows per call.  Where the
reference's ``butterfly_dit(a, b, w)`` returns the two halves of one
stage, :func:`butterfly_dit` maps x (8, B, N) to the stage's output
y (8, B, N); at B = 1, with x interleaving a and b (x[2j] = a[j],
x[2j+1] = b[j]), y is the concatenation [s, d] of the reference's outputs.
:func:`butterfly_dif` is the transpose: x = [a, b] gives y interleaving
s and d.
"""

from __future__ import annotations

import math
from collections import Counter

import torch
import torch.nn.functional as nnf

from ..field import bn254 as F
from .. import kernels
from . import fieldops as fo
from .fieldops import MASK32, P_INTS, R2_LIMBS, NLIMB, _add, _cond_sub, \
    narrow, to_torch

PLANAR_MODE = {"addmod_planar": 0, "submod_planar": 1, "mont_mul_planar": 2,
               "mulmod_planar": 3, "mont_mul_scalar_planar": 4}
FMA = "mulmod_fma_planar"     # KE's three-operand mode: acc + x*y
FMA_MODE = 5
STAGES = ("butterfly_dit", "butterfly_dif")
LAUNCHES = {name: 0 for name in ("mont_mul", "mulmod", *STAGES,
                                 *PLANAR_MODE, FMA)}
PLAIN_CALLS = {name: Counter() for name in LAUNCHES}     # by device type
MODE = {"mont_mul": 0, "mulmod": 1}   # ligero_mont_mul's `mode` argument


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


def _redc_plain(u: list[torch.Tensor]) -> torch.Tensor:
    """Montgomery reduction of a 512-bit U, 16 int64 u32 limb tensors:
    (..., 8) int32 limbs of t - p if t >= p else t, with
    t = U_hi + (m*p)_hi + [U_lo != 0] mod 2^256, m = U_lo*J mod 2^256."""
    j_dig, p_dig = _const_digits(u[0].device)
    u_lo = torch.stack(u[:NLIMB], -1)
    m = _carry(_conv(_digits(u_lo), j_dig), NLIMB)
    mp = _carry(_conv(_digits(torch.stack(m, -1)), p_dig), 16)
    nz = (u_lo != 0).any(-1).to(torch.int64)
    t, _ = _add(u[NLIMB:], [mp[NLIMB] + nz] + mp[NLIMB + 1:])
    return narrow(_cond_sub(t, P_INTS))


def _mont_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xd = _digits(x.to(torch.int64) & MASK32)
    yd = _digits(y.to(torch.int64) & MASK32)
    return _redc_plain(_carry(_conv(xd, yd), 16))


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


# ---- planar family: plain versions ---------------------------------------
#
# Operands are (8, ...) int32 limb planes; a second operand broadcasts over
# the trailing axes of the first (a (8, B, 1) per-row scalar over (8, B, n)
# rows), as torch broadcasting aligns them.

def _on_planes(fn, x, y):
    """`fn`, a function of (..., 8) limbs, applied to (8, ...) planes."""
    return fn(x.movedim(0, -1), y.movedim(0, -1)).movedim(-1, 0).contiguous()


def _scalar_planes(s: torch.Tensor, ndim: int) -> torch.Tensor:
    """(8,) scalar limbs -> (8, 1, ..., 1) broadcasting over `ndim` dims."""
    return s.reshape((NLIMB,) + (1,) * (ndim - 1))


def addmod_planar_plain(x, y):
    """Plain version of KE addmod: (x + y) mod p over limb planes."""
    PLAIN_CALLS["addmod_planar"][x.device.type] += 1
    return _on_planes(fo.addmod, x, y)


def submod_planar_plain(x, y):
    """Plain version of KE submod: (x - y) mod p over limb planes."""
    PLAIN_CALLS["submod_planar"][x.device.type] += 1
    return _on_planes(fo.submod, x, y)


def mont_mul_planar_plain(x, y):
    """Plain version of KE mont_mul: x*y*2^-256 mod p over limb planes."""
    PLAIN_CALLS["mont_mul_planar"][x.device.type] += 1
    return _on_planes(_mont_plain, x, y)


def mulmod_planar_plain(x, y):
    """Plain version of KE mulmod: x*y mod p over limb planes."""
    PLAIN_CALLS["mulmod_planar"][x.device.type] += 1
    r2 = _scalar_planes(to_torch(R2_LIMBS, x.device), x.dim())
    return _on_planes(_mont_plain, _on_planes(_mont_plain, x, y), r2)


def mont_mul_scalar_planar_plain(x, s):
    """Plain version of KE mont_scalar: x*s*2^-256 mod p, s one (8,)
    element."""
    PLAIN_CALLS["mont_mul_scalar_planar"][x.device.type] += 1
    return _on_planes(_mont_plain, x, _scalar_planes(s, x.dim()))


def mulmod_fma_planar_plain(acc, x, y):
    """Plain version of KE mulmod_fma: (acc + x*y) mod p over limb planes."""
    PLAIN_CALLS[FMA][x.device.type] += 1
    r2 = _scalar_planes(to_torch(R2_LIMBS, x.device), x.dim())
    prod = _on_planes(_mont_plain, _on_planes(_mont_plain, x, y), r2)
    return _on_planes(fo.addmod, acc, prod)


def butterfly_dit_plain(x, tw):
    """Plain version of KB, DIT: x (8, B, w) -> (8, B, N), N = 2*tw.shape[1];
    a narrower x is tiled to N first (the zero-extension of the encode)."""
    PLAIN_CALLS["butterfly_dit"][x.device.type] += 1
    h = tw.shape[1]
    if x.shape[2] != 2 * h:
        x = x.repeat(1, 1, 2 * h // x.shape[2])
    v = x.reshape(NLIMB, x.shape[1], h, 2)
    a, b = v[..., 0], v[..., 1]
    wb = _on_planes(_mont_plain, b, tw[:, None, :])
    return torch.cat([_on_planes(fo.addmod, a, wb),
                      _on_planes(fo.submod, a, wb)], dim=2)


def butterfly_dif_plain(x, tw):
    """Plain version of KB, DIF: x (8, B, N) -> (8, B, N)."""
    PLAIN_CALLS["butterfly_dif"][x.device.type] += 1
    h = tw.shape[1]
    a, b = x[:, :, :h], x[:, :, h:]
    s = _on_planes(fo.addmod, a, b)
    d = _on_planes(_mont_plain, _on_planes(fo.submod, a, b), tw[:, None, :])
    return torch.stack([s, d], dim=3).reshape(x.shape)


# ---- planar family: kernel wrappers --------------------------------------

def _check_operands(name: str, *ts: torch.Tensor):
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: operands must be CUDA tensors on one "
                         f"device, got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.int32 for t in ts):
        raise TypeError(f"{name}: operands must be int32 limbs")
    if any(t.dim() < 1 or t.shape[0] != NLIMB for t in ts):
        raise ValueError(f"{name}: operands must be (8, ...) limb planes, "
                         f"got {[tuple(t.shape) for t in ts]}")


def _with_plane_stride(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """`t` (8, ...) and its limb stride, such that limb l of element i is
    at offset l*stride + i: each plane contiguous (a slice t[:, a:b] of a
    contiguous tensor qualifies), else a contiguous copy."""
    plane = t[0]
    if plane.is_contiguous() and t.stride(0) >= max(plane.numel(), 1):
        return t, t.stride(0)
    t = t.contiguous()
    return t, max(t[0].numel(), 1)


def _y_div(name: str, xs, ys) -> int:
    """How many consecutive elements of x share one element of y: y has
    x's shape, except for trailing axes of size 1."""
    if len(ys) != len(xs):
        raise ValueError(f"{name}: operand shapes {tuple(xs)} and "
                         f"{tuple(ys)} have different ranks")
    d = next((i for i in range(1, len(xs)) if ys[i] != xs[i]), len(xs))
    if any(v != 1 for v in ys[d:]):
        raise ValueError(f"{name}: {tuple(ys)} does not broadcast over "
                         f"trailing axes of {tuple(xs)}")
    return max(math.prod(xs[d:]), 1)


def eltwise_args(name: str, x: torch.Tensor, y: torch.Tensor):
    """The operands that the KE wrapper `name` hands to
    ``ligero_planar_eltwise``, after its checks: (x, x's limb stride, y,
    y's limb stride, y_div, n elements).  x or y is a contiguous copy
    where its planes are not contiguous."""
    _check_operands(name, x, y)
    x, x_ls = _with_plane_stride(x)
    n = x[0].numel()
    if name == "mont_mul_scalar_planar":
        if y.numel() != NLIMB:
            raise ValueError(f"{name}: the scalar must be 8 limbs, got "
                             f"{tuple(y.shape)}")
        return x, x_ls, y.reshape(NLIMB).contiguous(), 1, max(n, 1), n
    y_div = _y_div(name, x.shape, y.shape)
    y, y_ls = _with_plane_stride(y)
    return x, x_ls, y, y_ls, y_div, n


def _eltwise(name: str, x: torch.Tensor, y: torch.Tensor,
             acc: torch.Tensor | None = None) -> torch.Tensor:
    x, x_ls, y, y_ls, y_div, n = eltwise_args(name, x, y)
    z_ptr, z_ls, mode = None, 0, PLANAR_MODE.get(name, FMA_MODE)
    if acc is not None:
        _check_operands(name, x, acc)
        if acc.shape != x.shape:
            raise ValueError(f"{name}: acc {tuple(acc.shape)} must have x's "
                             f"shape {tuple(x.shape)}")
        acc, z_ls = _with_plane_stride(acc)
        z_ptr = acc.data_ptr()
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    rc = kernels.lib().ligero_planar_eltwise(
        x.data_ptr(), x_ls, y.data_ptr(), y_ls, y_div, z_ptr, z_ls,
        out.data_ptr(), n, mode, kernels.stream_handle(x.device))
    kernels.check(rc, name)
    LAUNCHES[name] += 1
    return out


def _stage(name: str, x: torch.Tensor, tw: torch.Tensor,
           out: torch.Tensor | None) -> torch.Tensor:
    _check_operands(name, x, tw)
    dit = name == "butterfly_dit"
    if x.dim() != 3 or tw.dim() != 2:
        raise ValueError(f"{name}: x must be (8, B, N) and tw (8, N/2), got "
                         f"{tuple(x.shape)} and {tuple(tw.shape)}")
    h, (b_, w) = tw.shape[1], x.shape[1:]
    n = 2 * h
    if h & (h - 1) or (w != n if not dit else
                       (w < 2 or w & (w - 1) or w > n)):
        raise ValueError(f"{name}: bad widths x {tuple(x.shape)}, tw "
                         f"{tuple(tw.shape)}")
    x, tw = x.contiguous(), tw.contiguous()
    if out is None:
        out = torch.empty((NLIMB, b_, n), dtype=torch.int32, device=x.device)
    elif out.shape != (NLIMB, b_, n) or out.dtype != torch.int32 \
            or out.device != x.device or not out.is_contiguous() \
            or out.data_ptr() == x.data_ptr():
        raise ValueError(f"{name}: `out` must be a contiguous int32 "
                         f"(8, {b_}, {n}) tensor on {x.device}, apart "
                         f"from x")
    if x.data_ptr() % 8 or out.data_ptr() % 8:
        raise ValueError(f"{name}: x and out must be 8-byte aligned")
    rc = kernels.lib().ligero_planar_stage(
        x.data_ptr(), tw.data_ptr(), out.data_ptr(), b_, h.bit_length() - 1,
        w, int(dit), kernels.stream_handle(x.device))
    kernels.check(rc, name)
    LAUNCHES[name] += 1
    return out


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def butterfly_dit(x, tw, out=None):
    """KB, DIT: one constant-geometry stage over a batch of rows.

    x (8, B, w) bit-reversed-flow input, tw (8, N/2) the stage's twiddles
    in Montgomery form, result (8, B, N) (written into `out` when given,
    which must not be x).  w < N reads x tiled (zero-extension)."""
    if _on_cpu(x, tw):
        y = butterfly_dit_plain(x, tw)
        return y if out is None else out.copy_(y)
    return _stage("butterfly_dit", x, tw, out)


def butterfly_dif(x, tw, out=None):
    """KB, DIF: one constant-geometry stage, x (8, B, N) -> (8, B, N)."""
    if _on_cpu(x, tw):
        y = butterfly_dif_plain(x, tw)
        return y if out is None else out.copy_(y)
    return _stage("butterfly_dif", x, tw, out)


def addmod_planar(x, y):
    """KE: (x + y) mod p over limb planes (carry out of 2^256 dropped)."""
    if _on_cpu(x, y):
        return addmod_planar_plain(x, y)
    return _eltwise("addmod_planar", x, y)


def submod_planar(x, y):
    """KE: (x - y) mod p over limb planes."""
    if _on_cpu(x, y):
        return submod_planar_plain(x, y)
    return _eltwise("submod_planar", x, y)


def mont_mul_planar(x, y):
    """KE: x*y*2^-256 mod p over limb planes."""
    if _on_cpu(x, y):
        return mont_mul_planar_plain(x, y)
    return _eltwise("mont_mul_planar", x, y)


def mulmod_planar(x, y):
    """KE: x*y mod p over limb planes."""
    if _on_cpu(x, y):
        return mulmod_planar_plain(x, y)
    return _eltwise("mulmod_planar", x, y)


def mont_mul_scalar_planar(x, s):
    """KE: x*s*2^-256 mod p over limb planes, s one (8,) element."""
    if _on_cpu(x, s):
        return mont_mul_scalar_planar_plain(x, s)
    return _eltwise("mont_mul_scalar_planar", x, s)


def mulmod_fma_planar(acc, x, y):
    """KE: (acc + x*y) mod p over limb planes; acc has x's shape, y
    broadcasts over x's trailing axes as in :func:`mulmod_planar`."""
    if _on_cpu(acc, x, y):
        return mulmod_fma_planar_plain(acc, x, y)
    return _eltwise(FMA, x, y, acc)
