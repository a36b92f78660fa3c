"""BN254-Fr field kernels: K1 (``mont_mul``), K2 (``mulmod``), KA
(``addmod_aos``, ``submod_aos``: into a new tensor or in place, ``out=``,
an operand on the host of one element taken by value) and KF
(``masked_mulsum_aos``: acc plus the B products x*y, added in order, and
``masked_sum_aos``: acc plus B given rows) over AoS (..., 8) limbs, and the
planar family over
(8, ...) limb planes: KB (a pass of s constant-geometry butterfly
stages, ``butterfly_dit_pass``/``butterfly_dif_pass``;
``butterfly_dit``/``butterfly_dif`` are its one-stage case) and KE
(``addmod_planar``, ``submod_planar``, ``mont_mul_planar``,
``mulmod_planar``, ``mont_mul_scalar_planar``, ``mulmod_fma_planar``,
``mont_mul_tiled_planar``: mont_mul by one row tiled over the first
operand, the sharded encode's coset twist, and ``quad_terms_planar``: the
quadratic test's terms, read from the encoded batch by row index) and KQ
(``quad_acc_planar``: the check's whole quadratic-test accumulation, the
terms, their prescaled scalars, the pairwise fold and the add into the
(n, 8) accumulator, in one launch).

Ports of the Pallas kernels of ``ligero_prover_tpu/ops/pallas/fieldmul.py``
(``_k_mont_mul``/``_k_mulmod`` :260,264 through ``mont_mul_aos`` /
``mulmod_aos``; ``_k_butterfly_dit``/``_dif`` :238,245; ``_k_addmod``,
``_k_submod``, ``_k_mont_scalar``, ``_k_mulmod_fma`` :252,256,269,278 and
the planar entries of :351-383; ``quad_terms_planar`` is ``_k_mulmod``'s
planar entry redesigned around its one caller, the check's
``jnp.take`` + ``mulmod_planar`` + ``submod_planar`` + ``concatenate`` at
``ligero_prover_tpu/zkp/executor.py:233-250``; ``quad_acc_planar`` takes
that call with all the check wraps around it there, ``:230-250``).  The
CUDA sources are
``csrc/fieldmul.cu`` and ``csrc/planar.cu``; this module holds the
wrappers and, beside each kernel, its plain PyTorch version.  KA and KF
replace XLA ops of the reference, not Pallas kernels: ``fo.addmod``/
``fo.submod`` (``ligero_prover_tpu/ops/fieldops.py:100-111``) and the
verifier's ``_masked_sum`` loop (``ligero_prover_tpu/zkp/executor.py:
108-112``), which fused KF takes with the ``fo.mulmod`` product that each
of its callers hands it; ``ops.fieldops.addmod``/``submod`` dispatch to
KA.  Their plain versions are the limb chains ``_addmod_chain``/
``_submod_chain`` (and ``_mulmod_chain``), which every other plain
version here calls by name, so that no plain version reaches a kernel on
a CUDA tensor.

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

The planar butterflies take a whole batch of rows per call, and a pass
takes s consecutive stages of one transform in one launch.  Where the
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

import numpy as np
import torch
import torch.nn.functional as nnf

from ..field import bn254 as F
from .. import kernels
from .fieldops import MASK32, P_INTS, R2_LIMBS, NLIMB, _add, _cond_sub, \
    _select, _sub, narrow, to_torch, widen

PLANAR_MODE = {"addmod_planar": 0, "submod_planar": 1, "mont_mul_planar": 2,
               "mulmod_planar": 3, "mont_mul_scalar_planar": 4}
FMA = "mulmod_fma_planar"     # KE's three-operand mode: acc + x*y
FMA_MODE = 5
TILED = "mont_mul_tiled_planar"   # KE mont_mul, y one row tiled over x
TILED_MODE = 6
KE_MODE = {**PLANAR_MODE, FMA: FMA_MODE, TILED: TILED_MODE}
QUAD = "quad_terms_planar"    # KE mulmod around the check: rows by index
QACC = "quad_acc_planar"      # KQ: the quadratic test's whole accumulation
QACC_MAX_TERMS = 1024         # KQ's most terms T + P (csrc/planar.cu,
#                               kQuadMaxTerms)
STAGES = ("butterfly_dit", "butterfly_dif")   # KB: counted once per pass
MAX_PASS = 8            # most stages in one KB pass: log2 of its 256-element
#                         shared-memory tile (csrc/planar.cu, kLog2Tile)
AOS_MODE = {"addmod_aos": 0, "submod_aos": 1}   # KA's `mode` argument
FOLD = "masked_sum_aos"       # KF: acc + the B rows of terms, in order
MULSUM = "masked_mulsum_aos"  # KF fused: acc + the B products x*y, in order
LAUNCHES = {name: 0 for name in ("mont_mul", "mulmod", *AOS_MODE, FOLD,
                                 MULSUM,
                                 *STAGES, *PLANAR_MODE, FMA, TILED, QUAD,
                                 QACC)}
PLAIN_CALLS = {name: Counter() for name in LAUNCHES}     # by device type
TILED_SHAPES = Counter()  # the tiled mode's launches by (B rows, width w)
MODE = {"mont_mul": 0, "mulmod": 1}   # ligero_mont_mul's `mode` argument


def reset_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0
        PLAIN_CALLS[key].clear()
    TILED_SHAPES.clear()


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


def _mulmod_chain(x, y):
    """x*y mod p as two Montgomery products, broadcasting."""
    return _mont_plain(_mont_plain(x, y), to_torch(R2_LIMBS, x.device))


def mulmod_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2 (any device, broadcasting)."""
    PLAIN_CALLS["mulmod"][x.device.type] += 1
    return _mulmod_chain(x, y)


def _addmod_chain(x, y):
    """(x + y) mod p as a chain of limb ops, broadcasting: the carry out
    of 2^256 dropped, then one conditional subtract of p."""
    s, _ = _add(widen(x), widen(y))
    return narrow(_cond_sub(s, P_INTS))


def _submod_chain(x, y):
    """(x - y) mod p as a chain of limb ops, broadcasting: + p (mod 2^256)
    where the subtract borrowed."""
    d, nb = _sub(widen(x), widen(y))
    fix, _ = _add(d, P_INTS)
    return narrow(_select(nb != 0, fix, d))


def addmod_aos_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of KA addmod (any device, broadcasting)."""
    PLAIN_CALLS["addmod_aos"][x.device.type] += 1
    return _addmod_chain(x, y)


def submod_aos_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of KA submod (any device, broadcasting)."""
    PLAIN_CALLS["submod_aos"][x.device.type] += 1
    return _submod_chain(x, y)


def masked_sum_aos_plain(acc: torch.Tensor,
                         terms: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of KF: acc + terms[0] + ... + terms[B-1] mod
    p, one addmod at a time in that order (B = 0: acc itself)."""
    PLAIN_CALLS[FOLD][acc.device.type] += 1
    for i in range(terms.shape[0]):
        acc = _addmod_chain(acc, terms[i])
    return acc


def masked_mulsum_aos_plain(acc: torch.Tensor, x: torch.Tensor,
                            y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of fused KF: the products x*y mod p, then
    acc + prod[0] + ... + prod[B-1] mod p, one addmod at a time in that
    order (B = 0: acc itself)."""
    PLAIN_CALLS[MULSUM][acc.device.type] += 1
    prods = _mulmod_chain(x, y)
    for i in range(prods.shape[0]):
        acc = _addmod_chain(acc, prods[i])
    return acc


# ---- kernel wrappers -----------------------------------------------------

def _check_cuda(name: str, *ts: torch.Tensor):
    """Operands of an AoS kernel: int32 tensors on one CUDA device."""
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: operands must be CUDA tensors on one "
                         f"device, got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.int32 for t in ts):
        raise TypeError(f"{name}: operands must be int32 limbs")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous from a 16-byte boundary (a copy where it is not)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


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
    _check_cuda(name, x, y)
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
    kernels.launch("ligero_mont_mul", name, x.device, xt.data_ptr(),
                   yt.data_ptr(), out.data_ptr(), n, yt.shape[0], MODE[name])
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


def aos_view(t: torch.Tensor, shape) -> tuple[torch.Tensor, int, int, int]:
    """How KA reads operand `t` broadcast to `shape` (..., 8): (tensor,
    div, outer, inner) with element i of the result at element
    (i / div) * outer + (i % div) * inner of the tensor, strides in
    8-limb elements.  Broadcast axes (stride 0), row slices and every
    strided view whose element axes merge into at most two are read in
    place; any other operand is a contiguous copy (one more launch)."""
    v = t.expand(shape)
    n = math.prod(shape[:-1])
    if v.stride(-1) != 1 or v.data_ptr() % 16 \
            or any(st % NLIMB for st in v.stride()[:-1]):
        v = v.clone(memory_format=torch.contiguous_format)
    dims: list[tuple[int, int]] = []      # (size, stride), outermost first
    for size, st in zip(v.shape[:-1], v.stride()[:-1]):
        if size == 1:
            continue
        st //= NLIMB
        if dims and dims[-1][1] == size * st:
            dims[-1] = (dims[-1][0] * size, st)
        else:
            dims.append((size, st))
    if len(dims) > 2:
        v, dims = v.clone(memory_format=torch.contiguous_format), [(n, 1)]
    if not dims:
        return v, max(n, 1), 0, 0
    if len(dims) == 1:
        return v, max(n, 1), 0, dims[0][1]
    return v, dims[1][0], dims[0][1], dims[1][1]


def host_element(t: torch.Tensor) -> torch.Tensor | None:
    """`t` as (8,) int32 limbs on the host when it is one element on the
    CPU (a broadcast view of one counts), else None: KA takes such an
    operand by value, as a kernel argument, beside an operand on a card."""
    if t.device.type != "cpu" or t.dim() == 0 or t.shape[-1] != NLIMB \
            or any(size != 1 and st != 0 for size, st
                   in zip(t.shape[:-1], t.stride()[:-1])):
        return None
    return t[(0,) * (t.dim() - 1)].contiguous()


def _span(t: torch.Tensor) -> tuple[int, int]:
    """The bytes [first, end) that a view's elements lie in."""
    first = t.data_ptr()
    return first, first + t.element_size() * (1 + sum(
        (size - 1) * st for size, st in zip(t.shape, t.stride())))


def check_out(name: str, out: torch.Tensor, shape, device, *operands):
    """KA's `out`: a contiguous, 16-byte aligned int32 tensor of the result
    `shape` on `device`, which overlaps an operand only element for
    element (that operand read at out's own elements).  Raises before
    anything runs; there is no copy in its place."""
    if out.dtype != torch.int32 or out.device != torch.device(device) \
            or tuple(out.shape) != tuple(shape) or not out.is_contiguous() \
            or out.data_ptr() % 16:
        raise ValueError(f"{name}: `out` must be a contiguous, 16-byte "
                         f"aligned int32 {tuple(shape)} tensor on {device}, "
                         f"got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    if out.numel() == 0:
        return
    lo, hi = _span(out)
    for t in operands:
        if t.device != out.device or t.numel() == 0:
            continue
        t_lo, t_hi = _span(t)
        if t_lo < hi and lo < t_hi and (
                t_lo != lo or t.expand(shape).stride() != out.stride()):
            raise ValueError(f"{name}: `out` overlaps an operand other "
                             f"than element for element")


def _aos_eltwise(name: str, x: torch.Tensor, y: torch.Tensor,
                 out: torch.Tensor | None) -> torch.Tensor:
    consts = (host_element(x), host_element(y))
    side = 1 if consts[0] is not None else 2 if consts[1] is not None else 0
    cards = [t for t, c in zip((x, y), consts) if c is None]
    if not cards:
        raise ValueError(f"{name}: an operand must be on a card, got two "
                         f"host constants")
    _check_cuda(name, *cards)
    if side and consts[side - 1].dtype != torch.int32:
        raise TypeError(f"{name}: operands must be int32 limbs")
    shape = torch.broadcast_shapes(x.shape, y.shape)
    if len(shape) == 0 or shape[-1] != NLIMB:
        raise ValueError(f"{name}: last dimension must be {NLIMB}, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    dev = cards[0].device
    n = math.prod(shape[:-1])
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=dev)
    else:
        check_out(name, out, shape, dev, *cards)
    if n == 0:
        return out
    views = [(None, 1, 0, 0) if c is not None else aos_view(t, shape)
             for t, c in zip((x, y), consts)]
    (xv, *xd), (yv, *yd) = views
    kernels.launch("ligero_aos_eltwise", name, dev,
                   None if xv is None else xv.data_ptr(), *xd,
                   None if yv is None else yv.data_ptr(), *yd,
                   consts[side - 1].data_ptr() if side else None, side,
                   out.data_ptr(), n, AOS_MODE[name])
    LAUNCHES[name] += 1
    return out


def _addsub(name: str, plain, x, y, out):
    if _on_cpu(x, y, *(() if out is None else (out,))):
        if out is not None:
            check_out(name, out, torch.broadcast_shapes(x.shape, y.shape),
                      "cpu", x, y)
        return _into(plain(x, y), out)
    return _aos_eltwise(name, x, y, out)


def addmod_aos(x: torch.Tensor, y: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """KA: (x + y) mod p over (..., 8) int32 limbs, broadcasting (the
    carry out of 2^256 dropped), into `out` when given (which may be x or
    y: see :func:`check_out`).  An operand of one element on the host
    beside one on a card is passed by value."""
    return _addsub("addmod_aos", addmod_aos_plain, x, y, out)


def submod_aos(x: torch.Tensor, y: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """KA: (x - y) mod p over (..., 8) int32 limbs, broadcasting, with
    `out` and host constants as for :func:`addmod_aos`."""
    return _addsub("submod_aos", submod_aos_plain, x, y, out)


def masked_sum_aos(acc: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """KF: acc (..., 8) + terms[0] + ... + terms[B-1] mod p, terms
    (B, *acc.shape), added one row at a time in that order, as the
    reference's loop does, in one launch.  No caller on the main path
    since fused KF (:func:`masked_mulsum_aos`)."""
    if acc.device.type == "cpu" and terms.device.type == "cpu":
        return masked_sum_aos_plain(acc, terms)
    _check_cuda(FOLD, acc, terms)
    if acc.dim() < 1 or acc.shape[-1] != NLIMB \
            or tuple(terms.shape[1:]) != tuple(acc.shape):
        raise ValueError(f"{FOLD}: acc (..., {NLIMB}) and terms (B, "
                         f"*acc.shape), got {tuple(acc.shape)} and "
                         f"{tuple(terms.shape)}")
    n = acc.numel() // NLIMB
    acc, terms = _aligned(acc), _aligned(terms)
    out = torch.empty(acc.shape, dtype=torch.int32, device=acc.device)
    if n == 0:
        return out
    kernels.launch("ligero_masked_sum", FOLD, acc.device, acc.data_ptr(),
                   terms.data_ptr(), out.data_ptr(), n, terms.shape[0])
    LAUNCHES[FOLD] += 1
    return out


def mulsum_form(acc: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> bool:
    """Fused KF's operand check: acc (..., 8), x (B, *acc.shape) and y
    either x's shape (True) or one element a row, (B, 1, ..., 1, 8)
    (False); raises ValueError otherwise."""
    row = (x.shape[0],) + (1,) * (acc.dim() - 1) + (NLIMB,) \
        if x.dim() else ()
    if acc.dim() < 1 or acc.shape[-1] != NLIMB \
            or tuple(x.shape[1:]) != tuple(acc.shape) \
            or tuple(y.shape) not in (tuple(x.shape), row):
        raise ValueError(f"{MULSUM}: acc (..., {NLIMB}), x (B, *acc.shape) "
                         f"and y x's shape or (B, 1, ..., 1, {NLIMB}), got "
                         f"{tuple(acc.shape)}, {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    return tuple(y.shape) == tuple(x.shape)


def masked_mulsum_aos(acc: torch.Tensor, x: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """Fused KF: acc (..., 8) + x[0]*y[0] + ... + x[B-1]*y[B-1] mod p, x
    (B, *acc.shape), y x's shape or one element a row (B, 1, ..., 1, 8),
    the products (K2's) added one at a time in row order, as the
    reference's ``_masked_sum(acc, fo.mulmod(x, y))`` adds them, in one
    launch."""
    full = mulsum_form(acc, x, y)
    if _on_cpu(acc, x, y):
        return masked_mulsum_aos_plain(acc, x, y)
    _check_cuda(MULSUM, acc, x, y)
    n = acc.numel() // NLIMB
    acc, x, y = _aligned(acc), _aligned(x), _aligned(y)
    out = torch.empty(acc.shape, dtype=torch.int32, device=acc.device)
    if n == 0:
        return out
    kernels.launch("ligero_masked_mulsum", MULSUM, acc.device,
                   acc.data_ptr(), x.data_ptr(), y.data_ptr(),
                   out.data_ptr(), n, x.shape[0], int(full))
    LAUNCHES[MULSUM] += 1
    return out


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
    return _on_planes(_addmod_chain, x, y)


def submod_planar_plain(x, y):
    """Plain version of KE submod: (x - y) mod p over limb planes."""
    PLAIN_CALLS["submod_planar"][x.device.type] += 1
    return _on_planes(_submod_chain, x, y)


def mont_mul_planar_plain(x, y):
    """Plain version of KE mont_mul: x*y*2^-256 mod p over limb planes."""
    PLAIN_CALLS["mont_mul_planar"][x.device.type] += 1
    return _on_planes(_mont_plain, x, y)


def _mulmod_planes(x, y):
    r2 = _scalar_planes(to_torch(R2_LIMBS, x.device), x.dim())
    return _on_planes(_mont_plain, _on_planes(_mont_plain, x, y), r2)


def mulmod_planar_plain(x, y):
    """Plain version of KE mulmod: x*y mod p over limb planes."""
    PLAIN_CALLS["mulmod_planar"][x.device.type] += 1
    return _mulmod_planes(x, y)


def mont_mul_scalar_planar_plain(x, s):
    """Plain version of KE mont_scalar: x*s*2^-256 mod p, s one (8,)
    element."""
    PLAIN_CALLS["mont_mul_scalar_planar"][x.device.type] += 1
    return _on_planes(_mont_plain, x, _scalar_planes(s, x.dim()))


def _tile_row(x, y):
    """y, one row of w = x.shape[-1] elements, as (8, 1, ..., 1, w)
    broadcasting over x (8, ..., w); raises if y holds another count."""
    w = x.shape[-1] if x.dim() > 1 else 0
    if x.dim() < 2 or y.shape[0] != NLIMB or y.numel() != NLIMB * w:
        raise ValueError(f"{TILED}: y {tuple(y.shape)} must be one row of "
                         f"the {w} elements of x's last axis, x "
                         f"{tuple(x.shape)}")
    return y.reshape((NLIMB,) + (1,) * (x.dim() - 2) + (w,))


def mont_mul_tiled_planar_plain(x, y):
    """Plain version of KE mont_mul's tiled mode: x (8, ..., w) times y,
    one row of w elements ((8, w) or (8, 1, w)), element i of x's last
    axis by y's element i: x*y*2^-256 mod p."""
    PLAIN_CALLS[TILED][x.device.type] += 1
    return _on_planes(_mont_plain, x, _tile_row(x, y))


def mulmod_fma_planar_plain(acc, x, y):
    """Plain version of KE mulmod_fma: (acc + x*y) mod p over limb planes."""
    PLAIN_CALLS[FMA][x.device.type] += 1
    return _on_planes(_addmod_chain, acc, _mulmod_planes(x, y))


def quad_terms_planar_plain(e, tri_idx, pair_idx):
    """Plain version of quad-terms: the rows of e (8, B, n) gathered by
    index, t = e[x]*e[y] - e[z] for each (x, y, z) of tri_idx (T, 3) and
    d = e[x] - e[y] for each (x, y) of pair_idx (P, 2), as (8, T+P, n)."""
    PLAIN_CALLS[QUAD][e.device.type] += 1
    tri, pair = (torch.as_tensor(np.asarray(i), dtype=torch.int64,
                                 device=e.device).reshape(-1, w)
                 for i, w in ((tri_idx, 3), (pair_idx, 2)))
    ex, ey, ez = (e.index_select(1, tri[:, i]) for i in range(3))
    px, py = (e.index_select(1, pair[:, i]) for i in range(2))
    t_ = _on_planes(_submod_chain, _mulmod_planes(ex, ey), ez)  # (8, T, n)
    d_ = _on_planes(_submod_chain, px, py)                      # (8, P, n)
    return torch.cat([t_, d_], dim=1)


def _tree_fold_plain(x):
    """(8, N, n) -> (8, n): ``_tree_sum_mod_planar``'s association
    (``zkp/executor.py``) over the limb chain: fold rows i and i + h of the
    b rows left, an odd count carrying its first row (the head) on."""
    while x.shape[1] > 1:
        b = x.shape[1]
        head = x[:, :1] if b % 2 else None
        body = x[:, 1:] if b % 2 else x
        h = body.shape[1] // 2
        x = _on_planes(_addmod_chain, body[:, :h], body[:, h:])
        if head is not None:
            x = torch.cat([head, x], dim=1)
    return x[:, 0]


def _limb_rows(a, device) -> torch.Tensor:
    """(R, 8) limbs, a tensor or uint32/int32 host array, as int32 on
    `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.int32)
    return to_torch(np.asarray(a).reshape(-1, NLIMB), device)


def quad_acc_planar_plain(acc, e, tri_idx, pair_idx, tri_r, pair_r):
    """Plain version of KQ: acc (n, 8) plus the pairwise fold of the T + P
    terms of e (8, B, n) (:func:`quad_terms_planar_plain`) times their
    scalars tri_r (T, 8) and pair_r (P, 8) prescaled by R^2
    (:func:`mont_mul_scalar_planar_plain`, then
    :func:`mont_mul_planar_plain` by row scalar), as the check composed
    them before KQ."""
    PLAIN_CALLS[QACC][acc.device.type] += 1
    terms = quad_terms_planar_plain(e, tri_idx, pair_idx)      # (8, N, n)
    r = torch.cat([_limb_rows(tri_r, e.device),
                   _limb_rows(pair_r, e.device)]).T.contiguous()
    scals = mont_mul_scalar_planar_plain(r, to_torch(R2_LIMBS, e.device))
    prods = mont_mul_planar_plain(terms, scals[:, :, None])
    return _addmod_chain(acc, _tree_fold_plain(prods).T)


def _dit_stage(x, tw):
    h = tw.shape[1]
    if x.shape[2] != 2 * h:
        x = x.repeat(1, 1, 2 * h // x.shape[2])
    v = x.reshape(NLIMB, x.shape[1], h, 2)
    a, b = v[..., 0], v[..., 1]
    wb = _on_planes(_mont_plain, b, tw[:, None, :])
    return torch.cat([_on_planes(_addmod_chain, a, wb),
                      _on_planes(_submod_chain, a, wb)], dim=2)


def _dif_stage(x, tw):
    h = tw.shape[1]
    a, b = x[:, :, :h], x[:, :, h:]
    s = _on_planes(_addmod_chain, a, b)
    d = _on_planes(_mont_plain, _on_planes(_submod_chain, a, b),
                   tw[:, None, :])
    return torch.stack([s, d], dim=3).reshape(x.shape)


def butterfly_dit_plain(x, tw):
    """Plain version of KB, DIT: x (8, B, w) -> (8, B, N), N = 2*tw.shape[1];
    a narrower x is tiled to N first (the zero-extension of the encode)."""
    PLAIN_CALLS["butterfly_dit"][x.device.type] += 1
    return _dit_stage(x, tw)


def butterfly_dif_plain(x, tw):
    """Plain version of KB, DIF: x (8, B, N) -> (8, B, N)."""
    PLAIN_CALLS["butterfly_dif"][x.device.type] += 1
    return _dif_stage(x, tw)


def butterfly_dit_pass_plain(x, tws, t0: int, s: int):
    """Plain version of a KB DIT pass: the DIT stages t0..t0+s-1 of the
    (S, 8, N/2) stage table `tws`, in order, one after the other."""
    PLAIN_CALLS["butterfly_dit"][x.device.type] += 1
    for t in range(t0, t0 + s):
        x = _dit_stage(x, tws[t])
    return x


def butterfly_dif_pass_plain(x, tws, t0: int, s: int):
    """Plain version of a KB DIF pass: the DIF stages t0+s-1 down to t0."""
    PLAIN_CALLS["butterfly_dif"][x.device.type] += 1
    for t in range(t0 + s - 1, t0 - 1, -1):
        x = _dif_stage(x, tws[t])
    return x


# ---- planar family: kernel wrappers --------------------------------------

def _check_operands(name: str, *ts: torch.Tensor):
    _check_cuda(name, *ts)
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
    if name == TILED:
        w = x.shape[-1]
        y, y_ls = _with_plane_stride(_tile_row(x, y).reshape(NLIMB, w))
        return x, x_ls, y, y_ls, w, n
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
    z_ptr, z_ls, mode = None, 0, KE_MODE[name]
    if acc is not None:
        _check_operands(name, x, acc)
        if acc.shape != x.shape:
            raise ValueError(f"{name}: acc {tuple(acc.shape)} must have x's "
                             f"shape {tuple(x.shape)}")
        acc, z_ls = _with_plane_stride(acc)
        z_ptr = acc.data_ptr()
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    kernels.launch("ligero_planar_eltwise", name, x.device, x.data_ptr(),
                   x_ls, y.data_ptr(), y_ls, y_div, z_ptr, z_ls,
                   out.data_ptr(), n, mode)
    LAUNCHES[name] += 1
    return out


def _host(name: str, a, what: str) -> np.ndarray:
    """`a`, a numpy array or a CPU tensor, as numpy; a tensor on a device
    raises (checking it would wait for the device)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"{name}: {what} must be on the host, got a "
                             f"tensor on {a.device}")
        a = a.numpy()
    return np.asarray(a)


def quad_indices(e: torch.Tensor, tri_idx, pair_idx, name: str = QUAD):
    """quad-terms' and KQ's argument check of the row indices, on the
    host: tri_idx (T, 3) and pair_idx (P, 2) as int32 numpy arrays, each
    index in [0, B) for e (8, B, n).  Indices come as numpy arrays or CPU
    tensors (the check would otherwise wait for the device); an index out
    of range raises IndexError, as ``index_select`` does."""
    if e.dim() != 3 or e.shape[0] != NLIMB:
        raise ValueError(f"{name}: e must be (8, B, n) limb planes, got "
                         f"{tuple(e.shape)}")
    out = []
    for idx, width, rows in ((tri_idx, 3, "T"), (pair_idx, 2, "P")):
        a = _host(name, idx, "row indices")
        if a.ndim != 2 or a.shape[1] != width \
                or not np.issubdtype(a.dtype, np.integer):
            raise ValueError(f"{name}: row indices must be ({rows}, "
                             f"{width}) integers, got {a.dtype} {a.shape}")
        if a.size and (a.min() < 0 or a.max() >= e.shape[1]):
            raise IndexError(f"{name}: row index out of range [0, "
                             f"{e.shape[1]}): {a.min()}..{a.max()}")
        out.append(np.ascontiguousarray(a, np.int32))
    return out


def _quad_terms(e: torch.Tensor, tri: np.ndarray,
                pair: np.ndarray) -> torch.Tensor:
    _check_operands(QUAD, e)
    e, e_ls = _with_plane_stride(e)
    b_, n = e.shape[1:]
    t_, p_ = len(tri), len(pair)
    out = torch.empty((NLIMB, t_ + p_, n), dtype=torch.int32,
                      device=e.device)
    # one upload of both index sets; from pageable memory it is staged at
    # once and does not wait for the device
    idx = torch.from_numpy(np.concatenate([tri.ravel(), pair.ravel()])) \
        .to(e.device, non_blocking=True)
    base = idx.data_ptr()
    kernels.launch("ligero_planar_quad_terms", QUAD, e.device,
                   e.data_ptr(), e_ls, b_, n, base if t_ else None, t_,
                   base + 12 * t_ if p_ else None, p_, out.data_ptr())
    LAUNCHES[QUAD] += 1
    return out


def quad_acc_args(acc: torch.Tensor, e: torch.Tensor, tri_idx, pair_idx,
                  tri_r, pair_r) -> tuple[np.ndarray, int, int]:
    """KQ's argument check, on the host, before anything runs: e (8, B, n)
    limb planes, acc (n, 8) int32, the row indices as
    :func:`quad_indices` checks them, the scalars tri_r (T, 8) and pair_r
    (P, 8) integer host arrays (uint32 limbs or their int32 bit patterns),
    and 1 <= T + P <= ``QACC_MAX_TERMS``.  Returns (args, T, P): args the
    one int32 array that KQ reads, the 3T + 2P indices and then the
    (T+P, 8) scalars."""
    tri, pair = quad_indices(e, tri_idx, pair_idx, QACC)
    n = e.shape[2]
    if acc.dim() != 2 or tuple(acc.shape) != (n, NLIMB) \
            or acc.dtype != torch.int32:
        raise ValueError(f"{QACC}: acc must be int32 ({n}, {NLIMB}) for e "
                         f"{tuple(e.shape)}, got {acc.dtype} "
                         f"{tuple(acc.shape)}")
    scal = []
    for r, rows, count in ((tri_r, "T", len(tri)), (pair_r, "P", len(pair))):
        a = _host(QACC, r, "scalars")
        if a.shape != (count, NLIMB) or not np.issubdtype(a.dtype,
                                                          np.integer):
            raise ValueError(f"{QACC}: scalars must be ({rows}, {NLIMB}) = "
                             f"({count}, {NLIMB}) integer limbs, got "
                             f"{a.dtype} {a.shape}")
        scal.append(a.astype(np.uint32).view(np.int32))
    if not 1 <= len(tri) + len(pair) <= QACC_MAX_TERMS:
        raise ValueError(f"{QACC}: T + P must be in [1, {QACC_MAX_TERMS}], "
                         f"got {len(tri)} + {len(pair)}")
    args = np.concatenate([tri.ravel(), pair.ravel(),
                           *(a.ravel() for a in scal)])
    return args, len(tri), len(pair)


def _quad_acc(acc: torch.Tensor, e: torch.Tensor, args: np.ndarray,
              t_: int, p_: int) -> torch.Tensor:
    _check_cuda(QACC, acc, e)
    e, e_ls = _with_plane_stride(e)
    acc = _aligned(acc)
    b_, n = e.shape[1:]
    out = torch.empty((n, NLIMB), dtype=torch.int32, device=e.device)
    # indices and scalars in one upload; from pageable memory it is staged
    # at once and does not wait for the device
    dev_args = torch.from_numpy(args).to(e.device, non_blocking=True)
    kernels.launch("ligero_planar_quad_acc", QACC, e.device, e.data_ptr(),
                   e_ls, b_, n, dev_args.data_ptr(), t_, p_, acc.data_ptr(),
                   out.data_ptr())
    LAUNCHES[QACC] += 1
    return out


def _pass(name: str, x: torch.Tensor, tws: torch.Tensor, t0: int, s: int,
          out: torch.Tensor | None) -> torch.Tensor:
    _check_operands(name, x)
    dit = name == "butterfly_dit"
    if x.dim() != 3 or tws.dim() != 3 or tws.shape[1] != NLIMB:
        raise ValueError(f"{name}: x must be (8, B, N) and tws (S, 8, N/2), "
                         f"got {tuple(x.shape)} and {tuple(tws.shape)}")
    _check_operands(name, x, tws[0])
    h, (b_, w) = tws.shape[2], x.shape[1:]
    n = 2 * h
    log2n = n.bit_length() - 1
    if h & (h - 1) or (w != n if not dit else
                       (w < 2 or w & (w - 1) or w > n)):
        raise ValueError(f"{name}: bad widths x {tuple(x.shape)}, tws "
                         f"{tuple(tws.shape)}")
    if not (1 <= s <= min(log2n, MAX_PASS) and 0 <= t0
            and t0 + s <= tws.shape[0]):
        raise ValueError(f"{name}: stages {t0}..{t0 + s - 1} are not a pass "
                         f"of at most {min(log2n, MAX_PASS)} stages of "
                         f"{tws.shape[0]}")
    x, tws = x.contiguous(), tws.contiguous()
    if out is None:
        out = torch.empty((NLIMB, b_, n), dtype=torch.int32, device=x.device)
    elif out.shape != (NLIMB, b_, n) or out.dtype != torch.int32 \
            or out.device != x.device or not out.is_contiguous() \
            or out.data_ptr() == x.data_ptr():
        raise ValueError(f"{name}: `out` must be a contiguous int32 "
                         f"(8, {b_}, {n}) tensor on {x.device}, apart "
                         f"from x")
    kernels.launch("ligero_planar_pass", name, x.device, x.data_ptr(),
                   tws[t0].data_ptr(), out.data_ptr(), b_, log2n, w, s,
                   int(dit))
    LAUNCHES[name] += 1
    return out


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _into(y, out):
    return y if out is None else out.copy_(y)


def butterfly_dit(x, tw, out=None):
    """KB, DIT: one constant-geometry stage over a batch of rows (a pass
    of one stage).

    x (8, B, w) bit-reversed-flow input, tw (8, N/2) the stage's twiddles
    in Montgomery form, result (8, B, N) (written into `out` when given,
    which must not be x).  w < N reads x tiled (zero-extension)."""
    if _on_cpu(x, tw):
        return _into(butterfly_dit_plain(x, tw), out)
    return _pass("butterfly_dit", x, tw[None], 0, 1, out)


def butterfly_dif(x, tw, out=None):
    """KB, DIF: one constant-geometry stage, x (8, B, N) -> (8, B, N)."""
    if _on_cpu(x, tw):
        return _into(butterfly_dif_plain(x, tw), out)
    return _pass("butterfly_dif", x, tw[None], 0, 1, out)


def butterfly_dit_pass(x, tws, t0: int, s: int, out=None):
    """KB, DIT pass: the DIT stages t0..t0+s-1 of the (S, 8, N/2) stage
    table `tws` in one launch (1 <= s <= min(log2 N, MAX_PASS)).  x
    (8, B, w) as for :func:`butterfly_dit`; the result (8, B, N) equals
    the s one-stage calls limb for limb."""
    if _on_cpu(x, tws):
        return _into(butterfly_dit_pass_plain(x, tws, t0, s), out)
    return _pass("butterfly_dit", x, tws, t0, s, out)


def butterfly_dif_pass(x, tws, t0: int, s: int, out=None):
    """KB, DIF pass: the DIF stages t0+s-1 down to t0 of `tws` in one
    launch, x (8, B, N) -> (8, B, N)."""
    if _on_cpu(x, tws):
        return _into(butterfly_dif_pass_plain(x, tws, t0, s), out)
    return _pass("butterfly_dif", x, tws, t0, s, out)


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


def mont_mul_tiled_planar(x, y):
    """KE mont_mul, tiled: x (8, ..., w) times y, one row of w elements
    ((8, w) or (8, 1, w)), element i of x's last axis by y's element i:
    x*y*2^-256 mod p, one launch over every row of x, counted in
    :data:`TILED_SHAPES` by (B, w), B = x[0].numel() // w."""
    _tile_row(x, y)
    if _on_cpu(x, y):
        return mont_mul_tiled_planar_plain(x, y)
    out = _eltwise(TILED, x, y)
    w = x.shape[-1]
    TILED_SHAPES[(x[0].numel() // w, w)] += 1
    return out


def quad_terms_planar(e, tri_idx, pair_idx):
    """The quadratic test's terms from the rows of e (8, B, n), as
    (8, T+P, n): row t < T is e[x]*e[y] - e[z] mod p for the t-th (x, y, z)
    of tri_idx (T, 3), row T+p is e[x] - e[y] mod p for the p-th (x, y)
    of pair_idx (P, 2).  The indices are host arrays, checked here before
    anything runs."""
    tri, pair = quad_indices(e, tri_idx, pair_idx)
    if _on_cpu(e):
        return quad_terms_planar_plain(e, tri, pair)
    return _quad_terms(e, tri, pair)


def quad_acc_planar(acc, e, tri_idx, pair_idx, tri_r, pair_r):
    """KQ, the quadratic test's accumulation: acc (n, 8) plus, folded
    pairwise in ``_tree_sum_mod_planar``'s order, the terms of e (8, B, n)
    (:func:`quad_terms_planar`'s: e[x]*e[y] - e[z] for the T triples of
    tri_idx, e[x] - e[y] for the P pairs of pair_idx) each times its
    scalar (tri_r (T, 8), pair_r (P, 8)) prescaled by R^2: the (n, 8)
    result, a new tensor.  Indices and scalars are host arrays, checked
    here before anything runs (:func:`quad_acc_args`); on a card they
    travel in one upload."""
    args, t_, p_ = quad_acc_args(acc, e, tri_idx, pair_idx, tri_r, pair_r)
    if _on_cpu(acc, e):
        return quad_acc_planar_plain(acc, e, tri_idx, pair_idx, tri_r,
                                     pair_r)
    return _quad_acc(acc, e, args, t_, p_)


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
