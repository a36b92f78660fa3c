#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ligero_prover_tpu_torch/csrc`` (one nvcc per
source, in parallel), checks each kernel against its plain PyTorch version
at the shapes of the main path and times it, checks that small proofs made
on the GPU in the planar and the AoS configuration, each with the butterfly
and with the int8 encode engine, are byte-identical to the same proofs made
on the CPU, then drives the configurations through the port's
``prove``/``verify`` entry points at production geometry (k=8192, n=32768)
on the vbn254fr Poseidon-style guest of ``bench/e2e_prove.py``: the planar
butterfly path at full depth, the AoS path at a reduced depth, and the
planar path with the int8 engine (``USE_MXU``) at full depth, whose proof
must equal the butterfly path's byte for byte.  Each run counts the kernel
launches it makes, from zero.  Any failure raises and exits non-zero; without a CUDA
device it exits non-zero before doing anything.

The last two lines of output are the kernel table as JSON and the result
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

FULL_K = 8192
FULL_ROUNDS = 400          # the planar main path: 2,412 committed rows
AOS_ROUNDS = 60            # the AoS path, cut to 372 rows
SMALL_K = 256
SEED = 20261016
ROOT = Path(__file__).resolve().parent
ECDSA = (ROOT / "tests" / "guests" / "ecdsa_p256.wat", [b"Ligero\x00"])

# The card's published rates, for each kernel's bound (least time).
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 cache (NVIDIA data sheet)
SMS = 132
# Results per clock per SM for compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput table): 64 for 32-bit integer
# multiply, multiply-add and extended-precision multiply-add, the class of
# one 32x32->64-bit product (IMAD.WIDE); the SM issues at most 4 warp
# instructions, 128 thread instructions, per clock in all.
IMAD_PER_CLK = 64
ISSUE_PER_CLK = 128
# The least integer work of each kernel per thread and iteration, counted
# from the function it computes, not from its compiled code.  A Montgomery
# product of two 8-limb operands needs 64 + 36 + 64 = 164 32x32->64-bit
# products (x*y, the low half of U_lo*J, m*p); mulmod is two of them, a
# butterfly one; add and sub need none (their ~24 integer operations per
# element take under 1/20 of their bytes' time and are left out).
# The renormalisation needs 8 products for the fold of bits [504, 528)
# and 36 + 64 for its REDC; renorm_mid adds one Montgomery product.
PRODUCTS = {"mont_mul": 164, "mulmod": 328, "butterfly_dit": 164,
            "butterfly_dif": 164, "mont_mul_planar": 164,
            "mulmod_planar": 328, "mont_mul_scalar_planar": 164,
            "mulmod_fma_planar": 328, "renorm_final": 108,
            "renorm_pack": 108, "renorm_mid": 272}
# One SHA-256 compression, each operation one instruction (a rotate one
# funnel shift, a 3-input xor/choose/majority one LOP3, a 2- or 3-input add
# one IADD3): 64 rounds of 14 (Sigma0, Sigma1: 4 each; Ch, Maj: 1 each;
# 4 adds), 48 schedule words of 10 (sigma0, sigma1: 4 each; 2 adds) and the
# 8 state adds.
SHA_OPS = {"sha256_absorb": 64 * 14 + 48 * 10 + 8,
           "sha256_absorb_planar": 64 * 14 + 48 * 10 + 8}
# The signed byte sweep of a renormalisation: 66 steps of an add, a mask,
# an arithmetic shift and a shift-or into the packed limb (5 operations);
# the repack to signed digits 32 steps of 5 (extract, add, compare, fix,
# insert).  Counted at the same rate as the SHA operations.
SWEEP_OPS = {"renorm_final": 66 * 5, "renorm_pack": 66 * 5 + 32 * 5,
             "renorm_mid": 66 * 5 + 32 * 5, "digitize": 32 * 5}
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 (NVIDIA data sheet)
# mangled name fragment of each kernel's device function
SASS_NAME = {
    "mont_mul": "mont_mul_kernelILi0E", "mulmod": "mont_mul_kernelILi1E",
    "sha256_absorb": "absorb_kernelILb0E",
    "sha256_absorb_planar": "absorb_kernelILb1E",
    "butterfly_dit": "stage_kernelILb1E", "butterfly_dif": "stage_kernelILb0E",
    "addmod_planar": "eltwise_kernelILi0E",
    "submod_planar": "eltwise_kernelILi1E",
    "mont_mul_planar": "eltwise_kernelILi2E",
    "mulmod_planar": "eltwise_kernelILi3E",
    "mont_mul_scalar_planar": "eltwise_kernelILi4E",
    "mulmod_fma_planar": "eltwise_kernelILi5E",
    "renorm_final": "renorm_kernelILi0E", "renorm_mid": "renorm_kernelILi1E",
    "renorm_pack": "renorm_kernelILi2E", "digitize": "digitize_kernel",
}


def make_wat(rounds: int) -> str:
    """The guest of ``bench/e2e_prove.make_wat``: x <- x^2 * x + c over all
    k lanes via vbn254fr, then a copy and an assert_equal."""
    return f"""
(module
  (import "vbn254fr" "vbn254fr_alloc" (func $alloc (param i32)))
  (import "vbn254fr" "vbn254fr_set_ui_scalar" (func $set_scalar (param i32 i32)))
  (import "vbn254fr" "vbn254fr_mulmod" (func $mulmod (param i32 i32 i32)))
  (import "vbn254fr" "vbn254fr_addmod_constant" (func $addc (param i32 i32 i32)))
  (import "vbn254fr" "vbn254fr_copy" (func $copy (param i32 i32)))
  (import "vbn254fr" "vbn254fr_assert_equal" (func $assert_eq (param i32 i32)))
  (memory 1)
  (func $main (local $x i32) (local $t i32) (local $c i32) (local $chk i32) (local $i i32)
    (local.set $x (i32.const 0))
    (local.set $t (i32.const 4))
    (local.set $c (i32.const 8))
    (local.set $chk (i32.const 12))
    (call $alloc (local.get $x))
    (call $alloc (local.get $t))
    (call $alloc (local.get $c))
    (call $alloc (local.get $chk))
    (call $set_scalar (local.get $x) (i32.const 3))
    (call $set_scalar (local.get $c) (i32.const 17))
    (local.set $i (i32.const 0))
    (block $done
      (loop $round
        (br_if $done (i32.ge_u (local.get $i) (i32.const {rounds})))
        ;; t = x*x ; x = t*x ; x = x + c
        (call $mulmod (local.get $t) (local.get $x) (local.get $x))
        (call $mulmod (local.get $x) (local.get $t) (local.get $x))
        (call $addc (local.get $x) (local.get $x) (local.get $c))
        (local.set $i (i32.add (local.get $i) (i32.const 1)))
        (br $round)))
    ;; self-consistency: chk = x  =>  assert_equal(chk, x)
    (call $copy (local.get $chk) (local.get $x))
    (call $assert_eq (local.get $chk) (local.get $x)))
  (export "_start" (func $main)))
"""


def require(cond, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str):
    print(msg, flush=True)


# ---- phase 3 helpers -----------------------------------------------------

CARD: dict = {}     # clock and SASS counts, filled in by main()


def cuda_ms(fn, iters: int) -> float:
    """Median time of one call between two CUDA events, after a warm-up.
    For a Python call this includes its host time when the host is
    slower than the device."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _copy_like(t):
    """`t`'s shape, strides and offset on a copy of its whole storage."""
    import torch
    base = torch.empty(t.untyped_storage().nbytes() // t.element_size(),
                       dtype=t.dtype, device=t.device)
    base.untyped_storage().copy_(t.untyped_storage())
    return base.as_strided(t.shape, t.stride(), t.storage_offset())


def launches_ms(launch, *buffers, iters: int = 50) -> tuple[float, float]:
    """Device time of one kernel launch, (cold, hot): `iters` back-to-back
    launches of a C entry point between two CUDA events, after a warm-up.
    `launch` takes the tensors `buffers`.  Cold: successive launches take
    successive copies of them, enough copies to fill 3x the L2 cache, so
    each launch reads its operands from HBM, as the bound assumes.  Hot:
    every launch takes the same buffers, which stay in L2 when they fit.
    The events are queued behind a ~10 ms device sleep, so the host has
    enqueued every launch before the first one starts and host time does
    not enter the measurement."""
    import torch
    nbytes = sum(b.untyped_storage().nbytes() for b in buffers)
    copies = -(-3 * L2_BYTES // nbytes)
    sets = [buffers] + [[_copy_like(b) for b in buffers]
                        for _ in range(copies - 1)]
    times = []
    for rotation in (sets, sets[:1]):
        launch(*rotation[0])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for i in range(iters):
            launch(*rotation[i % len(rotation)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times[0], times[1]


def sass_counts(lib_path) -> dict:
    """Per kernel, (IMAD.WIDE, IMAD.HI, all) SASS instructions of its
    device function (``cuobjdump -sass``; NOPs not counted): how many
    32x32->64-bit products the compiled code spends against ``PRODUCTS``.
    The bodies are straight-line code, so this is one element's count,
    plus a prologue of a few instructions.  A diagnostic only: the bounds
    do not read it."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" \
        / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [0, 0, 0])
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if cur is None or m is None or m.group(1) == "NOP":
            continue
        cur[2] += 1
        cur[0] += m.group(1).startswith("IMAD.WIDE")
        cur[1] += m.group(1).startswith("IMAD.HI")
    out = {}
    for name, frag in SASS_NAME.items():
        hits = [v for f, v in funcs.items() if frag in f]
        require(len(hits) == 1, f"one SASS function for {name}: {hits}")
        out[name] = tuple(hits[0])
    return out


def bound(name: str, nbytes: int, threads: int, iters: int = 1):
    """(least ms, what bounds it): the larger of the bytes over HBM
    bandwidth and the kernel's least integer work (``PRODUCTS`` at the
    multiply-add rate, ``SHA_OPS`` and ``SWEEP_OPS`` at ``ISSUE_PER_CLK``)
    for `threads`
    threads of `iters` iterations each."""
    rate = SMS * CARD["clock_hz"]
    work = threads * iters
    t_ops = max(PRODUCTS.get(name, 0) * work / (rate * IMAD_PER_CLK),
                (SHA_OPS.get(name, 0) + SWEEP_OPS.get(name, 0)) * work
                / (rate * ISSUE_PER_CLK))
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def max_abs_err(a, b) -> int:
    import torch
    mask = 0xFFFFFFFF
    d = (a.to(torch.int64) & mask) - (b.to(torch.int64) & mask)
    return int(d.abs().max()) if d.numel() else 0


def random_limbs(gen, shape, device, canonical: bool):
    """Random (..., 8) int32 limbs; canonical ones are below p."""
    import numpy as np
    import torch
    from ligero_prover_tpu_torch.field import bn254 as F
    raw = gen.integers(0, 2 ** 32, size=tuple(shape) + (8,), dtype=np.uint64)
    arr = raw.astype(np.uint32)
    if canonical:
        arr[..., 7] %= (F.MODULUS >> 224)      # top limb below p's: < p
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def edge_limbs(device, reverse=False):
    """(6, 8) edge values: 0, 1, p-1, R mod p, p, 2^256-1."""
    import numpy as np
    import torch
    from ligero_prover_tpu_torch.field import bn254 as F
    from ligero_prover_tpu_torch.field.limbs import ints_to_limbs
    edges = ints_to_limbs([0, 1, F.MODULUS - 1, F.R % F.MODULUS, F.MODULUS,
                           (1 << 256) - 1])
    if reverse:
        edges = edges[::-1]
    return torch.from_numpy(np.ascontiguousarray(edges).view(np.int32)
                            .copy()).to(device)


def report(results, name, label, err, times, plain_ms, bnd):
    ms, hot_ms = times
    log(f"phase 3: {name} {label}: max_abs_err={err} kernel_ms={ms:.4f} "
        f"(operands in L2: {hot_ms:.4f}) plain_ms={plain_ms:.4f} "
        f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
    require(err == 0, f"{name} {label} equals its plain version")
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1]}


def compare_cases(kernel, plain, cases) -> int:
    """Largest difference between a wrapper and its plain version over
    the argument tuples `cases`."""
    import torch
    err = 0
    for args in cases:
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
    return err


def check_aos_kernels(device, gen, lib, stream, results):
    """K1, K2 and K3 (AoS rows) at the shapes of the AoS path."""
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm, sha256 as sha

    def limbs(shape, canonical=True):
        return random_limbs(gen, shape, device, canonical)

    def field_ms(name, x, y):
        xt, yt = x.reshape(-1, 8), y.reshape(-1, 8)
        return launches_ms(lambda xt, yt, out: kernels.check(
            lib.ligero_mont_mul(xt.data_ptr(), yt.data_ptr(), out.data_ptr(),
                                xt.shape[0], yt.shape[0], fm.MODE[name],
                                stream), name),
            xt, yt, torch.empty_like(xt))

    def compare(name, args):
        kernel, plain = getattr(fm, name), getattr(fm, name + "_plain")
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        return max_abs_err(got, want)

    # K1 at the DIT butterfly shape: (16, 16384) rows times a (16384, 8)
    # twiddle broadcast over the batch
    x, tw = limbs((16, 16384)), limbs((16384,))
    err = compare("mont_mul", (x, tw))
    err = max(err, compare("mont_mul", (limbs((16, 4096)), limbs((4096,)))))
    # non-canonical operands in [p, 2^256), with edge values
    a = limbs((65536,), canonical=False)
    b = limbs((65536,), canonical=False)
    a[:6], b[:6] = edge_limbs(device), edge_limbs(device, reverse=True)
    err = max(err, compare("mont_mul", (a, b)))
    n1 = x.numel() // 8
    report(results, "mont_mul", "(16*16384,8) x bcast (16384,8), "
           "(16*4096,8), (65536,8) non-canonical", err,
           field_ms("mont_mul", x, tw),
           cuda_ms(lambda: fm.mont_mul_plain(x, tw), 3),
           bound("mont_mul", 64 * n1 + 32 * 16384, n1))
    # K2 at the check-stage shape
    x, y = limbs((16, 32768)), limbs((16, 32768))
    err = max(compare("mulmod", (a, b)), compare("mulmod", (x, y)))
    n2 = x.numel() // 8
    report(results, "mulmod", "(16*32768,8), (65536,8) non-canonical", err,
           field_ms("mulmod", x, y),
           cuda_ms(lambda: fm.mulmod_plain(x, y), 3),
           bound("mulmod", 96 * n2, n2))

    # K3: two flushes of B=16 over C=32768 columns; the first leaves an odd
    # element pending, the second has valid_count < B
    cols, bsz = 32768, 16
    state = sha.initial_state(cols, device)
    pending = torch.zeros((cols, 8), dtype=torch.int32, device=device)
    flushes = [(limbs((bsz, cols), False), 15), (limbs((bsz, cols), False), 9)]
    k_st = p_st = (state, pending, False)
    for rows, valid in flushes:
        k_st = sha.absorb_stream(*k_st, rows, valid)
        p_st = sha.absorb_stream_plain(*p_st, rows, valid)
    torch.cuda.synchronize()
    err = max(max_abs_err(k_st[0], p_st[0]), max_abs_err(k_st[1], p_st[1]))
    require(k_st[2] == p_st[2] and k_st[2] is False, "K3 has_pending carry")
    st_out, pend_out = torch.empty_like(state), torch.empty_like(pending)
    report(results, "sha256_absorb", "B=16 C=32768 two flushes (15 then 9 "
           "valid)", err,
           launches_ms(lambda st, pe, rw, so, po: kernels.check(
               lib.ligero_sha256_absorb(
                   st.data_ptr(), pe.data_ptr(), rw.data_ptr(), so.data_ptr(),
                   po.data_ptr(), cols, bsz, 0, 16, 0, stream),
               "sha256_absorb"),
               state, pending, flushes[0][0], st_out, pend_out),
           cuda_ms(lambda: sha.absorb_stream_plain(
               state, pending, False, flushes[0][0], 16), 3),
           # 16 rows read, state in and out, the pending element written
           bound("sha256_absorb", 32 * cols * (bsz + 3), cols, bsz // 2))


def check_planar_kernels(device, gen, lib, stream, results, k=FULL_K):
    """KB, KE in every mode and K3 on planar rows, at the calls of the
    planar path: n = 4k, 16 rows per flush."""
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm, sha256 as sha

    n, bsz = 4 * k, 16

    def planes(shape, canonical=True):
        return random_limbs(gen, shape, device, canonical) \
            .movedim(-1, 0).contiguous()

    # KB: a DIT n-stage over (8, 16, n) and a DIF k-stage over (8, 16, k),
    # plus non-canonical operands; DIT also reads an (8, 16, k) input tiled
    # to n, as the first stage after the encode's zero-extension does
    for name, width, dit in (("butterfly_dit", n, 1),
                             ("butterfly_dif", k, 0)):
        kernel = getattr(fm, name)
        plain = getattr(fm, name + "_plain")
        x, tw = planes((bsz, width)), planes((width // 2,))
        xw, tww = planes((bsz, width), False), planes((width // 2,), False)
        xw[:, 0, :6] = edge_limbs(device).T
        tww[:, :6] = edge_limbs(device, reverse=True).T
        cases = [(x, tw), (xw, tww)]
        if dit:
            cases.append((planes((bsz, k)), tw))
        err = compare_cases(kernel, plain, cases)
        log2h = (width // 2).bit_length() - 1
        report(results, name, f"(8,{bsz},{width}) canonical and non-canonical"
               + (f", (8,{bsz},{k}) read tiled" if dit else ""), err,
               launches_ms(lambda x, tw, y: kernels.check(
                   lib.ligero_planar_stage(x.data_ptr(), tw.data_ptr(),
                                           y.data_ptr(), bsz, log2h, width,
                                           dit, stream), name),
                   x, tw, torch.empty_like(x)),
               cuda_ms(lambda: plain(x, tw), 3),
               bound(name, 32 * (2 * bsz * width + width // 2),
                     bsz * width // 2))

    # KE, timed at the call the main path makes in each mode:
    #   addmod   the tree sum's first fold: the two (8, 8, n) halves of
    #            (8, 16, n) products, read in place at limb stride 16n
    #   submod, mulmod   full (8, 16, n) operands (gathered rows)
    #   mont_mul (8, 16, n) rows times a (8, 16, 1) per-row scalar
    #   mont_scalar      (8, 16, k) rows times one scalar (the 1/k scaling)
    # and checked there, at full (8, 16, n) second operands, and on one
    # non-canonical set with the edge values
    rows, full = planes((bsz, n)), planes((bsz, n))
    s = planes(())
    main_call = {
        "addmod_planar": (rows[:, :bsz // 2], rows[:, bsz // 2:]),
        "submod_planar": (rows, full),
        "mont_mul_planar": (rows, planes((bsz, 1))),
        "mulmod_planar": (rows, full),
        "mont_mul_scalar_planar": (planes((bsz, k)), s),
    }
    xw, yw = planes((65536,), False), planes((65536,), False)
    xw[:, :6], yw[:, :6] = edge_limbs(device).T, \
        edge_limbs(device, reverse=True).T
    sw = planes((), False)
    for name, mode in fm.PLANAR_MODE.items():
        kernel = getattr(fm, name)
        plain = getattr(fm, name + "_plain")
        scalar = name == "mont_mul_scalar_planar"
        x, y = main_call[name]
        err = compare_cases(kernel, plain,
                            [(x, y), (rows, s if scalar else full),
                             (xw, sw if scalar else yw)])
        xa, x_ls, ya, y_ls, y_div, size = fm.eltwise_args(name, x, y)
        require(xa.data_ptr() == x.data_ptr(),
                f"{name} reads its first operand in place")
        out = torch.empty((8, size), dtype=torch.int32, device=device)
        report(results, name, f"{tuple(x.shape)} x {tuple(y.shape)} "
               f"(limb strides {x_ls}, {y_ls}; y_div {y_div}), full "
               f"(8,{bsz},{n}) and (8,65536) non-canonical", err,
               launches_ms(lambda xa, ya, out: kernels.check(
                   lib.ligero_planar_eltwise(
                       xa.data_ptr(), x_ls, ya.data_ptr(), y_ls, y_div,
                       None, 0, out.data_ptr(), size, mode, stream), name),
                   xa, ya, out),
               cuda_ms(lambda: plain(x, y), 3),
               # x read, out written, each y element read once
               bound(name, 64 * size + 4 * ya.numel(), size))

    # KE mulmod_fma: acc + x*y on full (8, 16, n) operands; no caller on
    # any path, so this is its only launch
    acc = planes((bsz, n))
    zw = planes((65536,), False)
    err = compare_cases(fm.mulmod_fma_planar, fm.mulmod_fma_planar_plain,
                        [(acc, rows, full), (zw, xw, yw)])
    size = bsz * n
    report(results, fm.FMA, f"(8,{bsz},{n}) + (8,{bsz},{n}) x same, and "
           "(8,65536) non-canonical", err,
           launches_ms(lambda xa, ya, za, out: kernels.check(
               lib.ligero_planar_eltwise(
                   xa.data_ptr(), size, ya.data_ptr(), size, 1,
                   za.data_ptr(), size, out.data_ptr(), size, fm.FMA_MODE,
                   stream), fm.FMA),
               rows, full, acc, torch.empty_like(rows)),
           cuda_ms(lambda: fm.mulmod_fma_planar_plain(acc, rows, full), 3),
           bound(fm.FMA, 128 * size, size))

    # K3 on planar rows: the same two flushes as the AoS check, read as
    # (8, 16, n) codeword planes
    cols = n
    state = sha.initial_state(cols, device)
    pending = torch.zeros((cols, 8), dtype=torch.int32, device=device)
    flushes = [(planes((bsz, cols), False), 15),
               (planes((bsz, cols), False), 9)]
    k_st = p_st = (state, pending, False)
    for rows, valid in flushes:
        k_st = sha.absorb_stream_planar(*k_st, rows, valid)
        p_st = sha.absorb_stream_planar_plain(*p_st, rows, valid)
    torch.cuda.synchronize()
    err = max(max_abs_err(k_st[0], p_st[0]), max_abs_err(k_st[1], p_st[1]))
    require(k_st[2] == p_st[2] and k_st[2] is False, "planar K3 carry")
    st_out, pend_out = torch.empty_like(state), torch.empty_like(pending)
    report(results, "sha256_absorb_planar", f"(8,{bsz},{cols}) two flushes "
           "(15 then 9 valid)", err,
           launches_ms(lambda st, pe, rw, so, po: kernels.check(
               lib.ligero_sha256_absorb(
                   st.data_ptr(), pe.data_ptr(), rw.data_ptr(), so.data_ptr(),
                   po.data_ptr(), cols, bsz, 0, bsz, 1, stream),
               "sha256_absorb_planar"),
               state, pending, flushes[0][0], st_out, pend_out),
           cuda_ms(lambda: sha.absorb_stream_planar_plain(
               state, pending, False, flushes[0][0], 16), 3),
           bound("sha256_absorb_planar", 32 * cols * (bsz + 3), cols,
                 bsz // 2))


def check_mxu_kernels(device, gen, lib, stream, results, k=FULL_K):
    """KR (digitize, renorm_mid at both levels, renorm_final, renorm_pack)
    at the calls of one 16-row k -> n encode through the int8 engine, on
    real slots (the level products of random canonical rows and the built
    tables), on an extreme set (every input digit +127, the largest V the
    contract allows, or -128, and all-zero slots) and with the twiddle
    table read by index; then the whole encode against the butterfly
    encode.  The three level products are library calls, timed beside."""
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import mxu_ntt as mx, mxu_renorm as mr, \
        ntt

    n, bsz = 4 * k, 16
    codec = ntt.RSCodec(k, n, device)
    t0 = time.perf_counter()
    tabs = codec.mxu_tabs
    torch.cuda.synchronize()
    CARD["mxu_table_s"] = time.perf_counter() - t0
    r1, c1, r2, c2, _ = tabs["geom"]
    log(f"phase 3: int8 engine tables for k={k}: geometry {tabs['geom']}, "
        f"built in {CARD['mxu_table_s']:.2f}s, "
        f"{ {key: tuple(tabs[key].shape) for key in mx.TABLE_KEYS} }")

    def renorm_launch(name, tw_args):
        """The C entry point on (slots, out) or, with a twiddle table
        read at `tw_args` = (tw_bc, tw_c), on (slots, tw, out)."""
        mode = mr.RENORM_MODE[name]

        def launch(slots, *rest):
            tw, out = (None, *rest) if len(rest) == 1 else rest
            kernels.check(lib.ligero_renorm(
                slots.data_ptr(), None if tw is None else tw.data_ptr(),
                0 if tw is None else tw[0].numel(), *tw_args,
                out.data_ptr(), slots[0].numel(), mode, stream), name)
        return launch

    def extremes(shape):
        """Packed digit operands of `shape`: every digit +127, -128."""
        return [torch.full(shape, word, dtype=torch.int32, device=device)
                for word in (0x7F7F7F7F, -0x7F7F7F80)]

    def slot_sets(level, real):
        """Slots of `real` and of the extreme operands through one level
        product, and all-zero slots, each copied out of the engine's
        buffer."""
        sets = [level(p, tabs).clone()
                for p in [real] + extremes(tuple(real.shape))]
        return sets + [torch.zeros_like(sets[0])]

    def check_renorm(name, sets, tw, nbytes):
        """(err over `sets`, (cold, hot) ms, plain ms, bound) of one KR
        mode, timed on the first set."""
        kernel, plain = getattr(mr, name), getattr(mr, name + "_plain")
        extra = () if tw is None else (tw,)
        err = compare_cases(kernel, plain, [(s, *extra) for s in sets])
        slots = sets[0]
        tw_args = (1, 1) if tw is None else mr.twiddle_index(
            name, slots.shape[1:], tw.shape[1:])
        out = torch.empty((8,) + slots.shape[1:], dtype=torch.int32,
                          device=device)
        times = launches_ms(renorm_launch(name, tw_args), slots, *extra, out)
        plain_ms = cuda_ms(lambda: plain(slots, *extra), 3)
        return err, times, plain_ms, bound(name, nbytes, slots[0].numel())

    rows = random_limbs(gen, (bsz, k), device, True)
    x = rows.movedim(-1, 0).contiguous()                   # (8, 16, k)
    edge = edge_limbs(device)[:4].T                        # 0, 1, p-1, R
    x[:, 0, :4] = edge
    err = compare_cases(mr.digitize, mr.digitize_plain, [(x,)])
    report(results, "digitize", f"(8,{bsz}*{k}) canonical with edge values",
           err,
           launches_ms(lambda a, out: kernels.check(lib.ligero_digitize(
               a.data_ptr(), out.data_ptr(), a[0].numel(), stream),
               "digitize"), x, torch.empty_like(x)),
           cuda_ms(lambda: mr.digitize_plain(x), 3),
           bound("digitize", 64 * bsz * k, bsz * k))

    xp = mr.digitize(x).view(8, bsz, r1, c1)
    # level 1: (64, r1*16*c1) slots, tw1 (8, r1, 1, c1) read by index
    sets1 = slot_sets(mx.level1_slots, xp)
    x1 = sets1[0][0].numel()
    tw1, tw3 = tabs["tw1"], tabs["tw3"]
    e1 = check_renorm("renorm_mid", sets1, tw1,
                      288 * x1 + 4 * tw1.numel())
    e1 = (max(e1[0], compare_cases(
        mr.renorm_mid, mr.renorm_mid_plain,
        [(sets1[0], tw1.expand(8, r1, bsz, c1).contiguous())])), *e1[1:])
    log(f"phase 3: renorm_mid (64,{x1}) x tw1 {tuple(tw1.shape)} by index "
        f"and broadcast, real/+127/-128/zero slots: max_abs_err={e1[0]} "
        f"kernel_ms={e1[1][0]:.4f} (same buffers: {e1[1][1]:.4f}) "
        f"plain_ms={e1[2]:.4f} bound_ms={e1[3][0]:.4f} ({e1[3][1]})")
    require(e1[0] == 0, "renorm_mid at level 1 equals its plain version")
    CARD["renorm_mid_level1"] = {"ms": e1[1][0], "bound_ms": e1[3][0]}
    b1 = mr.renorm_mid(sets1[0], tw1)
    del sets1
    # level 2: (64, r2*16*c2) slots, tw3 (8, r2, 1, c2) read by index
    sets2 = slot_sets(mx.level2_slots, b1)
    x2 = sets2[0][0].numel()
    e2 = check_renorm("renorm_mid", sets2, tw3,
                      288 * x2 + 4 * tw3.numel())
    report(results, "renorm_mid", f"(64,{x2}) x tw3 {tuple(tw3.shape)} by "
           "index, real/+127/-128/zero slots", *e2)
    a2 = mr.renorm_mid(sets2[0], tw3)
    del sets2
    # level 3: (64, c2*16*r2) slots -> canonical limbs, or packed digits
    sets3 = slot_sets(mx.level3_slots, a2)
    for name in ("renorm_final", "renorm_pack"):
        report(results, name, f"(64,{x2}) real/+127/-128/zero slots",
               *check_renorm(name, sets3, None, 288 * x2))
    got = mr.renorm_final(sets3[0]).transpose(1, 2).reshape(8, bsz, n)
    del sets3

    # the whole encode, limb for limb
    rows_aos = x.movedim(0, -1).contiguous()
    want = ntt.encode_rows_cg_planar_core(rows_aos, codec.dom_k, codec.dom_n,
                                          n)
    enc = mx.encode_rows_mxu_core(rows_aos, tabs, n)
    torch.cuda.synchronize()
    same = torch.equal(enc, want) and torch.equal(got, want)
    enc_ms = cuda_ms(lambda: mx.encode_rows_mxu_core(rows_aos, tabs, n), 10)
    cg_ms = cuda_ms(lambda: ntt.encode_rows_cg_planar_core(
        rows_aos, codec.dom_k, codec.dom_n, n), 10)
    log(f"phase 3: 16-row k={k} encode, int8 engine == butterflies limb for "
        f"limb: {same}; by CUDA events {enc_ms:.4f} ms against {cg_ms:.4f} "
        f"ms; tables and slot buffer {mx.table_bytes(tabs)} bytes")
    require(same, "the int8 engine's encode equals the butterfly encode")

    # the level products (library) as the engine calls them, second
    # operand column-major, beside the same product on a row-major copy,
    # and the layout copy that makes the operand
    buf = tabs["slots"]
    for label, w, packed, turn in (("level 1", tabs["w1"],
                                    xp.transpose(1, 2), False),
                                   ("middle", tabs["wm"], b1, True),
                                   ("level 3", tabs["w4"], a2, True)):
        xd = mx._digit_operand(packed, turn)               # (cols, 32*R)
        row_major = xd.t().contiguous()
        m, kk, cols = w.shape[0], w.shape[1], xd.shape[0]
        out = buf[:m * cols].view(m, cols)
        mm_ms = cuda_ms(lambda: torch._int_mm(w, xd.t(), out=out), 20)
        rm_ms = cuda_ms(lambda: torch._int_mm(w, row_major, out=out), 20)
        cp_ms = cuda_ms(lambda: mx._digit_operand(packed, turn), 20)
        ops = 2.0 * m * kk * cols
        log(f"phase 3: {label} product torch._int_mm ({m},{kk})@({kk},{cols})"
            f": {mm_ms:.4f} ms, {ops / mm_ms / 1e9:.1f} TOP/s, "
            f"{100 * ops / (mm_ms * 1e-3) / INT8_OPS_PER_S:.1f}% of the "
            f"dense int8 rate (second operand row-major: {rm_ms:.4f} ms); "
            f"digit operand copy {cp_ms:.4f} ms")


def check_kernels(device) -> dict:
    import numpy as np
    from ligero_prover_tpu_torch import kernels
    gen = np.random.default_rng(SEED)
    lib, stream = kernels.lib(), kernels.stream_handle(device)
    results = {}
    check_aos_kernels(device, gen, lib, stream, results)
    check_planar_kernels(device, gen, lib, stream, results)
    check_mxu_kernels(device, gen, lib, stream, results)
    return results


# ---- phases 4 to 6 -------------------------------------------------------

def wat_program(src, args=()):
    from ligero_prover_tpu_torch.vm.run import make_wat_program
    return make_wat_program(src, list(args), set())


@contextlib.contextmanager
def configuration(planar, mxu=False):
    """Select the planar or the AoS path (``ops.ntt.USE_PLANAR``) and the
    butterfly or the int8 encode engine (``ops.ntt.USE_MXU``) for the
    executors made inside the block; None is the per-device default."""
    from ligero_prover_tpu_torch.ops import ntt
    ntt.USE_PLANAR, ntt.USE_MXU = planar, mxu
    try:
        yield
    finally:
        ntt.USE_PLANAR = ntt.USE_MXU = None


def check_small_proofs(device):
    """CUDA planar == CUDA AoS == both with the int8 engine == CPU proof
    bytes at k=256, for the vbn254fr guest (batch rows only) and for a
    guest with witness rows (linear and quadratic callback rows: the planar
    check's linear branch and a second encode per flush)."""
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.verifier import verify
    from ligero_prover_tpu_torch.zkp.executor import TorchExecutor
    geo = RowGeometry(SMALL_K)
    programs = {"make_wat(4)": wat_program(make_wat(4)),
                "ecdsa_p256": wat_program(str(ECDSA[0]), ECDSA[1])}
    os.environ["LIGERO_PROOF_TIMESTAMP"] = "1700000000"
    try:
        for name, prog in programs.items():
            proofs = {}
            for label, dev, planar, mxu in (
                    ("cuda planar", device, True, False),
                    ("cuda aos", device, False, False),
                    ("cuda planar+mxu", device, True, True),
                    ("cuda aos+mxu", device, False, True),
                    ("cpu", "cpu", None, False)):
                with configuration(planar, mxu):
                    ex = TorchExecutor(geo.k, geo.n, 8, dev)
                require(ex.use_planar is bool(planar) and ex.use_mxu is mxu,
                        f"{label} executor")
                res = prove(prog, geometry=geo, executor=ex,
                            encoding_seed=bytes(range(32)))
                require(res.ok, f"k={SMALL_K} {name} self-check, {label}")
                proofs[label] = (res.proof, ex)
            same = len({p for p, _ in proofs.values()}) == 1
            log(f"phase 4: k={SMALL_K} {name} proof bytes "
                f"{' == '.join(proofs)}: {same} "
                f"({len(proofs['cpu'][0])} bytes)")
            require(same, f"{name}: proofs identical in every configuration")
            ok = verify(prog, proofs["cpu"][0], geometry=geo,
                        executor=proofs["cuda planar"][1]).ok
            log(f"phase 4: the planar CUDA verifier accepts the CPU proof "
                f"of {name}: {ok}")
            require(ok, f"{name}: planar CUDA verifier accepts")
    finally:
        del os.environ["LIGERO_PROOF_TIMESTAMP"]


def tamper(proof: bytes) -> bytes:
    from ligero_prover_tpu_torch.proto import ligero_proof_pb2 as pb
    env = pb.LigeroProofEnvelope()
    env.ParseFromString(gzip.decompress(proof))
    env.ligero_proof.sampled_data.values[5] ^= 1
    return gzip.compress(env.SerializeToString())


PLANAR_KERNELS = ("butterfly_dit", "butterfly_dif", "addmod_planar",
                  "submod_planar", "mont_mul_planar", "mulmod_planar",
                  "mont_mul_scalar_planar", "sha256_absorb_planar")
AOS_KERNELS = ("mont_mul", "mulmod", "sha256_absorb")
MXU_KERNELS = ("digitize", "renorm_mid", "renorm_final")
# KB launches of one k-width butterfly encode at k=8192: log2(k) DIF
# stages, and log2(n) DIT stages less the two the zero-extension skips
STAGES_PER_ENCODE = 13


def prove_full(device, phase: str, planar: bool, rounds: int,
               mxu: bool = False) -> tuple[dict, bytes]:
    """Prove and verify make_wat(rounds) at k=8192 in one configuration,
    counting every kernel's launches from zero; the tamper check runs on
    the planar paths.  Returns the launch counts and the proof."""
    import torch
    from ligero_prover_tpu_torch.ops import fieldmul as fm, sha256 as sha, \
        mxu_renorm as mr
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.verifier import verify
    from ligero_prover_tpu_torch.utils import timer as T

    geo = RowGeometry(FULL_K)
    prog = wat_program(make_wat(rounds))
    label = ("planar" if planar else "aos") + ("+mxu" if mxu else "")
    with configuration(planar, mxu):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        T.clear_timers()
        for module in (fm, sha, mr):
            module.reset_counts()
        t0 = time.perf_counter()
        res = prove(prog, geometry=geo, encoding_seed=bytes(32),
                    device=device)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        vres = verify(prog, res.proof, geometry=geo, device=device)
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t0
        launches = {**fm.LAUNCHES, **sha.LAUNCHES, **mr.LAUNCHES}
        plain = {name: calls["cuda"] for name, calls in
                 {**fm.PLAIN_CALLS, **sha.PLAIN_CALLS,
                  **mr.PLAIN_CALLS}.items()}
        peak = torch.cuda.max_memory_allocated()
        stages = {s: round(T.get_timer(s), 3)
                  for s in ("stage1", "stage2", "stage3")}
        log(f"{phase}: {label} k={FULL_K} n={geo.n} make_wat({rounds}): "
            f"rows={res.num_rows} prove_s={prove_s:.3f} "
            f"rows_per_s={res.num_rows / prove_s:.1f} stages_s={stages} "
            f"verify_s={verify_s:.3f} proof_bytes={len(res.proof)} "
            f"max_memory_allocated={peak} launches={launches} "
            f"launches_per_row={sum(launches.values()) / res.num_rows:.2f} "
            f"plain_calls_on_cuda={plain}")
        require(res.ok, f"{label} prove self-check")
        require(vres.ok, f"port verifier accepts the {label} proof")
        path = (PLANAR_KERNELS if planar else AOS_KERNELS) \
            + (MXU_KERNELS if mxu else ())
        require(all(launches[k] > 0 for k in path),
                f"every kernel of the {label} path launched: {launches}")
        require(all(v == 0 for v in plain.values()),
                f"no plain version ran on CUDA tensors: {plain}")
        if planar:
            bad = verify(prog, tamper(res.proof), geometry=geo,
                         device=device)
            log(f"{phase}: one-bit tamper of sampled_data rejected: "
                f"{not bad.ok}")
            require(not bad.ok, "tampered proof rejected")
    return launches, res.proof


def prove_mxu(device, butterfly: dict, butterfly_proof: bytes) -> dict:
    """The planar path with the int8 encode engine at full depth: the same
    proof as the butterfly path's, byte for byte, with every k-width
    encode moved from the KB stages to the engine (mask rows, decode and
    the verifier keep the butterflies)."""
    from ligero_prover_tpu_torch.ops import mxu_ntt as mx
    from ligero_prover_tpu_torch.ops.ntt import RSCodec
    launches, proof = prove_full(device, "phase 7", True, FULL_ROUNDS, True)
    tabs = RSCodec(FULL_K, 4 * FULL_K, device).mxu_tabs
    encodes = launches["digitize"]
    log(f"phase 7: int8 engine: {encodes} k-width encodes; tables built in "
        f"{CARD['mxu_table_s']:.2f}s (phase 3), tables and slot buffer "
        f"{mx.table_bytes(tabs)} device bytes; butterfly launches "
        f"{launches['butterfly_dit']} + {launches['butterfly_dif']} against "
        f"{butterfly['butterfly_dit']} + {butterfly['butterfly_dif']}; "
        f"proof bytes equal the butterfly path's: "
        f"{proof == butterfly_proof}")
    require(launches["renorm_mid"] == 2 * encodes
            and launches["renorm_final"] == encodes,
            "one digitize, two renorm_mid and one renorm_final per encode")
    for stage in ("butterfly_dit", "butterfly_dif"):
        require(launches[stage] > 0 and launches[stage] ==
                butterfly[stage] - STAGES_PER_ENCODE * encodes,
                f"{stage} runs only for mask rows, decode and the verifier")
    require(proof == butterfly_proof,
            "the int8 engine's proof equals the butterfly proof")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    from ligero_prover_tpu_torch import kernels
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True,
                         check=True).stdout.split()[0]
    CARD["clock_hz"] = float(clk) * 1e6
    log(smi[0])
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices "
        f"{torch.cuda.device_count()} max SM clock {clk} MHz")

    t0 = time.perf_counter()
    kernels.lib()
    info = kernels.build_info
    ptxas = [ln.strip() for ln in info.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    CARD["sass"] = sass_counts(info["path"])
    log(f"phase 2: built {os.path.basename(info['path'])} in "
        f"{time.perf_counter() - t0:.2f}s (nvcc {info['seconds']:.2f}s, "
        f"cached={info['cached']}); ptxas: {' | '.join(ptxas)}; SASS "
        f"(IMAD.WIDE, IMAD.HI, all) per kernel: {CARD['sass']}")

    measured = check_kernels(device)
    check_small_proofs(device)
    os.environ["LIGERO_PROOF_TIMESTAMP"] = "1700000000"
    launches, proof = prove_full(device, "phase 5", True, FULL_ROUNDS)
    aos, _ = prove_full(device, "phase 6", False, AOS_ROUNDS)
    mxu = prove_mxu(device, launches, proof)
    launches.update({k: aos[k] for k in AOS_KERNELS})
    launches.update({k: mxu[k] for k in MXU_KERNELS})

    meta = {
        "mont_mul": ("fieldmul.cu", "ops/pallas/fieldmul.py:260"),
        "mulmod": ("fieldmul.cu", "ops/pallas/fieldmul.py:264"),
        "sha256_absorb": ("sha256.cu", "zkp/executor.py:43"),
        "sha256_absorb_planar": ("sha256.cu", "zkp/executor.py:68"),
        "butterfly_dit": ("planar.cu", "ops/pallas/fieldmul.py:238"),
        "butterfly_dif": ("planar.cu", "ops/pallas/fieldmul.py:245"),
        "addmod_planar": ("planar.cu", "ops/pallas/fieldmul.py:252"),
        "submod_planar": ("planar.cu", "ops/pallas/fieldmul.py:256"),
        "mont_mul_planar": ("planar.cu", "ops/pallas/fieldmul.py:260"),
        "mulmod_planar": ("planar.cu", "ops/pallas/fieldmul.py:264"),
        "mont_mul_scalar_planar": ("planar.cu",
                                   "ops/pallas/fieldmul.py:269"),
        # no caller on any path of either package: launched in phase 3 only
        "mulmod_fma_planar": ("planar.cu", "ops/pallas/fieldmul.py:278"),
        "digitize": ("renorm.cu", "ops/pallas/mxu_renorm.py:146"),
        "renorm_mid": ("renorm.cu", "ops/pallas/mxu_renorm.py:130"),
        "renorm_final": ("renorm.cu", "ops/pallas/mxu_renorm.py:124"),
        # no caller on any path of either package: launched in phase 3 only
        "renorm_pack": ("renorm.cu", "ops/pallas/mxu_renorm.py:139"),
    }
    table = []
    for name, (src, replaces) in meta.items():
        m = measured[name]
        table.append({"name": name, "route": "cuda",
                      "source": f"ligero_prover_tpu_torch/csrc/{src}",
                      "replaces": f"ligero_prover_tpu/{replaces}",
                      "launches": launches[name], **m,
                      "library_ms": None})
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
