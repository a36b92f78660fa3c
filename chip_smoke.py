#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ligero_prover_tpu_torch/csrc`` (one nvcc per
source, in parallel) and reports each kernel's registers, spills and SASS
counts and the rate of the carry chains' wide multiply-adds (a probe
kernel), checks each kernel against its plain PyTorch version at the shapes
of the main path and times it (KB per butterfly transform, as its planned
passes, beside the one-stage-per-launch composition; K1 at a butterfly
stage's shape and at the vbn254fr arena's calls, K2, KE mont_scalar and K3
(AoS rows, the verifier's 192 columns) also at their small calls, beside the
launch floor of an empty kernel with the same grid; KA (AoS add/sub) at
the vbn254fr arena's calls (the slot written in place, a host constant by
value), the older forms (its broadcast-first ``const_sub``, a constant on
the card) and the verifier's rows, and KF (the ordered fold) fused with
its products at the verifier's sums and a codeword-wide one, beside their
floors and the K2 + fold pair it replaced, and as the fold of given rows;
one invmod ladder of
K1 launches against the plain ladder; KE mont_mul at the check's three
calls and quad-terms beside the nine launches it replaced; KQ, the
check's whole quadratic-test accumulation, at the single-device call
and one shard's, beside the launch floor and the 13-op sequence it
replaced; KR digitize on
the engine's AoS rows read in place and on planar limbs, and KE
mulmod_fma with a full-plane and a per-row second operand, each also on
non-canonical words), checks that
small proofs made on the GPU with the butterfly and with the int8 encode
engine are byte-identical to the same proofs made on the CPU (the vbn254fr
guest, an ECDSA guest with witness rows, and a vbn254fr bit decomposition
whose division runs the invmod ladder through K1), then drives the
executor through the port's ``prove``/``verify`` entry points at
production geometry (k=8192, n=32768) on the vbn254fr Poseidon-style guest
of ``bench/e2e_prove.py``: the butterfly path (phase 5) and the path with
the int8 engine (``USE_MXU``, phase 7), whose proof must equal the
butterfly path's byte for byte, both at full depth, and (phase 8) the
column-sharded prover of ``parallel/mesh.py`` with 4 shards on
cuda:(i % cards) at full depth, whose proof must equal it too (its coset
twist is KE mont_mul's tiled mode, checked and timed in phase 3 at the
sharded path's calls with its grid and beside KE mont_scalar, its
launches counted by call shape), and (phase 9) the same prover over a
``torch.distributed`` process group, one process per rank: 4 ranks of one
card each over NCCL on a host with 4 cards, else 2 ranks of 2 shards each
on cuda:0 over gloo (``mp_layout``), every rank's proof equal to phase
5's.  Each run counts the kernel launches it makes, from zero.  Any
failure raises and exits non-zero; without a CUDA device it exits non-zero
before doing anything.

The last two lines of output are the kernel table as JSON and the result
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

FULL_K = 8192
FULL_ROUNDS = 400          # the main path: 2,412 committed rows
SMALL_K = 256
SEED = 20261016
ROOT = Path(__file__).resolve().parent
ECDSA = (ROOT / "tests" / "guests" / "ecdsa_p256.wat", [b"Ligero\x00"])
# vbn254fr divmod: the invmod ladder of K1 launches on the planar path
BIT_DECOMPOSE = ROOT / "tests" / "guests" / "bit_decompose.wat"

# The card's published rates, for each kernel's bound (least time).
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 cache (NVIDIA data sheet)
SMS = 132
# Results per clock per SM for compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput table): 64 for 32-bit integer
# multiply, multiply-add and extended-precision multiply-add, the class of
# one 32x32->64-bit product (IMAD.WIDE); 64 for 32-bit integer add and
# subtract, for 32-bit shifts, for 32-bit bitwise AND, OR and XOR and for
# funnel shifts, the integer pipe's rows (16 INT32 lanes per SM
# sub-partition, beside 32 FP32 lanes); the SM issues at most 4 warp
# instructions, 128 thread instructions, per clock in all (the 32-bit
# floating-point add, multiply and multiply-add row).
IMAD_PER_CLK = 64
INT_PER_CLK = 64
ISSUE_PER_CLK = 128
# The least integer work of each kernel per thread and iteration, counted
# from the function it computes, not from its compiled code.  A Montgomery
# product of two 8-limb operands needs 64 + 36 + 64 = 164 32x32->64-bit
# products (x*y, the low half of U_lo*J, m*p); mulmod is two of them, a
# butterfly one; add and sub need none (their ~24 integer operations per
# element take under 1/20 of their bytes' time and are left out); a
# quad-terms element of a triple is one mulmod, of a pair none; KQ's
# count is of Montgomery products (a triple 3, a pair 1, a prescale 1).
# The renormalisation needs 8 products for the fold of bits [504, 528)
# and 36 + 64 for its REDC; renorm_mid adds one Montgomery product.
PRODUCTS = {"mont_mul": 164, "mulmod": 328, "butterfly_dit": 164,
            "butterfly_dif": 164, "mont_mul_planar": 164,
            "mulmod_planar": 328, "quad_terms_planar": 328,
            "quad_acc_planar": 164,
            "mont_mul_scalar_planar": 164, "mont_mul_tiled_planar": 164,
            "mulmod_fma_planar": 328, "masked_mulsum_aos": 328,
            "renorm_final": 108,
            "renorm_pack": 108, "renorm_mid": 272}
# One SHA-256 compression, each operation one instruction (a rotate one
# funnel shift, a 3-input xor/choose/majority one LOP3, a 2- or 3-input add
# one IADD3): 64 rounds of 14 (Sigma0, Sigma1: 4 each; Ch, Maj: 1 each;
# 4 adds), 48 schedule words of 10 (sigma0, sigma1: 4 each; 2 adds) and the
# 8 state adds: 1,384 in all (SHA_OPS), at the issue rate.  Of them, the
# rotates, shifts, xors, Ch and Maj (64 x 10 + 48 x 8 = 1,024, SHA_INT_OPS)
# run only on the integer pipe, at INT_PER_CLK; the adds may also issue as
# IMAD on the FMA pipe.  The bound takes the larger of the two times.
SHA_OPS = {"sha256_absorb": 64 * 14 + 48 * 10 + 8,
           "sha256_absorb_planar": 64 * 14 + 48 * 10 + 8}
SHA_INT_OPS = {"sha256_absorb": 64 * 10 + 48 * 8,
               "sha256_absorb_planar": 64 * 10 + 48 * 8}
# The signed byte sweep of a renormalisation: 66 steps of an add, a mask,
# an arithmetic shift and a shift-or into the packed limb (5 operations);
# the repack to signed digits one 256-bit add of 0x80 in every byte and a
# XOR of each word (8 + 8 operations: csrc/renorm.cu, canonical_to_packed).
# All integer-pipe operations, at INT_PER_CLK.
REPACK_OPS = 8 + 8
SWEEP_OPS = {"renorm_final": 66 * 5, "renorm_pack": 66 * 5 + REPACK_OPS,
             "renorm_mid": 66 * 5 + REPACK_OPS, "digitize": REPACK_OPS}
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 (NVIDIA data sheet)
# mangled name fragment of each kernel's device function
SASS_NAME = {
    # K1 with its 32-bit index (below 2^31 elements)
    "mont_mul": "mont_mul_kernelIjE", "mulmod": "mulmod_kernel",
    # KA's two modes with both operands read (the verifier's), and with a
    # host constant by value as y (the arena's add_const) or as x
    # (const_sub); KF's fold of given rows and its fused form (a row
    # scalar y, the code and quad sums; full y, the linear sum)
    "addmod_aos": "addsub_kernelILi0ELi0E",
    "submod_aos": "addsub_kernelILi1ELi0E",
    "addmod_aos_const": "addsub_kernelILi0ELi2E",
    "submod_aos_const_first": "addsub_kernelILi1ELi1E",
    "masked_sum_aos": "masked_sum_kernel",
    "masked_mulsum_aos": "masked_mulsum_kernelILb0E",
    "masked_mulsum_aos_full": "masked_mulsum_kernelILb1E",
    # K3 at the commit step's tile (128 columns per CTA) and at the
    # verifier's (32): both roles in one function, one compression each
    "sha256_absorb": "absorb_tile_kernelILb0ELi128E",
    "sha256_absorb_planar": "absorb_tile_kernelILb1ELi128E",
    "sha256_absorb_t32": "absorb_tile_kernelILb0ELi32E",
    "sha256_absorb_planar_t32": "absorb_tile_kernelILb1ELi32E",
    "butterfly_dit": "pass_kernelILb1E", "butterfly_dif": "pass_kernelILb0E",
    "addmod_planar": "eltwise_kernelILi0E",
    "submod_planar": "eltwise_kernelILi1E",
    # KE mont_mul (mode 2): the per-row scalar form (the check's calls)
    # and the full-plane form (the linear test); mulmod (3): the full-plane
    # form; all in 16-byte units of 4 elements (SASS_ELEMENTS); mulmod_fma
    # (5): the full-plane and the per-row form, in single elements
    "mont_mul_planar": "run_product_kernelILi2ELi1ELb1EE",
    "mont_mul_planar_full": "run_product_kernelILi2ELi0ELb1EE",
    # the tiled mode (6, the sharded encode's twist)
    "mont_mul_tiled_planar": "tiled_kernel",
    "mulmod_planar": "run_product_kernelILi3ELi0ELb1EE",
    "quad_terms_planar": "quad_terms_kernelILb1EE",
    # KQ: one kernel for every geometry
    "quad_acc_planar": "quad_acc_kernel",
    "mont_mul_scalar_planar": "mont_scalar_kernel",
    "mulmod_fma_planar": "run_product_kernelILi5ELi0ELb0EE",
    "mulmod_fma_planar_row": "run_product_kernelILi5ELi1ELb0EE",
    "renorm_final": "renorm_kernelILi0E", "renorm_mid": "renorm_kernelILi1E",
    "renorm_pack": "renorm_kernelILi2E",
    # digitize on the engine's AoS rows viewed as planes (16-byte loads),
    # and word by word on planar input
    "digitize": "digitize_kernelILb1E",
    "digitize_planar": "digitize_kernelILb0E",
    # phase 2's probe of the wide multiply-adds, 1 and 4 chains a thread
    "imad_probe_1": "imad_probe_kernelILi1E",
    "imad_probe_4": "imad_probe_kernelILi4E",
}
# digitize's threads a CTA, one element each (kDigitThreads of
# csrc/renorm.cu)
DIGIT_THREADS = 256
# elements whose code one pass of the kernel's body holds (its SASS count
# over this is per element); 1 where not listed
SASS_ELEMENTS = {"mont_mul_planar": 4, "mont_mul_planar_full": 4,
                 "mulmod_planar": 4, "quad_terms_planar": 4}


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
    not enter the measurement.  Every set is launched once before the
    timing."""
    import torch
    nbytes = sum(b.untyped_storage().nbytes() for b in buffers)
    copies = -(-3 * L2_BYTES // nbytes) if nbytes else 1
    sets = [buffers] + [[_copy_like(b) for b in buffers]
                        for _ in range(copies - 1)]
    times = []
    for rotation in (sets, sets[:1]):
        for bufs in rotation:
            launch(*bufs)
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


def graph_ms(fn, *buffers, iters: int = 50) -> tuple[float, float]:
    """Device time of one call of `fn`, a sequence of launches, (cold,
    hot) as ``launches_ms`` takes them, with the call captured in a CUDA
    graph for each set of buffers and replayed: called from Python, a
    sequence of small launches can take longer on the host than on the
    device, and the device time is what is measured here."""
    import torch
    graphs = {}

    def replay(*bufs):
        key = tuple(b.data_ptr() for b in bufs)
        if key not in graphs:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*bufs)
            torch.cuda.current_stream().wait_stream(side)
            graphs[key] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[key]):
                fn(*bufs)
        graphs[key].replay()
    return launches_ms(replay, *buffers, iters=iters)


def sass_counts(lib_path, names: dict = SASS_NAME) -> dict:
    """Per kernel of `names` (name -> a fragment of the mangled name of
    its device function), (IMAD.WIDE, IMAD.HI, all) SASS instructions
    of its device function (``cuobjdump -sass``; NOPs not counted): how
    many 32x32->64-bit products the compiled code spends against
    ``PRODUCTS``.  The bodies are straight-line code, so this is the count
    of ``SASS_ELEMENTS`` elements (one unless listed), plus a prologue of
    a few instructions.  A diagnostic only: the bounds do not read it."""
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
    for name, frag in names.items():
        hits = [v for f, v in funcs.items() if frag in f]
        require(len(hits) == 1, f"one SASS function for {name}: {hits}")
        out[name] = tuple(hits[0])
    return out


def ptxas_report(text: str, names: dict = SASS_NAME) -> dict:
    """Per kernel of `names` (as for ``sass_counts``), (registers, spill
    store bytes, spill load bytes) from the ``ptxas -v`` lines of the
    build log (empty for a cached build)."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:entry function|Function properties for) "
                      r"'?([A-Za-z_]\w*)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [0, 0, 0])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur[0] = int(m.group(1))
    return {name: tuple(v) for name, frag in names.items()
            for f, v in funcs.items() if frag in f}


def floor_ms(lib, stream, blocks: int, threads: int) -> float:
    """The launch floor: device time of one launch of an empty kernel with
    this grid, timed as the kernels are (``launches_ms``)."""
    from ligero_prover_tpu_torch import kernels
    return launches_ms(lambda: kernels.check(
        lib.ligero_empty(blocks, threads, stream), "empty"))[0]


def k2_grid(n: int) -> tuple[int, int]:
    """K2's and K1's (blocks, threads) for n elements (K1's below 2^31),
    as ``mulmod_threads`` in csrc/fieldmul.cu chooses them."""
    threads = 256
    while threads > 32 and -(-n // threads) < SMS:
        threads //= 2
    return -(-n // threads), threads


# csrc/fieldmul.cu kMulsumLanes, kMulsumLanesFull, kMulsumSmem
MULSUM_LANES, MULSUM_LANES_FULL, MULSUM_SMEM = 16, 4, 48 * 1024


def mulsum_grid(n: int, rows: int) -> tuple[int, int, int, int, int]:
    """Fused KF's (blocks, threads, cols, lanes, chunk) for n columns and
    B = rows, as ``mulsum_geom`` in csrc/fieldmul.cu chooses them."""
    cols = 32
    while cols > 1 and -(-n // cols) < SMS:
        cols //= 2
    chunk = min(max(rows, 1), MULSUM_SMEM // (32 * cols))
    lanes = min(chunk, MULSUM_LANES_FULL if cols == 32 else MULSUM_LANES)
    return -(-n // cols), cols * lanes, cols, lanes, chunk


RUN_THREADS, RUN_UNITS = 128, 2    # csrc/planar.cu kRunThreads, kRunUnits


def run_vec(n, x_ls, x16, out16, row, y_div, y_ls, y16) -> bool:
    """Whether KE mont_mul or mulmod moves 16-byte units, as ``run_vec``
    in csrc/planar.cu decides from the limb strides, the run length and
    whether the pointers sit at 16-byte boundaries (mulmod_fma always
    moves single elements)."""
    return (n % 4 == 0 and x_ls % 4 == 0 and bool(x16) and bool(out16)
            and (y_div % 4 == 0 if row else y_ls % 4 == 0 and bool(y16)))


def run_grid(n: int, length: int, vec: bool) -> tuple[int, int]:
    """(blocks, threads) of KE mont_mul, mulmod and quad-terms over n
    output elements in runs of `length` (a row), 4-element units if
    `vec`, as ``run_geom``/``run_ctas`` in csrc/planar.cu compute them."""
    per_cta = RUN_THREADS * RUN_UNITS * (4 if vec else 1)
    return -(-n // length) * -(-length // per_cta), RUN_THREADS


# csrc/planar.cu kQuadCols, kQuadThreads, kQuadMinCtas, kQuadSmem
QUAD_COLS, QUAD_THREADS, QUAD_MIN_CTAS, QUAD_SMEM = 16, 128, 7 * SMS, \
    100 * 1024


def quad_acc_grid(n: int, t_: int, p_: int) -> tuple[int, int, int, int,
                                                     int]:
    """KQ's (CTAs, threads, cols, lanes, shared bytes) for n columns, T
    triples and P pairs, as ``quad_geom``/``quad_ctas``/``quad_smem`` in
    csrc/planar.cu compute them."""
    terms = t_ + p_
    cols = QUAD_COLS
    while cols > 1 and (-(-n // cols) < QUAD_MIN_CTAS
                        or 32 * terms * (cols + 1) > QUAD_SMEM):
        cols //= 2
    lanes = min(terms, QUAD_THREADS // cols)
    return -(-n // cols), cols * lanes, cols, lanes, 32 * terms * (cols + 1)


# csrc/planar.cu kTiledMaxThreads
TILED_MAX_THREADS = 256


def tiled_grid(b: int, w: int) -> tuple[int, int]:
    """(CTAs, threads) of KE mont_mul's tiled mode over b rows of w
    elements, one element a thread, as ``tiled_geom``/``tiled_ctas`` in
    csrc/planar.cu compute them."""
    t = TILED_MAX_THREADS
    while t > 32 and -(-w // t) * b < SMS:
        t //= 2
    return -(-w // t) * b, t


def resident_warps(regs: int, threads: int) -> int:
    """Warps of `threads`-thread CTAs that one SM holds at `regs`
    registers a thread: 65,536 registers, allocated to a warp in units of
    256; at most 64 warps and 32 CTAs."""
    per_warp = -(-regs * 32 // 256) * 256
    wpc = -(-threads // 32)
    return min(32, 65536 // per_warp // wpc, 64 // wpc) * wpc


def imad_rate(lib, stream) -> dict:
    """Phase 2's probe of the wide multiply-adds (``ligero_imad_probe``):
    mont_mul_cc's even chain, 4 IMAD.WIDE a round, in 1 and 4 independent
    chains a thread, on as many 256-thread CTAs as the card holds at once.
    Per chain count: CTAs, ms (median of 5, CUDA events) and IMAD.WIDE
    per clock per SM at the card's maximum SM clock (a lower bound where
    the card runs slower)."""
    import ctypes
    import torch
    from ligero_prover_tpu_torch import kernels
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2048 * sms, dtype=torch.int32, device="cuda")
    blocks, iters, rates = ctypes.c_int(0), 4096, {}
    for chains in (1, 4):
        def run():
            kernels.check(lib.ligero_imad_probe(
                chains, iters, out.data_ptr(), ctypes.addressof(blocks),
                stream), "imad_probe")
        ms = cuda_ms(run, 5)
        wide = blocks.value * 256 * iters * 4 * chains
        rates[chains] = {"ctas": blocks.value, "ms": ms,
                         "per_clk_per_sm": wide / (ms * 1e-3 * sms
                                                   * CARD["clock_hz"])}
    return rates


def bound(name: str, nbytes: int, threads: int, iters: int = 1):
    """(least ms, what bounds it): the larger of the bytes over HBM
    bandwidth and the kernel's least integer work for `threads` threads
    of `iters` iterations each: ``PRODUCTS`` at the multiply-add rate,
    the integer-pipe operations (``SHA_INT_OPS``, ``SWEEP_OPS``) at
    ``INT_PER_CLK`` and all of them (``PRODUCTS``, ``SHA_OPS``,
    ``SWEEP_OPS``) at ``ISSUE_PER_CLK``."""
    rate = SMS * CARD["clock_hz"]
    work = threads * iters
    products = PRODUCTS.get(name, 0)
    sweep = SWEEP_OPS.get(name, 0)
    t_ops = max(products * work / (rate * IMAD_PER_CLK),
                (SHA_INT_OPS.get(name, 0) + sweep) * work
                / (rate * INT_PER_CLK),
                (products + SHA_OPS.get(name, 0) + sweep) * work
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


def digit_edges(device):
    """(4, 8) words whose signed recoding carries through every byte or
    none: 2^256 - 1 and every byte 0x7F, 0x80 or 0x81."""
    import numpy as np
    import torch
    from ligero_prover_tpu_torch.field.limbs import ints_to_limbs
    words = [(1 << 256) - 1] + [int(b * 32, 16) for b in ("7f", "80", "81")]
    return torch.from_numpy(np.ascontiguousarray(ints_to_limbs(words))
                            .view(np.int32).copy()).to(device)


def report(results, name, label, err, times, plain_ms, bnd, floor=None):
    """Log one kernel's check and times and keep them as its row of the
    kernel table; `floor`: the launch floor at the same grid."""
    ms, hot_ms = times
    extra = "" if floor is None else f" floor_ms={floor:.4f}"
    log(f"phase 3: {name} {label}: max_abs_err={err} kernel_ms={ms:.4f} "
        f"(operands in L2: {hot_ms:.4f}){extra} plain_ms={plain_ms:.4f} "
        f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
    require(err == 0, f"{name} {label} equals its plain version")
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1]}
    if floor is not None:
        results[name]["floor_ms"] = floor


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
    from ligero_prover_tpu_torch.ops import fieldmul as fm, fieldops as fo, \
        sha256 as sha

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
    # twiddle broadcast over the batch, and at the vbn254fr arena's
    # (k, 8) rows times the same shape (the invmod ladder's squares) and
    # times one constant (mont_mul_const, the ladder's last step): each
    # checked on canonical operands and on non-canonical ones with the
    # edge values, and timed beside the launch floor at K1's grid
    a = limbs((65536,), canonical=False)
    b = limbs((65536,), canonical=False)
    a[:6], b[:6] = edge_limbs(device), edge_limbs(device, reverse=True)
    for label, shape, y_shape in (("DIT", (16, 16384), (16384,)),
                                  ("arena", (FULL_K,), (FULL_K,)),
                                  ("arena constant", (FULL_K,), (1,))):
        x, y = limbs(shape), limbs(y_shape)
        xw, yw = limbs(shape, False), limbs(y_shape, False)
        xw.view(-1, 8)[:6] = edge_limbs(device)
        yw.view(-1, 8)[:min(6, yw.numel() // 8)] = \
            edge_limbs(device, reverse=True)[:yw.numel() // 8]
        cases = [(x, y), (xw, yw), (a, b)]
        if label == "DIT":      # the DIT scan's narrower stages too
            cases.append((limbs((16, 4096)), limbs((4096,))))
        err = max(compare("mont_mul", args) for args in cases)
        size, y_rows = x.numel() // 8, y.numel() // 8
        times = field_ms("mont_mul", x, y)
        floor = floor_ms(lib, stream, *k2_grid(size))
        bnd = bound("mont_mul", 64 * size + 32 * y_rows, size)
        if label == "DIT":
            report(results, "mont_mul", "(16*16384,8) x bcast (16384,8), "
                   "non-canonical and edge operands, (16*4096,8), "
                   "(65536,8) non-canonical", err, times,
                   cuda_ms(lambda: fm.mont_mul_plain(x, y), 3), bnd, floor)
            continue
        CARD[f"mont_mul_{label}"] = {"ms": times[0], "hot_ms": times[1],
                                     "floor_ms": floor, "bound_ms": bnd[0]}
        log(f"phase 3: mont_mul at the {label}'s {shape + (8,)} x "
            f"{y_shape + (8,)}, grid {k2_grid(size)}: max_abs_err={err} "
            f"kernel_ms={times[0]:.4f} (operands in L2: {times[1]:.4f}) "
            f"floor_ms={floor:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]})")
        require(err == 0, f"mont_mul at the {label}'s shape equals its "
                "plain version")
    # one vector division's inverse as the arena runs it on the planar
    # path: the invmod ladder of K1 launches at (k, 8), against the same
    # ladder on the plain product
    x = limbs((FULL_K,))
    x[:2] = edge_limbs(device)[:2]                       # 0 and 1
    before = fm.LAUNCHES["mont_mul"]
    got = fo.invmod(x)
    torch.cuda.synchronize()
    ladder = fm.LAUNCHES["mont_mul"] - before
    err = max_abs_err(got, fo.invmod(x, mul=fm.mont_mul_plain))
    inv_ms = cuda_ms(lambda: fo.invmod(x), 3)
    plain_ms = cuda_ms(lambda: fo.invmod(x, mul=fm.mont_mul_plain), 3)
    CARD["invmod"] = {"launches": ladder, "ms": inv_ms,
                      "plain_ms": plain_ms}
    log(f"phase 3: invmod ladder on ({FULL_K}, 8): {ladder} mont_mul "
        f"launches, max_abs_err={err} against the plain ladder; "
        f"{inv_ms:.4f} ms by CUDA events, host launches included "
        f"(plain ladder {plain_ms:.4f} ms)")
    require(err == 0 and ladder == 383, "the invmod ladder of 383 K1 "
            "launches equals the plain ladder")
    # K2 at the AoS path's check shape and at the shapes of its callers on
    # the planar path, the vbn254fr arena's (k, 8) rows and the verifier's
    # (B, 192, 8) sums: checked on canonical operands, on non-canonical
    # ones with the edge values, and against one broadcast element
    # (y_rows = 1); timed on the canonical pair beside the launch floor at
    # K2's grid for that size
    for label, shape in (("AoS check", (16, 32768)), ("arena", (FULL_K,)),
                         ("verifier", (16, 192))):
        x, y = limbs(shape), limbs(shape)
        xw, yw = limbs(shape, False), limbs(shape, False)
        xw.view(-1, 8)[:6] = edge_limbs(device)
        yw.view(-1, 8)[:6] = edge_limbs(device, reverse=True)
        err = max(compare("mulmod", args) for args in
                  ((x, y), (xw, yw), (xw, limbs((), False)),
                   (xw, edge_limbs(device)[5])))
        size = x.numel() // 8
        times = field_ms("mulmod", x, y)
        floor = floor_ms(lib, stream, *k2_grid(size))
        bnd = bound("mulmod", 96 * size, size)
        if label == "AoS check":
            report(results, "mulmod", f"{shape + (8,)} x same, non-canonical "
                   "and edge operands, one broadcast element", err, times,
                   cuda_ms(lambda: fm.mulmod_plain(x, y), 3), bnd, floor)
            continue
        CARD[f"mulmod_{label}"] = {"ms": times[0], "floor_ms": floor,
                                   "bound_ms": bnd[0]}
        log(f"phase 3: mulmod at the {label}'s {shape + (8,)}, grid "
            f"{k2_grid(size)}: max_abs_err={err} kernel_ms={times[0]:.4f} "
            f"(operands in L2: {times[1]:.4f}) floor_ms={floor:.4f} "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
        require(err == 0, f"mulmod at the {label}'s shape equals its plain "
                "version")

    # K3: two flushes of B=16 over C=32768 columns; the first leaves an odd
    # element pending, the second has valid_count < B; then the same at the
    # verifier's C=192 sampled columns
    bsz = 16
    for cols in (32768, 192):
        state = sha.initial_state(cols, device)
        pending = torch.zeros((cols, 8), dtype=torch.int32, device=device)
        flushes = [(limbs((bsz, cols), False), 15),
                   (limbs((bsz, cols), False), 9)]
        k_st = p_st = (state, pending, False)
        for rows, valid in flushes:
            k_st = sha.absorb_stream(*k_st, rows, valid)
            p_st = sha.absorb_stream_plain(*p_st, rows, valid)
        torch.cuda.synchronize()
        err = max(max_abs_err(k_st[0], p_st[0]),
                  max_abs_err(k_st[1], p_st[1]))
        require(k_st[2] == p_st[2] and k_st[2] is False,
                f"K3 has_pending carry at C={cols}")
        tile = sha.tile_for(cols)
        st_out, pend_out = torch.empty_like(state), torch.empty_like(pending)
        times = launches_ms(lambda st, pe, rw, so, po: kernels.check(
            lib.ligero_sha256_absorb(
                st.data_ptr(), pe.data_ptr(), rw.data_ptr(), so.data_ptr(),
                po.data_ptr(), cols, bsz, 0, 16, 0, tile, stream),
            "sha256_absorb"),
            state, pending, flushes[0][0], st_out, pend_out)
        plain_ms = cuda_ms(lambda: sha.absorb_stream_plain(
            state, pending, False, flushes[0][0], 16), 3)
        # 16 rows read, state in and out, the pending element written
        bnd = bound("sha256_absorb", 32 * cols * (bsz + 3), cols, bsz // 2)
        if cols != 192:
            report(results, "sha256_absorb", f"B=16 C={cols} two flushes "
                   "(15 then 9 valid)", err, times, plain_ms, bnd)
            continue
        floor = floor_ms(lib, stream, -(-cols // tile), 2 * tile)
        CARD["sha256_absorb_verify"] = {
            "ms": times[0], "hot_ms": times[1], "floor_ms": floor,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
        log(f"phase 3: sha256_absorb at the verifier's (16, {cols}, 8), "
            f"two flushes (15 then 9 valid), tile {tile}: max_abs_err={err} "
            f"kernel_ms={times[0]:.4f} (operands in L2: {times[1]:.4f}) "
            f"floor_ms={floor:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
        require(err == 0, f"sha256_absorb at C={cols} equals its plain "
                "version")


def check_limb_kernels(device, gen, lib, stream, results):
    """KA (addmod/submod) and KF (the ordered fold, fused with its
    products and of given rows) at the calls of the planar path, on
    canonical, edge (all pairs of ``edge_limbs``) and non-canonical
    operands (limbs up to 2^256 - 1, sums that carry out of 2^256),
    against their plain versions on the card; timed beside the launch
    floor at their grid, fused KF also beside the K2 + fold pair it
    replaced."""
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm

    def limbs(shape, canonical=True):
        return random_limbs(gen, shape, device, canonical)

    edges = edge_limbs(device)
    xe = edges.repeat_interleave(len(edges), 0)        # every ordered pair
    ye = edges.repeat(len(edges), 1)

    def ka_ms(name, x, y):
        shape = torch.broadcast_shapes(x.shape, y.shape)
        n = math.prod(shape[:-1])
        xv, *xd = fm.aos_view(x, shape)
        yv, *yd = fm.aos_view(y, shape)
        return launches_ms(lambda xv, yv, out: kernels.check(
            lib.ligero_aos_eltwise(xv.data_ptr(), *xd, yv.data_ptr(), *yd,
                                   None, 0, out.data_ptr(), n,
                                   fm.AOS_MODE[name], stream), name),
            xv, yv, torch.empty(shape, dtype=torch.int32, device=device))

    # (label, x shape, y shape, x expanded to the result first): the
    # arena's x +- constant and constant - x (const_sub) with the constant
    # on the card and a new result (the form before the arena wrote in
    # place), the verifier's (T, 192, 8) and mask (192, 8) rows, the
    # prove's mask row (n, 8)
    calls = [("arena + constant", (FULL_K,), (), False),
             ("const_sub", (1,), (FULL_K,), True),
             ("verifier", (16, 192), (16, 192), False),
             ("verifier mask", (192,), (192,), False),
             ("mask row", (4 * FULL_K,), (4 * FULL_K,), False)]
    for name in fm.AOS_MODE:
        kernel = getattr(fm, name)
        plain = getattr(fm, name + "_plain")
        for label, xs, ys, first in calls:
            x, y = limbs(xs), limbs(ys)
            xw = limbs(xs, False)
            yw = limbs(ys, False)
            xw.view(-1, 8)[:min(6, xw.numel() // 8)] = edges[:xw.numel() // 8]
            cases = [(x, y), (xw, yw), (xe, ye), (ye, xe)]
            if first:
                shape = ys + (8,)
                cases = [(a.expand(shape), b) for a, b in cases[:2]] \
                    + cases[2:]
                x = x.expand(shape)
            err = compare_cases(kernel, plain, cases)
            shape = torch.broadcast_shapes(x.shape, y.shape)
            size = math.prod(shape[:-1])
            times = ka_ms(name, x, y)
            floor = floor_ms(lib, stream, *k2_grid(size))
            # each operand's own elements read once (a broadcast one
            # once), the result written once
            bnd = bound(name, 32 * (math.prod(xs) + math.prod(ys) + size),
                        size)
            plain_ms = cuda_ms(lambda: plain(x, y), 3)
            if (name, label) == ("submod_aos", "verifier"):
                report(results, name, f"{label} {tuple(shape)}, canonical, "
                       "non-canonical and edge pairs", err, times, plain_ms,
                       bnd, floor)
                continue
            CARD[f"{name} {label}"] = {"ms": times[0], "hot_ms": times[1],
                                       "floor_ms": floor,
                                       "bound_ms": bnd[0],
                                       "plain_ms": plain_ms}
            log(f"phase 3: {name} at the {label}'s {tuple(x.shape)} and "
                f"{tuple(y.shape)}, grid {k2_grid(size)}: max_abs_err={err} "
                f"kernel_ms={times[0]:.4f} (operands in L2: {times[1]:.4f}) "
                f"floor_ms={floor:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
            require(err == 0, f"{name} at the {label}'s shape equals its "
                    "plain version")
    check_ka_in_place(device, gen, lib, stream, results)
    check_fold(device, gen, lib, stream, results)
    check_mulsum(device, gen, lib, stream, results)


def check_ka_in_place(device, gen, lib, stream, results):
    """KA as the arena calls it: the (8192, 8) slot written in place (out
    is x, y or both) and a host constant by value (x + c, x - c, c - x,
    into x); the arena's add_const (x + c into x) times as addmod's row."""
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm
    k = FULL_K
    edges = edge_limbs(device)
    for name in fm.AOS_MODE:
        kernel = getattr(fm, name)
        plain = getattr(fm, name + "_plain")
        err = 0
        for canonical in (True, False):
            x = random_limbs(gen, (k,), device, canonical)
            y = random_limbs(gen, (k,), device, canonical)
            x[:6] = edges
            y[:6] = edge_limbs(device, reverse=True)
            for c in (random_limbs(gen, (), "cpu", canonical),
                      edge_limbs("cpu")[-1], edge_limbs("cpu")[3]):
                for args, slot in (((x, y), 0), ((x, y), 1), ((x, x), 0),
                                   ((x, c), 0), ((c, x), 1)):
                    want = plain(*(a.cpu() for a in args))
                    got = kernel(*args, out=args[slot])
                    torch.cuda.synchronize()
                    err = max(err, max_abs_err(got.cpu(), want))
        x = random_limbs(gen, (k,), device, True)
        c = random_limbs(gen, (), "cpu", True)
        times = launches_ms(lambda xs: kernels.check(
            lib.ligero_aos_eltwise(xs.data_ptr(), k, 0, 1, None, 1, 0, 0,
                                   c.data_ptr(), 2, xs.data_ptr(), k,
                                   fm.AOS_MODE[name], stream), name), x)
        floor = floor_ms(lib, stream, *k2_grid(k))
        bnd = bound(name, 32 * (2 * k + 1), k)
        xp, cd = x.clone(), c.to(device)
        plain_ms = cuda_ms(lambda: xp.copy_(plain(xp, cd)), 3)
        sign = "+" if name == "addmod_aos" else "-"
        label = (f"arena in place ({k}, 8) {sign} constant by value, into "
                 "the slot; out = x, y or both, c - x; canonical, "
                 "non-canonical and edge limbs")
        if name == "addmod_aos":
            report(results, name, label, err, times, plain_ms, bnd, floor)
            continue
        CARD[f"{name} arena in place"] = {"ms": times[0], "hot_ms": times[1],
                                          "floor_ms": floor,
                                          "bound_ms": bnd[0],
                                          "plain_ms": plain_ms}
        log(f"phase 3: {name} {label}: max_abs_err={err} kernel_ms="
            f"{times[0]:.4f} (operands in L2: {times[1]:.4f}) floor_ms="
            f"{floor:.4f} plain_ms={plain_ms:.4f} bound_ms={bnd[0]:.4f} "
            f"({bnd[1]})")
        require(err == 0, f"{name} in place equals its plain version")


def check_fold(device, gen, lib, stream, results):
    """KF's fold of given rows (no caller on the main path since fused
    KF) at the verifier's (16, 192, 8) and the AoS check's
    (16, 32768, 8); B = 0, 1 and 17 checked beside."""
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm
    edges = edge_limbs(device)
    name = fm.FOLD
    for label, rows, n in (("verifier", 16, 192),
                           ("AoS check", 16, 4 * FULL_K)):
        acc, terms = (random_limbs(gen, s, device, True)
                      for s in ((n,), (rows, n)))
        accw, termsw = (random_limbs(gen, s, device, False)
                        for s in ((n,), (rows, n)))
        accw[:6] = edges
        termsw[:, :6] = edge_limbs(device, reverse=True)
        termsw[:, -2:] = -1                 # 2^256 - 1: every add carries
        cases = [(acc, terms), (accw, termsw), (accw, termsw[:0]),
                 (accw, termsw[:1]),
                 (accw, random_limbs(gen, (17, n), device, False))]
        err = compare_cases(fm.masked_sum_aos, fm.masked_sum_aos_plain,
                            cases)
        out = torch.empty_like(acc)
        times = launches_ms(lambda a, t, o: kernels.check(
            lib.ligero_masked_sum(a.data_ptr(), t.data_ptr(), o.data_ptr(),
                                  n, rows, stream), name), acc, terms, out)
        floor = floor_ms(lib, stream, *k2_grid(n))
        bnd = bound(name, 32 * n * (rows + 2), n)
        plain_ms = cuda_ms(lambda: fm.masked_sum_aos_plain(acc, terms), 3)
        if label == "verifier":
            report(results, name, f"({rows}, {n}, 8) into ({n}, 8), B = 0, "
                   "1, 16 and 17, canonical, non-canonical and edge rows",
                   err, times, plain_ms, bnd, floor)
            continue
        CARD[f"{name} {label}"] = {"ms": times[0], "hot_ms": times[1],
                                   "floor_ms": floor, "bound_ms": bnd[0],
                                   "plain_ms": plain_ms}
        log(f"phase 3: {name} at the {label}'s ({rows}, {n}, 8), grid "
            f"{k2_grid(n)}: max_abs_err={err} "
            f"kernel_ms={times[0]:.4f} (operands in L2: {times[1]:.4f}) "
            f"floor_ms={floor:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
        require(err == 0, f"{name} at the {label}'s shape equals its plain "
                "version")


# fused KF's calls: (label, B, n, y full) -- the verifier's code and quad
# sums (a row scalar), its linear sum (full y), the AoS check's code sum
MULSUM_CALLS = (("verifier, row scalar", 16, 192, False),
                ("verifier, full y", 16, 192, True),
                ("AoS check, row scalar", 16, 4 * FULL_K, False))


def check_mulsum(device, gen, lib, stream, results):
    """Fused KF at MULSUM_CALLS on random, edge and non-canonical acc, x
    and y, B = 0, 1, 16, 17 and (at 4,224 columns, 32 a CTA) 60 rows in
    two chunks; timed beside its floor and beside the K2 + fold-only KF
    pair it replaced (K2 on y expanded to x's shape, as K2's wrapper
    expanded a row scalar), in this run."""
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm
    name = fm.MULSUM

    def operands(rows, n, full, canonical):
        acc = random_limbs(gen, (n,), device, canonical)
        x = random_limbs(gen, (rows, n), device, canonical)
        y = random_limbs(gen, (rows, n if full else 1), device, canonical)
        if not canonical:
            acc[:6] = edge_limbs(device)
            if rows:
                x[:, :6] = edge_limbs(device)
                x[:, -2:] = -1
                y[:, :min(6, y.shape[1])] = \
                    edge_limbs(device, reverse=True)[:y.shape[1]]
        return acc, x, y

    for label, rows, n, full in MULSUM_CALLS:
        cases = [operands(rows, n, full, True),
                 operands(rows, n, full, False)]
        if n == 192:
            cases += [operands(b, n, full, False) for b in (0, 1, 17)]
        else:
            cases += [operands(60, 4224, full, False)]
        err = compare_cases(fm.masked_mulsum_aos, fm.masked_mulsum_aos_plain,
                            cases)
        acc, x, y = cases[0]
        out = torch.empty_like(acc)
        times = launches_ms(lambda a, u, v, o: kernels.check(
            lib.ligero_masked_mulsum(a.data_ptr(), u.data_ptr(),
                                     v.data_ptr(), o.data_ptr(), n, rows,
                                     int(full), stream), name),
            acc, x, y, out)
        yx = y.expand(x.shape).contiguous()
        prod = torch.empty_like(x)

        def pair(a, u, v, p, o):
            kernels.check(lib.ligero_mont_mul(u.data_ptr(), v.data_ptr(),
                                              p.data_ptr(), rows * n,
                                              rows * n, 1, stream), "mulmod")
            kernels.check(lib.ligero_masked_sum(a.data_ptr(), p.data_ptr(),
                                                o.data_ptr(), n, rows,
                                                stream), fm.FOLD)
        pair_times = launches_ms(pair, acc, x, yx, prod, out)
        grid = mulsum_grid(n, rows)
        floor = floor_ms(lib, stream, *grid[:2])
        # acc, x and y read once, out written once; one mulmod a product
        bnd = bound(name, 32 * (2 * n + x.numel() // 8 + y.numel() // 8),
                    rows * n)
        plain_ms = cuda_ms(lambda: fm.masked_mulsum_aos_plain(acc, x, y), 3)
        detail = (f"({rows}, {n}, 8), y {tuple(y.shape)}, grid {grid[:2]} "
                  f"(cols, lanes, chunk {grid[2:]}); pair K2 + fold "
                  f"{pair_times[0]:.4f} ms (in L2: {pair_times[1]:.4f})")
        CARD[f"{name} {label}"] = {"ms": times[0], "hot_ms": times[1],
                                   "floor_ms": floor, "bound_ms": bnd[0],
                                   "plain_ms": plain_ms,
                                   "pair_ms": pair_times[0],
                                   "pair_hot_ms": pair_times[1],
                                   "max_abs_err": err}
        if label == MULSUM_CALLS[0][0]:
            report(results, name, f"{label} {detail}; B = 0, 1, 16, 17; "
                   "canonical, non-canonical and edge limbs", err, times,
                   plain_ms, bnd, floor)
            results[name]["pair_ms"] = pair_times[0]
            continue
        log(f"phase 3: {name} at the {label}'s {detail}: max_abs_err={err} "
            f"kernel_ms={times[0]:.4f} (operands in L2: {times[1]:.4f}) "
            f"floor_ms={floor:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
        require(err == 0, f"{name} at the {label}'s shape equals its plain "
                "version")


def check_planar_kernels(device, gen, lib, stream, results, k=FULL_K):
    """KE add, sub and mont_scalar (mont_mul, mulmod, mulmod_fma and
    quad-terms: ``check_ke_runs``) and K3 on planar rows, at the calls of
    the planar path: n = 4k, 16 rows per flush."""
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm, sha256 as sha

    n, bsz = 4 * k, 16

    def planes(shape, canonical=True):
        return random_limbs(gen, shape, device, canonical) \
            .movedim(-1, 0).contiguous()

    # KE add, sub and mont_scalar (the products: check_ke_runs),
    # timed at the call the main path makes in each mode:
    #   addmod   the tree sum's first fold: the two (8, 8, n) halves of
    #            (8, 16, n) products, read in place at limb stride 16n
    #   submod   full (8, 16, n) operands
    #   mont_scalar      (8, 16, k) rows times one scalar (the 1/k scaling)
    # and checked there, at full (8, 16, n) second operands, and on one
    # non-canonical set with the edge values
    rows, full = planes((bsz, n)), planes((bsz, n))
    s = planes(())
    main_call = {
        "addmod_planar": (rows[:, :bsz // 2], rows[:, bsz // 2:]),
        "submod_planar": (rows, full),
        "mont_mul_scalar_planar": (planes((bsz, k)), s),
    }
    xw, yw = planes((65536,), False), planes((65536,), False)
    xw[:, :6], yw[:, :6] = edge_limbs(device).T, \
        edge_limbs(device, reverse=True).T
    sw = planes((), False)
    for name, mode in fm.PLANAR_MODE.items():
        if name not in main_call:
            continue
        kernel = getattr(fm, name)
        plain = getattr(fm, name + "_plain")
        scalar = name == "mont_mul_scalar_planar"
        x, y = main_call[name]
        err = compare_cases(kernel, plain,
                            [(x, y), (rows, s if scalar else full),
                             (xw, sw if scalar else yw)])

        def ke_ms(x, y):
            """(cold, hot) ms of one launch on (x, y), the arguments it
            hands ``ligero_planar_eltwise``, the bytes it must move and
            the launch floor at its grid (KE: 256-thread blocks)."""
            args = fm.eltwise_args(name, x, y)
            xa, x_ls, ya, y_ls, y_div, size = args
            require(xa.data_ptr() == x.data_ptr(),
                    f"{name} reads its first operand in place")
            out = torch.empty((8, size), dtype=torch.int32, device=device)
            times = launches_ms(lambda xa, ya, out: kernels.check(
                lib.ligero_planar_eltwise(
                    xa.data_ptr(), x_ls, ya.data_ptr(), y_ls, y_div, None, 0,
                    out.data_ptr(), size, mode, stream), name), xa, ya, out)
            # x read, out written, each y element read once
            return times, args, 64 * size + 4 * ya.numel(), \
                floor_ms(lib, stream, -(-size // 256), 256)

        times, (_, x_ls, _, y_ls, y_div, size), nbytes, floor = ke_ms(x, y)
        report(results, name, f"{tuple(x.shape)} x {tuple(y.shape)} "
               f"(limb strides {x_ls}, {y_ls}; y_div {y_div}), full "
               f"(8,{bsz},{n}) and (8,65536) non-canonical", err, times,
               cuda_ms(lambda: plain(x, y), 3), bound(name, nbytes, size),
               floor if scalar else None)
        if scalar:
            # the check's prescale of the 16 per-row scalars, also with
            # the edge values p and 2^256 - 1 as the scalar
            small = planes((bsz,), False)
            small[:, :6] = edge_limbs(device).T
            edges = edge_limbs(device)
            err = compare_cases(kernel, plain, [(small, s), (small, sw),
                                                (small, edges[4]),
                                                (small, edges[5]),
                                                (xw, edges[5])])
            times, (*_, size), nbytes, floor = ke_ms(small, s)
            bnd = bound(name, nbytes, size)
            CARD["mont_scalar_small"] = {"ms": times[0], "floor_ms": floor,
                                         "bound_ms": bnd[0]}
            log(f"phase 3: {name} at the check's prescale (8, {bsz}): "
                f"max_abs_err={err} kernel_ms={times[0]:.4f} (operands in "
                f"L2: {times[1]:.4f}) floor_ms={floor:.4f} "
                f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
            require(err == 0, f"{name} at (8, {bsz}) equals its plain "
                    "version")

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
                   po.data_ptr(), cols, bsz, 0, bsz, 1, sha.tile_for(cols),
                   stream),
               "sha256_absorb_planar"),
               state, pending, flushes[0][0], st_out, pend_out),
           cuda_ms(lambda: sha.absorb_stream_planar_plain(
               state, pending, False, flushes[0][0], 16), 3),
           bound("sha256_absorb_planar", 32 * cols * (bsz + 3), cols,
                 bsz // 2))


def _run_log(name, label, err, times, floor, bnd, extra=""):
    regs = CARD.get("ptxas", {}).get(name, ("not built here",))[0]
    sass = CARD["sass"][name][2] / SASS_ELEMENTS.get(name, 1)
    log(f"phase 3: {name} {label}: max_abs_err={err} kernel_ms={times[0]:.4f}"
        f" (operands in L2: {times[1]:.4f}) floor_ms={floor:.4f} "
        f"bound_ms={bnd[0]:.4f} ({bnd[1]}, {100 * bnd[0] / times[0]:.0f}%) "
        f"registers={regs} sass_per_element={sass:.0f}{extra}")


def check_ke_runs(device, gen, lib, stream, results, k=FULL_K):
    """KE mont_mul and mulmod (carry-chain products, one row per CTA run,
    16-byte units) and quad-terms at the calls of the planar check step
    (n = 4k, 16 rows per flush, T = P = 16 after padding to the batch),
    and mulmod_fma on the same geometry at (8, 16, n) in its full-plane
    and per-row forms: checked against the plain versions on canonical
    operands, on non-canonical ones with the edge values, and with one
    scalar for all; timed L2-cold and L2-hot beside the launch floor at
    their grid and the bound."""
    import numpy as np
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm

    n, bsz = 4 * k, 16

    def planes(shape, canonical=True):
        return random_limbs(gen, shape, device, canonical) \
            .movedim(-1, 0).contiguous()

    def ke_ms(name, x, y, z=None):
        """(cold, hot) ms of one ligero_planar_eltwise launch on (x, y)
        and, for mulmod_fma, the addend z (x's shape, contiguous), the
        bytes it must move, the launch floor at its grid, the elements it
        computes and its grid (``run_grid``; the tiled mode:
        ``tiled_grid``)."""
        xa, x_ls, ya, y_ls, y_div, size = fm.eltwise_args(name, x, y)
        mode = fm.KE_MODE[name]
        out = torch.empty((8, size), dtype=torch.int32, device=device)

        def launch(xa, ya, out, *za):
            kernels.check(lib.ligero_planar_eltwise(
                xa.data_ptr(), x_ls, ya.data_ptr(), y_ls, y_div,
                za[0].data_ptr() if za else None, size if za else 0,
                out.data_ptr(), size, mode, stream), name)
        times = launches_ms(launch, xa, ya, out,
                            *(() if z is None else (z,)))
        row = y_div > 1
        vec = z is None and run_vec(size, x_ls, xa.data_ptr() % 16 == 0,
                                    out.data_ptr() % 16 == 0, row, y_div,
                                    y_ls, ya.data_ptr() % 16 == 0)
        grid = tiled_grid(size // y_div, y_div) if name == fm.TILED \
            else run_grid(size, y_div if row else size, vec)
        # x (and z) read, out written, each y element read once
        return times, (64 if z is None else 96) * size + 4 * ya.numel(), \
            floor_ms(lib, stream, *grid), size, grid

    # non-canonical operands with the edge values: rows, per-row scalars
    # (the edges as six of the scalars) and full planes
    xw, yw = planes((bsz, n), False), planes((bsz, n), False)
    xw[:, 0, :6] = edge_limbs(device).T
    yw[:, 0, :6] = edge_limbs(device, reverse=True).T
    sw = planes((bsz, 1), False)
    sw[:, :6, 0] = edge_limbs(device).T
    code = (planes((bsz, n)), planes((bsz, 1)))
    quad = (planes((2 * bsz, n)), planes((2 * bsz, 1)))
    full = (planes((bsz, n)), planes((bsz, n)))
    wild = [(xw, sw), (xw, yw), (xw, sw[:, 5:6])]
    calls = [("code test (8,16,n) x (8,16,1)", code),
             ("quad test (8,32,n) x (8,32,1)", quad),
             ("linear test, full plane (8,16,n) x (8,16,n)", full)]
    err = compare_cases(fm.mont_mul_planar, fm.mont_mul_planar_plain,
                        [c for _, c in calls] + wild)
    for i, (label, (x, y)) in enumerate(calls):
        times, nbytes, floor, size, _ = ke_ms("mont_mul_planar", x, y)
        bnd = bound("mont_mul_planar", nbytes, size)
        sass_name = "mont_mul_planar_full" if y.shape == x.shape \
            else "mont_mul_planar"
        _run_log(sass_name, label, err, times, floor, bnd)
        require(err == 0, f"mont_mul_planar {label} equals its plain version")
        CARD.setdefault("ke_mont_mul", {})[label] = {
            "ms": times[0], "hot_ms": times[1], "floor_ms": floor,
            "bound_ms": bnd[0], "bound_by": bnd[1]}
        if i == 0:
            report(results, "mont_mul_planar", label + "; all three calls "
                   "and (8,16,n) non-canonical", err, times,
                   cuda_ms(lambda: fm.mont_mul_planar_plain(x, y), 3), bnd,
                   floor)

    # the tiled mode (6) at the sharded encode's calls, D = 4 shards of
    # m = n/4 columns: the k-width flush's twist (8, 16, k) x one (8, 1, k)
    # row, and the 2k mask row's (8, 1, 2k) x (8, 1, 2k); also on
    # non-canonical words with the edge values (strided views, copied),
    # an odd B with w not a multiple of 4, a plane-stride view read in
    # place and w under one CTA's slice
    twist = [(planes((bsz, k)), planes((1, k))),
             (planes((1, 2 * k)), planes((1, 2 * k)))]
    err = compare_cases(fm.mont_mul_tiled_planar,
                        fm.mont_mul_tiled_planar_plain,
                        twist + [(xw[:, :, :k], yw[:, :1, :k]),
                                 (xw.reshape(8, -1)[:, :2 * k][:, None],
                                  yw.reshape(8, -1)[:, :2 * k]),
                                 (planes((3, 1030), False),
                                  planes((1030,), False)),
                                 (twist[0][0][:, 5:12], twist[0][1]),
                                 (planes((5, 12), False), planes((12,)))])
    # KE mont_scalar at the twist's call, the single-device encode's
    # scaling, timed beside it (ops/ntt.py keeps that encode on it)
    xs, sc = twist[0][0], planes(())
    sa = fm.eltwise_args("mont_mul_scalar_planar", xs, sc)
    s_out = torch.empty((8, sa[5]), dtype=torch.int32, device=device)
    scalar_ms = launches_ms(lambda xa, ya, out: kernels.check(
        lib.ligero_planar_eltwise(
            xa.data_ptr(), sa[1], ya.data_ptr(), sa[3], sa[4], None, 0,
            out.data_ptr(), sa[5], fm.KE_MODE["mont_mul_scalar_planar"],
            stream), "mont_mul_scalar_planar"), sa[0], sa[2], s_out)
    for i, (x, y) in enumerate(twist):
        label = f"{tuple(x.shape)} x {tuple(y.shape)}"
        times, nbytes, floor, size, (ctas, threads) = ke_ms(fm.TILED, x, y)
        bnd = bound(fm.TILED, nbytes, size)
        regs = CARD.get("ptxas", {}).get(fm.TILED, (0,))[0]
        warps = ctas * -(-threads // 32) / SMS
        held = resident_warps(regs, threads) if regs else "not built here"
        extra = (f"; grid {ctas} CTAs of {threads} threads, one element "
                 f"and one row a thread, {warps:.1f} warps per SM (the "
                 f"registers allow {held})")
        if i == 0:
            extra += (f"; mont_scalar at the same (8,{bsz},{k}): "
                      f"{scalar_ms[0]:.4f} (operands in L2: "
                      f"{scalar_ms[1]:.4f})")
        _run_log(fm.TILED, label, err, times, floor, bnd, extra)
        CARD.setdefault("ke_tiled", {})[label] = {
            "ms": times[0], "hot_ms": times[1], "floor_ms": floor,
            "bound_ms": bnd[0], "bound_by": bnd[1], "ctas": ctas,
            "threads": threads, "warps_per_sm": warps,
            "resident_warps": held,
            **({"mont_scalar_ms": scalar_ms[0],
                "mont_scalar_hot_ms": scalar_ms[1]} if i == 0 else {})}
        if i == 0:
            report(results, fm.TILED, label + "; the 2k mask row's call "
                   "and non-canonical words", err, times,
                   cuda_ms(lambda: fm.mont_mul_tiled_planar_plain(x, y), 3),
                   bnd, floor)
    require(err == 0, "the tiled mode equals its plain version")

    # mode 3, no caller on the main path since quad-terms: full planes
    x, y = full
    err = compare_cases(fm.mulmod_planar, fm.mulmod_planar_plain,
                        [full, code] + wild)
    times, nbytes, floor, size, _ = ke_ms("mulmod_planar", x, y)
    bnd = bound("mulmod_planar", nbytes, size)
    _run_log("mulmod_planar", "(8,16,n) x same", err, times, floor, bnd)
    report(results, "mulmod_planar", "(8,16,n) x same, per-row scalars, "
           "non-canonical", err, times,
           cuda_ms(lambda: fm.mulmod_planar_plain(x, y), 3), bnd, floor)

    # mulmod_fma (mode 5, no caller on any path of either package): z +
    # x*y with y a full plane and a per-row scalar, on canonical operands
    # and on non-canonical ones with the edge values (z too)
    x, y = full
    acc = planes((bsz, n))
    zw = planes((bsz, n), False)
    zw[:, 0, :6] = edge_limbs(device, reverse=True).T
    err = compare_cases(fm.mulmod_fma_planar, fm.mulmod_fma_planar_plain,
                        [(acc, x, y), (acc, *code), (zw, xw, yw),
                         (zw, xw, sw), (zw, xw, sw[:, 5:6])])
    for label, (x, y), sass_name in (
            ("(8,16,n) + (8,16,n) x same", full, fm.FMA),
            ("(8,16,n) + (8,16,n) x (8,16,1)", code, fm.FMA + "_row")):
        times, nbytes, floor, size, _ = ke_ms(fm.FMA, x, y, acc)
        bnd = bound(fm.FMA, nbytes, size)
        _run_log(sass_name, label, err, times, floor, bnd)
        CARD.setdefault("ke_fma", {})[label] = {
            "ms": times[0], "hot_ms": times[1], "floor_ms": floor,
            "bound_ms": bnd[0], "bound_by": bnd[1]}
        if sass_name == fm.FMA:
            report(results, fm.FMA, label + ", per-row scalars, "
                   "non-canonical", err, times,
                   cuda_ms(lambda: fm.mulmod_fma_planar_plain(acc, x, y), 3),
                   bnd, floor)
    require(err == 0, "mulmod_fma equals its plain version")

    # quad-terms at the check's call: e (8, 16, n), 16 triples and 16
    # pairs of random row indices (repeats among them), then the same
    # indices, x = y = z, and zero-padded entries on non-canonical rows
    e = planes((bsz, n))
    ew = xw.clone()
    ew[:, 1, :6] = edge_limbs(device, reverse=True).T
    tri = gen.integers(0, bsz, (bsz, 3)).astype(np.int32)
    pair = gen.integers(0, bsz, (bsz, 2)).astype(np.int32)
    same = np.repeat(np.arange(bsz, dtype=np.int32)[:, None], 3, 1)
    padded = (np.zeros((bsz, 3), np.int32), np.zeros((bsz, 2), np.int32))
    padded[0][:2], padded[1][:1] = tri[:2], pair[:1]
    err = compare_cases(fm.quad_terms_planar, fm.quad_terms_planar_plain,
                        [(e, tri, pair), (ew, tri, pair),
                         (ew, same, same[:, :2]), (ew, *padded)])
    idx = torch.from_numpy(np.concatenate([tri.ravel(), pair.ravel()])) \
        .to(device)
    t_, p_ = len(tri), len(pair)
    out = torch.empty((8, t_ + p_, n), dtype=torch.int32, device=device)
    times = launches_ms(lambda e, idx, out: kernels.check(
        lib.ligero_planar_quad_terms(
            e.data_ptr(), bsz * n, bsz, n, idx.data_ptr(), t_,
            idx.data_ptr() + 12 * t_, p_, out.data_ptr(), stream),
        fm.QUAD), e, idx, out)
    floor = floor_ms(lib, stream, *run_grid((t_ + p_) * n, n, True))
    # each distinct row of e read once, the indices once, out written
    distinct = len(set(tri.ravel()) | set(pair.ravel()))
    bnd = bound(fm.QUAD, 32 * n * (distinct + t_ + p_) + 4 * idx.numel(),
                t_ * n)
    # the sequence it replaces: five index_selects, mulmod, two submods
    # and a cat (9 launches)
    tri_d, pair_d = (torch.from_numpy(a.astype(np.int64)).to(device)
                     for a in (tri, pair))

    def sequence(e, tri_d, pair_d):
        ex, ey, ez = (e.index_select(1, tri_d[:, i]) for i in range(3))
        px, py = (e.index_select(1, pair_d[:, i]) for i in range(2))
        t = fm.submod_planar(fm.mulmod_planar(ex, ey), ez)
        return torch.cat([t, fm.submod_planar(px, py)], dim=1)

    want = sequence(e, tri_d, pair_d)
    got = fm.quad_terms_planar(e, tri, pair)
    torch.cuda.synchronize()
    err = max(err, max_abs_err(got, want))
    seq = launches_ms(sequence, e, tri_d, pair_d, iters=20)
    CARD["quad_terms"] = {"ms": times[0], "hot_ms": times[1],
                          "floor_ms": floor, "bound_ms": bnd[0],
                          "sequence_ms": seq[0], "sequence_hot_ms": seq[1]}
    _run_log(fm.QUAD, f"e (8,{bsz},{n}), T={t_} P={p_} ({distinct} "
             "distinct rows)", err, times, floor, bnd,
             f"; the 9-launch sequence it replaces: {seq[0]:.4f} (operands "
             f"in L2: {seq[1]:.4f}) ms, equal: {torch.equal(got, want)}")
    report(results, fm.QUAD, f"e (8,{bsz},{n}) T={t_} P={p_}, repeated, "
           "equal and padded indices, non-canonical rows", err, times,
           cuda_ms(lambda: fm.quad_terms_planar_plain(e, tri, pair), 3),
           bnd, floor)


# KQ's calls: (label, rows of e, columns) -- the single-device check step
# and one of phase 8's 4 shards, T = P = 16 (batch_rows 16)
QUAD_ACC_CALLS = (("single device", 16, 4 * FULL_K),
                  ("one of 4 shards", 16, FULL_K))


def quad_acc_sequence(lib, quad, e, idx, t_, p_, tri_r, pair_r):
    """The planar check's quadratic test before KQ, its 13 device ops as
    ``zkp/executor.py`` made them: quad-terms, the scalars' cat, transpose
    and prescale, the row-scalar product, the tree sum's five addmod folds
    (T + P = 32), and the transposes and the addmod around the (n, 8)
    accumulator.  The row indices (idx: T (x, y, z) then P (x, y), int32)
    and the scalars tri_r and pair_r are on the card already: the uploads
    are left out, as they are of KQ's time (the check uploaded the
    indices once and each scalar set once; KQ uploads indices and scalars
    in one)."""
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm
    from ligero_prover_tpu_torch.zkp.executor import _r2, \
        _tree_sum_mod_planar
    b, n = e.shape[1:]
    terms = torch.empty((8, t_ + p_, n), dtype=torch.int32, device=e.device)
    kernels.check(lib.ligero_planar_quad_terms(
        e.data_ptr(), b * n, b, n, idx.data_ptr(), t_,
        idx.data_ptr() + 12 * t_, p_, terms.data_ptr(),
        kernels.stream_handle(e.device)), fm.QUAD)
    scals = fm.mont_mul_scalar_planar(
        torch.cat([tri_r, pair_r]).T.contiguous(), _r2(e.device))
    prods = fm.mont_mul_planar(terms, scals[:, :, None])
    return fm.addmod_planar(quad.T.contiguous(),
                            _tree_sum_mod_planar(prods)).T.contiguous()


def check_quad_acc(device, gen, lib, stream, results):
    """KQ at QUAD_ACC_CALLS against its plain version (max_abs_err 0):
    random rows and indices with repeats; non-canonical rows, scalars and
    acc with the edge values; x = y = z; entries zero-padded as
    ``_pack_quads`` pads them (index 0, scalar 0); batch_rows 3 (T = P =
    3, a head at the tree's second level) and T = 3, P = 2.  Timed
    L2-cold and hot beside the launch floor at its grid, its bound and
    the 13-op sequence it replaced (``quad_acc_sequence``, one callable,
    its operands on the card, replayed as a CUDA graph: ``graph_ms``),
    which must give the same limbs."""
    import numpy as np
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm
    name = fm.QACC

    def operands(b, n, t_, p_, canonical=True, index="random"):
        acc = random_limbs(gen, (n,), device, canonical)
        e = random_limbs(gen, (b, n), device, canonical).movedim(-1, 0) \
            .contiguous()
        tri = gen.integers(0, b, (t_, 3)).astype(np.int32)
        pair = gen.integers(0, b, (p_, 2)).astype(np.int32)
        tri_r, pair_r = (random_limbs(gen, (k,), "cpu", canonical).numpy()
                         .view(np.uint32) for k in (t_, p_))
        if not canonical:
            acc[:6] = edge_limbs(device)
            e[:, 0, :6] = edge_limbs(device).T
            e[:, 1, :6] = edge_limbs(device, reverse=True).T
            e[:, 0, -2:] = -1
            k = min(6, t_)
            tri_r[:k] = edge_limbs("cpu").numpy().view(np.uint32)[:k]
        if index == "same":
            tri[:] = np.arange(t_)[:, None] % b
            pair[:] = np.arange(p_)[:, None] % b
        elif index == "padded":
            tri[2:], pair[1:], tri_r[2:], pair_r[1:] = 0, 0, 0, 0
        return acc, e, tri, pair, tri_r, pair_r

    rows = {}
    for label, bsz, n in QUAD_ACC_CALLS:
        t_ = p_ = bsz
        cases = [operands(bsz, n, t_, p_),
                 operands(bsz, n, t_, p_, False),
                 operands(bsz, n, t_, p_, False, "same"),
                 operands(bsz, n, t_, p_, False, "padded"),
                 operands(3, n, 3, 3, False),
                 operands(bsz, n, 3, 2, False)]
        err = compare_cases(fm.quad_acc_planar, fm.quad_acc_planar_plain,
                            cases)
        acc, e, tri, pair, tri_r, pair_r = cases[0]
        args, _, _ = fm.quad_acc_args(acc, e, tri, pair, tri_r, pair_r)
        dev_args = torch.from_numpy(args).to(device)
        out = torch.empty_like(acc)
        times = launches_ms(lambda e, a, acc, out: kernels.check(
            lib.ligero_planar_quad_acc(
                e.data_ptr(), bsz * n, bsz, n, a.data_ptr(), t_, p_,
                acc.data_ptr(), out.data_ptr(), stream), name),
            e, dev_args, acc, out)
        tr_d, pr_d = (torch.from_numpy(a.view(np.int32)).to(device)
                      for a in (tri_r, pair_r))
        want = quad_acc_sequence(lib, acc, e, dev_args, t_, p_, tr_d, pr_d)
        got = fm.quad_acc_planar(acc, e, tri, pair, tri_r, pair_r)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        require(same, f"{name} {label} equals the sequence it replaced")
        seq = graph_ms(lambda acc, e, a, tr, pr: quad_acc_sequence(
            lib, acc, e, a, t_, p_, tr, pr), acc, e, dev_args, tr_d, pr_d)
        ctas, threads, cols, lanes, smem = quad_acc_grid(n, t_, p_)
        floor = floor_ms(lib, stream, ctas, threads)
        # each distinct row of e read once, acc read and out written once,
        # the packed indices and scalars read once; a Montgomery product
        # per prescale, three per triple and one per pair
        distinct = len(set(tri.ravel()) | set(pair.ravel()))
        bnd = bound(name, 32 * n * (distinct + 2) + 4 * args.size,
                    n * (3 * t_ + p_) + t_ + p_)
        plain_ms = cuda_ms(lambda: fm.quad_acc_planar_plain(
            acc, e, tri, pair, tri_r, pair_r), 3)
        regs, st, ld = CARD.get("ptxas", {}).get(name, ("not built here",
                                                        0, 0))
        wide, _, sass = CARD["sass"][name]
        rows[label] = {"ms": times[0], "hot_ms": times[1], "floor_ms": floor,
                       "bound_ms": bnd[0], "bound_by": bnd[1],
                       "sequence_ms": seq[0], "sequence_hot_ms": seq[1],
                       "plain_ms": plain_ms, "max_abs_err": err,
                       "ctas": ctas, "cols": cols, "lanes": lanes,
                       "smem": smem}
        log(f"phase 3: {name} {label}: e (8,{bsz},{n}), T={t_} P={p_} "
            f"({distinct} distinct rows); also non-canonical, x = y = z, "
            f"padded, batch_rows 3 and T=3 P=2: max_abs_err={err} "
            f"kernel_ms={times[0]:.4f} (operands in L2: {times[1]:.4f}) "
            f"floor_ms={floor:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]}, "
            f"{100 * bnd[0] / times[0]:.0f}%); the 13-op sequence it "
            f"replaced {seq[0]:.4f} (in L2: {seq[1]:.4f}) ms, "
            f"equal: {same}; plain_ms={plain_ms:.4f}; grid {ctas} CTAs of "
            f"{cols} columns x {lanes} lanes, {smem} shared bytes; "
            f"registers={regs} spills={st}/{ld} SASS={sass} "
            f"(IMAD.WIDE {wide})")
        require(err == 0, f"{name} {label} equals its plain version")
    CARD["quad_acc"] = rows
    first = rows[QUAD_ACC_CALLS[0][0]]
    results[name] = {k: first[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "floor_ms", "sequence_ms")}
    results[name]["at_shard"] = {k: rows[QUAD_ACC_CALLS[1][0]][k] for k in
                                 ("ms", "floor_ms", "bound_ms",
                                  "sequence_ms")}


def check_butterfly_passes(device, gen, lib, stream, results, k=FULL_K):
    """KB at every butterfly transform of the planar path at k (n = 4k):
    each transform as its planned passes (``ops.ntt.pass_plan``) against
    the plain passes, on canonical rows with the real twiddles and on
    non-canonical rows with the edge values and a non-canonical table, and
    against the one-stage-per-launch composition (``max_pass=1``); timed
    per transform beside the one-stage composition and the bound.  Then a
    16-row k -> n encode and a decode through passes against the one-stage
    path, limb for limb, with their launches and times."""
    import torch
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm, ntt

    n, bsz = 4 * k, 16
    codec = ntt.RSCodec(k, n, device)
    kdom, k2dom, ndom = codec.dom_k, codec.dom_2k, codec.dom_n
    # (label, dit, rows, table, first stage, input width); the k-width
    # encode runs at B = 16 (commit, check, open, the verifier's rands)
    # and at B = 1 (the mask's code row)
    transforms = [
        ("k-width encode DIF", False, bsz, kdom["cg_inv_pl"], 0, k),
        ("k-width encode DIT", True, bsz, ndom["cg_fwd_pl"], 2, k),
        ("mask code row DIF", False, 1, kdom["cg_inv_pl"], 0, k),
        ("mask code row DIT", True, 1, ndom["cg_fwd_pl"], 2, k),
        ("2k mask row DIF", False, 1, k2dom["cg_inv_pl"], 0, 2 * k),
        ("2k mask row DIT", True, 1, ndom["cg_fwd_pl"], 1, 2 * k),
        ("decode DIF", False, 1, ndom["cg_inv_pl"], 0, n),
        ("decode DIT", True, 1, kdom["cg_fwd_pl"], 0, k),
    ]

    def planes(shape, canonical=True):
        return random_limbs(gen, shape, device, canonical) \
            .movedim(-1, 0).contiguous()

    def plan_of(tws, first, max_pass):
        log2n = tws.shape[0]
        return ntt.pass_plan(log2n, first, log2n - first, max_pass)

    def through(dit, x, tws, first, max_pass):
        """The transform by the wrappers (kernels)."""
        if dit:
            return ntt._cg_dit_scan_planar(x, tws, first, max_pass)
        return ntt._cg_dif_scan_planar(x, tws, max_pass)

    def plain(dit, x, tws, first):
        """The transform by the plain passes of the planned split."""
        plan = plan_of(tws, first, ntt.LARGEST_PASS)
        for t0, s in (plan if dit else reversed(plan)):
            x = (fm.butterfly_dit_pass_plain if dit else
                 fm.butterfly_dif_pass_plain)(x, tws, t0, s)
        return x

    def launcher(dit, tws, first, max_pass, rows, width):
        """All passes of one transform through the C entry point, on
        (x, tws, buffer, buffer)."""
        plan = plan_of(tws, first, max_pass)
        if not dit:
            plan = plan[::-1]
        log2n = tws.shape[0]
        name = "butterfly_dit" if dit else "butterfly_dif"

        def launch(x, tw, b0, b1):
            src, w = x, width
            for i, (t0, s) in enumerate(plan):
                dst = (b0, b1)[i % 2]
                kernels.check(lib.ligero_planar_pass(
                    src.data_ptr(), tw[t0].data_ptr(), dst.data_ptr(), rows,
                    log2n, w, s, int(dit), stream), name)
                src, w = dst, 1 << log2n
        return launch

    for label, dit, rows, tws, first, width in transforms:
        name = "butterfly_dit" if dit else "butterfly_dif"
        x = planes((rows, width))
        xw = planes((rows, width), False)
        xw[:, 0, :6] = edge_limbs(device).T
        tww = planes((tws.shape[0], tws.shape[2]), False).transpose(0, 1) \
            .contiguous()
        tww[0, :, :6] = edge_limbs(device, reverse=True).T
        err = one_err = 0
        for xs, tw in ((x, tws), (xw, tww)):
            got = through(dit, xs, tw, first, ntt.LARGEST_PASS)
            one = through(dit, xs, tw, first, 1)
            want = plain(dit, xs, tw, first)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, want))
            one_err = max(one_err, max_abs_err(got, one))
        log2n = tws.shape[0]
        npass = len(plan_of(tws, first, ntt.LARGEST_PASS))
        stages = log2n - first
        out_n = 1 << log2n
        bufs = (x, tws, torch.empty((8, rows, out_n), dtype=torch.int32,
                                    device=device),
                torch.empty((8, rows, out_n), dtype=torch.int32,
                            device=device))
        times = launches_ms(launcher(dit, tws, first, ntt.LARGEST_PASS, rows,
                                     width), *bufs, iters=20)
        one_times = launches_ms(launcher(dit, tws, first, 1, rows, width),
                                *bufs, iters=20)
        # input read once, output written once, each stage's twiddle plane
        # read once; one butterfly per output pair per stage
        bnd = bound(name, 32 * rows * (width + out_n)
                    + 32 * (out_n // 2) * stages, rows * out_n // 2, stages)
        CARD.setdefault("kb", {})[label] = {
            "rows": rows, "passes": npass, "stages": stages, "ms": times[0],
            "hot_ms": times[1], "one_stage_ms": one_times[0],
            "one_stage_hot_ms": one_times[1], "bound_ms": bnd[0],
            "bound_by": bnd[1]}
        log(f"phase 3: KB {label} (8,{rows},{width}) -> (8,{rows},{out_n}), "
            f"{stages} stages in {npass} passes: max_abs_err={err} against "
            f"the plain passes, {one_err} against the one-stage path; per "
            f"transform kernel_ms={times[0]:.4f} (operands in L2: "
            f"{times[1]:.4f}) one_stage_ms={one_times[0]:.4f} (in L2: "
            f"{one_times[1]:.4f}) bound_ms={bnd[0]:.4f} ({bnd[1]})")
        require(err == 0 and one_err == 0,
                f"KB {label} equals its plain passes and the one-stage path")
        if label.startswith("k-width encode") and rows == bsz:
            report(results, name, f"{label}, (8,{rows},{width}) -> "
                   f"(8,{rows},{out_n}), {npass} passes, canonical and "
                   "non-canonical", err, times,
                   cuda_ms(lambda: plain(dit, x, tws, first), 3), bnd)

    # one 16-row k -> n encode and one decode, passes against one stage
    rows = random_limbs(gen, (bsz, k), device, True)
    rows[0, :6] = edge_limbs(device)
    cws = random_limbs(gen, (1, n), device, False)
    cws[0, :6] = edge_limbs(device)
    before = dict(fm.LAUNCHES)
    enc = ntt.encode_rows_cg_planar_core(rows, kdom, ndom, n)
    launched = {key: v - before[key] for key, v in fm.LAUNCHES.items()
                if v != before[key]}
    enc1 = ntt.encode_rows_cg_planar_core(rows, kdom, ndom, n, 1)
    dec = ntt.decode_rows_cg_planar(cws, kdom, ndom, k)
    dec1 = ntt.decode_rows_cg_planar(cws, kdom, ndom, k, 1)
    torch.cuda.synchronize()
    same = torch.equal(enc, enc1) and torch.equal(dec, dec1)
    CARD["encode_launches"] = launched

    def host_and_events(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        host, dev = [], []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            dev.append(start.elapsed_time(end))
        return statistics.median(host), statistics.median(dev)

    enc_t = host_and_events(lambda: ntt.encode_rows_cg_planar_core(
        rows, kdom, ndom, n))
    enc1_t = host_and_events(lambda: ntt.encode_rows_cg_planar_core(
        rows, kdom, ndom, n, 1))
    CARD["encode16"] = {"host_ms": enc_t[0], "event_ms": enc_t[1],
                        "one_stage_host_ms": enc1_t[0],
                        "one_stage_event_ms": enc1_t[1]}
    log(f"phase 3: 16-row k={k} encode and a decode through passes == the "
        f"one-stage path limb for limb: {same}; encode launches {launched} "
        f"({sum(launched.values())} in all); encode host/events "
        f"{enc_t[0]:.4f}/{enc_t[1]:.4f} ms, one-stage path "
        f"{enc1_t[0]:.4f}/{enc1_t[1]:.4f} ms")
    require(same, "encode and decode through passes equal the one-stage "
            "path")
    require(sum(launched.values()) <= 7,
            f"a k-width encode makes at most 7 launches: {launched}")


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
        read at the shifts `tw_args` = (tw_lbc, tw_lc), on (slots, tw,
        out)."""
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
        tw_args = (0, 0) if tw is None else mr.twiddle_shifts(
            name, slots[0].numel(), *mr.twiddle_index(
                name, slots.shape[1:], tw.shape[1:]))
        out = torch.empty((8,) + slots.shape[1:], dtype=torch.int32,
                          device=device)
        times = launches_ms(renorm_launch(name, tw_args), slots, *extra, out)
        plain_ms = cuda_ms(lambda: plain(slots, *extra), 3)
        return err, times, plain_ms, bound(name, nbytes, slots[0].numel())

    # digitize at the engine's call: the (16, k, 8) AoS rows read in place
    # as (8, 16, k) planes; also on a planar copy of them, and on
    # non-canonical words (2^256 - 1, every byte 0x7F, 0x80 or 0x81) in
    # both layouts
    rows = random_limbs(gen, (bsz, k), device, True)
    rows[0, :4] = edge_limbs(device)[:4]                   # 0, 1, p-1, R
    view = rows.movedim(-1, 0)
    require(mr.digitize_args(view)[0] is view,
            "digitize reads the engine's AoS rows in place")
    x = view.contiguous()                                  # (8, 16, k)
    wild = random_limbs(gen, (bsz, k), device, False)
    wild[0, :4] = digit_edges(device)
    err = compare_cases(mr.digitize, mr.digitize_plain,
                        [(view,), (x,), (wild.movedim(-1, 0),),
                         (wild.movedim(-1, 0).contiguous(),)])
    size = bsz * k
    bnd = bound("digitize", 64 * size, size)
    for name, label, operand, strides in (
            ("digitize_planar", f"(8,{bsz},{k}) planar", x, (size, 1)),
            ("digitize", f"(16,{k},8) AoS rows viewed as (8,{bsz},{k})",
             rows, (1, 8))):
        times = launches_ms(lambda a, out, st=strides: kernels.check(
            lib.ligero_digitize(a.data_ptr(), *st, out.data_ptr(), size,
                                stream), "digitize"),
            operand, torch.empty_like(x))
        floor = floor_ms(lib, stream, -(-size // DIGIT_THREADS),
                         DIGIT_THREADS)
        _run_log(name, label + ", canonical and non-canonical", err, times,
                 floor, bnd)
        CARD[name] = {"ms": times[0], "hot_ms": times[1], "floor_ms": floor,
                      "bound_ms": bnd[0]}
    report(results, "digitize", f"(16,{k},8) AoS rows viewed as planes, "
           "planar copy, non-canonical words", err, times,
           cuda_ms(lambda: mr.digitize_plain(view), 3), bnd, floor)

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
    check_limb_kernels(device, gen, lib, stream, results)
    check_butterfly_passes(device, gen, lib, stream, results)
    check_planar_kernels(device, gen, lib, stream, results)
    check_ke_runs(device, gen, lib, stream, results)
    check_quad_acc(device, gen, lib, stream, results)
    check_mxu_kernels(device, gen, lib, stream, results)
    return results


# ---- phases 4 to 6 -------------------------------------------------------

def wat_program(src, args=()):
    from ligero_prover_tpu_torch.vm.run import make_wat_program
    return make_wat_program(src, list(args), set())


@contextlib.contextmanager
def configuration(mxu=False):
    """Select the butterfly or the int8 encode engine (``ops.ntt.USE_MXU``)
    for the executors made inside the block."""
    from ligero_prover_tpu_torch.ops import ntt
    ntt.USE_MXU = mxu
    try:
        yield
    finally:
        ntt.USE_MXU = None


def check_small_proofs(device) -> dict:
    """CUDA == CUDA with the int8 engine == CPU proof bytes at k=256, for
    the vbn254fr guest (batch rows only), for a guest with witness rows
    (linear and quadratic callback rows: the check's linear branch and a
    second encode per flush) and for the vbn254fr bit decomposition, whose
    vector division runs the invmod ladder through K1.  Returns each
    program's proof."""
    from ligero_prover_tpu_torch.ops import fieldmul as fm
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.verifier import verify
    from ligero_prover_tpu_torch.zkp.executor import TorchExecutor
    geo = RowGeometry(SMALL_K)
    programs = {"make_wat(4)": wat_program(make_wat(4)),
                "ecdsa_p256": wat_program(str(ECDSA[0]), ECDSA[1]),
                "bit_decompose": wat_program(str(BIT_DECOMPOSE))}
    os.environ["LIGERO_PROOF_TIMESTAMP"] = "1700000000"
    out = {}
    try:
        for name, prog in programs.items():
            proofs = {}
            for label, dev, mxu in (("cuda planar", device, False),
                                    ("cuda planar+mxu", device, True),
                                    ("cpu", "cpu", False)):
                with configuration(mxu):
                    ex = TorchExecutor(geo.k, geo.n, 8, dev)
                require(ex.use_mxu is mxu, f"{label} executor")
                k1 = fm.LAUNCHES["mont_mul"]
                res = prove(prog, geometry=geo, executor=ex,
                            encoding_seed=bytes(range(32)))
                require(res.ok, f"k={SMALL_K} {name} self-check, {label}")
                proofs[label] = (res.proof, ex)
                if label == "cuda planar":
                    k1 = fm.LAUNCHES["mont_mul"] - k1
                    log(f"phase 4: k={SMALL_K} {name} on the planar path: "
                        f"{k1} mont_mul (K1) launches")
                    require(name != "bit_decompose" or k1 >= 383,
                            "bit_decompose's division runs the invmod "
                            "ladder through K1")
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
            out[name] = proofs["cpu"][0]
    finally:
        del os.environ["LIGERO_PROOF_TIMESTAMP"]
    return out


def tamper(proof: bytes) -> bytes:
    from ligero_prover_tpu_torch.proto import ligero_proof_pb2 as pb
    env = pb.LigeroProofEnvelope()
    env.ParseFromString(gzip.decompress(proof))
    env.ligero_proof.sampled_data.values[5] ^= 1
    return gzip.compress(env.SerializeToString())


def plain_on_cuda() -> dict:
    """How often each wrapper ran its plain version on CUDA tensors since
    the counts were last reset."""
    from ligero_prover_tpu_torch.ops import fieldmul as fm, sha256 as sha, \
        mxu_renorm as mr
    return {name: calls["cuda"] for name, calls in
            {**fm.PLAIN_CALLS, **sha.PLAIN_CALLS, **mr.PLAIN_CALLS}.items()}


# KA and fused KF: the arena's and the mask step's adds, the verifier's
# submods and sums
LIMB_KERNELS = ("addmod_aos", "submod_aos", "masked_mulsum_aos")
PLANAR_KERNELS = ("butterfly_dit", "butterfly_dif", "addmod_planar",
                  "mont_mul_planar", "quad_acc_planar",
                  "mont_mul_scalar_planar", "sha256_absorb_planar",
                  *LIMB_KERNELS)
MXU_KERNELS = ("digitize", "renorm_mid", "renorm_final")


def device_time_us(evt) -> float:
    """Device time of one ``key_averages()`` row, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_kernels(fn) -> tuple[int, float, int]:
    """(device ops, device seconds, memcpys among the ops) of one call of
    `fn` under ``torch.profiler``, synchronised at its end: every device
    row of ``key_averages()``, kernels and copies (``Memcpy ...``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.count for e in dev), \
        sum(device_time_us(e) for e in dev) / 1e6, \
        sum(e.count for e in dev if e.key.startswith("Memcpy"))


def prove_full(device, phase: str, rounds: int, mxu: bool = False,
               profile: bool = False) -> tuple[dict, bytes]:
    """Prove and verify make_wat(rounds) at k=8192 with the butterfly or
    the int8 encode engine, counting every kernel's launches from zero
    (the prove's and the verify's apart), and check that a tampered proof
    is rejected; with
    `profile`, one more prove and verify each under ``torch.profiler``
    count their device kernels.  Returns the launch counts (prove and
    verify) and the proof."""
    import torch
    from ligero_prover_tpu_torch.ops import fieldmul as fm, sha256 as sha, \
        mxu_renorm as mr
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.verifier import verify
    from ligero_prover_tpu_torch.utils import timer as T

    geo = RowGeometry(FULL_K)
    prog = wat_program(make_wat(rounds))
    label = "planar" + ("+mxu" if mxu else "")
    with configuration(mxu):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # what earlier phases left allocated; the prove's own peak is
        # counted above it
        before = torch.cuda.memory_allocated()
        T.clear_timers()
        for module in (fm, sha, mr):
            module.reset_counts()
        t0 = time.perf_counter()
        res = prove(prog, geometry=geo, encoding_seed=bytes(32),
                    device=device)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        prove_peak = torch.cuda.max_memory_allocated() - before
        proved = {**fm.LAUNCHES, **sha.LAUNCHES, **mr.LAUNCHES}
        t0 = time.perf_counter()
        vres = verify(prog, res.proof, geometry=geo, device=device)
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t0
        launches = {**fm.LAUNCHES, **sha.LAUNCHES, **mr.LAUNCHES}
        plain = plain_on_cuda()
        peak = torch.cuda.max_memory_allocated()
        stages = {s: round(T.get_timer(s), 3)
                  for s in ("stage1", "stage2", "stage3")}
        verified = {k: v - proved[k] for k, v in launches.items()
                    if v != proved[k]}
        log(f"{phase}: {label} k={FULL_K} n={geo.n} make_wat({rounds}): "
            f"rows={res.num_rows} prove_s={prove_s:.3f} "
            f"rows_per_s={res.num_rows / prove_s:.1f} stages_s={stages} "
            f"verify_s={verify_s:.3f} proof_bytes={len(res.proof)} "
            f"max_memory_allocated={peak} prove_peak_above_before="
            f"{prove_peak} (allocated before: {before}) launches={launches} "
            f"launches_per_row={sum(launches.values()) / res.num_rows:.2f} "
            f"plain_calls_on_cuda={plain}")
        log(f"{phase}: {label} launches of the prove "
            f"{ {k: v for k, v in proved.items() if v} } "
            f"({sum(proved.values()) / res.num_rows:.2f} per row), of the "
            f"verify {verified} "
            f"({sum(verified.values()) / res.num_rows:.2f} per row)")
        log(f"{phase}: {label} verify: K2 (mulmod) {verified.get('mulmod', 0)}"
            f" launches, fused KF {verified.get(fm.MULSUM, 0)}, fold-only "
            f"KF {verified.get(fm.FOLD, 0)}")
        require(res.ok, f"{label} prove self-check")
        require(vres.ok, f"port verifier accepts the {label} proof")
        path = PLANAR_KERNELS + (MXU_KERNELS if mxu else ())
        require(all(launches[k] > 0 for k in path),
                f"every kernel of the {label} path launched: {launches}")
        require(all(v == 0 for v in plain.values()),
                f"no plain version ran on CUDA tensors: {plain}")
        require(launches[fm.QUAD] == 0,
                f"the check takes KQ, not quad-terms: {launches}")
        bad = verify(prog, tamper(res.proof), geometry=geo, device=device)
        log(f"{phase}: one-bit tamper of sampled_data rejected: "
            f"{not bad.ok}")
        require(not bad.ok, "tampered proof rejected")
        if profile:
            rows = res.num_rows
            kp, tp, mp = device_kernels(lambda: prove(
                prog, geometry=geo, encoding_seed=bytes(32), device=device))
            kv, tv, mv = device_kernels(lambda: verify(
                prog, res.proof, geometry=geo, device=device))
            CARD["device_kernels"] = {
                "rows": rows, "prove": kp, "prove_per_row": kp / rows,
                "prove_memcpys": mp, "prove_device_s": tp, "verify": kv,
                "verify_per_row": kv / rows, "verify_memcpys": mv,
                "verify_device_s": tv}
            log(f"{phase}: {label} torch.profiler: prove {kp} device "
                f"ops ({kp / rows:.3f} per row; {mp} memcpys, "
                f"{mp / rows:.3f} per row; {tp:.4f} s device time), verify "
                f"{kv} ({kv / rows:.3f} per row; {mv} memcpys, "
                f"{mv / rows:.3f} per row; {tv:.4f} s device time)")
    return launches, res.proof


def prove_mxu(device, butterfly: dict, butterfly_proof: bytes) -> dict:
    """The planar path with the int8 encode engine at full depth: the same
    proof as the butterfly path's, byte for byte, with every k-width
    encode moved from the KB stages to the engine (mask rows, decode and
    the verifier keep the butterflies)."""
    from ligero_prover_tpu_torch.ops import mxu_ntt as mx
    from ligero_prover_tpu_torch.ops.ntt import LARGEST_PASS, RSCodec, \
        pass_plan
    launches, proof = prove_full(device, "phase 7", FULL_ROUNDS, True)
    # KB launches of one k-width butterfly encode: the passes of log2(k)
    # DIF stages, and of log2(n) DIT stages less the two the
    # zero-extension skips
    log2k = FULL_K.bit_length() - 1
    per_encode = {"butterfly_dif": len(pass_plan(log2k, 0, log2k,
                                                 LARGEST_PASS)),
                  "butterfly_dit": len(pass_plan(log2k + 2, 2, log2k,
                                                 LARGEST_PASS))}
    tabs = RSCodec(FULL_K, 4 * FULL_K, device).mxu_tabs
    encodes = launches["digitize"]
    log(f"phase 7: int8 engine: {encodes} k-width encodes; tables built in "
        f"{CARD['mxu_table_s']:.2f}s (phase 3), tables and slot buffer "
        f"{mx.table_bytes(tabs)} device bytes; butterfly launches "
        f"{launches['butterfly_dit']} + {launches['butterfly_dif']} against "
        f"{butterfly['butterfly_dit']} + {butterfly['butterfly_dif']} "
        f"({per_encode} passes per encode); proof bytes equal the "
        f"butterfly path's: {proof == butterfly_proof}")
    require(launches["renorm_mid"] == 2 * encodes
            and launches["renorm_final"] == encodes,
            "one digitize, two renorm_mid and one renorm_final per encode")
    for stage in ("butterfly_dit", "butterfly_dif"):
        require(launches[stage] > 0 and launches[stage] ==
                butterfly[stage] - per_encode[stage] * encodes,
                f"{stage} runs only for mask rows, decode and the verifier")
    require(proof == butterfly_proof,
            "the int8 engine's proof equals the butterfly proof")
    return launches


SHARDS = 4
# the sharded phases prove and do not verify: no submod (make_wat has
# none) and no fold (the verifier's)
SHARDED_KERNELS = tuple(k for k in PLANAR_KERNELS
                        if k not in ("submod_aos", "masked_mulsum_aos")) \
    + ("mont_mul_tiled_planar", "mulmod")


def prove_sharded(device, proof: bytes, bit_decompose: bytes) -> dict:
    """The column-sharded prover (``parallel/mesh.py``): make_wat(400) at
    k=8192 through ``prove(mesh=make_mesh(...))`` with SHARDS shards on
    cuda:(i % cards), whose proof must equal phase 5's `proof`, and
    bit_decompose.wat at k=256 through the same mesh (its divisions run
    K1 through the arena on the home device), whose proof must equal the
    CPU proof of phase 4.  The launches are counted from zero
    before each prove and read after it: every kernel of the sharded path
    must have launched in the make_wat(400) prove, K1 in the bit_decompose
    one, and no plain version may have run on CUDA tensors in either.  No
    verify: the bytes equal phase 5's, which was verified.  Returns the
    launch counts of the make_wat(400) prove."""
    import torch
    from ligero_prover_tpu_torch.ops import fieldmul as fm, sha256 as sha, \
        mxu_renorm as mr
    from ligero_prover_tpu_torch.parallel.mesh import make_mesh
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.utils import timer as T

    cards = torch.cuda.device_count()
    mesh = make_mesh([torch.device("cuda", i % cards)
                      for i in range(SHARDS)])
    devices = sorted(set(mesh.devices), key=str)
    log(f"phase 8: {SHARDS} shards over {cards} card(s): "
        + ", ".join(f"shard {d} -> {dev}"
                    for d, dev in enumerate(mesh.devices)))
    geo = RowGeometry(FULL_K)
    prog = wat_program(make_wat(FULL_ROUNDS))
    small = wat_program(str(BIT_DECOMPOSE))
    for dev in devices:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    # what earlier phases left allocated (caches, tables); the
    # prove's own peak is counted above it
    before = {str(dev): torch.cuda.memory_allocated(dev)
              for dev in devices}
    T.clear_timers()
    for module in (fm, sha, mr):
        module.reset_counts()
    t0 = time.perf_counter()
    res = prove(prog, geometry=geo, encoding_seed=bytes(32), mesh=mesh)
    for dev in devices:
        torch.cuda.synchronize(dev)
    prove_s = time.perf_counter() - t0
    stages = {s: round(T.get_timer(s), 3)
              for s in ("stage1", "stage2", "stage3")}
    peaks = {str(dev): torch.cuda.max_memory_allocated(dev)
             - before[str(dev)] for dev in devices}
    launches = {**fm.LAUNCHES, **sha.LAUNCHES, **mr.LAUNCHES}
    tiled_shapes = dict(fm.TILED_SHAPES)
    plain = plain_on_cuda()
    for module in (fm, sha, mr):
        module.reset_counts()
    small_res = prove(small, geometry=RowGeometry(SMALL_K), mesh=mesh,
                      batch_rows=8, encoding_seed=bytes(range(32)))
    for dev in devices:
        torch.cuda.synchronize(dev)
    small_launches = {**fm.LAUNCHES, **sha.LAUNCHES, **mr.LAUNCHES}
    small_plain = plain_on_cuda()
    log(f"phase 8: sharded k={FULL_K} n={geo.n} make_wat({FULL_ROUNDS}): "
        f"rows={res.num_rows} prove_s={prove_s:.3f} "
        f"rows_per_s={res.num_rows / prove_s:.1f} stages_s={stages} "
        f"prove_peak_above_before_per_device={peaks} (allocated before "
        f"the prove: {before}) launches={launches} "
        f"launches_per_row={sum(launches.values()) / res.num_rows:.2f} "
        f"tiled launches by (B, w)={tiled_shapes} "
        f"plain_calls_on_cuda={plain} "
        f"proof_bytes={len(res.proof)} equal to phase 5's: "
        f"{res.proof == proof}")
    log(f"phase 8: sharded k={SMALL_K} bit_decompose.wat: proof equal to "
        f"the CPU proof of phase 4: {small_res.proof == bit_decompose}; "
        f"launches={small_launches} plain_calls_on_cuda={small_plain}")
    require(res.ok and small_res.ok, "sharded prove self-checks")
    require(res.proof == proof, "the sharded proof equals phase 5's")
    require(small_res.proof == bit_decompose,
            "the sharded bit_decompose proof equals the CPU proof")
    require(all(launches[k] > 0 for k in SHARDED_KERNELS),
            f"every kernel of the sharded path launched: {launches}")
    require(launches[fm.QUAD] == 0,
            f"the sharded check takes KQ, not quad-terms: {launches}")
    require(small_launches["mont_mul"] > 0,
            f"K1 ran through the arena on the mesh: {small_launches}")
    require(all(v == 0 for v in {**plain, **small_plain}.values()),
            f"no plain version ran on CUDA tensors: {plain} {small_plain}")
    return launches


MP_RANK_TIMEOUT = 600       # seconds a phase-9 rank may take, start-up included
MP_COLLECTIVE_TIMEOUT = 300  # the process group's limit per collective


def mp_layout(cards: int) -> tuple[int, int, str]:
    """(P ranks, L shards a rank, backend) of phase 9: one card a rank over
    NCCL where the host has SHARDS cards, else two ranks sharing cuda:0
    over gloo (NCCL refuses two ranks on one card), D = SHARDS."""
    if cards >= SHARDS:
        return SHARDS, 1, "nccl"
    return 2, SHARDS // 2, "gloo"


def mp_rank(cfg: dict) -> int:
    """One rank of phase 9 (``chip_smoke.py --mp-rank '<json>'``): join the
    process group through the parent's store, prove make_wat(4) at k=256
    through the mesh (start-up: the CUDA context, the communicators, the
    kernels' first launches), then make_wat(400) at k=8192 with the counts
    set to 0 just before and read just after, and print one ``phase 9
    rank`` JSON line."""
    import datetime
    import hashlib
    import torch
    import torch.distributed as dist
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm, sha256 as sha, \
        mxu_renorm as mr
    from ligero_prover_tpu_torch.parallel.mesh import make_mesh
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.utils import timer as T

    rank, world, local = cfg["rank"], cfg["world"], cfg["local"]
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    cards = [rank] if cfg["backend"] == "nccl" else [0] * local
    devices = [torch.device("cuda", i) for i in cards]
    torch.cuda.set_device(devices[0])
    timeout = datetime.timedelta(seconds=MP_COLLECTIVE_TIMEOUT)
    store = dist.TCPStore("127.0.0.1", cfg["port"], world, is_master=False,
                          timeout=timeout)
    dist.init_process_group(cfg["backend"], store=store, rank=rank,
                            world_size=world, timeout=timeout)
    try:
        kernels.lib()               # the parent's build, loaded
        mesh = make_mesh(devices)
        warm = prove(wat_program(make_wat(4)),
                     geometry=RowGeometry(SMALL_K), mesh=mesh,
                     batch_rows=8, encoding_seed=bytes(32))
        require(warm.ok, "phase 9 start-up prove")
        prog = wat_program(make_wat(FULL_ROUNDS))
        uniq = sorted(set(devices), key=str)
        for dev in uniq:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        before = {str(dev): torch.cuda.memory_allocated(dev)
                  for dev in uniq}
        T.clear_timers()
        mesh.reset_counts()
        for module in (fm, sha, mr):
            module.reset_counts()
        t0 = time.perf_counter()
        res = prove(prog, geometry=RowGeometry(FULL_K),
                    encoding_seed=bytes(32), mesh=mesh)
        for dev in uniq:
            torch.cuda.synchronize(dev)
        prove_s = time.perf_counter() - t0
        launches = {**fm.LAUNCHES, **sha.LAUNCHES, **mr.LAUNCHES}
        tiled_shapes = {f"{b}x{w}": c
                        for (b, w), c in fm.TILED_SHAPES.items()}
        plain = plain_on_cuda()
        collectives = dict(mesh.counts)
        peaks = {str(dev): torch.cuda.max_memory_allocated(dev)
                 - before[str(dev)] for dev in uniq}
        stages = {s: round(T.get_timer(s), 3)
                  for s in ("stage1", "stage2", "stage3")}
    finally:
        dist.destroy_process_group()
    imported = [m for m in sys.modules if m.split(".")[0]
                in ("jax", "ligero_prover_tpu")]
    require(not imported, f"phase 9 rank {rank} imported {imported[:5]}")
    log("phase 9 rank " + json.dumps({
        "rank": rank, "world": world, "backend": cfg["backend"],
        "shards": list(mesh.local_shards),
        "devices": [str(d) for d in devices], "ok": res.ok,
        "proof_sha256": hashlib.sha256(res.proof).hexdigest(),
        "rows": res.num_rows, "prove_s": prove_s,
        "rows_per_s": res.num_rows / prove_s, "stages_s": stages,
        "prove_peak_above_before_per_device": peaks,
        "allocated_before": before, "launches": launches,
        "launches_per_row": sum(launches.values()) / res.num_rows,
        "tiled_launches_by_shape": tiled_shapes,
        "plain_calls_on_cuda": {k: v for k, v in plain.items() if v},
        "collectives": collectives}))
    return 0


def prove_multiprocess(proof: bytes) -> list[dict]:
    """Phase 9: the column-sharded prover over a process group, one process
    per rank (``mp_layout``), each proving make_wat(400) at k=8192 through
    ``prove(mesh=make_mesh(...))`` with its own shards.  Every rank must
    exit 0 within MP_RANK_TIMEOUT (a rank still running then is killed),
    prove phase 5's `proof` byte for byte, launch every kernel of the
    sharded path and run no plain version on a CUDA tensor.  Returns each
    rank's line."""
    import hashlib
    import torch
    import torch.distributed as dist
    world, local, backend = mp_layout(torch.cuda.device_count())
    # the ranks meet through this store, bound at a port the system picks
    # and held until they end
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                          wait_for_workers=False)
    port = store.port
    env = dict(os.environ, LIGERO_PROOF_TIMESTAMP="1700000000")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    log(f"phase 9: {world} ranks x {local} shard(s) over {backend}, "
        f"D = {world * local}, tcp://127.0.0.1:{port}")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mp-rank",
         json.dumps({"rank": r, "world": world, "local": local,
                     "backend": backend, "port": port})],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            left = t0 + MP_RANK_TIMEOUT - time.perf_counter()
            outs.append(p.communicate(timeout=max(left, 1)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        found = [ln for ln in out.splitlines()
                 if ln.startswith("phase 9 rank ")]
        require(p.returncode == 0 and found,
                f"phase 9 rank {r} exited {p.returncode}:\n{out[-4000:]}"
                f"\n{err[-4000:]}")
        log(found[-1])
        lines.append(json.loads(found[-1][len("phase 9 rank "):]))
    want = hashlib.sha256(proof).hexdigest()
    log(f"phase 9: {world} ranks in {time.perf_counter() - t0:.1f}s; "
        f"every proof equal to phase 5's: "
        f"{all(ln['proof_sha256'] == want for ln in lines)}")
    for ln in lines:
        r = ln["rank"]
        require(ln["ok"], f"phase 9 rank {r} self-check")
        require(ln["proof_sha256"] == want,
                f"phase 9 rank {r}'s proof equals phase 5's")
        require(all(ln["launches"][k] > 0 for k in SHARDED_KERNELS),
                f"every kernel of the sharded path launched on rank {r}: "
                f"{ln['launches']}")
        require(all(v == 0 for v in ln["plain_calls_on_cuda"].values()),
                f"no plain version ran on CUDA tensors on rank {r}")
    return lines


def main() -> int:
    import torch
    if len(sys.argv) > 2 and sys.argv[1] == "--mp-rank":
        return mp_rank(json.loads(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.ops import fieldmul as fm
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
        f"{torch.cuda.device_count()} max SM clock {clk} MHz; phase 9: "
        "{} ranks x {} shard(s) over {}".format(
            *mp_layout(torch.cuda.device_count())))

    t0 = time.perf_counter()
    kernels.lib()
    info = kernels.build_info
    ptxas = ptxas_report(info.get("log", ""))
    CARD["sass"] = sass_counts(info["path"])
    CARD["ptxas"] = ptxas
    log(f"phase 2: built {os.path.basename(info['path'])} in "
        f"{time.perf_counter() - t0:.2f}s (nvcc {info['seconds']:.2f}s, "
        f"cached={info['cached']}); ptxas (registers, spill store bytes, "
        f"spill load bytes) per kernel: {ptxas}; SASS "
        f"(IMAD.WIDE, IMAD.HI, all) per kernel: {CARD['sass']}")
    CARD["imad"] = imad_rate(kernels.lib(), kernels.stream_handle(device))
    log("phase 2: wide multiply-add probe (mont_mul_cc's even chain, "
        "4 IMAD.WIDE a round; the loop's SASS IMAD.WIDE: "
        f"{CARD['sass']['imad_probe_1'][0]} and "
        f"{CARD['sass']['imad_probe_4'][0]}): "
        + "; ".join(f"{c} chain(s) a thread, {r['ctas']} CTAs of 256: "
                    f"{r['ms']:.4f} ms, {r['per_clk_per_sm']:.1f} "
                    f"IMAD.WIDE per clock per SM"
                    for c, r in CARD["imad"].items())
        + f" (at {CARD['clock_hz'] / 1e6:.0f} MHz; chip_smoke.bound "
        f"takes {IMAD_PER_CLK})")

    measured = check_kernels(device)
    small = check_small_proofs(device)
    os.environ["LIGERO_PROOF_TIMESTAMP"] = "1700000000"
    launches, proof = prove_full(device, "phase 5", FULL_ROUNDS, profile=True)
    mxu = prove_mxu(device, launches, proof)
    sharded = prove_sharded(device, proof, small["bit_decompose"])
    ranks = prove_multiprocess(proof)
    launches.update({k: mxu[k] for k in MXU_KERNELS})
    launches[fm.TILED] = sharded[fm.TILED]

    meta = {
        "mont_mul": ("fieldmul.cu", "ops/pallas/fieldmul.py:260"),
        "mulmod": ("fieldmul.cu", "ops/pallas/fieldmul.py:264"),
        "sha256_absorb": ("sha256.cu", "zkp/executor.py:43"),
        "sha256_absorb_planar": ("sha256.cu", "zkp/executor.py:68"),
        "butterfly_dit": ("planar.cu", "ops/pallas/fieldmul.py:238"),
        "butterfly_dif": ("planar.cu", "ops/pallas/fieldmul.py:245"),
        "addmod_planar": ("planar.cu", "ops/pallas/fieldmul.py:252"),
        # no caller on the main path since quad-terms: phase 3 only
        "submod_planar": ("planar.cu", "ops/pallas/fieldmul.py:256"),
        "mont_mul_planar": ("planar.cu", "ops/pallas/fieldmul.py:260"),
        # no caller on the main path since quad-terms: phase 3 only
        "mulmod_planar": ("planar.cu", "ops/pallas/fieldmul.py:264"),
        # _k_mulmod's planar entry around the check's call, with the
        # jnp.take gather and the submods of zkp/executor.py:233-250; no
        # caller on the main path since KQ: phase 3 only
        "quad_terms_planar": ("planar.cu", "ops/pallas/fieldmul.py:264"),
        # KQ: the same with all the quadratic test wraps around it
        "quad_acc_planar": ("planar.cu", "ops/pallas/fieldmul.py:264 + "
                            "ligero_prover_tpu/zkp/executor.py:230-250"),
        "mont_mul_scalar_planar": ("planar.cu",
                                   "ops/pallas/fieldmul.py:269"),
        # _k_mont_mul's planar entry, tiled: the sharded encode's twist
        "mont_mul_tiled_planar": ("planar.cu", "ops/pallas/fieldmul.py:260"),
        # no caller on any path of either package: launched in phase 3 only
        "mulmod_fma_planar": ("planar.cu", "ops/pallas/fieldmul.py:278"),
        "digitize": ("renorm.cu", "ops/pallas/mxu_renorm.py:146"),
        "renorm_mid": ("renorm.cu", "ops/pallas/mxu_renorm.py:130"),
        "renorm_final": ("renorm.cu", "ops/pallas/mxu_renorm.py:124"),
        # no caller on any path of either package: launched in phase 3 only
        "renorm_pack": ("renorm.cu", "ops/pallas/mxu_renorm.py:139"),
        # XLA ops of the reference, not Pallas kernels: fo.addmod/submod
        # and the verifier's _masked_sum loop, fused with the fo.mulmod
        # product its callers hand it (zkp/executor.py:145-149, 272-274,
        # 307-308); the fold of given rows has no caller since: phase 3
        "addmod_aos": ("fieldmul.cu", "ops/fieldops.py:100"),
        "submod_aos": ("fieldmul.cu", "ops/fieldops.py:106"),
        "masked_mulsum_aos": ("fieldmul.cu", "zkp/executor.py:108"),
        "masked_sum_aos": ("fieldmul.cu", "zkp/executor.py:108"),
    }
    table = []
    for name, (src, replaces) in meta.items():
        m = measured[name]
        table.append({"name": name, "route": "cuda",
                      "source": f"ligero_prover_tpu_torch/csrc/{src}",
                      "replaces": f"ligero_prover_tpu/{replaces}",
                      "launches": launches[name], **m,
                      "library_ms": None,
                      "phase9_launches_per_rank": [
                          ln["launches"][name] for ln in ranks]})
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
