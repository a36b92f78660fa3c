#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ligero_prover_tpu_torch/csrc``, checks each
kernel against its plain PyTorch version at the shapes of the main path,
checks that a small proof made on the GPU is byte-identical to the same
proof made on the CPU, then proves and verifies the vbn254fr Poseidon-style
guest of ``bench/e2e_prove.py`` at production geometry (k=8192, n=32768)
through the port's ``prove``/``verify`` entry points, counting the kernel
launches of that run.  Any failure raises and exits non-zero; without a
CUDA device it exits non-zero before doing anything.

The last two lines of output are the kernel table as JSON and the result
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gzip
import json
import os
import statistics
import subprocess
import sys
import time

FULL_K = 8192
FULL_ROUNDS = 400
SMALL_K = 256
SEED = 20261016


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


def launches_ms(launch, iters: int = 50) -> float:
    """Device time of one kernel launch: `iters` back-to-back launches of a
    C entry point on fixed buffers between two CUDA events, after a
    warm-up.  A wrapper call costs more host time than these kernels take,
    so timing wrapper calls would time the host."""
    import torch
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def check_kernels(device) -> dict:
    import numpy as np
    import torch
    from ligero_prover_tpu_torch.field import bn254 as F
    from ligero_prover_tpu_torch import kernels
    from ligero_prover_tpu_torch.field.limbs import ints_to_limbs
    from ligero_prover_tpu_torch.ops import fieldmul as fm, sha256 as sha

    gen = np.random.default_rng(SEED)
    lib, stream = kernels.lib(), kernels.stream_handle(device)
    results = {}

    def limbs(shape, canonical=True):
        return random_limbs(gen, shape, device, canonical)

    def field_launch(name, x, y):
        xt, yt = x.reshape(-1, 8), y.reshape(-1, 8)
        out = torch.empty_like(xt)
        return lambda: kernels.check(lib.ligero_mont_mul(
            xt.data_ptr(), yt.data_ptr(), out.data_ptr(), xt.shape[0],
            yt.shape[0], fm.MODE[name], stream), name)

    def compare(name, args, label):
        kernel, plain = getattr(fm, name), getattr(fm, name + "_plain")
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ms = launches_ms(field_launch(name, *args))
        call_ms = cuda_ms(lambda: kernel(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 3)
        log(f"phase 3: {name} {label}: max_abs_err={err} "
            f"kernel_ms={ms:.4f} wrapper_call_ms={call_ms:.4f} "
            f"plain_ms={plain_ms:.4f}")
        require(err == 0, f"{name} {label} equals its plain version")
        return err, ms, plain_ms

    # K1 at the DIT butterfly shape: (16, 16384) rows times a (16384, 8)
    # twiddle broadcast over the batch, and at the k-domain DIF shape
    x = limbs((16, 16384))
    tw = limbs((16384,))
    err1, ms1, pms1 = compare("mont_mul", (x, tw),
                              "(16*16384,8) x bcast (16384,8)")
    compare("mont_mul", (limbs((16, 4096)), limbs((4096,))), "(16*4096,8)")
    # non-canonical operands in [p, 2^256), with edge values
    a = limbs((65536,), canonical=False)
    b = limbs((65536,), canonical=False)
    edges = ints_to_limbs([0, 1, F.MODULUS - 1, F.R % F.MODULUS, F.MODULUS,
                           (1 << 256) - 1])
    a[:6] = torch.from_numpy(edges.view(np.int32).copy()).to(device)
    b[:6] = torch.from_numpy(edges[::-1].view(np.int32).copy()).to(device)
    compare("mont_mul", (a, b), "(65536,8) non-canonical")
    compare("mulmod", (a, b), "(65536,8) non-canonical")
    # K2 at the check-stage shape
    err2, ms2, pms2 = compare("mulmod",
                              (limbs((16, 32768)), limbs((16, 32768))),
                              "(16*32768,8)")

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
    err3 = max(max_abs_err(k_st[0], p_st[0]), max_abs_err(k_st[1], p_st[1]))
    require(k_st[2] == p_st[2] and k_st[2] is False, "K3 has_pending carry")
    args = (state, pending, False, flushes[0][0], 16)
    st_out, pend_out = torch.empty_like(state), torch.empty_like(pending)
    ms3 = launches_ms(lambda: kernels.check(lib.ligero_sha256_absorb(
        state.data_ptr(), pending.data_ptr(), flushes[0][0].data_ptr(),
        st_out.data_ptr(), pend_out.data_ptr(), cols, bsz, 0, 16, stream),
        "sha256_absorb"))
    call_ms3 = cuda_ms(lambda: sha.absorb_stream(*args), 20)
    pms3 = cuda_ms(lambda: sha.absorb_stream_plain(*args), 3)
    log(f"phase 3: sha256_absorb B=16 C=32768 two flushes (15 then 9 "
        f"valid): max_abs_err={err3} kernel_ms={ms3:.4f} "
        f"wrapper_call_ms={call_ms3:.4f} plain_ms={pms3:.4f}")
    require(err3 == 0, "sha256_absorb equals its plain version")

    results["mont_mul"] = (err1, ms1, pms1)
    results["mulmod"] = (err2, ms2, pms2)
    results["sha256_absorb"] = (err3, ms3, pms3)
    return results


# ---- phases 4 and 5 ------------------------------------------------------

def wat_program(src: str):
    from ligero_prover_tpu_torch.vm.run import make_wat_program
    return make_wat_program(src, [], set())


def check_small_proof(device):
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.zkp.executor import TorchExecutor
    geo = RowGeometry(SMALL_K)
    prog = wat_program(make_wat(4))
    os.environ["LIGERO_PROOF_TIMESTAMP"] = "1700000000"
    try:
        proofs = {}
        for dev in (device, "cpu"):
            ex = TorchExecutor(geo.k, geo.n, 8, dev)
            res = prove(prog, geometry=geo, executor=ex,
                        encoding_seed=bytes(range(32)))
            require(res.ok, f"k={SMALL_K} prove self-check on {dev}")
            proofs[dev] = res.proof
    finally:
        del os.environ["LIGERO_PROOF_TIMESTAMP"]
    same = proofs[device] == proofs["cpu"]
    log(f"phase 4: k={SMALL_K} make_wat(4) proof bytes cuda == cpu: {same} "
        f"({len(proofs['cpu'])} bytes)")
    require(same, "CUDA and CPU proofs are byte-identical")


def tamper(proof: bytes) -> bytes:
    from ligero_prover_tpu_torch.proto import ligero_proof_pb2 as pb
    env = pb.LigeroProofEnvelope()
    env.ParseFromString(gzip.decompress(proof))
    env.ligero_proof.sampled_data.values[5] ^= 1
    return gzip.compress(env.SerializeToString())


def prove_full(device) -> dict:
    import torch
    from ligero_prover_tpu_torch.ops import fieldmul as fm, sha256 as sha
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.verifier import verify
    from ligero_prover_tpu_torch.utils import timer as T

    geo = RowGeometry(FULL_K)
    prog = wat_program(make_wat(FULL_ROUNDS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    T.clear_timers()
    fm.reset_counts()
    sha.reset_counts()
    t0 = time.perf_counter()
    res = prove(prog, geometry=geo, encoding_seed=bytes(32), device=device)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vres = verify(prog, res.proof, geometry=geo, device=device)
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    launches = {**fm.LAUNCHES, **sha.LAUNCHES}
    plain = {name: calls["cuda"] for name, calls in
             {**fm.PLAIN_CALLS, **sha.PLAIN_CALLS}.items()}
    peak = torch.cuda.max_memory_allocated()
    stages = {s: round(T.get_timer(s), 3)
              for s in ("stage1", "stage2", "stage3")}
    log(f"phase 5: k={FULL_K} n={geo.n} make_wat({FULL_ROUNDS}): "
        f"rows={res.num_rows} prove_s={prove_s:.3f} "
        f"rows_per_s={res.num_rows / prove_s:.1f} stages_s={stages} "
        f"verify_s={verify_s:.3f} proof_bytes={len(res.proof)} "
        f"max_memory_allocated={peak} launches={launches} "
        f"plain_calls_on_cuda={plain}")
    require(res.ok, "full-size prove self-check")
    require(vres.ok, "port verifier accepts the full-size proof")
    require(all(v > 0 for v in launches.values()),
            f"every kernel launched on the main path: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"no plain version ran on CUDA tensors: {plain}")
    bad = verify(prog, tamper(res.proof), geometry=geo, device=device)
    log(f"phase 5: one-bit tamper of sampled_data rejected: {not bad.ok}")
    require(not bad.ok, "tampered proof rejected")
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
    log(smi[0])
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    kernels.lib()
    info = kernels.build_info
    ptxas = [ln.strip() for ln in info.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"phase 2: built {os.path.basename(info['path'])} in "
        f"{time.perf_counter() - t0:.2f}s (nvcc {info['seconds']:.2f}s, "
        f"cached={info['cached']}); ptxas: {' | '.join(ptxas)}")

    measured = check_kernels(device)
    check_small_proof(device)
    launches = prove_full(device)

    meta = {
        "mont_mul": ("ligero_prover_tpu_torch/csrc/fieldmul.cu",
                     "ligero_prover_tpu/ops/pallas/fieldmul.py:260"),
        "mulmod": ("ligero_prover_tpu_torch/csrc/fieldmul.cu",
                   "ligero_prover_tpu/ops/pallas/fieldmul.py:264"),
        "sha256_absorb": ("ligero_prover_tpu_torch/csrc/sha256.cu",
                          "ligero_prover_tpu/zkp/executor.py:43"),
    }
    table = []
    for name, (src, replaces) in meta.items():
        err, ms, plain_ms = measured[name]
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
