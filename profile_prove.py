#!/usr/bin/env python3
"""Profile the port's prove on one GPU, planar and AoS side by side.

    python3 profile_prove.py [--rounds 60] [--out build/profile.json]

For each configuration of ``ops.ntt.USE_PLANAR`` (planar, then AoS) on the
vbn254fr guest of ``chip_smoke.make_wat`` at k=8192: one warm-up prove;
one timed prove (wall and stage seconds, the port's launch counters); one
prove under ``torch.profiler`` (device kernel time, kernel count, the top
device ops); and one 16-row k->n encode as the pipelines call it, timed
by the host clock and by CUDA events.  The device busy share is the
profiled kernel time over the unprofiled prove wall.  Prints one JSON
object per configuration, and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from chip_smoke import configuration, make_wat, wat_program

K = 8192


def _device_time_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def encode_times(planar: bool, iters: int = 5) -> dict:
    """One 16-row k->n encode: median host ms and median CUDA-event ms."""
    import numpy as np
    import torch
    from ligero_prover_tpu_torch.field import bn254 as F
    from ligero_prover_tpu_torch.ops import ntt
    codec = ntt.RSCodec(K, 4 * K, "cuda")
    gen = np.random.default_rng(1)
    raw = gen.integers(0, 2 ** 32, (16, K, 8), dtype=np.uint64)
    raw[..., 7] %= F.MODULUS >> 224                   # canonical: < p
    rows = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).cuda()

    def encode():
        if planar:
            return ntt.encode_rows_cg_planar_core(rows, codec.dom_k,
                                                  codec.dom_n, 4 * K)
        return ntt.encode_rows_cg(rows, codec.dom_k, codec.dom_n, 4 * K)

    encode()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        encode()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        encode()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"encode16_host_ms": statistics.median(host),
            "encode16_event_ms": statistics.median(dev),
            "encode16_kernels": kernels}


def profile_config(planar: bool, rounds: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ligero_prover_tpu_torch.ops import fieldmul as fm, sha256 as sha
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.utils import timer as T

    geo = RowGeometry(K)
    prog = wat_program(make_wat(rounds))
    out = {"config": "planar" if planar else "aos", "rounds": rounds}
    with configuration(planar):
        def run():
            res = prove(prog, geometry=geo, encoding_seed=bytes(32),
                        device="cuda")
            torch.cuda.synchronize()
            if not res.ok:
                raise RuntimeError("prove self-check failed")
            return res

        run()                                             # warm-up
        T.clear_timers()
        fm.reset_counts()
        sha.reset_counts()
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        counted = {**fm.LAUNCHES, **sha.LAUNCHES}
        out.update(rows=res.num_rows, prove_s=wall,
                   stages_s={s: T.get_timer(s)
                             for s in ("stage1", "stage2", "stage3")},
                   kernel_wrapper_launches=counted)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        out["prove_profiled_s"] = time.perf_counter() - t0
        ev = prof.key_averages()
        dev = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA]
        kernel_us = sum(_device_time_us(e) for e in dev)
        n_kernels = sum(e.count for e in dev)
        out.update(device_kernel_s=kernel_us / 1e6,
                   device_busy_share=kernel_us / 1e6 / wall,
                   device_kernels=n_kernels,
                   device_kernels_per_row=n_kernels / res.num_rows,
                   top_device_ops=[
                       (e.key[:60], round(_device_time_us(e) / 1e3, 3),
                        e.count)
                       for e in sorted(dev, key=_device_time_us,
                                       reverse=True)[:12]])
        out.update(encode_times(planar))
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--out", default="build/profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    results = []
    for planar in (True, False):
        r = profile_config(planar, args.rounds)
        r["card"] = card
        print(json.dumps(r), flush=True)
        results.append(r)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
