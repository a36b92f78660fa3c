#!/usr/bin/env python3
"""The port's spans and counters (``ligero_prover_tpu_torch/utils/timer``)
held against the profiler's own record, on one GPU.

    python3 experiment_trace.py [--requests 3] [--seed 7] \
        [--out build/experiment_trace.json]
    python3 experiment_trace.py --device cpu --k 256 --small   # a CPU try

The guest is the benchmark's (``proverbench`` cell ``poseidon2.prove``:
the vbn254fr Poseidon2 digest at k=8192, unless ``--k`` and ``--small``
shrink it).  In order:

1. ``flag``: the profiler's flag that turns the spans on, inside and
   outside a ``torch.profiler.profile``.
2. ``clock``: a span inside a ``record_function`` range, and where the
   profiler puts that range (both on ``time.time_ns()``).
3. ``span_cost_s``: a span with the profiler off, a count off, a span on.
4. One prove and one verify to warm up.
5. ``syncs`` (GPU only): one prove and one verify under
   ``torch.cuda.set_sync_debug_mode("warn")``, with the spans on: each
   synchronising call by its innermost frame in the port, and how many of
   them were outside a ``host.wait`` span (should be 0).
6. ``prove``, ``verify``: each of ``--requests`` calls in a profiler
   session of its own (CPU and, on a GPU, CUDA activity): the spans per
   request (``summary()``), the counters, the stages' self time outside
   every child span as a share of the stages' time, the time of the
   Merkle tree and the recommit inside it (``merkle_s``: no span, timed
   here), the spans' count and memory, and the trace's memcpys by kind
   (count, bytes) with the ``htod.bytes`` counter against the trace's
   HtoD bytes of that request.

Prints one JSON line per phase and writes the whole record to ``--out``.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "proverbench")]
PORT = str(ROOT / "ligero_prover_tpu_torch")
SPAN_RECORD_BYTES = 160     # a 5-tuple of a str, three ints and an int


def _emit(record: dict, key: str, value):
    record[key] = value
    print(json.dumps({key: value}), flush=True)


def _cost(fn, n: int) -> float:
    """Seconds a call of `fn`, the median of 5 loops of `n`."""
    out = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n)
    return statistics.median(out)


def _memcpys(prof) -> dict:
    """The trace's memcpys by kind: [count, bytes] (from the exported
    trace: the events' own ``nbytes()`` reads 0 for a memcpy)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    out: dict[str, list[int]] = {}
    for e in events:
        if e.get("cat") != "gpu_memcpy":
            continue
        acc = out.setdefault(e["name"], [0, 0])
        acc[0] += 1
        acc[1] += int(e.get("args", {}).get("bytes", 0))
    return out


def _per_request(T, stages: tuple[str, ...], n: int) -> dict:
    s = T.summary()
    spans = {name: {k: v / n for k, v in rec.items()}
             for name, rec in s["spans"].items()}
    total = sum(s["spans"][x]["total_s"] for x in stages)
    own = sum(s["spans"][x]["self_s"] for x in stages)
    count = len(T.spans())
    return {"requests": s["requests"], "spans": spans,
            "counters": {k: v / n for k, v in s["counters"].items()},
            "stages": list(stages), "stages_s": total / n,
            "stages_self_share": own / total,
            "spans_per_request": count / n,
            "span_bytes_per_request": count * SPAN_RECORD_BYTES / n}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--small", action="store_true",
                    help="one full and one partial Poseidon2 round")
    ap.add_argument("--out", default="build/experiment_trace.json")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    import harness
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.utils import timer as T
    from ligero_prover_tpu_torch.verifier import verify
    from ligero_prover_tpu_torch.vm.run import make_wat_program

    os.environ["LIGERO_PROOF_TIMESTAMP"] = harness.PROOF_TIMESTAMP
    gpu = args.device.startswith("cuda")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if gpu else [])
    rec: dict = {}
    card = ""
    if gpu:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout
    _emit(rec, "versions", {"python": sys.version.split()[0],
                            "torch": torch.__version__,
                            "cuda": torch.version.cuda, "card": card.strip()})

    flag = torch.autograd.profiler
    with profile(activities=[ProfilerActivity.CPU]):
        inside = flag._is_profiler_enabled
    _emit(rec, "flag", {"inside": inside,
                        "outside": flag._is_profiler_enabled})

    T.clear_timers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("trace.probe"):
            with T.span("probe"):
                time.sleep(0.002)
    (_, t0, t1, _, _), = T.spans()
    (r0, r1), = [(e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "trace.probe"
                 and e.device_type() == torch.autograd.DeviceType.CPU]
    _emit(rec, "clock", {"inside": r0 <= t0 < t1 <= r1,
                         "lead_ns": t0 - r0, "trail_ns": r1 - t1})

    def one_span():
        with T.span("x"):
            pass
    cost = {"span_off": _cost(one_span, 100_000),
            "count_off": _cost(lambda: T.count("x"), 100_000)}
    with profile(activities=[ProfilerActivity.CPU]):
        cost["span_on"] = _cost(one_span, 20_000)
    T.clear_timers()
    _emit(rec, "span_cost_s", cost)

    cell = harness.Cell.load("poseidon2.prove")
    small = {"full_rounds": 1, "partial_rounds": 1} if args.small else {}
    ctx = harness.Context(cell, args.seed, args.device,
                          args.k or int(cell.config["packing"]), small)
    src, guest_args = ctx.guest()
    program = make_wat_program(src, guest_args, set())
    geo = RowGeometry(ctx.k)

    def do_prove(i):
        res = prove(program, geometry=geo, encoding_seed=ctx.encoding_seed(i),
                    device=args.device, batch_rows=ctx.batch_rows)
        assert res.ok
        return res

    def do_verify(blob):
        res = verify(program, blob, geometry=geo, device=args.device,
                     batch_rows=ctx.batch_rows)
        assert res.ok
        return res

    t = time.perf_counter()
    blob = do_prove(-1).proof
    first_prove = time.perf_counter() - t
    t = time.perf_counter()
    do_verify(blob)
    _emit(rec, "warm_up_s", {"prove": first_prove,
                             "verify": time.perf_counter() - t})

    if gpu:
        seen_at: list[tuple[str, int]] = []
        phase = ["prove"]

        def seen(message, category, filename, lineno, file=None, line=None):
            stamp = time.time_ns()
            frames = [f for f in traceback.extract_stack()
                      if f.filename.startswith(PORT)]
            where = (f"{os.path.relpath(frames[-1].filename, ROOT)}:"
                     f"{frames[-1].lineno} {frames[-1].name}"
                     if frames else f"{filename}:{lineno}")
            seen_at.append((f"{phase[0]} {where}", stamp))

        T.clear_timers()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            with profile(activities=[ProfilerActivity.CPU]):
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    do_prove(-2)
                    phase[0] = "verify"
                    do_verify(blob)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        waits = sorted((r[1], r[2]) for r in T.spans()
                       if r is not None and r[0] == "host.wait")
        starts = [w[0] for w in waits]
        sites: dict[str, dict] = {}
        for key, stamp in seen_at:
            i = bisect.bisect_right(starts, stamp) - 1
            held = i >= 0 and waits[i][0] <= stamp <= waits[i][1]
            acc = sites.setdefault(key, {"calls": 0, "outside_host_wait": 0})
            acc["calls"] += 1
            acc["outside_host_wait"] += 0 if held else 1
        T.clear_timers()
        _emit(rec, "syncs", {
            "sites": dict(sorted(sites.items())), "calls": len(seen_at),
            "outside_host_wait": sum(v["outside_host_wait"]
                                     for v in sites.values()),
            "host_wait_spans": len(waits)})

    # the Merkle tree and the recommit have no span (the harness's ranges
    # split them): timed here, to tell them apart in the stages' own time
    import ligero_prover_tpu_torch.prover as prover_mod
    import ligero_prover_tpu_torch.verifier as verifier_mod
    merkle_ns = [0]

    def timed(fn):
        def inner(*a, **kw):
            t = time.time_ns()
            try:
                return fn(*a, **kw)
            finally:
                merkle_ns[0] += time.time_ns() - t
        return inner
    prover_mod.MerkleTree = timed(prover_mod.MerkleTree)
    verifier_mod.recommit = timed(verifier_mod.recommit)

    for mode, stages in (("prove", ("stage1", "stage2")),
                         ("verify", ("verify",))):
        T.clear_timers()
        merkle_ns[0] = 0
        per_call = []
        for i in range(args.requests):
            before = dict(T.summary()["counters"])
            with profile(activities=acts) as prof:
                if mode == "prove":
                    rows = do_prove(i).num_rows
                else:
                    do_verify(blob)
                    rows = None
                if gpu:
                    torch.cuda.synchronize()
            after = T.summary()["counters"]
            htod = after.get("htod.bytes", 0) - before.get("htod.bytes", 0)
            copies = _memcpys(prof) if gpu else {}
            traced = sum(v[1] for k, v in copies.items()
                         if k.startswith("Memcpy HtoD"))
            per_call.append({"rows": rows, "htod_counter": htod,
                             "htod_trace": traced if gpu else None,
                             "memcpys": copies})
            del prof
        out = _per_request(T, stages, args.requests)
        out["merkle_s"] = merkle_ns[0] / 1e9 / args.requests
        out["per_call"] = per_call
        T.clear_timers()
        _emit(rec, mode, out)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
