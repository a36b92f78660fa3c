#!/usr/bin/env python3
"""Profile the port's prove on one GPU: the planar butterfly path, the AoS
path, the planar path with the int8 encode engine and the column-sharded
prover (4 shards on cuda:(i % cards)), side by side.

    python3 profile_prove.py [--rounds 60] [--out build/profile.json]
                             [--configs planar,aos,planar+mxu,planar+mesh4]
                             [--walls 0]

For each configuration of ``ops.ntt.USE_PLANAR``, ``ops.ntt.USE_MXU`` and
the shard count on the vbn254fr guest of ``chip_smoke.make_wat`` at
k=8192: one warm-up prove;
one timed prove (wall and stage seconds, the port's launch counters, the
tiled mode's launches by call shape); one
prove under ``torch.profiler`` (device kernel time, kernel count, the top
device ops, the device ms and launches of each of the port's own
kernels and of the library's row gathers and concatenations); and, before any prove, one 16-row k->n encode as the
pipelines call it, timed by the host clock and by CUDA events, with its
device kernels by name (the int8 engine's three ``torch._int_mm`` products
show under their library names).  The device busy share is the profiled kernel time over the
unprofiled prove wall.  ``--walls N`` adds N more unprofiled proves per
configuration, taken in turns over the configurations, and reports each
one's walls and their median.  Prints one JSON object per configuration,
and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

from chip_smoke import configuration, device_time_us as _device_time_us, \
    make_wat, wat_program

K = 8192


# name -> (USE_PLANAR, USE_MXU, shards: 0 for the single-device executor)
CONFIGS = {"planar": (True, False, 0), "aos": (False, False, 0),
           "planar+mxu": (True, True, 0), "planar+mesh4": (True, False, 4)}


def _mesh(shards: int):
    """`shards` shards on cuda:(i % cards), or None for one device."""
    import torch
    from ligero_prover_tpu_torch.parallel.mesh import make_mesh
    if not shards:
        return None
    cards = torch.cuda.device_count()
    return make_mesh([torch.device("cuda", i % cards)
                      for i in range(shards)])


def _by_device_time(events, top: int) -> list:
    """The `top` device ops of a profile: (name, ms, count)."""
    return [(e.key[:60], round(_device_time_us(e) / 1e3, 3), e.count)
            for e in sorted(events, key=_device_time_us, reverse=True)[:top]]


def port_kernels(events) -> dict:
    """Device ms and launches of each of the port's own kernels in a
    profile, by namespace, name and template arguments."""
    out = {}
    for e in events:
        m = re.search(r"ligero_\w+::\w+(?:<[^>]*>)?", e.key)
        if m:
            ms, count = out.get(m.group(0), (0.0, 0))
            out[m.group(0)] = (ms + _device_time_us(e) / 1e3, count + e.count)
    return out


# library kernels by a fragment of their profiler name: the row gathers
# and concatenations, of which quad-terms took over the check's on the
# planar path
ATEN_KERNELS = {"index_select": "indexSelect", "cat": "CatArrayBatchedCopy"}


def aten_kernels(events) -> dict:
    """Device ms and launches of the library kernels of ATEN_KERNELS."""
    out = {}
    for name, frag in ATEN_KERNELS.items():
        hits = [e for e in events if frag in e.key]
        out[name] = (sum(_device_time_us(e) for e in hits) / 1e3,
                     sum(e.count for e in hits))
    return out


def encode_times(planar: bool, mxu: bool, shards: int,
                 iters: int = 5) -> dict:
    """One 16-row k->n encode: median host ms, median CUDA-event ms and
    its device kernels by name (sharded: the iNTT once and every shard's
    coset encode)."""
    import numpy as np
    import torch
    from ligero_prover_tpu_torch.field import bn254 as F
    from ligero_prover_tpu_torch.ops import mxu_ntt, ntt
    codec = ntt.RSCodec(K, 4 * K, torch.device("cuda", 0))
    gen = np.random.default_rng(1)
    raw = gen.integers(0, 2 ** 32, (16, K, 8), dtype=np.uint64)
    raw[..., 7] %= F.MODULUS >> 224                   # canonical: < p
    rows = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).cuda()

    mesh = _mesh(shards)
    cosets = [] if mesh is None else [
        (dev, ntt.coset_tables(K, 4 * K, mesh.size, d, dev))
        for d, dev in enumerate(mesh.devices)]

    def encode():
        if cosets:
            c = ntt.coset_coeffs(rows, codec.dom_k, True)
            return [ntt.encode_rows_coset_planar_core(c.to(dev), tabs)
                    for dev, tabs in cosets]
        if mxu:
            return mxu_ntt.encode_rows_mxu_core(rows, codec.mxu_tabs, 4 * K)
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        encode()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"encode16_host_ms": statistics.median(host),
            "encode16_event_ms": statistics.median(dev),
            "encode16_kernels": sum(e.count for e in ops),
            "encode16_device_ops": _by_device_time(ops, 16)}


def _prove(prog, geo, shards: int):
    import torch
    from ligero_prover_tpu_torch.prover import prove
    res = prove(prog, geometry=geo, encoding_seed=bytes(32), device="cuda",
                mesh=_mesh(shards))
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    if not res.ok:
        raise RuntimeError("prove self-check failed")
    return res


def profile_config(name: str, rounds: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ligero_prover_tpu_torch.ops import fieldmul as fm, sha256 as sha, \
        mxu_renorm as mr
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.utils import timer as T

    planar, mxu, shards = CONFIGS[name]
    geo = RowGeometry(K)
    prog = wat_program(make_wat(rounds))
    out = {"config": name, "rounds": rounds}
    with configuration(planar, mxu):
        def run():
            return _prove(prog, geo, shards)

        run()                                             # warm-up
        T.clear_timers()
        for module in (fm, sha, mr):
            module.reset_counts()
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        counted = {**fm.LAUNCHES, **sha.LAUNCHES, **mr.LAUNCHES}
        out.update(rows=res.num_rows, prove_s=wall,
                   stages_s={s: T.get_timer(s)
                             for s in ("stage1", "stage2", "stage3")},
                   kernel_wrapper_launches=counted,
                   tiled_launches_by_shape={
                       f"{b}x{w}": c for (b, w), c in
                       fm.TILED_SHAPES.items()})
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
        kb_us = sum(_device_time_us(e) for e in dev
                    if "ligero_pl::pass_kernel" in e.key)
        out.update(device_kernel_s=kernel_us / 1e6,
                   kb_device_s=kb_us / 1e6,
                   kb_launches=sum(e.count for e in dev
                                   if "ligero_pl::pass_kernel" in e.key),
                   device_busy_share=kernel_us / 1e6 / wall,
                   device_kernels=n_kernels,
                   device_kernels_per_row=n_kernels / res.num_rows,
                   top_device_ops=_by_device_time(dev, 12),
                   port_kernels=port_kernels(dev),
                   aten_kernels=aten_kernels(dev))
    return out


def extra_walls(names: list, rounds: int, count: int) -> dict:
    """`count` more unprofiled prove walls per configuration, taken in
    turns (a, b, ..., a, b, ...) so that drift of the host hits all
    alike.  Every configuration has been warmed up by its profile."""
    from ligero_prover_tpu_torch.params import RowGeometry
    geo = RowGeometry(K)
    prog = wat_program(make_wat(rounds))
    walls = {name: [] for name in names}
    for _ in range(count):
        for name in names:
            planar, mxu, shards = CONFIGS[name]
            with configuration(planar, mxu):
                t0 = time.perf_counter()
                _prove(prog, geo, shards)
                walls[name].append(time.perf_counter() - t0)
    return walls


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--out", default="build/profile.json")
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--walls", type=int, default=0)
    args = ap.parse_args()
    names = args.configs.split(",")
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    # the encodes first: a short trace taken after a prove's long one
    # came back with kernels missing
    encodes = {name: encode_times(*CONFIGS[name]) for name in names}
    results = []
    for name in names:
        r = profile_config(name, args.rounds)
        r.update(encodes[name], card=card)
        results.append(r)
    if args.walls:
        walls = extra_walls(names, args.rounds, args.walls)
        for r in results:
            r["prove_walls_s"] = walls[r["config"]]
            r["prove_wall_median_s"] = statistics.median(walls[r["config"]])
    for r in results:
        print(json.dumps(r), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
