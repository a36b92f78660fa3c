"""The benchmark's harness: cells found by name, the closed-loop window, the
profiler's reading and the result line.

Everything that belongs to one configuration, traffic mix, mode or metric
lives in a file of its own under this folder and is found by the name that
``BENCHMARK.json`` and the cell's file give:

    configs/<config>.json     the deployment: geometry, guest, guarantees
    traffic/<traffic>.json    the mix: mode, clients, warm-up, set-up proofs
    workloads/<cell>.json     the cell: its config, traffic, checks, limits
    modes/<mode>.py           setup(), call(), check() of one kind of traffic
    metrics/<metric>.py       read(run): one metric from the run's record
    guests/                   the guests' WAT and generators

The window is closed-loop: one client calls the mode until ``seconds`` have
passed and lets the last call finish; every rate divides all the work by
that whole time.  With tracing on, the same window runs under
``torch.profiler``, with ranges that this file places around the program's
stages and post-stage calls and around the executor's encode entries.
"""

from __future__ import annotations

import bisect
import hashlib
import importlib.util
import json
import random
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# Top-level module names that no run may hold once its window has closed:
# the JAX package, JAX itself and the old benchmark of the JAX package.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ligero_prover_tpu", "bench"})
# The proof's metadata carries a timestamp (LIGERO_PROOF_TIMESTAMP): fixed,
# so that a seed fixes the proof bytes of the program and the reference.
PROOF_TIMESTAMP = "1700000000"


def forbidden_modules(names=None) -> list[str]:
    """Modules whose top-level name (before the first dot), compared whole,
    is forbidden."""
    names = sys.modules if names is None else names
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


# ---- data found by name -------------------------------------------------

def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    key = f"proverbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def benchmark_spec() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def metrics_of(spec: dict, cell: str, kind: str) -> list[dict]:
    """The cell's end-to-end (`kind` "end_to_end") or per-layer metrics: an
    entry with `workloads` names its cells; one without names every cell
    (end-to-end) or every cell that reports the metric it moves
    (per-layer)."""
    e2e = {m["name"] for m in metrics_of_e2e(spec, cell)}
    if kind == "end_to_end":
        return metrics_of_e2e(spec, cell)
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def metrics_of_e2e(spec: dict, cell: str) -> list[dict]:
    return [m for m in spec["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    mode: object

    @classmethod
    def load(cls, name: str) -> "Cell":
        w = load_json("workloads", name)
        t = load_json("traffic", w["traffic"])
        return cls(name, w, load_json("configs", w["config"]), t,
                   load_module("modes", t["mode"]))


@dataclass
class Context:
    """What a mode is given: the cell, the seed, the device and the row
    geometry (the configuration's packing unless a test sets a smaller
    one)."""
    cell: Cell
    seed: int
    device: str
    k: int
    guest_params: dict = field(default_factory=dict)

    @property
    def batch_rows(self) -> int:
        return int(self.cell.config["batch_rows"])

    def rng(self, purpose: str) -> random.Random:
        return random.Random(f"{purpose}:{self.seed}")

    def encoding_seed(self, index: int) -> bytes:
        """Proof `index`'s encoding seed (set-up and warm-up calls take
        negative indices)."""
        return hashlib.sha256(
            f"proverbench:{self.seed}:{index}".encode()).digest()

    def guest(self) -> tuple[str, list[bytes]]:
        """The guest's WAT text, from its file or its generator, and its
        arguments."""
        g = self.cell.config["guest"]
        if "wat" in g:
            src = (ROOT / g["wat"]).read_text()
        else:
            gen = load_module("guests", Path(g["generator"]).stem)
            lanes = self.k - int(self.cell.config["sample_size"])
            src = gen.make({**g.get("params", {}), **self.guest_params,
                            "lanes": lanes, "device": self.device},
                           self.rng("guest"))
        return src, [bytes.fromhex(a) for a in self.cell.config["args_hex"]]


def differing_bytes(a: bytes, b: bytes) -> int:
    """The bytes in which `a` and `b` differ, the length's difference
    counted as bytes that differ."""
    import numpy as np
    n = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, n)
    y = np.frombuffer(b, np.uint8, n)
    return int(np.count_nonzero(x != y)) + abs(len(a) - len(b))


def synchronize(device: str):
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


# ---- ranges placed around the program's calls (traced runs) ------------

# (module, attribute path, label): the stage timers become ranges of their
# own names; the rest get the label given.
RANGES = [
    ("ligero_prover_tpu_torch.prover", "timer", None),
    ("ligero_prover_tpu_torch.verifier", "timer", None),
    ("ligero_prover_tpu_torch.prover", "MerkleTree.decommit",
     "post.decommit"),
    ("ligero_prover_tpu_torch.prover", "MerkleTree", "merkle_tree"),
    ("ligero_prover_tpu_torch.prover", "portable_sample", "post.sample"),
    ("ligero_prover_tpu_torch.prover", "limbs_to_ints", "post.to_ints"),
    ("ligero_prover_tpu_torch.prover", "serialize_proof", "post.serialize"),
    ("ligero_prover_tpu_torch.zkp.executor", "TorchExecutor.decode",
     "post.decode"),
    ("ligero_prover_tpu_torch.verifier", "deserialize_proof",
     "post.deserialize"),
    ("ligero_prover_tpu_torch.verifier", "recommit", "post.recommit"),
    ("ligero_prover_tpu_torch.verifier", "limbs_to_ints", "post.to_ints"),
]
# The executor's encode entries, whose kernels the encode's roofline counts.
ENCODE_ENTRIES = [("ligero_prover_tpu_torch.zkp.executor", "_encode_planes"),
                  ("ligero_prover_tpu_torch.zkp.executor", "_encode_aos")]
ENCODE = "encode"
WINDOW = "window"


class Wrappers:
    """Installs the ranges and the encode's call-shape record; `restore`
    puts every original back.  A target that is not there is reported on
    stderr and skipped."""

    def __init__(self):
        self._undo: list = []
        self.encode_calls: list[tuple[int, int, int]] = []   # (B, w, n)

    def _target(self, module: str, path: str):
        obj = importlib.import_module(module)
        *owners, attr = path.split(".")
        for o in owners:
            obj = getattr(obj, o)
        if not hasattr(obj, attr):
            raise AttributeError(path)
        return obj, attr

    def _set(self, obj, attr, new):
        self._undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    def install(self):
        from torch.profiler import record_function
        import contextlib
        for module, path, label in RANGES:
            try:
                obj, attr = self._target(module, path)
            except (ImportError, AttributeError):
                print(f"range {label or path}: no {module}.{path} to wrap",
                      file=sys.stderr)
                continue
            orig = getattr(obj, attr)
            if label is None:                     # a stage timer
                @contextlib.contextmanager
                def staged(name, _orig=orig):
                    with record_function(name), _orig(name):
                        yield
                self._set(obj, attr, staged)
            else:                                 # a function or a class
                def ranged(*a, _orig=orig, _label=label, **kw):
                    with record_function(_label):
                        return _orig(*a, **kw)
                self._set(obj, attr, ranged)
        for module, name in ENCODE_ENTRIES:
            try:
                obj, attr = self._target(module, name)
            except (ImportError, AttributeError):
                print(f"range {ENCODE}: no {module}.{name} to wrap",
                      file=sys.stderr)
                continue

            def encode(rows, dom_msg, dom_n, n, *a, _orig=getattr(obj, attr),
                       **kw):
                self.encode_calls.append(
                    (int(rows.shape[0]), int(rows.shape[1]), int(n)))
                with record_function(ENCODE):
                    return _orig(rows, dom_msg, dom_n, n, *a, **kw)
            self._set(obj, attr, encode)

    def restore(self):
        for obj, attr, old in reversed(self._undo):
            setattr(obj, attr, old)
        self._undo.clear()


# ---- the profiler's reading --------------------------------------------

STAGES = ("stage1", "stage2", "stage3", "verify")
LABELS = frozenset({WINDOW, ENCODE, *STAGES,
                    *(label for _, _, label in RANGES if label)})


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: int = 0
    encode_device_s: float = 0.0
    top_ops: list = field(default_factory=list)
    idle_by_range: list = field(default_factory=list)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(events) -> Trace:
    """Reduce the profiler's events (``kineto_results.events()``) of one
    window to the device's busy time (the union of its operations'
    intervals), its operations (kernels, memcpys, memsets), the device time
    of the kernels launched inside the encode ranges (by the CUDA API call
    that launched each), the operations that took most time, and the idle
    time by the host range it fell in (the innermost around its middle)."""
    from torch.autograd import DeviceType
    window = None
    ranges, encode, launches, device = [], [], {}, []
    for e in events:
        name = e.name()
        if name in LABELS:                  # a range, on the host or device
            if e.device_type() != DeviceType.CPU:
                continue
            span = (e.start_ns(), e.start_ns() + e.duration_ns())
            if name == WINDOW:
                window = span
            elif name == ENCODE:
                encode.append(span)
            else:
                ranges.append((span[0], span[1], name))
        elif e.device_type() == DeviceType.CUDA:
            device.append(e)
        elif name.startswith("cu"):         # a CUDA runtime or driver call
            launches[e.correlation_id()] = e.start_ns()
    if window is None:
        return Trace()
    w0, w1 = window
    encode.sort()
    starts = [s for s, _ in encode]
    spans, by_name, enc_ns = [], {}, 0
    for e in device:
        s = e.start_ns()
        t = s + e.duration_ns()
        if t <= w0 or s >= w1:
            continue
        spans.append((max(s, w0), min(t, w1)))
        by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
        launched = launches.get(e.correlation_id())
        if launched is not None:
            i = bisect.bisect_right(starts, launched) - 1
            if i >= 0 and encode[i][0] <= launched <= encode[i][1]:
                enc_ns += e.duration_ns()
    busy = _merge(spans)
    busy_ns = sum(e - s for s, e in busy)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if prev < w1:
        gaps.append((prev, w1))
    ranges.sort()
    rstarts = [r[0] for r in ranges]
    longest = max((r[1] - r[0] for r in ranges), default=0)
    idle: dict[str, int] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        best = None
        for j in range(bisect.bisect_right(rstarts, mid) - 1, -1, -1):
            r0, r1, name = ranges[j]
            if mid - r0 > longest:
                break
            if mid <= r1 and (best is None or r1 - r0 < best[1] - best[0]):
                best = (r0, r1, name)
        label = best[2] if best else "outside_stages"
        idle[label] = idle.get(label, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                 device_ops=len(spans), encode_device_s=enc_ns / 1e9,
                 top_ops=[[n, v / 1e9] for n, v in top],
                 idle_by_range=[[n, v / 1e9] for n, v in sorted(
                     idle.items(), key=lambda kv: -kv[1])[:10]])


# ---- one run -------------------------------------------------------------

@dataclass
class Run:
    """The record that the metric readers read."""
    k: int
    setup_s: float
    records: list = field(default_factory=list)      # one per timed call
    elapsed_s: float = 0.0
    trace: Trace | None = None
    encode_calls: list = field(default_factory=list)

    @property
    def rows(self) -> int:
        return sum(r["rows"] for r in self.records)


def quantile(values, q: float) -> float:
    """The q-quantile of all values (linear between order statistics)."""
    return statistics.quantiles(values, n=100, method="inclusive")[
        round(q * 100) - 1] if len(values) > 1 else values[0]


def window(ctx: Context, state, seconds: float, run: Run):
    mode = ctx.cell.mode
    start = time.perf_counter()
    index = 0
    while True:
        rec = mode.call(state, index)
        run.records.append(rec)
        index += 1
        if time.perf_counter() - start >= seconds:
            break
    run.elapsed_s = time.perf_counter() - start


def execute(cell: Cell, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", k: int | None = None,
            guest_params: dict | None = None,
            t_start: float | None = None) -> tuple[dict, list[str]]:
    """Run one cell once; returns the result object and the lines that
    print each compared number beside its limit.  `k` and `guest_params`
    shrink the cell for the CPU tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    ctx = Context(cell, seed, device, k or int(cell.config["packing"]),
                  guest_params or {})
    mode = cell.mode
    marks = [("start", time.perf_counter() - t_start)]
    state = mode.setup(ctx)
    marks.append(("mode set-up", time.perf_counter() - t_start))
    for j in range(int(cell.traffic.get("warmup_calls", 0))):
        mode.call(state, -1 - j, warmup=True)
    synchronize(device)
    run = Run(k=ctx.k, setup_s=time.perf_counter() - t_start)
    marks.append(("warm-up", run.setup_s))
    print("proverbench: set-up at " + ", ".join(
        f"{name} {t:.3f} s" for name, t in marks), file=sys.stderr)
    wrappers = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        wrappers = Wrappers()
        wrappers.install()
        acts = [ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                window(ctx, state, seconds, run)
                synchronize(device)
        wrappers.restore()
        run.encode_calls = wrappers.encode_calls
        run.trace = read_trace(prof.profiler.kineto_results.events())
        del prof
    else:
        window(ctx, state, seconds, run)
    dev = device_info(device, run.trace)
    t_check = time.perf_counter()
    checks = mode.check(state, run.records)
    print("proverbench: walls " + " ".join(
        f"{r['wall']:.3f}" for r in run.records), file=sys.stderr)
    print(f"proverbench: {len(run.records)} calls of {run.rows} rows in "
          f"{run.elapsed_s:.3f} s after {run.setup_s:.3f} s of set-up; "
          f"the reference's check "
          f"took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    limits = cell.workload["limits"]
    compared = {name: {"value": value, "limit": limits[name]}
                for name, value in checks.items()}
    failed = sum(1 for r in run.records if not r["ok"])
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in compared.values())
    spec = benchmark_spec()
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(spec, cell.name, kind):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(run.records),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_ops,
                               "idle_gaps": run.trace.idle_by_range}
    result["checks"] = compared
    lines = [f"check {name}: {c['value']} (limit {c['limit']})"
             for name, c in compared.items()]
    return result, lines


def device_info(device: str, trace: Trace | None) -> dict:
    if not device.startswith("cuda"):
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    else:
        import torch
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info
