"""CPU tests of the benchmark's harness and reference.

    python -m pytest proverbench -q

They shrink the cells (packing 256: 64 lanes; one full round at each end
and one partial round) and run the port's plain CPU paths; the one test that needs the card carries the `cuda` marker and
skips without one.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))
import harness  # noqa: E402
import roofline  # noqa: E402

os.environ["LIGERO_PROOF_TIMESTAMP"] = harness.PROOF_TIMESTAMP

SPEC = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SEED = 2**31 + 977          # beyond 32 signed bits, as the driver's are
SMALL = {"full_rounds": 1, "partial_rounds": 1}
PROVE, VERIFY = "poseidon2.prove", "poseidon2.verify"


# ---- the files, found by name -------------------------------------------

def test_benchmark_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["proverbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_loads_by_name(cell):
    c = harness.Cell.load(cell)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert c.workload["config"] == entry["config"] == c.config["name"]
    assert c.workload["traffic"] == entry["traffic"]
    for fn in ("setup", "call", "check"):
        assert callable(getattr(c.mode, fn))
    reported = harness.metrics_of(SPEC, cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert harness.metrics_of(SPEC, cell, "per_layer")


@pytest.mark.parametrize("config", SPEC["configs"],
                         ids=lambda c: c["name"])
def test_config_file(config):
    path = HERE.parent / config["file"]
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert data["packing"] == 8192 and data["sample_size"] == 192


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"]
                                    + SPEC["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    reader = harness.load_module("metrics", metric)
    empty = harness.Run(k=256, setup_s=1.0)
    value = reader.read(empty)
    assert value is None or metric == "setup_s"


# ---- the import check ---------------------------------------------------

@pytest.mark.parametrize("name,bad", [
    ("ligero_prover_tpu", True), ("ligero_prover_tpu.zkp.executor", True),
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax", True),
    ("bench", True), ("bench.e2e_prove", True),
    ("ligero_prover_tpu_torch", False),
    ("ligero_prover_tpu_torch.zkp.executor", False),
    ("benchmark", False), ("jaxtyping", False), ("flaxen", False)])
def test_import_check_compares_top_level_names_whole(name, bad):
    assert harness.forbidden_modules([name]) == ([name] if bad else [])


# ---- the roofline's count and the trace's reading ------------------------

def test_encode_products():
    # k = 8192: 4096*13 + 8192 + 16384*15 Montgomery products a row
    assert roofline.encode_products(1, 8192, 32768) == 307_200 * 164
    assert roofline.encode_products(2, 16384, 32768) == \
        2 * (8192 * 14 + 16384 + 16384 * 15) * 164


# ---- the guest ------------------------------------------------------------

def test_poseidon2_digest_is_the_sdk_instance():
    g = harness.load_module("guests", "poseidon2")
    # the digest that the port's tests' poseidon2.wat asserts for 12345
    assert g.digest(g._Ints, 12345, 4, 56) == int(
        "087c15ba45847b76952538b50ff7ebb3e26e9e0094a97c681048ce918b2bd4a8",
        16)


def test_poseidon2_guest_lanes_differ_and_follow_the_seed():
    import random
    g = harness.load_module("guests", "poseidon2")
    params = {**SMALL, "lanes": 64, "device": "cpu"}
    a = g.make(params, random.Random("guest:1"))
    assert a == g.make(params, random.Random("guest:1"))
    assert a != g.make(params, random.Random("guest:2"))
    msgs = [int.from_bytes(bytes.fromhex(h), "big") for h in re.findall(
        r"[0-9a-f]{64}", re.sub(r"\\", "", a.split(
            f'(data (i32.const {g.MSGBUF}) "')[1].split('"')[0]))]
    assert len(msgs) == 64 and len(set(msgs)) == 64
    want = g.digests(msgs, "cpu", 1, 1)
    assert want == [g.digest(g._Ints, m, 1, 1) for m in msgs]


class _Ev:
    def __init__(self, name, dev, start, dur, corr=0):
        from torch.autograd import DeviceType
        self._n, self._s, self._d, self._c = name, start, dur, corr
        self._t = DeviceType.CUDA if dev else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._t

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


def test_read_trace():
    evs = [_Ev("window", 0, 0, 1000), _Ev("stage1", 0, 0, 500),
           _Ev("encode", 0, 100, 100), _Ev("post.serialize", 0, 600, 300),
           _Ev("cudaLaunchKernel", 0, 150, 5, corr=7),
           _Ev("cudaLaunchKernel", 0, 300, 5, corr=8),
           _Ev("kb", 1, 200, 50, corr=7), _Ev("kb", 1, 220, 50, corr=9),
           _Ev("other", 1, 400, 100, corr=8),
           _Ev("encode", 1, 100, 100)]          # a device-side annotation
    t = harness.read_trace(evs)
    assert t.window_s == 1000 / 1e9
    assert t.busy_s == 170 / 1e9                # [200, 270) and [400, 500)
    assert t.device_ops == 3
    assert t.encode_device_s == 50 / 1e9        # only the kernel of corr 7
    assert t.top_ops[0] == ["kb", 100 / 1e9]
    idle = dict(t.idle_by_range)
    assert idle["stage1"] == (200 + 130) / 1e9
    assert idle["post.serialize"] == 500 / 1e9


def test_quantile():
    assert harness.quantile([float(i) for i in range(1, 101)], 0.9) == \
        pytest.approx(90.1)


# ---- the reference against the port, and a whole run ---------------------

@pytest.mark.parametrize("cell", [PROVE])
def test_reference_agrees_with_port(cell):
    from ligero_prover_tpu_torch.params import RowGeometry
    from ligero_prover_tpu_torch.prover import prove
    from ligero_prover_tpu_torch.vm.run import make_wat_program
    from reference import prover as ref
    c = harness.Cell.load(cell)
    ctx = harness.Context(c, SEED, "cpu", 256, SMALL)
    src, args = ctx.guest()
    res = prove(make_wat_program(src, args, set()),
                geometry=RowGeometry(256), encoding_seed=ctx.encoding_seed(0),
                device="cpu")
    guest = ref.Guest(src, args)
    mine = ref.prove(guest, 256, ctx.encoding_seed(0), "cpu")
    assert mine.ok and res.ok and mine.num_rows == res.num_rows
    assert mine.proof == res.proof
    assert ref.verify(guest, 256, res.proof, "cpu")
    vm = harness.load_module("modes", "verify")
    assert not ref.verify(guest, 256, vm.tamper(res.proof), "cpu")
    assert ref.verify(guest, 256, vm.tamper(res.proof), "cpu",
                      check_merkle=False)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    result, lines = harness.execute(harness.Cell.load(PROVE), SEED, 0.1,
                                    trace, device="cpu", k=256,
                                    guest_params=SMALL)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if trace else ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"setup_s", "prove_rows_per_s"}
    assert lines == [f"check {n}: 0 (limit 0)"
                     for n in result["checks"]]
    json.dumps(result)


def test_run_refuses_without_a_card():
    if _cuda():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         PROVE, "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=HERE.parent)
    assert out.returncode != 0 and out.stdout == ""


# ---- the controls and the faults: each makes `correct` false --------------

@pytest.mark.parametrize("cell", [PROVE, VERIFY])
def test_control_fails_the_check(cell):
    import control
    r = control.readings(cell, SEED, "cpu", 256, SMALL)
    assert r["value"] > r["limit"]


def _broken_commit(orig):
    def commit_step(self, sha, rows, valid_count, **kw):   # state unchanged
        orig(self, sha, rows, valid_count, **kw)
        return sha
    return commit_step


def _broken_check(orig):
    def check_step(self, accs, rows, *a, **kw):            # half the batch
        import numpy as np
        rows = rows.clone() if hasattr(rows, "clone") else np.array(rows)
        rows[1::2] = 0                      # every other row of the flush
        return orig(self, accs, rows, *a, **kw)
    return check_step


def _broken_proof(orig):
    def serialize_proof(*a, **kw):                          # answer altered
        blob = orig(*a, **kw)
        return blob[:-9] + bytes([blob[-9] ^ 1]) + blob[-8:]
    return serialize_proof


def _broken_verify_step(orig):
    def verify_step(self, sha, accs, *a, **kw):            # state unchanged
        _, new_accs = orig(self, sha, accs, *a, **kw)
        return sha, new_accs
    return verify_step


def _flipped_verdict(orig):
    def verify(*a, **kw):                                   # answer altered
        res = orig(*a, **kw)
        return SimpleNamespace(ok=not res.ok)
    return verify


@pytest.mark.parametrize("cell,module,attr,breaker", [
    (PROVE, "ligero_prover_tpu_torch.zkp.executor",
     "TorchExecutor.commit_step", _broken_commit),
    (PROVE, "ligero_prover_tpu_torch.zkp.executor",
     "TorchExecutor.check_step", _broken_check),
    (PROVE, "ligero_prover_tpu_torch.prover",
     "serialize_proof", _broken_proof),
    (VERIFY, "ligero_prover_tpu_torch.zkp.executor",
     "TorchExecutor.verify_step", _broken_verify_step),
    (VERIFY, "ligero_prover_tpu_torch.verifier", "verify",
     _flipped_verdict)],
    ids=["prove-state-unchanged", "prove-half-batch", "prove-answer-altered",
         "verify-state-unchanged", "verify-answer-altered"])
def test_fault_makes_run_incorrect(cell, module, attr, breaker, monkeypatch):
    import importlib
    obj = importlib.import_module(module)
    *owners, name = attr.split(".")
    for o in owners:
        obj = getattr(obj, o)
    if cell == VERIFY:
        # the set-up's proofs come from the unbroken prover
        c = harness.Cell.load(cell)
        ctx = harness.Context(c, SEED, "cpu", 256, SMALL)
        state = c.mode.setup(ctx)
        monkeypatch.setattr(obj, name, breaker(getattr(obj, name)))
        records = [c.mode.call(state, i) for i in range(3)]
        checks = c.mode.check(state, records)
        assert checks["verdicts_wrong"] > c.workload["limits"][
            "verdicts_wrong"]
        return
    monkeypatch.setattr(obj, name, breaker(getattr(obj, name)))
    result, _ = harness.execute(harness.Cell.load(cell), SEED, 0.1, False,
                                device="cpu", k=256, guest_params=SMALL)
    assert result["correct"] is False


# ---- on the card ---------------------------------------------------------

def _cuda() -> bool:
    import torch
    return torch.cuda.is_available()


@pytest.mark.cuda
def test_cell_on_card():
    if not _cuda():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         PROVE, "--seed", str(SEED), "--seconds", "3",
         "--trace", "1"], capture_output=True, text=True, cwd=HERE.parent,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
