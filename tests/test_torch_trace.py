"""The port's spans and counters (``ligero_prover_tpu_torch/utils/timer``):
off without a profiler, nested per request with one, stamped on the
profiler's own clock, exact counts, and the benchmark's readers of them.

    python -m pytest tests/test_torch_trace.py -q

CPU, k=256.
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from bench.e2e_prove import make_wat
from ligero_prover_tpu_torch.params import IV_ANY, RowGeometry
from ligero_prover_tpu_torch.prover import prove
from ligero_prover_tpu_torch.utils import timer as T
from ligero_prover_tpu_torch.verifier import verify
from ligero_prover_tpu_torch.vm.run import make_wat_program
from ligero_prover_tpu_torch.zkp.context import VerifierContext
from ligero_prover_tpu_torch.zkp.executor import TorchExecutor

import _torch_helpers  # noqa: F401  (thread count)

K = 256
SEED = bytes(range(32))
BENCH = Path(__file__).resolve().parent.parent / "proverbench"


@pytest.fixture(scope="module")
def program():
    return make_wat_program(make_wat(3), [], set())


@pytest.fixture(autouse=True)
def cleared():
    T.clear_timers()
    yield
    T.clear_timers()


def _prove(program):
    return prove(program, geometry=RowGeometry(K), encoding_seed=SEED,
                 device="cpu")


def _traced(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, prof


def test_spans_record_exactly_while_a_profiler_runs():
    flag = torch.autograd.profiler
    with T.span("before"):
        T.count("before")
    assert not flag._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag._is_profiler_enabled
        with T.span("during"):
            T.count("during", 3)
    assert not flag._is_profiler_enabled
    with T.span("after"):
        T.count("after")
    assert [r[0] for r in T.spans()] == ["during"]
    assert T.summary()["counters"] == {"during": 3}


def test_off_records_nothing(program):
    before = T.get_timer("stage1")
    res = _prove(program)
    assert res.ok
    assert T.get_timer("stage1") > before
    assert T.spans() == []
    assert T.summary() == {"spans": {}, "counters": {}, "requests": 0}


def test_on_nests_spans_in_one_request(program):
    res, _ = _traced(_prove, program)
    recs = T.spans()
    assert recs and all(r is not None for r in recs)
    names = [r[0] for r in recs]
    assert names[0] == "prover.prove" and names.count("prover.prove") == 1
    for name in ("executor.init", "stage1", "stage2", "stage3", "vm.run",
                 "vm.hostcall", "ctx.flush", "host.wait", "witness.finalize"):
        assert name in names, name
    for name, t0, t1, parent, request in recs:
        assert t0 <= t1 and request == 0
        if name == "prover.prove":
            assert parent is None
            continue
        p = recs[parent]
        assert p[1] <= t0 and t1 <= p[2], (name, p[0])
    parents = {recs[r[3]][0] for r in recs if r[0].startswith("stage")}
    assert parents == {"prover.prove"}
    assert {recs[r[3]][0] for r in recs if r[0] == "vm.run"} <= {
        "stage1", "stage2", "stage3"}
    s = T.summary()
    assert s["requests"] == 1
    assert all(v["self_s"] >= 0 and v["self_s"] <= v["total_s"]
               for v in s["spans"].values())
    assert s["counters"]["ctx.rows"] == res.num_rows
    assert s["counters"]["htod.bytes"] > 0 and s["counters"]["dtoh.bytes"] > 0


def test_two_calls_two_requests(program):
    res = _prove(program)
    executor = TorchExecutor(K, 4 * K, 16, "cpu")

    def both():
        _prove(program)
        return verify(program, res.proof, geometry=RowGeometry(K),
                      executor=executor)
    out, _ = _traced(both)
    assert out.ok
    recs = T.spans()
    tops = [r for r in recs if r[3] is None]
    assert [r[0] for r in tops] == ["prover.prove", "verifier.verify"]
    assert [r[4] for r in tops] == [0, 1]
    assert {r[4] for r in recs} == {0, 1}
    assert "executor.init" not in {r[0] for r in recs if r[4] == 1}
    assert T.summary()["requests"] == 2


def test_span_lies_inside_the_profilers_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        before = time.time_ns()
        with record_function("trace.probe"):
            with T.span("probe"):
                time.sleep(0.002)
        after = time.time_ns()
    (name, t0, t1, _, _), = T.spans()
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() == "trace.probe"
              and e.device_type() == DeviceType.CPU]
    assert len(ranges) == 1
    r0, r1 = ranges[0]
    # one clock: the profiler's range lies between two time_ns() reads
    # around it, and the span inside the range
    assert before <= r0 <= t0 < t1 <= r1 <= after
    assert t1 - t0 >= 2_000_000


def test_self_time_is_less_the_union_of_children():
    rec = T._REC
    rec.spans = [("a", 0, 100, None, None), ("b", 10, 40, 0, None),
                 ("c", 30, 60, 0, None), ("d", 35, 38, 2, None),
                 ("b", 90, 130, 0, None)]
    s = T.summary()["spans"]
    assert s["a"]["count"] == 1
    assert s["a"]["total_s"] == pytest.approx(100e-9)
    assert s["a"]["self_s"] == pytest.approx(40e-9)    # less 10..60, 90..100
    assert s["b"]["count"] == 2 and s["b"]["total_s"] == pytest.approx(70e-9)
    assert s["c"]["self_s"] == pytest.approx(27e-9)


def test_per_request_divides_by_the_requests():
    rec = T._REC
    rec.spans = [("prover.prove", 0, 100, None, 0), ("b", 10, 40, 0, 0),
                 ("prover.prove", 200, 300, None, 1), ("b", 210, 260, 2, 1)]
    assert T.per_request("b", "total_s") is None     # no request counted
    rec.requests = 2
    assert T.per_request("b", "total_s") == pytest.approx(40e-9)
    assert T.per_request("prover.prove", "self_s") == pytest.approx(60e-9)
    assert T.per_request("c", "self_s") is None


def test_one_verifier_flush_uploads_counted_exactly():
    executor = TorchExecutor(K, 4 * K, 16, "cpu")
    gen = np.random.default_rng(5)
    sample_index = sorted(gen.choice(4 * K, 192, replace=False).tolist())
    samplings = np.zeros(16 * 192 * 8, np.uint32)
    vctx = VerifierContext(executor, K - 192, sample_index, samplings)
    vctx.init_witness_random(SEED, IV_ANY)

    def flush():
        for _ in range(16):
            vctx.on_batch_init()
    _traced(flush)
    s = T.summary()
    assert s["spans"]["ctx.flush"]["count"] == 1
    assert s["counters"]["ctx.rows"] == 16
    uploaded = (16 * K * 8 * 4           # the randomness rows
                + 16 * 192 * 8 * 4       # the opened columns
                + 16 * 8 * 4             # code-test scalars
                + 16 * 3 * 8 + 16 * 8 * 4    # triples: indices, scalars
                + 16 * 2 * 8 + 16 * 8 * 4    # pairs: indices, scalars
                + 192 * 8                # the sampled column indices
                + 5 * 8 * 4)             # R^2 of the CPU's five products
    assert s["counters"]["htod.bytes"] == uploaded
    assert s["spans"]["host.wait"]["count"] == 8 + 5


NEW_METRICS = {
    "poseidon2.prove": ["vm_self_s.rows", "hostcall_self_s.rows",
                        "flush_self_s.rows", "host_wait_s.rows",
                        "executor_init_s.rows", "htod_bytes_per_row.prove"],
    "poseidon2.verify": ["vm_self_s.verify", "hostcall_self_s.verify",
                         "flush_self_s.verify", "host_wait_s.verify",
                         "executor_init_s.verify",
                         "htod_bytes_per_row.verify"],
}


@pytest.mark.parametrize("cell", sorted(NEW_METRICS))
def test_traced_cell_reports_its_span_metrics(cell, monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH.parent))
    monkeypatch.syspath_prepend(str(BENCH))
    import harness
    monkeypatch.setenv("LIGERO_PROOF_TIMESTAMP", harness.PROOF_TIMESTAMP)
    result, _ = harness.execute(
        harness.Cell.load(cell), 2**31 + 977, 0.1, True, device="cpu",
        k=K, guest_params={"full_rounds": 1, "partial_rounds": 1})
    assert result["correct"] is True
    metrics = result["metrics"]
    for name in NEW_METRICS[cell]:
        assert metrics.get(name, {}).get("value") is not None, name
        assert metrics[name]["value"] > 0, name
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in harness.benchmark_spec()["per_layer"]
                 if cell in m.get("workloads", [])}
    assert set(NEW_METRICS[cell]) <= per_layer
