"""The benchmark's SHA-256 guest (``proverbench/guests/sha256.py``) on the
port's interpreter, its cell's mode against the plain reference, and the
witness path's counters and span.

    python -m pytest tests/test_sha256_guest.py -q

CPU only: the digests at 64 rounds under ``NullContext(k=8192)``; proofs at
k=256 with the rounds cut to one and a 4-byte message.
"""

import hashlib
import random
import sys
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

from ligero_prover_tpu_torch.params import RowGeometry
from ligero_prover_tpu_torch.prover import prove
from ligero_prover_tpu_torch.utils import timer as T
from ligero_prover_tpu_torch.vm.run import make_wat_program
from ligero_prover_tpu_torch.vm.values import WasmTrap
from ligero_prover_tpu_torch.zkp.context import NullContext

import _torch_helpers  # noqa: F401  (thread count)

BENCH = Path(__file__).resolve().parent.parent / "proverbench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))
import harness  # noqa: E402
from reference import secret as S  # noqa: E402

G = harness.load_module("guests", "sha256")

K = 256
SEED = 2**31 + 977
SMALL = {"message_bytes": 4, "rounds": 1}
# the padding's boundaries: empty, the longest one-block tail, the
# shortest two-block tail, one whole block, a whole block and the longest
# two-block tail, the configuration's message
LENGTHS = [0, 55, 56, 64, 119, 512]


def _message(n: int) -> bytes:
    return G.message({"message_bytes": n}, random.Random(n))


def _run(src: str, message: bytes, private: set, strict: bool = True):
    ctx = NullContext(k=8192)
    make_wat_program(src, [message], private, strict=strict)(ctx)
    return ctx


@pytest.mark.parametrize("secret", [False, True], ids=["public", "secret"])
@pytest.mark.parametrize("n", LENGTHS)
def test_guest_states_hashlibs_digest(n, secret):
    message = _message(n)
    want = hashlib.sha256(message).digest()
    assert S.sha256(message) == want
    ctx = _run(G.make({"rounds": 64}, want), message,
               {0} if secret else set())
    m = ctx.backend.manager
    elements = m.linear_counter + 3 * m.quadratic_counter
    if secret and n:
        assert elements > 10_000        # the witness path, every block
    else:
        assert elements < 100           # the 8 asserted words only


@pytest.mark.parametrize("secret", [False, True], ids=["public", "secret"])
def test_wrong_stated_digest_fails(secret, capsys):
    message = _message(64)
    good = hashlib.sha256(message).digest()
    bad = good[:31] + bytes([good[31] ^ 1])
    src = G.make({"rounds": 64}, bad)
    private = {0} if secret else set()
    _run(src, message, private, strict=False)
    assert capsys.readouterr().err.count("Assertion failed") == 1
    with pytest.raises(WasmTrap, match="1 assertion failures"):
        _run(src, message, private)


@pytest.mark.parametrize("rounds", [1, 5, 16, 17, 40])
def test_reduced_rounds_give_the_references_digest(rounds):
    for n in (0, 56, 119):
        message = _message(n)
        _run(G.make({"rounds": rounds}, S.sha256(message, rounds)),
             message, {0})


def test_cell_proof_equals_reference(monkeypatch):
    monkeypatch.setenv("LIGERO_PROOF_TIMESTAMP", harness.PROOF_TIMESTAMP)
    cell = harness.Cell.load("sha256.prove")
    assert cell.config["private_args"] == [0]
    result, lines = harness.execute(cell, SEED, 0.1, True, device="cpu",
                                    k=K, guest_params=SMALL)
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"] == {
        "proof_bytes_differing": {"value": 0, "limit": 0}}
    metrics = result["metrics"]
    for name in ("witness_us_per_element.sha256", "row_limbs_s.sha256"):
        assert metrics[name]["value"] > 0, name


def test_wrong_stated_digest_fails_the_self_check():
    ctx = harness.Context(harness.Cell.load("sha256.prove"), SEED, "cpu", K,
                          SMALL)
    src, args = harness.load_module("modes", "prove_secret").setup(ctx).guest
    stated = S.sha256(args[0], SMALL["rounds"])
    assert src == G.make(SMALL, stated)
    bad = G.make(SMALL, stated[:31] + bytes([stated[31] ^ 0x80]))
    res = prove(make_wat_program(bad, args, {0}), geometry=RowGeometry(K),
                encoding_seed=ctx.encoding_seed(0), device="cpu")
    assert not res.ok


def test_control_reads_above_the_limit():
    """The reading of the cell's limit with a guarantee broken: the
    reference opening 191 columns."""
    mode = harness.load_module("modes", "prove_secret")
    ctx = harness.Context(harness.Cell.load("sha256.prove"), SEED, "cpu", K,
                          SMALL)
    state = mode.setup(ctx)
    sound, control = (mode.reference_proofs(state, [0], **kw)[0]
                      for kw in ({}, {"openings": 191}))
    assert sound.ok
    assert harness.differing_bytes(control.proof, sound.proof) > 0


def _traced_prove(program):
    T.clear_timers()
    with profile(activities=[ProfilerActivity.CPU]):
        res = prove(program, geometry=RowGeometry(K),
                    encoding_seed=bytes(32), device="cpu")
    s = T.summary()
    T.clear_timers()
    return res, s


def test_witness_elements_and_limb_spans():
    message = _message(SMALL["message_bytes"])
    src = G.make(SMALL, S.sha256(message, SMALL["rounds"]))
    res, s = _traced_prove(make_wat_program(src, [message], {0}))
    assert res.ok and s["requests"] == 1
    # stages 1 and 2 run the guest; each flushes every element once
    elements = res.num_linear + 3 * res.num_quadratic
    assert elements > 100
    assert s["counters"]["witness.elements"] == 2 * elements
    # list rows: stage 1's data rows, stage 2's and their randomness
    # rows, and two mask sets of three in each stage (stage 3 replays)
    data_rows = res.num_rows - 6
    assert s["spans"]["ctx.limbs"]["count"] == 3 * data_rows + 12


def test_batch_rows_take_no_limb_span():
    from bench.e2e_prove import make_wat
    res, s = _traced_prove(make_wat_program(make_wat(2), [], set()))
    assert res.ok
    assert s["spans"]["ctx.limbs"]["count"] == 12         # the masks only
    assert s["counters"].get("witness.elements", 0) == \
        2 * (res.num_linear + 3 * res.num_quadratic)


def _gadget_bits(src: str, args: list, private: set) -> int:
    T.clear_timers()
    with profile(activities=[ProfilerActivity.CPU]):
        make_wat_program(src, args, private, strict=True)(NullContext(k=K))
    bits = T.summary()["counters"].get("gadget.bits", 0)
    T.clear_timers()
    return bits


def test_gadget_bits_counts_the_secret_bits():
    message = _message(SMALL["message_bytes"])
    src = G.make(SMALL, S.sha256(message, SMALL["rounds"]))
    assert _gadget_bits(src, [message], {0}) > 0


def test_gadget_bits_one_opcode():
    """Two ``i32_private_const`` calls decompose 32 bits each (64), and the
    secret ``i32.xor`` of the two makes 32 bits (96); the result is
    dropped, so nothing composes it: 96 in all."""
    src = """(module
  (import "env" "i32_private_const" (func $pc (param i32) (result i32)))
  (func $main (export "_start")
    (drop (i32.xor (call $pc (i32.const 0x12345678))
                   (call $pc (i32.const 0x0F0F0F0F))))))
"""
    assert _gadget_bits(src, [], set()) == 96


def test_gadget_bits_none_in_the_vbn254fr_guest():
    from bench.e2e_prove import make_wat
    assert _gadget_bits(make_wat(2), [], set()) == 0
