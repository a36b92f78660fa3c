"""The port's vbn254fr batch rows built from limbs: every setter of the
``vbn254fr`` host module runs through both packages' VMs under a recording
context whose policy pads encoding randomness (stage 1's) or zeros (the
verifier's), and each ``on_batch_init`` row, and the encoding engine's next
draw afterwards, are identical.  The traps keep their order, and the
counter ``vbn254fr.broadcast_rows`` counts the rows built by broadcasting
one value.

    python -m pytest tests/test_torch_vbn254fr_rows.py -q
"""

import hashlib
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ligero_prover_tpu.vm.run import make_wat_program as j_wat_program
from ligero_prover_tpu.vm.values import WasmTrap as JTrap
from ligero_prover_tpu.zkp import witness as JW
from ligero_prover_tpu.zkp.context import NullContext as JNull
from ligero_prover_tpu_torch.field import bn254 as F
from ligero_prover_tpu_torch.utils import timer as T
from ligero_prover_tpu_torch.vm.run import make_wat_program as t_wat_program
from ligero_prover_tpu_torch.vm.values import WasmTrap as TTrap
from ligero_prover_tpu_torch.zkp import witness as TW
from ligero_prover_tpu_torch.zkp.context import NullContext as TNull

import _torch_helpers  # noqa: F401  (thread count)

BENCH = Path(__file__).resolve().parent.parent / "proverbench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))
import harness  # noqa: E402

K = 256
L = K - 192
P = F.MODULUS
KEY = hashlib.sha256(b"vbn254fr rows").digest()

IMPORTS = r"""
  (import "vbn254fr" "vbn254fr_alloc" (func $alloc (param i32)))
  (import "vbn254fr" "vbn254fr_set_ui" (func $set_ui (param i32 i32 i64)))
  (import "vbn254fr" "vbn254fr_set_ui_scalar"
    (func $set_ui_scalar (param i32 i32)))
  (import "vbn254fr" "vbn254fr_set_str"
    (func $set_str (param i32 i32 i64 i32) (result i32)))
  (import "vbn254fr" "vbn254fr_set_str_scalar"
    (func $set_str_scalar (param i32 i32 i32) (result i32)))
  (import "vbn254fr" "vbn254fr_set_bytes"
    (func $set_bytes (param i32 i32 i64 i64)))
  (import "vbn254fr" "vbn254fr_set_bytes_scalar"
    (func $set_bytes_scalar (param i32 i32 i64)))
"""

# guest memory: handles at 0, 4, 8; a set_str's error code at 16; string
# pointers at 1024; data from 4096
ERR, PTRS, DATA = 16, 1024, 4096
END = (256 + 128) * 65536      # the VM's memory: 256 pages and 128 more


def _data(addr: int, raw: bytes) -> str:
    return f'  (data (i32.const {addr}) "' + "".join(
        f"\\{b:02x}" for b in raw) + '")'


def _guest(data: dict[int, bytes], calls: list[str]) -> str:
    """Three handles allocated, `data` in memory, then `calls`."""
    body = "\n    ".join(["(call $alloc (i32.const 0))",
                          "(call $alloc (i32.const 4))",
                          "(call $alloc (i32.const 8))"] + calls)
    segs = "\n".join(_data(a, b) for a, b in data.items())
    return (f"(module{IMPORTS}  (memory 2)\n{segs}\n"
            f"  (func $main\n    {body})\n"
            '  (export "_start" (func $main)))\n')


def _with_err(call: str) -> list[str]:
    """A call that returns an error code, the code stored, then set as
    lane 0 of handle 8 (so the row shows it)."""
    return [f"(i32.store (i32.const {ERR}) {call})",
            f"(call $set_ui (i32.const 8) (i32.const {ERR}) (i64.const 1))"]


def _edge_lanes(length: int, n: int) -> list[int]:
    """`n` lanes of `length` bytes: the edges of p and of the width, then
    values drawn from a seeded generator."""
    top = (1 << 8 * length) - 1
    edges = [0, 1, P - 1, P, P + 1, 2 * P, (1 << 255), top,
             (P >> 224) << 224, ((P >> 224) << 224) - 1]
    gen = random.Random(length)
    vals = [v for v in edges if v <= top]
    return vals + [gen.getrandbits(8 * length) for _ in range(n - len(vals))]


def _be(vals: list[int], length: int) -> bytes:
    return b"".join(v.to_bytes(length, "big") for v in vals)


def _strs(texts: list[str]) -> tuple[dict[int, bytes], int]:
    """C strings from DATA and their pointer array at PTRS."""
    data, ptrs, addr = {}, b"", DATA
    for s in texts:
        raw = s.encode() + b"\x00"
        data[addr] = raw
        ptrs += addr.to_bytes(4, "little")
        addr += len(raw)
    data[PTRS] = ptrs
    return data, len(texts)


def _set_ui():
    gen = random.Random(7)
    lanes = [0, 1, 0xFFFFFFFF] + [gen.getrandbits(32) for _ in range(L - 3)]
    raw = b"".join(v.to_bytes(4, "little") for v in lanes)
    return _guest({DATA: raw}, [
        f"(call $set_ui (i32.const 0) (i32.const {DATA}) (i64.const {L}))",
        f"(call $set_ui (i32.const 4) (i32.const {DATA}) (i64.const 5))",
        f"(call $set_ui (i32.const 8) (i32.const {DATA}) (i64.const 0))"])


def _set_ui_scalar():
    return _guest({}, ["(call $set_ui_scalar (i32.const 0) (i32.const 0))",
                       "(call $set_ui_scalar (i32.const 4) (i32.const -1))",
                       "(call $set_ui_scalar (i32.const 0) (i32.const 77))"])


def _set_str(base: int, texts: list[str]):
    data, n = _strs(texts)
    return _guest(data, _with_err(
        f"(call $set_str (i32.const 0) (i32.const {PTRS}) (i64.const {n}) "
        f"(i32.const {base}))"))


def _set_str_scalar(base: int, text: str):
    return _guest({DATA: text.encode() + b"\x00"}, _with_err(
        f"(call $set_str_scalar (i32.const 0) (i32.const {DATA}) "
        f"(i32.const {base}))"))


def _set_bytes(length: int, n: int):
    return _guest({DATA: _be(_edge_lanes(length, n), length)}, [
        f"(call $set_bytes (i32.const 0) (i32.const {DATA}) "
        f"(i64.const {length}) (i64.const {n}))"])


def _set_bytes_scalar(length: int, value: int):
    return _guest({DATA: value.to_bytes(length, "big")}, [
        f"(call $set_bytes_scalar (i32.const 0) (i32.const {DATA}) "
        f"(i64.const {length}))",
        f"(call $set_bytes_scalar (i32.const 4) (i32.const {DATA}) "
        f"(i64.const {length}))"])


HEX = [hex(P - 1), hex(P), hex(P + 5), hex((1 << 256) - 1), "0x0", "0X1f"]
DEC = [str(P - 1), str(P), str(3 * P + 2), "0", "-5", "123456789"]
GUESTS = {
    "set_ui": _set_ui(),
    "set_ui_scalar": _set_ui_scalar(),
    "set_str_hex": _set_str(16, HEX),
    "set_str_dec": _set_str(10, DEC),
    "set_str_parse_error": _set_str(10, ["12", "nope", "34"]),
    "set_str_scalar_hex": _set_str_scalar(16, hex(P + 3)),
    "set_str_scalar_dec": _set_str_scalar(10, str((1 << 256) - 1)),
    "set_str_scalar_parse_error": _set_str_scalar(16, "0xzz"),
    "set_bytes_31": _set_bytes(31, L),
    "set_bytes_32": _set_bytes(32, L),
    "set_bytes_33": _set_bytes(33, 20),
    "set_bytes_0": _set_bytes(0, 5),
    "set_bytes_scalar_31": _set_bytes_scalar(31, (1 << 248) - 1),
    "set_bytes_scalar_32_p": _set_bytes_scalar(32, P),
    "set_bytes_scalar_32_top": _set_bytes_scalar(32, (1 << 256) - 1),
}


def _recorder(base, policy):
    """A null context under `policy` that keeps every on_batch_init row as
    numpy limbs, its encoding engine seeded with KEY."""

    class Recorder(base):
        wants_batch_rows = True

        def __init__(self):
            self.policy = policy
            super().__init__(k=K)
            self.init_encoding_random(KEY)
            self.seen = []

        def on_batch_init(self, row):
            arr = row.cpu().numpy().view(np.uint32) \
                if isinstance(row, torch.Tensor) else np.asarray(row)
            self.seen.append(arr.astype(np.uint32))

    return Recorder()


def _next_draw(ctx) -> int:
    return ctx.backend.manager.encoding_random_engine.draw_int(32)


def _run_both(src: str, jpol, tpol):
    want, got = _recorder(JNull, jpol), _recorder(TNull, tpol)
    j_wat_program(src, [], set())(want)
    t_wat_program(src, [], set())(got)
    return want, got


def _assert_same(want, got):
    assert len(got.seen) == len(want.seen) > 0
    for g, w in zip(got.seen, want.seen):
        np.testing.assert_array_equal(g, w)
    assert _next_draw(got) == _next_draw(want)


@pytest.mark.parametrize("name", list(GUESTS))
def test_rows_match_reference_with_encoding_tail(name):
    want, got = _run_both(GUESTS[name], JW.STAGE1_POLICY, TW.STAGE1_POLICY)
    _assert_same(want, got)
    for row in got.seen:
        assert row[L:].any()            # the tail is drawn randomness


def test_rows_match_reference_with_zero_tail():
    src = GUESTS["set_bytes_32"]
    want, got = _run_both(src, JW.VERIFIER_POLICY, TW.VERIFIER_POLICY)
    _assert_same(want, got)
    assert not any(row[L:].any() for row in got.seen)


def test_lanes_reduced_mod_p():
    """The 32-byte lanes in [p, 2^256) are reduced, the rest kept."""
    _, got = _run_both(GUESTS["set_bytes_32"], JW.STAGE1_POLICY,
                       TW.STAGE1_POLICY)
    row = got.seen[0]
    lanes = [int.from_bytes(row[i].tobytes(), "little") for i in range(L)]
    assert lanes == [v % P for v in _edge_lanes(32, L)]


def test_parse_error_sets_zero_and_returns_all_ones():
    _, got = _run_both(GUESTS["set_str_parse_error"], JW.STAGE1_POLICY,
                       TW.STAGE1_POLICY)
    vals, err = got.seen
    assert [int(v) for v in vals[:3, 0]] == [12, 0, 34]
    assert not vals[:3, 1:].any()
    assert int(err[0, 0]) == 0xFFFFFFFF


TRAPS = {
    "set_ui_too_many": (
        _guest({}, [f"(call $set_ui (i32.const 0) (i32.const {DATA}) "
                    f"(i64.const {L + 1}))"]),
        "too many elements for a batch row"),
    "set_bytes_too_many": (
        _guest({}, [f"(call $set_bytes (i32.const 0) (i32.const {DATA}) "
                    f"(i64.const 32) (i64.const {L + 1}))"]),
        "too many elements for a batch row"),
    "set_str_too_many": (
        _set_str(10, ["1"] * (L + 1)),
        "too many elements for a batch row"),
    # a bad handle traps before the count is looked at
    "set_ui_bad_handle_too_many": (
        _guest({12: (600).to_bytes(4, "little")},
               [f"(call $set_ui (i32.const 12) (i32.const {DATA}) "
                f"(i64.const {L + 1}))"]),
        "invalid handle"),
    "set_ui_scalar_bad_handle": (
        _guest({12: (512).to_bytes(4, "little")},
               ["(call $set_ui_scalar (i32.const 12) (i32.const 1))"]),
        "invalid handle"),
    # memory is read before the handle: the third lane ends past the
    # last byte
    "set_bytes_out_of_memory": (
        _guest({12: (600).to_bytes(4, "little")},
               [f"(call $set_bytes (i32.const 12) (i32.const {END - 64}) "
                f"(i64.const 32) (i64.const 5))"]),
        "Invalid memory address"),
}


@pytest.mark.parametrize("name", list(TRAPS))
def test_setter_traps_as_reference(name):
    src, match = TRAPS[name]
    want = _recorder(JNull, JW.STAGE1_POLICY)
    got = _recorder(TNull, TW.STAGE1_POLICY)
    with pytest.raises(JTrap, match=match):
        j_wat_program(src, [], set())(want)
    with pytest.raises(TTrap, match=match):
        t_wat_program(src, [], set())(got)
    assert got.seen == want.seen == []
    assert _next_draw(got) == _next_draw(want)


def _broadcast_rows(src: str, args: list[bytes], private: set) -> int:
    T.clear_timers()
    with profile(activities=[ProfilerActivity.CPU]):
        t_wat_program(src, args, private, strict=True)(TNull(k=K))
    return T.summary()["counters"].get("vbn254fr.broadcast_rows", 0)


def test_broadcast_rows_counted_in_the_benchmark_guests():
    cfg = harness.Cell.load("poseidon2.prove").config["guest"]["params"]
    pos = harness.load_module("guests", "poseidon2")
    src = pos.make(dict(cfg, lanes=L, device="cpu"), random.Random(5))
    # 128 round constants, two zero states, the padding block
    assert _broadcast_rows(src, [], set()) == 131
    sha = harness.load_module("guests", "sha256")
    src, args = sha.guest({"message_bytes": 4, "rounds": 1},
                          random.Random(5))
    assert _broadcast_rows(src, args, {0}) == 0
