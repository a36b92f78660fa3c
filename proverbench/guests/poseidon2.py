"""The vbn254fr-batched Poseidon2 (t = 2) digest of the SDK's
``sdk/cpp/src/poseidon2.cpp`` (``poseidon2_vbn254_*``): one message a lane,
the digest of each lane asserted equal to the one the caller states.

The host-call sequence is that of the SDK's digest, as ``poseidon2.wat`` of
the port's tests has it: the round constants (``poseidon2_rc.txt``, the
standard BN254 t = 2 instance's; 128 at its 4 + 56 + 4 rounds) by
``set_str_scalar``, the
external and internal MDS as ``addmod`` chains, x^5 as three ``mulmod``,
update(message), the permutation, the 0x80-padded 31-byte final block by
``set_bytes_scalar``, the permutation, and ``assert_equal`` against the
stated digests.  The seed draws every lane's message (31 bytes); the
digests are worked out here, all lanes at once on the run's device with the
benchmark's own field (``reference.field``), two lanes again with Python
integers, and both enter the guest as data (``set_bytes``, 32 bytes a
lane, big-endian).  The configuration fixes the structure and so the
rows: the seed changes values only.
"""

from __future__ import annotations

from pathlib import Path

P = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
RC = [int(v, 16) for v in
      (Path(__file__).with_name("poseidon2_rc.txt").read_text().split())]

# handle slots (4 bytes each) and data addresses in the guest's memory
RC0 = 16
S0, S1, TMP, SUM, MSG, PAD, EXP = 528, 532, 536, 540, 544, 548, 552
STR0 = 1024                     # round constants as C strings, 68 bytes each
PADBUF = STR0 + 68 * len(RC)    # the 31-byte final block
MSGBUF = 10496                  # lane messages, 32 bytes each
PAGE = 65536


class _Ints:
    """The field on Python integers, one lane."""
    add = staticmethod(lambda a, b: (a + b) % P)
    mul = staticmethod(lambda a, b: a * b % P)
    const = staticmethod(lambda c: c % P)


class _Lanes:
    """The field on all lanes at once (``reference.field``)."""

    def __init__(self, device):
        from reference import field
        self.add, self.mul = field.add, field.mul
        self.const = lambda c: field.const(c, device)


def _plan(full: int, partial: int):
    """(round, full?) of the permutation: `full` full rounds at each end,
    `partial` partial rounds between; round r adds RC[2r] (and RC[2r+1])."""
    kinds = [True] * full + [False] * partial + [True] * full
    return list(enumerate(kinds))


def permute(f, s0, s1, full: int, partial: int):
    def ext(a, b):
        s = f.add(a, b)
        return f.add(a, s), f.add(b, s)

    def pow5(x):
        t = f.mul(x, x)
        return f.mul(f.mul(t, t), x)

    s0, s1 = ext(s0, s1)
    for r, is_full in _plan(full, partial):
        s0 = pow5(f.add(s0, f.const(RC[2 * r])))
        if is_full:
            s1 = pow5(f.add(s1, f.const(RC[2 * r + 1])))
            s0, s1 = ext(s0, s1)
        else:
            s = f.add(s0, s1)
            s0 = f.add(s0, s)
            s = f.add(s, s1)
            s1 = f.add(s, s1)
    return s0, s1


def digest(f, msg, full: int, partial: int):
    """update(msg), then the 0x80-padded final block."""
    s0, s1 = permute(f, msg, f.const(0), full, partial)
    s0, _ = permute(f, f.add(s0, f.const(0x80 << 240)), s1, full, partial)
    return s0


def digests(msgs: list[int], device, full: int, partial: int) -> list[int]:
    from reference import field
    out = field.to_ints(digest(_Lanes(device), field.from_ints(msgs, device),
                               full, partial))
    for i in (0, len(msgs) - 1):
        if digest(_Ints, msgs[i], full, partial) != out[i]:
            raise AssertionError(f"poseidon2 digest of lane {i} disagrees")
    return out


class _Emit:
    def __init__(self):
        self.calls: list[str] = []

    def __call__(self, fn: str, *slots: int):
        self.calls.append(f"(call ${fn} " + " ".join(
            f"(i32.const {s})" for s in slots) + ")")

    def pow5(self, h: int):
        self("mul", TMP, h, h)
        self("mul", TMP, TMP, TMP)
        self("mul", h, TMP, h)

    def ext_mds(self):
        self("add", SUM, S0, S1)
        self("add", S0, SUM, S0)
        self("add", S1, SUM, S1)

    def int_mds(self):
        self("add", SUM, S0, S1)
        self("add", S0, SUM, S0)
        self("add", SUM, SUM, S1)
        self("add", S1, SUM, S1)

    def permute(self, full: int, partial: int):
        self.ext_mds()
        for r, is_full in _plan(full, partial):
            self("add", S0, S0, RC0 + 8 * r)
            if is_full:
                self("add", S1, S1, RC0 + 8 * r + 4)
            self.pow5(S0)
            if is_full:
                self.pow5(S1)
                self.ext_mds()
            else:
                self.int_mds()


def _data(addr: int, raw: bytes) -> str:
    return f'  (data (i32.const {addr}) "' + "".join(
        f"\\{b:02x}" for b in raw) + '")'


def make(params: dict, rng) -> str:
    """The guest for `params["lanes"]` lanes and the rounds
    `params["full_rounds"]` (at each end) and `params["partial_rounds"]`,
    its messages drawn from `rng`, the digests worked out on
    `params["device"]`."""
    lanes = int(params["lanes"])
    full, partial = int(params["full_rounds"]), int(params["partial_rounds"])
    nrc = 2 * (2 * full + partial)
    if nrc > len(RC):
        raise ValueError(f"{nrc} round constants wanted, {len(RC)} known")
    msgs = [int.from_bytes(rng.randbytes(31), "big") for _ in range(lanes)]
    want = digests(msgs, params["device"], full, partial)
    expbuf = MSGBUF + 32 * lanes
    pages = -(-(expbuf + 32 * lanes) // PAGE)
    e = _Emit()
    for h in (S0, S1, TMP, SUM, MSG, PAD, EXP):
        e("alloc", h)
    e("set_ui_scalar", S0, 0)
    e("set_ui_scalar", S1, 0)
    e.calls.append(f"(call $set_bytes (i32.const {MSG}) (i32.const {MSGBUF})"
                   f" (i64.const 32) (i64.const {lanes}))")
    e("add", S0, S0, MSG)
    e.permute(full, partial)
    e.calls.append(f"(call $set_bytes_scalar (i32.const {PAD}) "
                   f"(i32.const {PADBUF}) (i64.const 31))")
    e("add", S0, S0, PAD)
    e.permute(full, partial)
    e.calls.append(f"(call $set_bytes (i32.const {EXP}) (i32.const {expbuf})"
                   f" (i64.const 32) (i64.const {lanes}))")
    e("assert_eq", S0, EXP)
    data = [_data(STR0 + 68 * i, f"0x{v:064x}".encode() + b"\x00")
            for i, v in enumerate(RC[:nrc])]
    data.append(_data(PADBUF, b"\x80" + bytes(30)))
    data.append(_data(MSGBUF, b"".join(m.to_bytes(32, "big") for m in msgs)))
    data.append(_data(expbuf, b"".join(d.to_bytes(32, "big") for d in want)))
    body = "\n    ".join(e.calls)
    nl = "\n"
    return f"""(module
  (import "vbn254fr" "vbn254fr_alloc" (func $alloc (param i32)))
  (import "vbn254fr" "vbn254fr_set_ui_scalar"
    (func $set_ui_scalar (param i32 i32)))
  (import "vbn254fr" "vbn254fr_set_str_scalar"
    (func $set_str_scalar (param i32 i32 i32) (result i32)))
  (import "vbn254fr" "vbn254fr_set_bytes"
    (func $set_bytes (param i32 i32 i64 i64)))
  (import "vbn254fr" "vbn254fr_set_bytes_scalar"
    (func $set_bytes_scalar (param i32 i32 i64)))
  (import "vbn254fr" "vbn254fr_addmod" (func $add (param i32 i32 i32)))
  (import "vbn254fr" "vbn254fr_mulmod" (func $mul (param i32 i32 i32)))
  (import "vbn254fr" "vbn254fr_assert_equal" (func $assert_eq (param i32 i32)))
  (memory {pages})
{nl.join(data)}

  (func $rc_setup
    (local $i i32)
    (block $done (loop $l
      (br_if $done (i32.ge_u (local.get $i) (i32.const {nrc})))
      (call $alloc (i32.add (i32.const {RC0})
                            (i32.mul (local.get $i) (i32.const 4))))
      (drop (call $set_str_scalar
        (i32.add (i32.const {RC0}) (i32.mul (local.get $i) (i32.const 4)))
        (i32.add (i32.const {STR0}) (i32.mul (local.get $i) (i32.const 68)))
        (i32.const 0)))
      (local.set $i (i32.add (local.get $i) (i32.const 1)))
      (br $l))))

  (func $main
    (call $rc_setup)
    {body})

  (export "_start" (func $main))
)
"""
