"""SHA-256 (FIPS 180-4) of the program's argument 0, written as plain 32-bit
WASM the way a C compiler emits a straightforward implementation, and each
of the 8 digest words asserted equal to the stated one (``env``'s
``assert_equal``).

The guest reads its argument's length with ``args_sizes_get`` and copies
the argument in with ``args_get`` (the configuration marks it secret, so
every byte of it is secret memory).  ``$transform`` compresses one 64-byte
block at a pointer:

* the schedule's first 16 words from byte loads combined big-endian, the
  rest from sigma0/sigma1 of earlier words, all in a 64-word array in
  linear memory;
* `rounds` rounds (64 as published) on eight locals, with the round
  constants read from a table in the guest's data (the constants, the
  initial state and the stated digest are the plain reference's,
  ``reference.secret``);
* the state, kept in linear memory, added into.

``_start`` compresses every whole block of the argument in place, then
builds the last one or two blocks in a buffer: the remaining bytes copied
one by one, 0x80, zeros and the bit length (the length is public).  The
stated digest is the guest's data.  Nothing here depends on the seed but
the message and the digest, so a configuration fixes the guest's shape.
"""

from __future__ import annotations

from reference.secret import H0, K, sha256

# addresses in the guest's one page of memory
K_TAB = 1024        # 64 round constants
STATE = 1280        # the running state, 8 words
STATED = 1312       # the stated digest, 8 words
SCHED = 2048        # the 64-word schedule
ARGV = 4096         # args_get's pointer array
COUNT, SIZE = 4160, 4164
PADBUF = 4224       # the last one or two blocks
ARGBUF = 8192       # the argument's bytes


def message(params: dict, rng) -> bytes:
    """The secret message: `message_bytes` bytes drawn from `rng`."""
    return bytes(rng.getrandbits(8) for _ in range(int(
        params["message_bytes"])))


def guest(params: dict, rng) -> tuple[str, list[bytes]]:
    """The guest stating the plain reference's digest of a message drawn
    from `rng`, and its arguments (the message)."""
    m = message(params, rng)
    return make(params, sha256(m, int(params.get("rounds", 64)))), [m]


def _words_data(addr: int, words) -> str:
    raw = b"".join(int(w).to_bytes(4, "little") for w in words)
    return f'  (data (i32.const {addr}) "' + "".join(
        f"\\{b:02x}" for b in raw) + '")\n'


def _rotr_expr(x: str, n: int) -> str:
    return f"(i32.rotr {x} (i32.const {n}))"


def make(params: dict, stated: bytes) -> str:
    """The guest's WAT for `rounds` rounds (params), asserting the digest
    `stated` (32 bytes)."""
    rounds = int(params.get("rounds", 64))
    if not 1 <= rounds <= 64 or len(stated) != 32:
        raise ValueError("rounds in 1..64 and a 32-byte digest")
    sched = max(16, rounds)
    L = "(local.get ${})".format
    e, a = L("e"), L("a")
    big_s1 = ("(i32.xor (i32.xor " + _rotr_expr(e, 6) + " "
              + _rotr_expr(e, 11) + ") " + _rotr_expr(e, 25) + ")")
    big_s0 = ("(i32.xor (i32.xor " + _rotr_expr(a, 2) + " "
              + _rotr_expr(a, 13) + ") " + _rotr_expr(a, 22) + ")")
    w15 = "(i32.load offset={} (local.get $q))".format(SCHED - 60)
    w2 = "(i32.load offset={} (local.get $q))".format(SCHED - 8)
    small_s0 = ("(i32.xor (i32.xor " + _rotr_expr("(local.get $x)", 7) + " "
                + _rotr_expr("(local.get $x)", 18)
                + ") (i32.shr_u (local.get $x) (i32.const 3)))")
    small_s1 = ("(i32.xor (i32.xor " + _rotr_expr("(local.get $y)", 17) + " "
                + _rotr_expr("(local.get $y)", 19)
                + ") (i32.shr_u (local.get $y) (i32.const 10)))")
    state_in = "".join(
        f"    (local.set ${v} (i32.load offset={STATE + 4 * i} "
        "(i32.const 0)))\n" for i, v in enumerate("abcdefgh"))
    state_out = "".join(
        f"    (i32.store offset={STATE + 4 * i} (i32.const 0)\n"
        f"      (i32.add (i32.load offset={STATE + 4 * i} (i32.const 0)) "
        f"(local.get ${v})))\n" for i, v in enumerate("abcdefgh"))
    h0 = "".join(
        f"    (i32.store offset={STATE + 4 * i} (i32.const 0) "
        f"(i32.const {h}))\n" for i, h in enumerate(H0))
    checks = "".join(
        f"    (call $assert_equal (i32.load offset={STATE + 4 * i} "
        f"(i32.const 0)) (i32.load offset={STATED + 4 * i} "
        "(i32.const 0)))\n" for i in range(8))
    stated_words = [int.from_bytes(stated[4 * i:4 * i + 4], "big")
                    for i in range(8)]
    return f""";; SHA-256 of argument 0 ({rounds} rounds a block)
(module
  (import "wasi_snapshot_preview1" "args_sizes_get"
    (func $args_sizes_get (param i32 i32) (result i32)))
  (import "wasi_snapshot_preview1" "args_get"
    (func $args_get (param i32 i32) (result i32)))
  (import "env" "assert_equal" (func $assert_equal (param i32 i32)))
  (memory 1)
{_words_data(K_TAB, K)}{_words_data(STATED, stated_words)}
  ;; one 64-byte block at $p into the state
  (func $transform (param $p i32)
    (local $t i32) (local $q i32) (local $x i32) (local $y i32)
    (local $t1 i32) (local $t2 i32)
    (local $a i32) (local $b i32) (local $c i32) (local $d i32)
    (local $e i32) (local $f i32) (local $g i32) (local $h i32)
    ;; w[t] = the big-endian word at p + 4t, t < 16
    (block $d0 (loop $l0
      (br_if $d0 (i32.ge_u (local.get $t) (i32.const 16)))
      (i32.store offset={SCHED} (i32.shl (local.get $t) (i32.const 2))
        (i32.or
          (i32.or (i32.shl (i32.load8_u (local.get $p)) (i32.const 24))
                  (i32.shl (i32.load8_u offset=1 (local.get $p))
                           (i32.const 16)))
          (i32.or (i32.shl (i32.load8_u offset=2 (local.get $p))
                           (i32.const 8))
                  (i32.load8_u offset=3 (local.get $p)))))
      (local.set $p (i32.add (local.get $p) (i32.const 4)))
      (local.set $t (i32.add (local.get $t) (i32.const 1)))
      (br $l0)))
    ;; w[t] = w[t-16] + s0(w[t-15]) + w[t-7] + s1(w[t-2]), t < {sched}
    (block $d1 (loop $l1
      (br_if $d1 (i32.ge_u (local.get $t) (i32.const {sched})))
      (local.set $q (i32.shl (local.get $t) (i32.const 2)))
      (local.set $x {w15})
      (local.set $y {w2})
      (i32.store offset={SCHED} (local.get $q)
        (i32.add
          (i32.add (i32.load offset={SCHED - 64} (local.get $q)) {small_s0})
          (i32.add (i32.load offset={SCHED - 28} (local.get $q)) {small_s1})))
      (local.set $t (i32.add (local.get $t) (i32.const 1)))
      (br $l1)))
{state_in}    (local.set $t (i32.const 0))
    (block $d2 (loop $l2
      (br_if $d2 (i32.ge_u (local.get $t) (i32.const {rounds})))
      (local.set $q (i32.shl (local.get $t) (i32.const 2)))
      ;; t1 = h + S1(e) + ch(e, f, g) + k[t] + w[t]
      (local.set $t1
        (i32.add
          (i32.add
            (i32.add (local.get $h) {big_s1})
            (i32.xor (i32.and (local.get $e) (local.get $f))
                     (i32.and (i32.xor (local.get $e) (i32.const -1))
                              (local.get $g))))
          (i32.add (i32.load offset={K_TAB} (local.get $q))
                   (i32.load offset={SCHED} (local.get $q)))))
      ;; t2 = S0(a) + maj(a, b, c)
      (local.set $t2
        (i32.add {big_s0}
          (i32.xor (i32.xor (i32.and (local.get $a) (local.get $b))
                            (i32.and (local.get $a) (local.get $c)))
                   (i32.and (local.get $b) (local.get $c)))))
      (local.set $h (local.get $g))
      (local.set $g (local.get $f))
      (local.set $f (local.get $e))
      (local.set $e (i32.add (local.get $d) (local.get $t1)))
      (local.set $d (local.get $c))
      (local.set $c (local.get $b))
      (local.set $b (local.get $a))
      (local.set $a (i32.add (local.get $t1) (local.get $t2)))
      (local.set $t (i32.add (local.get $t) (i32.const 1)))
      (br $l2)))
{state_out}  )

  (func $_start
    (local $n i32) (local $i i32) (local $r i32) (local $last i32)
    (local $bits i64)
    (drop (call $args_sizes_get (i32.const {COUNT}) (i32.const {SIZE})))
    (drop (call $args_get (i32.const {ARGV}) (i32.const {ARGBUF})))
    (local.set $n (i32.load (i32.const {SIZE})))
{h0}    ;; every whole block of the message, in place
    (block $d0 (loop $l0
      (br_if $d0 (i32.gt_u (i32.add (local.get $i) (i32.const 64))
                           (local.get $n)))
      (call $transform (i32.add (i32.const {ARGBUF}) (local.get $i)))
      (local.set $i (i32.add (local.get $i) (i32.const 64)))
      (br $l0)))
    ;; the rest, 0x80, zeros and the bit length: one or two blocks
    (memory.fill (i32.const {PADBUF}) (i32.const 0) (i32.const 128))
    (block $d1 (loop $l1
      (br_if $d1 (i32.ge_u (i32.add (local.get $i) (local.get $r))
                           (local.get $n)))
      (i32.store8 offset={PADBUF} (local.get $r)
        (i32.load8_u offset={ARGBUF}
          (i32.add (local.get $i) (local.get $r))))
      (local.set $r (i32.add (local.get $r) (i32.const 1)))
      (br $l1)))
    (i32.store8 offset={PADBUF} (local.get $r) (i32.const 128))
    (local.set $last (select (i32.const 128) (i32.const 64)
                             (i32.ge_u (local.get $r) (i32.const 56))))
    (local.set $bits (i64.shl (i64.extend_i32_u (local.get $n))
                              (i64.const 3)))
    (local.set $i (i32.const 0))
    (block $d2 (loop $l2
      (br_if $d2 (i32.ge_u (local.get $i) (i32.const 8)))
      (i32.store8 offset={PADBUF - 1}
        (i32.sub (local.get $last) (local.get $i))
        (i32.wrap_i64 (local.get $bits)))
      (local.set $bits (i64.shr_u (local.get $bits) (i64.const 8)))
      (local.set $i (i32.add (local.get $i) (i32.const 1)))
      (br $l2)))
    (call $transform (i32.const {PADBUF}))
    (if (i32.eq (local.get $last) (i32.const 128))
      (then (call $transform (i32.const {PADBUF + 64}))))
{checks}  )
  (export "_start" (func $_start)))
"""
