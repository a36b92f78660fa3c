"""The port's secret-operand front end against the JAX package's, row for
row: the bit gadgets (``Backend.bit_decompose``, ``bit_compose``, the
per-bit and/or/xor of ``op_bitwise``) and every opcode built on them.

    python -m pytest tests/test_secret_gadgets.py -q

CPU only, k=256 (l=64, so a small guest still fills rows).  Each case is a
small WAT function whose operands come from ``env.i32_private_const`` /
``i64_private_const`` (secret), or a ``const`` (public).  It runs under a
context that keeps every row the witness manager emits, under
``STAGE1_POLICY``, ``STAGE2_POLICY`` and ``VERIFIER_POLICY``, engines
seeded alike in both packages: the linear, quadratic and mask rows, their randomness rows
and ``constant_sum`` must be identical, and they must satisfy the linear
test (sum of value * randomness + constant_sum = 0) and a * b = c.
"""

import importlib

import pytest

from ligero_prover_tpu_torch.field import bn254 as F

K = 256
KEY = bytes(range(32))
# secret operands: x negative as a signed value, y positive
X = {"i32": 0x9E3779B1, "i64": 0x9E3779B97F4A7C15}
Y = {"i32": 0x7F4A7C15, "i64": 0x2545F4914F6CDD1D}
PUBLIC = {"i32": 0x0FF00F0F, "i64": 0x0FF00F0F33CC55AA}
COND = 0x00010000       # the secret select condition (non-zero)

# name -> (body, result type; None: the operand type)
CASES = {
    "and": ("(T.and (local.get $x) (local.get $y))", None),
    "or": ("(T.or (local.get $x) (local.get $y))", None),
    "xor": ("(T.xor (local.get $x) (local.get $y))", None),
    "and_public": ("(T.and (local.get $x) (T.const PUB))", None),
    "or_public": ("(T.or (T.const PUB) (local.get $y))", None),
    "xor_public": ("(T.xor (local.get $x) (T.const PUB))", None),
    "xor_minus_one": ("(T.xor (local.get $x) (T.const -1))", None),
    "xor_self": ("(T.xor (local.get $x) (local.get $x))", None),
    "and_chain": ("(T.or (T.and (local.get $x) (local.get $y))"
                  " (T.xor (local.get $y) (T.const PUB)))", None),
    "shl": ("(T.shl (local.get $x) (T.const 5))", None),
    "shr_u": ("(T.shr_u (local.get $x) (T.const 7))", None),
    "shr_s": ("(T.shr_s (local.get $x) (T.const 3))", None),
    "rotl": ("(T.rotl (local.get $x) (T.const 9))", None),
    "rotr": ("(T.rotr (local.get $x) (T.const 13))", None),
    "add": ("(T.add (local.get $x) (local.get $y))", None),
    "sub": ("(T.sub (local.get $x) (local.get $y))", None),
    "mul": ("(T.mul (local.get $x) (local.get $y))", None),
    "div_s": ("(T.div_s (local.get $x) (local.get $y))", None),
    "div_u": ("(T.div_u (local.get $x) (local.get $y))", None),
    "rem_s": ("(T.rem_s (local.get $x) (local.get $y))", None),
    "rem_u": ("(T.rem_u (local.get $x) (local.get $y))", None),
    "eq": ("(T.eq (local.get $x) (local.get $y))", "i32"),
    "ne": ("(T.ne (local.get $x) (local.get $y))", "i32"),
    "lt_s": ("(T.lt_s (local.get $x) (local.get $y))", "i32"),
    "gt_u": ("(T.gt_u (local.get $x) (local.get $y))", "i32"),
    "eqz": ("(T.eqz (local.get $x))", "i32"),
    "clz": ("(T.clz (local.get $y))", None),
    "ctz": ("(T.ctz (local.get $x))", None),
    "popcnt": ("(T.popcnt (local.get $x))", None),
    "select": ("(select (local.get $x) (local.get $y) (local.get $c))",
               None),
    "private_const": ("(local.get $x)", None),
}


def make_guest(case: str, t: str) -> str:
    """`_start` computes the case's body into $r, then adds $r to itself
    (every result composed back into a witness) and stores $r (its value
    marked secret); the operands stay live in locals until the end."""
    body, rt = CASES[case]
    rt = rt or t
    body = body.replace("T.", f"{t}.").replace("PUB", hex(PUBLIC[t]))
    return f"""(module
  (import "env" "i32_private_const" (func $pc_i32 (param i32) (result i32)))
  (import "env" "i64_private_const" (func $pc_i64 (param i64) (result i64)))
  (memory 1)
  (func $main (export "_start")
    (local $x {t}) (local $y {t}) (local $c i32) (local $r {rt})
    (local.set $x (call $pc_{t} ({t}.const {hex(X[t])})))
    (local.set $y (call $pc_{t} ({t}.const {hex(Y[t])})))
    (local.set $c (call $pc_i32 (i32.const {COND})))
    (local.set $r {body})
    (drop ({rt}.add (local.get $r) (local.get $r)))
    ({rt}.store (i32.const 64) (local.get $r))))
"""


def _capture(pkg: str, policy: str, src: str):
    """Runs `src` in package `pkg` under `policy`; the context keeps every
    row the witness manager emits."""
    ctxmod = importlib.import_module(pkg + ".zkp.context")
    witness = importlib.import_module(pkg + ".zkp.witness")
    run = importlib.import_module(pkg + ".vm.run")

    class Capture(ctxmod.NullContext):
        def __init__(self):
            self.policy = getattr(witness, policy)
            super().__init__(k=K)
            self.linear, self.quadratic, self.masks = [], [], []

        def linear_callback(self, row, rand):
            self.linear.append((list(row), list(rand)))

        def quadratic_callback(self, vals, rands):
            self.quadratic.append(([list(v) for v in vals],
                                   [list(r) for r in rands]))

        def mask_callback(self, code, linear, quad):
            self.masks.append((list(code), list(linear), list(quad)))

    ctx = Capture()
    ctx.init_encoding_random(KEY)
    ctx.init_witness_random(KEY)
    run.make_wat_program(src, [], set(), strict=True)(ctx)
    return ctx


def _linear_test(ctx) -> int:
    """sum(value * randomness) over every committed element, plus
    constant_sum: 0 when the constraints hold (the padding's randomness
    is 0)."""
    total = ctx.backend.manager.constant_sum
    for row, rand in ctx.linear:
        total += sum(v * r for v, r in zip(row, rand))
    for vals, rands in ctx.quadratic:
        for row, rand in zip(vals, rands):
            total += sum(v * r for v, r in zip(row, rand))
    return total % F.MODULUS


@pytest.mark.parametrize("policy", ["STAGE1_POLICY", "STAGE2_POLICY",
                                    "VERIFIER_POLICY"])
@pytest.mark.parametrize("t", ["i32", "i64"])
@pytest.mark.parametrize("case", list(CASES))
def test_rows_equal_jax_front_end(case, t, policy):
    src = make_guest(case, t)
    port = _capture("ligero_prover_tpu_torch", policy, src)
    ref = _capture("ligero_prover_tpu", policy, src)
    assert port.quadratic, "no quadratic row: the guest made no bit"
    assert len(port.linear) == len(ref.linear)
    assert len(port.quadratic) == len(ref.quadratic)
    for i, (got, want) in enumerate(zip(port.linear, ref.linear)):
        assert got == want, f"linear row {i}"
    for i, (got, want) in enumerate(zip(port.quadratic, ref.quadratic)):
        assert got == want, f"quadratic rows {i}"
    assert port.masks == ref.masks
    m = port.backend.manager
    assert m.constant_sum == ref.backend.manager.constant_sum
    assert m.live_witnesses == 0
    assert _linear_test(port) == 0
    for vals, _ in port.quadratic:
        n = m.l
        assert all(a * b % F.MODULUS == c
                   for a, b, c in zip(vals[0][:n], vals[1][:n], vals[2][:n]))

