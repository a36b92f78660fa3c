"""Port vbn254fr arena: every guest op of the JAX package's vbn254fr tests
(mul, div, add, copy, the constant family, vector set, bit_decompose) plus
``mont_mul_constant`` with a constant in [p, 2^256) runs through both
packages' VMs, and the rows each hands to the stage contexts' batch hooks
are identical, in the same order."""

import numpy as np
import pytest
import torch

from ligero_prover_tpu.vm.run import make_wat_program as j_wat_program
from ligero_prover_tpu.zkp.context import NullContext as JNull
from ligero_prover_tpu_torch.vm.run import make_wat_program as t_wat_program
from ligero_prover_tpu_torch.zkp.context import NullContext as TNull

from test_vbn254fr_module import BITS_WAT, CONST_WAT, VEC_WAT, WAT

import _torch_helpers  # noqa: F401  (thread count)

# x * c * 2^-256 with c = 2^256 - 1 (reduced only mod 2^256, as the
# reference's mont_mul_constant passes it), checked through assert_equal
MONT_WAT = r"""
(module
  (import "vbn254fr" "vbn254fr_alloc" (func $alloc (param i32)))
  (import "vbn254fr" "vbn254fr_set_ui_scalar" (func $set_scalar (param i32 i32)))
  (import "vbn254fr" "vbn254fr_mont_mul_constant" (func $montc (param i32 i32 i32)))
  (import "vbn254fr" "vbn254fr_assert_equal" (func $assert_eq (param i32 i32)))
  (memory 1)
  (func $test
    (local $i i32)
    (call $alloc (i32.const 0))
    (call $alloc (i32.const 4))
    (call $set_scalar (i32.const 0) (i32.const 12345))
    (block $done (loop $l
      (br_if $done (i32.ge_u (local.get $i) (i32.const 8)))
      (i32.store (i32.add (i32.const 1024) (i32.mul (local.get $i) (i32.const 4)))
                 (i32.const -1))
      (local.set $i (i32.add (local.get $i) (i32.const 1)))
      (br $l)))
    (call $montc (i32.const 4) (i32.const 0) (i32.const 1024))
    (call $assert_eq (i32.const 4) (i32.const 0)))
  (export "_start" (func $test)))
"""

GUESTS = {"arith": WAT, "constants": CONST_WAT, "vector": VEC_WAT,
          "bits": BITS_WAT, "mont_const": MONT_WAT}


def _recorder(base):
    """A null context that keeps every batch-hook row as numpy limbs."""

    class Recorder(base):
        wants_batch_rows = True

        def __init__(self):
            super().__init__(k=256)
            self.seen = []

        def _keep(self, kind, *rows):
            for r in rows:
                arr = r.cpu().numpy().view(np.uint32) \
                    if isinstance(r, torch.Tensor) else np.asarray(r)
                self.seen.append((kind, arr.astype(np.uint32)))

        def on_batch_init(self, row):
            self._keep("init", row)

        def on_batch_bit(self, row):
            self._keep("bit", row)

        def on_batch_equal(self, rx, ry):
            self._keep("equal", rx, ry)

        def on_batch_quadratic(self, rx, ry, rz):
            self._keep("quadratic", rx, ry, rz)

    return Recorder()


@pytest.mark.parametrize("name", list(GUESTS))
def test_batch_rows_match_reference(name):
    want, got = _recorder(JNull), _recorder(TNull)
    j_wat_program(GUESTS[name], [b"Ligero\x00"], set())(want)
    t_wat_program(GUESTS[name], [b"Ligero\x00"], set())(got)
    assert [k for k, _ in got.seen] == [k for k, _ in want.seen]
    assert len(got.seen) > 0
    for (_, g), (_, w) in zip(got.seen, want.seen):
        np.testing.assert_array_equal(g, w)
