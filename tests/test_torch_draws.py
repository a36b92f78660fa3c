"""Block draws of the port's AES-CTR engine: ``csprng.draw_ints`` and
``witness.generate_randoms`` give what as many single draws give, across
the 16 KiB buffer's refills (``bit_decompose`` takes its linear randoms
this way).

    python -m pytest tests/test_torch_draws.py -q
"""

import pytest

from ligero_prover_tpu_torch.field import bn254 as F
from ligero_prover_tpu_torch.zkp.csprng import (BUFFER_BYTES, MpzRandomEngine,
                                                draw_ints)
from ligero_prover_tpu_torch.zkp.witness import generate_randoms

KEY = bytes(range(32))


def _pair(before: int, num_bytes: int):
    """Two engines seeded alike, each `before` draws of `num_bytes` in."""
    a, b = MpzRandomEngine(KEY), MpzRandomEngine(KEY)
    for _ in range(before):
        a.draw_int(num_bytes)
        b.draw_int(num_bytes)
    return a, b


# 32-byte draws: 512 fill the buffer exactly, so a refill discards nothing;
# 24-byte draws: 682 fit, and the refill discards the tail's 16 bytes
@pytest.mark.parametrize("num_bytes", [32, 24])
@pytest.mark.parametrize("before", [0, 1, 500, 511, 512])
@pytest.mark.parametrize("count", [1, 67, 512, 513, 1500])
def test_block_equals_single_draws(num_bytes, before, count):
    a, b = _pair(before, num_bytes)
    assert draw_ints(a, num_bytes, count) == \
        [b.draw_int(num_bytes) for _ in range(count)]
    # the engines go on alike
    assert a.draw_int(num_bytes) == b.draw_int(num_bytes)
    assert a._offset_u64 == b._offset_u64


def test_draws_per_buffer():
    assert BUFFER_BYTES // F.NUM_BYTES == 512
    assert BUFFER_BYTES % F.NUM_BYTES == 0


@pytest.mark.parametrize("before", [0, 450])
def test_generate_randoms_equals_generate_random(before):
    a, b = _pair(before, F.NUM_BYTES)
    got = generate_randoms(a, 129)
    assert got == [F.generate_random(b) for _ in range(129)]
    assert all(0 <= v < F.MODULUS for v in got)


def test_block_refuses_what_a_single_draw_refuses():
    eng = MpzRandomEngine(KEY)
    for num_bytes in (0, 12, BUFFER_BYTES + 8):
        with pytest.raises(ValueError):
            draw_ints(eng, num_bytes, 1)
        with pytest.raises(ValueError):
            eng.draw_int(num_bytes)
