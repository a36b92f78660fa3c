"""Fiat-Shamir column sampling: partial Fisher-Yates over [0, n).

Replicates ``util/portable_sample.hpp`` which relies on
``boost::random::uniform_int_distribution`` for platform-portable draws.
:func:`boost_uniform_int` is a faithful re-implementation of Boost.Random's
``generate_uniform_int`` mult-and-add / bucket algorithm for a uint8 engine
(min 0, max 255), so index sequences match the reference given the same
:class:`~ligero_prover_tpu_torch.zkp.csprng.HashRandomEngine` byte stream.
"""

from __future__ import annotations

_U64_MAX = (1 << 64) - 1


def boost_uniform_int(engine, lo: int, hi: int, _width: int = 64) -> int:
    """Draw uniformly from [lo, hi] consuming bytes from `engine`.

    Mirrors boost::random::detail::generate_uniform_int with
    base engine range brange = 255 and unsigned 64-bit value type.
    """
    rmax = (1 << _width) - 1
    brange = engine.MAX - engine.MIN
    bmin = engine.MIN
    rng = hi - lo
    if rng == 0:
        return lo
    if brange < rng:
        while True:
            if rng == rmax:
                limit = rng // (brange + 1)
                if rng % (brange + 1) == brange:
                    limit += 1
            else:
                limit = (rng + 1) // (brange + 1)
            result = 0
            mult = 1
            early = False
            while mult <= limit:
                result += (engine() - bmin) * mult
                if mult * brange == rng - mult + 1:
                    early = True
                    break
                mult *= brange + 1
            if early:
                return result + lo
            incr = boost_uniform_int(engine, 0, rng // mult, _width)
            if rmax // mult < incr:
                continue  # overflow -> reject
            incr *= mult
            result += incr
            if result > rmax:  # overflow in C++ wraps; boost rejects via compare
                continue
            if result > rng:
                continue
            return result + lo
    elif brange == rng:
        return (engine() - bmin) + lo
    else:
        if brange == 255 and rng + 1 == 256:
            bucket_size = 1
        else:
            bucket_size = (brange + 1) // (rng + 1)
        while True:
            result = (engine() - bmin) // bucket_size
            if result <= rng:
                return result + lo


def portable_sample(population_size: int, count: int, engine) -> list[int]:
    """Partial Fisher-Yates: pick `count` distinct indices from
    [0, population_size) (``util/portable_sample.hpp:15-33``).
    Returns indices in draw order (the caller sorts them, as both the prover
    and the verifier do — ``webgpu_prover.cpp:343-351``)."""
    idx = list(range(population_size))
    out = []
    n = min(count, population_size)
    for i in range(n):
        j = boost_uniform_int(engine, i, population_size - 1)
        idx[i], idx[j] = idx[j], idx[i]
        out.append(idx[i])
    return out
