"""The H100's published rates and the encode's operation count.

Rates (CUDA C++ Programming Guide 12, arithmetic instructions table, compute
capability 9.0; NVIDIA H100 SXM data sheet): 64 32-bit integer
multiply-adds (IMAD.WIDE: one 32x32 -> 64-bit product) per clock per SM,
132 SMs, 1,980 MHz boost clock; HBM3 at 3.35 TB/s.  These are chip_smoke's
``bound()`` figures.  A probe on the card (chip_smoke phase 2) measured
only 19.9-24.5 wide multiply-adds per clock per SM, so a share of this
peak near 30-38% is already near what the card sustains; the share keeps
the published rate so that it stays comparable.

The work of an encode is counted from the algorithm at the call's shape,
whatever implements it: a row of width w (k for data rows, 2k for the
mask rows) takes an inverse NTT of w points ((w/2) log2 w butterflies),
a scaling by 1/w (w products) and an NTT of n points of the zero-extended
coefficients ((n/2) log2 n butterflies: on zero-extended input the first
log2(n/w) stages still multiply by their twiddles, the coset twists); one
Montgomery product per butterfly and per scaling, 164
32x32 -> 64-bit products per Montgomery product (8x8 limbs for x*y and
8x8 for m*p, plus 36 for m's low half: chip_smoke's ``PRODUCTS``).
"""

from __future__ import annotations

SMS = 132
CLOCK_HZ = 1.980e9
IMAD_PER_CLOCK_SM = 64
HBM_BYTES_PER_S = 3.35e12
PRODUCTS_PER_MONT_MUL = 164
PEAK_PRODUCTS_PER_S = IMAD_PER_CLOCK_SM * SMS * CLOCK_HZ


def encode_products(rows: int, w: int, n: int) -> int:
    """32x32 -> 64-bit products that encoding `rows` rows of width `w` into
    codewords of `n` needs."""
    log_w, log_n = w.bit_length() - 1, n.bit_length() - 1
    mont = (w // 2) * log_w + w + (n // 2) * log_n
    return rows * mont * PRODUCTS_PER_MONT_MUL


def encode_least_s(calls) -> float:
    """The least time of the encode calls [(rows, w, n), ...] at the
    published rate."""
    return sum(encode_products(b, w, n) for b, w, n in calls) \
        / PEAK_PRODUCTS_PER_S
