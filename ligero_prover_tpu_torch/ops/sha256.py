"""Batched per-column SHA-256 in PyTorch, with the absorb kernel K3.

One independent SHA-256 stream per codeword column, state laid out (8, C)
with the column axis last, as in ``ligero_prover_tpu.ops.sha256``.  Each
absorbed element is 32 bytes: its 8 little-endian u32 limbs, each
serialized big-endian, so a block's 16 message words are exactly the raw
limbs of two consecutive elements.

:func:`absorb_stream` is the executor's flush of (B, C, 8) rows: on CUDA
tensors it launches ``csrc/sha256.cu`` (K3: a CTA per tile of
:func:`tile_for` columns, schedule and round warps handing blocks over
through shared memory), on CPU tensors it runs
:func:`absorb_stream_plain`, the port of the reference's
``_absorb_stream`` (``ligero_prover_tpu/zkp/executor.py:43-65``).
:func:`absorb_stream_planar` is the same flush of (8, B, C) limb-major
codewords (the planar codec's output), the port of
``_absorb_stream_planar`` (``executor.py:68-105``): the same kernel reads
them in place, and :func:`absorb_stream_planar_plain` is its plain
version.  :func:`finalize` is plain torch on every device: it runs one
block per proof.

Words are int32 bit patterns; the plain compression widens them to int64
and masks to 32 bits after every add.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .. import kernels
from . import fieldops as fo

MASK32 = 0xFFFFFFFF

K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2], dtype=np.uint32)

INIT_STATE = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19], dtype=np.uint32)

_K_INTS = [int(k) for k in K]

# columns per CTA that csrc/sha256.cu is built for (tile_ok there), and the
# SMs of the card the choice is made for (an H100 SXM has 132)
TILES = (32, 128)
SMS = 132

LAUNCHES = {"sha256_absorb": 0, "sha256_absorb_planar": 0}
PLAIN_CALLS = {name: Counter() for name in LAUNCHES}   # by device type


def reset_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        PLAIN_CALLS[name].clear()


def initial_state(num_cols: int, device=None) -> torch.Tensor:
    """(8, C) int32."""
    init = torch.from_numpy(INIT_STATE.view(np.int32).copy())
    return fo.upload(init[:, None].expand(8, num_cols).contiguous(), device)


def _rotr(x, r):
    return ((x >> r) | (x << (32 - r))) & MASK32


def transform(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One compression: state (8, C), block (16, C) int32 words."""
    w = list((block.to(torch.int64) & MASK32).unbind(0))
    st = list((state.to(torch.int64) & MASK32).unbind(0))
    a, b, c, d, e, f, g, h = st
    for i in range(64):
        if i >= 16:
            x15, x2 = w[(i - 15) % 16], w[(i - 2) % 16]
            s0 = _rotr(x15, 7) ^ _rotr(x15, 18) ^ (x15 >> 3)
            s1 = _rotr(x2, 17) ^ _rotr(x2, 19) ^ (x2 >> 10)
            w[i % 16] = (w[i % 16] + s1 + w[(i - 7) % 16] + s0) & MASK32
        t1 = h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) \
            + ((e & f) ^ (~e & g & MASK32)) + _K_INTS[i] + w[i % 16]
        t2 = (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) \
            + ((a & b) ^ (a & c) ^ (b & c))
        a, b, c, d, e, f, g, h = ((t1 + t2) & MASK32, a, b, c,
                                  (d + t1) & MASK32, e, f, g)
    out = [(s + v) & MASK32 for s, v in zip(st, (a, b, c, d, e, f, g, h))]
    return torch.stack(out).to(torch.int32)


def _absorb(state, pending, has_pending: bool, rows, valid_count: int):
    bsz = rows.shape[0]
    stream = torch.cat([pending[None], rows], dim=0)        # (B+1, C, 8)
    hp = int(bool(has_pending))
    start = 1 - hp
    total = int(valid_count) + hp
    pairs = total // 2
    for i in range(pairs):
        j = start + 2 * i
        block = torch.cat([stream[j].T, stream[j + 1].T], dim=0)  # (16, C)
        state = transform(state, block)
    idx = min(max(start + 2 * pairs, 0), bsz)
    return state, stream[idx].clone(), total % 2 == 1


def absorb_stream_plain(state, pending, has_pending: bool, rows,
                        valid_count: int):
    """Plain version of K3.  Absorbs `valid_count` elements of `rows`
    (B, C, 8) in order into the (8, C) column states, honoring a carried
    unpaired element `pending` (C, 8).  Returns the new
    (state, pending, has_pending)."""
    PLAIN_CALLS["sha256_absorb"][rows.device.type] += 1
    return _absorb(state, pending, has_pending, rows, valid_count)


def absorb_stream_planar_plain(state, pending, has_pending: bool, cws,
                               valid_count: int):
    """Plain version of the planar K3 flush: :func:`absorb_stream_plain`
    of the rows given as (8, B, C) limb planes; `pending` stays (C, 8)."""
    PLAIN_CALLS["sha256_absorb_planar"][cws.device.type] += 1
    return _absorb(state, pending, has_pending, cws.permute(1, 2, 0),
                   valid_count)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def tile_for(cols: int) -> int:
    """K3's columns per CTA for C = `cols`: 128 once that still gives every
    SM a CTA (the commit step's 32,768 columns: 256 CTAs of 8 warps, each
    SM sub-partition running a round warp beside a schedule warp), else
    32 (the verifier's 192 sampled columns: 6 CTAs of 2 warps on 6 SMs)."""
    return 128 if cols >= 128 * SMS else 32


def _launch(name, state, pending, has_pending, rows, valid_count, planar):
    if rows.device.type != "cuda" or state.device != rows.device \
            or pending.device != rows.device:
        raise ValueError(f"{name}: state, pending and rows must be CUDA "
                         f"tensors on one device")
    if rows.dim() != 3:
        raise ValueError(f"{name}: rows must have 3 dimensions, got "
                         f"{tuple(rows.shape)}")
    limbs, bsz, cols = rows.shape if planar else \
        (rows.shape[2], rows.shape[0], rows.shape[1])
    if limbs != 8 or state.shape != (8, cols) or pending.shape != (cols, 8):
        raise ValueError(f"{name}: bad shapes {tuple(state.shape)}, "
                         f"{tuple(pending.shape)}, {tuple(rows.shape)}")
    if not 0 <= valid_count <= bsz:
        raise ValueError(f"{name}: valid_count {valid_count} outside "
                         f"[0, {bsz}]")
    for t in (state, pending, rows):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: operands must be int32 words")
    state, pending, rows = (_aligned(t) for t in (state, pending, rows))
    new_state = torch.empty_like(state)
    new_pending = torch.empty_like(pending)
    hp = int(bool(has_pending))
    kernels.launch("ligero_sha256_absorb", name, rows.device,
                   state.data_ptr(), pending.data_ptr(), rows.data_ptr(),
                   new_state.data_ptr(), new_pending.data_ptr(), cols, bsz,
                   hp, int(valid_count), int(planar), tile_for(cols))
    LAUNCHES[name] += 1
    return new_state, new_pending, (int(valid_count) + hp) % 2 == 1


def absorb_stream(state, pending, has_pending: bool, rows, valid_count: int):
    """K3: column SHA-256 absorb of one flush of (B, C, 8) rows (see
    absorb_stream_plain)."""
    if rows.device.type == "cpu":
        return absorb_stream_plain(state, pending, has_pending, rows,
                                   valid_count)
    return _launch("sha256_absorb", state, pending, has_pending, rows,
                   valid_count, planar=False)


def absorb_stream_planar(state, pending, has_pending: bool, cws,
                         valid_count: int):
    """K3, planar: the same absorb of (8, B, C) limb-major codewords."""
    if cws.device.type == "cpu":
        return absorb_stream_planar_plain(state, pending, has_pending, cws,
                                          valid_count)
    return _launch("sha256_absorb_planar", state, pending, has_pending, cws,
                   valid_count, planar=True)


def finalize(state, pending, has_pending: bool, rows_absorbed: int):
    """Apply SHA-256 padding and return the (8, C) final state.

    pending: (C, 8) limbs of an unpaired absorbed element (used when
    has_pending); rows_absorbed counts the pending element too."""
    c = state.shape[1]
    bits = (int(rows_absorbed) * 256) & ((1 << 64) - 1)
    blk = torch.zeros((16, c), dtype=torch.int32, device=state.device)
    word8 = 8 if has_pending else 0
    if has_pending:
        blk[:8] = pending.T
    pad = [0x80000000, bits >> 32, bits & MASK32]
    pad = [v - (1 << 32) if v >= 1 << 31 else v for v in pad]
    blk[word8] = pad[0]
    blk[14] = pad[1]
    blk[15] = pad[2]
    return transform(state, blk)


def digests_to_bytes(state) -> list[bytes]:
    """(8, C) -> per-column 32-byte digests (words big-endian)."""
    if isinstance(state, torch.Tensor):
        state = fo.to_numpy(state)
    arr = np.asarray(state).view(np.uint32).astype(">u4")   # (8, C)
    cols = np.ascontiguousarray(arr.T)                      # (C, 8)
    raw = cols.tobytes()
    return [raw[i * 32:(i + 1) * 32] for i in range(cols.shape[0])]
