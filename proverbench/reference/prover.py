"""The benchmark's plain Ligero prover and verifier.

They follow the protocol (``src/webgpu_prover.cpp:59-495``,
``src/webgpu_verifier.cpp:57-464`` of ligero-prover) with none of the
prover's batching, kernels or executor: the guest runs on the frozen front
end of ``reference.ligero`` with a context that records what each stage
hands it, and the rest is whole-array arithmetic on ``reference.field``:

* stage 1: every committed row (stage-1 order, masks last) encoded at once,
  one SHA-256 per codeword column over its elements (each 32-bit limb
  big-endian), the Merkle tree of those digests;
* stage 2: the code test in the message domain (it is linear), the linear
  and quadratic tests from the stage-1 codewords;
* stage 3: the sampled columns of the stage-1 codewords;
* the proof through the frozen serializer.

The verifier replays the guest with the verifier's policy against the
opened columns and checks the Merkle root, the three tests on the sampled
columns and the degree of the three claimed codewords.
"""

from __future__ import annotations

import hashlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from . import field as fd
from .ligero.field import bn254 as F
from .ligero.params import SAMPLE_SIZE, IV_ANY
from .ligero.vm.run import run_program
from .ligero.vm.values import WasmTrap, ExitProgram
from .ligero.vm.wat import parse_wat
from .ligero.zkp import transcript
from .ligero.zkp.backend import Backend
from .ligero.zkp.csprng import HashRandomEngine
from .ligero.zkp.merkle import MerkleTree, recommit
from .ligero.zkp.proof import serialize_proof, deserialize_proof
from .ligero.zkp.sampling import portable_sample
from .ligero.zkp.witness import (STAGE1_POLICY, STAGE2_POLICY,
                                 VERIFIER_POLICY)

BLOCK = 128         # rows encoded together
ZERO = bytes(32)    # the instance and program hashes the drivers default to


class Rejected(Exception):
    """The proof's opened data runs out or is malformed."""


class Recorder:
    """A stage context that records the rows, randomness and checks the
    witness manager and the vbn254fr module hand it, in arrival order, with
    the draws of the test randomness in the protocol's order
    (``nonbatch_context.hpp``)."""

    def __init__(self, policy, k: int, device, samples=None):
        self.k, self.l, self.n = k, k - SAMPLE_SIZE, 4 * k
        self.device = device
        self.wants_batch_rows = samples is None
        self.backend = Backend(self.l, k, policy)
        m = self.backend.manager
        m.linear_callback = self.linear_callback
        m.quadratic_callback = self.quadratic_callback
        m.mask_callback = self.mask_callback
        self.rows: list = []        # message rows (w, 16), or popped samples
        self.rands: list = []       # linear-test rows (k, 16) or None
        self.code_rs: list[int] = []
        self.tris: list[tuple[int, int, int, int]] = []
        self.pairs: list[tuple[int, int, int]] = []
        self.masks: list[list] = []     # [code, linear, quad] per finalize
        self._samples = samples
        self._pop = 0

    # -- plumbing --
    def init_encoding_random(self, key: bytes):
        self.backend.manager.encoding_random_engine.init(key, IV_ANY)

    def init_witness_random(self, key: bytes):
        m = self.backend.manager
        for engine in (m.code_random_engine, m.linear_random_engine,
                       m.quadratic_random_engine):
            engine.init(key, IV_ANY)

    def finalize(self):
        self.backend.finalize()

    def batch_encoding_tail(self):
        m = self.backend.manager
        if not m.policy.pad_encoding_random:
            return None
        return [F.generate_random(m.encoding_random_engine)
                for _ in range(self.k - self.l)]

    def _row(self, row):
        if self._samples is not None:
            if self._pop >= len(self._samples):
                raise Rejected("proof has too few opened rows")
            self._pop += 1
            return self._samples[self._pop - 1]
        if isinstance(row, list):
            return fd.from_ints(row, self.device)
        if isinstance(row, np.ndarray):           # (w, 8) 32-bit limbs
            return fd.from_u32(row).to(self.device)
        return row

    def _code_r(self) -> int:
        return self.backend.manager.generate_code_random()

    def _quad_r(self) -> int:
        return self.backend.manager.generate_quadratic_random()

    def _add(self, row, rand, code_r):
        self.rows.append(self._row(row))
        self.rands.append(None if rand is None or not any(rand)
                          else fd.from_ints(rand, self.device))
        self.code_rs.append(code_r)
        return len(self.rows) - 1

    # -- the witness manager's callbacks --
    def linear_callback(self, row, rand):
        self._add(row, rand, self._code_r())

    def quadratic_callback(self, vals, rands):
        crs = [self._code_r() for _ in range(3)]
        idx = [self._add(vals[i], rands[i] if rands else None, crs[i])
               for i in range(3)]
        self.tris.append((*idx, self._quad_r()))

    def mask_callback(self, code, linear, quad):
        self.masks.append([self._row(r) for r in (code, linear, quad)])

    def mask(self, which: int) -> torch.Tensor:
        """The sum of the code (0), linear (1) or quadratic (2) masks."""
        return fd.total(torch.stack([m[which] for m in self.masks]))

    @property
    def committed(self) -> list:
        """Every committed row in commitment order: the data rows, then
        each finalize's three masks."""
        return self.rows + [r for m in self.masks for r in m]

    # -- the vbn254fr module's batch rows: no linear-test row --
    def on_batch_init(self, row=None):
        self._add(row, None, self._code_r())

    def on_batch_bit(self, row=None):
        i = self._add(row, None, self._code_r())
        self.tris.append((i, i, i, self._quad_r()))

    def on_batch_equal(self, rx=None, ry=None):
        i = self._add(rx, None, 0)
        j = self._add(ry, None, 0)
        self.pairs.append((i, j, self._quad_r()))

    def on_batch_quadratic(self, rx=None, ry=None, rz=None):
        crs = [self._code_r() for _ in range(3)]
        idx = [self._add(r, None, c) for r, c in zip((rx, ry, rz), crs)]
        self.tris.append((*idx, self._quad_r()))

    @property
    def constant_sum(self) -> int:
        return self.backend.manager.constant_sum


class Guest:
    """A WAT guest and its arguments, parsed once."""

    def __init__(self, wat: str, args: list[bytes]):
        self.module = parse_wat(wat)
        self.args = list(args)

    def run(self, ctx: Recorder):
        """As the prover's and verifier's drivers run a guest: the program
        finalizes the context when `_start` returns, and the driver
        finalizes it once more, which commits a second set of masks."""
        run_program(self.module, ctx, self.args, set())
        ctx.finalize()


def _encode_all(rows: list[torch.Tensor], k: int) -> torch.Tensor:
    """Rows of width k or 2k -> (R, n, 8) int32 codewords (32-bit limbs)."""
    out = torch.empty((len(rows), 4 * k, 8), dtype=torch.int32,
                      device=rows[0].device)
    i = 0
    while i < len(rows):
        w = rows[i].shape[0]
        j = i
        while j < len(rows) and j - i < BLOCK and rows[j].shape[0] == w:
            j += 1
        cw = fd.encode(torch.stack(rows[i:j]), k)
        out[i:j] = fd.words(cw)
        i = j
    return out


def _column_digests(words: torch.Tensor) -> list[bytes]:
    """(R, C, 8) int32 32-bit limbs -> the C columns' SHA-256 digests, each
    over its R elements with every limb big-endian."""
    w = words.transpose(0, 1).to(torch.int64) & 0xFFFFFFFF    # (C, R, 8)
    w = ((w & 0xFF) << 24) | ((w & 0xFF00) << 8) | ((w >> 8) & 0xFF00) \
        | (w >> 24)
    cols = (w - ((w >> 31) << 32)).to(torch.int32).contiguous()
    del w
    cols = cols.cpu().numpy()
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda j: hashlib.sha256(cols[j]).digest(),
                             range(cols.shape[0]), chunksize=256))


def _decode_checks(code, linear, quad, k: int, constsum: int):
    """The degree and sum tests of the three codewords ((n, 16) each)."""
    l = k - SAMPLE_SIZE
    dec = fd.decode(torch.stack([code, linear, quad]), k)
    dc, dl, dq = (fd.to_ints(d) for d in dec)
    valid_code = all(v == 0 for v in dc[k:])
    valid_linear = (sum(dl[:l]) + constsum) % fd.P == 0
    valid_quad = all(v == 0 for v in dq[:l])
    return valid_code, valid_linear, valid_quad


@dataclass
class RefProof:
    proof: bytes
    num_rows: int
    valid: tuple[bool, bool, bool]

    @property
    def ok(self) -> bool:
        return all(self.valid)


def prove(guest: Guest, k: int, encoding_seed: bytes, device, *,
          openings: int = SAMPLE_SIZE) -> RefProof:
    """The proof of `guest` at packing k under `encoding_seed`, with the
    prover's default instance and program hashes (zero).  `openings` other
    than 192 breaks the protocol (the benchmark's control)."""
    n = 4 * k
    s1 = Recorder(STAGE1_POLICY, k, device)
    s1.init_encoding_random(encoding_seed)
    guest.run(s1)
    rows = s1.committed
    cws = _encode_all(rows, k)
    tree = MerkleTree(_column_digests(cws))
    root = tree.root

    s2 = Recorder(STAGE2_POLICY, k, device)
    s2.init_encoding_random(encoding_seed)
    s2.init_witness_random(transcript.stage1_seed(root, ZERO))
    guest.run(s2)
    if len(s2.rows) != len(s1.rows) or any(
            not torch.equal(a, b) for a, b in zip(s1.rows, s2.rows)):
        raise RuntimeError("stage 2 rows differ from stage 1's")
    data = len(s1.rows)

    def cw(i):
        return fd.from_u32(cws[i])

    # code test: sum_i r_i * row_i, encoded once (the encode is linear)
    # code test: sum_i r_i * row_i, encoded once (the encode is linear)
    code = s2.mask(0)
    if data:
        rs = fd.from_ints(s2.code_rs, device)[:, None]
        code = fd.add(code, fd.total(torch.stack([fd.total(fd.mul(
            torch.stack(s2.rows[i:i + BLOCK]), rs[i:i + BLOCK]))
            for i in range(0, data, BLOCK)])))
    code = fd.encode(code[None], k)[0]
    # linear test: sum_i enc(row_i) * enc(rand_i)
    parts = [fd.encode(s2.mask(1)[None], k)[0]]
    lin = [i for i, r in enumerate(s2.rands) if r is not None]
    for b in range(0, len(lin), BLOCK):
        ids = lin[b:b + BLOCK]
        er = fd.encode(torch.stack([s2.rands[i] for i in ids]), k)
        parts.append(fd.total(fd.mul(torch.stack([cw(i) for i in ids]), er)))
    linear = fd.total(torch.stack(parts))
    # quadratic test: sum_t r_t (x*y - z) + sum r (x - y)
    parts = [fd.encode(s2.mask(2)[None], k)[0]]
    for b in range(0, len(s2.tris), BLOCK):
        t = s2.tris[b:b + BLOCK]
        x, y, z = (torch.stack([cw(e[c]) for e in t]) for c in range(3))
        r = fd.from_ints([e[3] for e in t], device)[:, None]
        parts.append(fd.total(fd.mul(fd.sub(fd.mul(x, y), z), r)))
    for b in range(0, len(s2.pairs), BLOCK):
        t = s2.pairs[b:b + BLOCK]
        x, y = (torch.stack([cw(e[c]) for e in t]) for c in range(2))
        r = fd.from_ints([e[2] for e in t], device)[:, None]
        parts.append(fd.total(fd.mul(fd.sub(x, y), r)))
    quad = fd.total(torch.stack(parts))

    code_w, linear_w, quad_w = (fd.to_u32(c) for c in (code, linear, quad))
    seed2 = transcript.stage2_seed(root, code_w, linear_w, quad_w)
    index = sorted(portable_sample(n, openings, HashRandomEngine(seed2)))
    opened = cws[:, torch.tensor(index, device=cws.device)]
    proof = serialize_proof(
        root, code_w, linear_w, quad_w, index, tree.decommit(index),
        opened.cpu().numpy().view(np.uint32).reshape(-1),
        program_hash=ZERO, k=k, n=n)
    valid = _decode_checks(code, linear, quad, k, s2.constant_sum)
    return RefProof(proof, len(rows), valid)


def verify(guest: Guest, k: int, proof_blob: bytes, device, *,
           check_merkle: bool = True) -> bool:
    """The verdict on `proof_blob`.  `check_merkle=False` drops the Merkle
    root's check, the commitment's binding (the benchmark's control)."""
    n, S = 4 * k, SAMPLE_SIZE
    try:
        pr = deserialize_proof(proof_blob)
    except Exception:                     # noqa: BLE001 - any parse error
        return False
    claimed = [pr.encoded_code_limbs, pr.encoded_linear_limbs,
               pr.encoded_quad_limbs]
    if any(c.size != n * 8 for c in claimed) \
            or pr.host_samplings.size % (S * 8):
        return False
    root = pr.merkle_root
    seed1 = transcript.stage1_seed(root, ZERO)
    seed2 = transcript.stage2_seed(root, *claimed)
    index = sorted(portable_sample(n, S, HashRandomEngine(seed2)))
    opened = fd.from_u32(pr.host_samplings.reshape(-1, S, 8).astype(
        np.int64)).to(device)
    vc = Recorder(VERIFIER_POLICY, k, device, samples=opened)
    vc.init_witness_random(seed1)
    try:
        guest.run(vc)
    except (WasmTrap, ExitProgram, Rejected):
        return False
    if vc._pop != opened.shape[0]:
        return False
    samples = torch.stack(vc.committed)                    # (R, S, 16)
    if check_merkle:
        leaves = _column_digests(fd.words(samples))
        try:
            vroot = recommit(leaves, index, pr.siblings, 2 * n - 1)
        except KeyError:
            return False
        if vroot != root:
            return False
    idx = torch.tensor(index, device=device)
    vcode, vlin, vquad = (vc.mask(i) for i in range(3))
    if vc.rows:
        rows = torch.stack(vc.rows)                         # (R, S, 16)
        rs = fd.from_ints(vc.code_rs, device)[:, None]
        vcode = fd.add(vcode, fd.total(fd.mul(rows, rs)))
        lin = [i for i, r in enumerate(vc.rands) if r is not None]
        if lin:
            er = fd.encode(torch.stack([vc.rands[i] for i in lin]), k)
            vlin = fd.add(vlin, fd.total(fd.mul(rows[lin], er[:, idx])))
        terms = [vquad]
        if vc.tris:
            x, y, z, q = zip(*vc.tris)
            r = fd.from_ints(q, device)[:, None]
            terms.append(fd.total(fd.mul(fd.sub(fd.mul(
                rows[list(x)], rows[list(y)]), rows[list(z)]), r)))
        if vc.pairs:
            x, y, q = zip(*vc.pairs)
            r = fd.from_ints(q, device)[:, None]
            terms.append(fd.total(fd.mul(fd.sub(
                rows[list(x)], rows[list(y)]), r)))
        vquad = fd.total(torch.stack(terms))
    full = [fd.from_u32(c.reshape(n, 8).astype(np.int64)).to(device)
            for c in claimed]
    if not all(torch.equal(f[idx], v)
               for f, v in zip(full, (vcode, vlin, vquad))):
        return False
    return all(_decode_checks(*full, k, vc.constant_sum))
