"""Torch executor: batched stage pipelines on one device.

Port of ``ligero_prover_tpu.zkp.executor`` (its AoS constant-geometry
path).  The contexts queue rows on the host and flush them through one
call per batch:

* ``commit_step``    — encode B rows + ordered SHA-256 column absorption
                       (stage 1 / the verifier's 192-column variant).
* ``check_step``     — encode B rows + B randomness rows, accumulate the
                       code / linear / quadratic test codewords (stage 2).
* ``open_step``      — encode B rows and gather the 192 sampled columns
                       (stage 3).
* ``verify_step``    — absorb sampled columns, encode+sample randomness
                       rows, replay all checks on 192-wide buffers.

Batching is semantics-preserving: SHA absorbs stay ordered inside the
batch, and the test accumulators are sums in the field, so zero-padded
batch tails contribute exactly zero.

Tensors are int32 limb bit patterns on ``self.device``.  The executor also
owns every tensor the contexts, prover and verifier need (``zeros``,
``stack_batch``, ``concat``, ``fetch``), so those modules hold no torch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fieldops as fo
from ..ops import sha256 as tsha
from ..ops.ntt import RSCodec, encode_rows_cg

NLIMB = 8


def _masked_sum(acc, terms):
    """acc (n, 8) += field-sum over axis 0 of terms (B, n, 8), in order."""
    for i in range(terms.shape[0]):
        acc = fo.addmod(acc, terms[i])
    return acc


def _commit_body(state, pending, has_pending, rows, valid_count,
                 dom_msg, dom_n, n):
    cws = encode_rows_cg(rows, dom_msg, dom_n, n)
    return tsha.absorb_stream(state, pending, has_pending, cws, valid_count)


def _quad_contrib(quad, e, tri_idx, tri_r, pair_idx, pair_r):
    """Accumulate quadratic-test terms: r*(x∘y - z) for each (x,y,z) triple
    and r*(x - y) for each batch-equality pair.  Padded entries carry zero
    scalars and contribute nothing."""
    ex = e.index_select(0, tri_idx[:, 0])
    ey = e.index_select(0, tri_idx[:, 1])
    ez = e.index_select(0, tri_idx[:, 2])
    t = fo.submod(fo.mulmod(ex, ey), ez)
    quad = _masked_sum(quad, fo.mulmod(t, tri_r[:, None, :]))
    px = e.index_select(0, pair_idx[:, 0])
    py = e.index_select(0, pair_idx[:, 1])
    d = fo.submod(px, py)
    return _masked_sum(quad, fo.mulmod(d, pair_r[:, None, :]))


def _check_body(code, linear, quad, rows, rands, code_rs, tri_idx, tri_r,
                pair_idx, pair_r, dom_k, dom_n, n, rands_zero=False):
    """`rands_zero`: the flush carries only batch rows, which have no
    linear-test randomness rows; the second encode and the linear
    accumulation are identities on zeros and are skipped."""
    e = encode_rows_cg(rows, dom_k, dom_n, n)
    code = _masked_sum(code, fo.mulmod(e, code_rs[:, None, :]))
    if not rands_zero:
        r = encode_rows_cg(rands, dom_k, dom_n, n)
        linear = _masked_sum(linear, fo.mulmod(e, r))
    quad = _quad_contrib(quad, e, tri_idx, tri_r, pair_idx, pair_r)
    return code, linear, quad


def _mask_body(code, linear, quad, cr, lr, qr, dom_k, dom_2k, dom_n, n):
    code = fo.addmod(code, encode_rows_cg(cr[None], dom_k, dom_n, n)[0])
    linear = fo.addmod(linear, encode_rows_cg(lr[None], dom_2k, dom_n, n)[0])
    quad = fo.addmod(quad, encode_rows_cg(qr[None], dom_2k, dom_n, n)[0])
    return code, linear, quad


def _open_body(rows, idx, dom_msg, dom_n, n):
    return encode_rows_cg(rows, dom_msg, dom_n, n).index_select(1, idx)


def _verify_body(state, pending, has_pending, code, linear, quad,
                 samples, rands, code_rs, tri_idx, tri_r, pair_idx, pair_r,
                 idx, valid_count, dom_k, dom_n, n):
    state, pending, has_pending = tsha.absorb_stream(
        state, pending, has_pending, samples, valid_count)
    r = encode_rows_cg(rands, dom_k, dom_n, n).index_select(1, idx)
    code = _masked_sum(code, fo.mulmod(samples, code_rs[:, None, :]))
    linear = _masked_sum(linear, fo.mulmod(samples, r))
    quad = _quad_contrib(quad, samples, tri_idx, tri_r, pair_idx, pair_r)
    return state, pending, has_pending, code, linear, quad


def _verify_mask_body(state, pending, has_pending, code, linear, quad, ms):
    state, pending, has_pending = tsha.absorb_stream(
        state, pending, has_pending, ms, 3)
    code = fo.addmod(code, ms[0])
    linear = fo.addmod(linear, ms[1])
    quad = fo.addmod(quad, ms[2])
    return state, pending, has_pending, code, linear, quad


class TorchExecutor:
    """Owns the RS codec tables on one device and drives the pipelines."""

    def __init__(self, k: int, n: int, batch_rows: int = 16,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is false")
        self.k, self.n = k, n
        self.codec = RSCodec(k, n, self.device)
        self.batch_rows = batch_rows

    # ---- tensors ---------------------------------------------------------

    def _limbs(self, a) -> torch.Tensor:
        """uint32 limbs (numpy) or a limb tensor -> int32 on the device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return fo.to_torch(a, self.device)

    def _index(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.int64)
        return torch.from_numpy(
            np.asarray(a, np.int64)).to(self.device)

    def fetch(self, x) -> np.ndarray:
        """Device -> host transfer of a pipeline output, as uint32 limbs."""
        if isinstance(x, np.ndarray):
            return x.astype(np.uint32, copy=False)
        return fo.to_numpy(x)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=torch.int32,
                           device=self.device)

    def stack_batch(self, queue, bsz: int, width: int):
        """Stack queued rows into one (bsz, width, 8) zero-padded batch.
        All-numpy queues (witness rows) stay numpy; any device row (a
        vbn254fr batch row) makes it a device stack, so those rows never
        round-trip through the host."""
        cnt = len(queue)
        if all(isinstance(r, np.ndarray) for r in queue):
            batch = np.zeros((bsz, width, NLIMB), np.uint32)
            if cnt:
                batch[:cnt] = np.stack(queue)
            return batch
        zero = self.zeros((width, NLIMB))
        return torch.stack([self._limbs(r) for r in queue]
                           + [zero] * (bsz - cnt))

    def concat(self, parts, dim: int = 0) -> torch.Tensor:
        return torch.cat([self._limbs(p) for p in parts], dim=dim)

    # ---- stage 1: commit -------------------------------------------------

    def commit_step(self, sha, rows, valid_count, *, width_2k=False):
        dom = self.codec.dom_2k if width_2k else self.codec.dom_k
        state, pending, has_pending = sha
        return _commit_body(state, pending, has_pending, self._limbs(rows),
                            int(valid_count), dom, self.codec.dom_n, self.n)

    # ---- stage 2: checks -------------------------------------------------

    def check_step(self, accs, rows, rands, code_rs, tri_idx, tri_r,
                   pair_idx, pair_r, rands_zero=False):
        return _check_body(*accs, self._limbs(rows), self._limbs(rands),
                           self._limbs(code_rs), self._index(tri_idx),
                           self._limbs(tri_r), self._index(pair_idx),
                           self._limbs(pair_r), self.codec.dom_k,
                           self.codec.dom_n, self.n, rands_zero)

    def mask_step(self, accs, code_row, linear_row, quad_row):
        return _mask_body(*accs, self._limbs(code_row),
                          self._limbs(linear_row), self._limbs(quad_row),
                          self.codec.dom_k, self.codec.dom_2k,
                          self.codec.dom_n, self.n)

    # ---- stage 3: openings ----------------------------------------------

    def open_step(self, rows, sample_idx, *, width_2k=False):
        dom = self.codec.dom_2k if width_2k else self.codec.dom_k
        return _open_body(self._limbs(rows), self._index(sample_idx), dom,
                          self.codec.dom_n, self.n)

    # ---- verifier --------------------------------------------------------

    def verify_step(self, sha, accs, samples, rands, code_rs, tri_idx, tri_r,
                    pair_idx, pair_r, sample_idx, valid_count):
        state, pending, has_pending = sha
        out = _verify_body(state, pending, has_pending, *accs,
                           self._limbs(samples), self._limbs(rands),
                           self._limbs(code_rs), self._index(tri_idx),
                           self._limbs(tri_r), self._index(pair_idx),
                           self._limbs(pair_r), self._index(sample_idx),
                           int(valid_count), self.codec.dom_k,
                           self.codec.dom_n, self.n)
        return (out[0], out[1], out[2]), (out[3], out[4], out[5])

    def verify_mask_step(self, sha, accs, mask_samples):
        state, pending, has_pending = sha
        out = _verify_mask_body(state, pending, has_pending, *accs,
                                self._limbs(mask_samples))
        return (out[0], out[1], out[2]), (out[3], out[4], out[5])

    # ---- decode / sha ----------------------------------------------------

    def decode(self, codeword):
        """(n, 8) -> (n, 8) decoded (see ops.ntt.decode_rows_cg)."""
        return self.codec.decode(self._limbs(codeword)[None])[0]

    def sha_init(self, num_cols: int):
        return (tsha.initial_state(num_cols, self.device),
                self.zeros((num_cols, NLIMB)), False)

    def sha_finalize(self, sha, rows_absorbed: int):
        state, pending, has_pending = sha
        return tsha.finalize(state, pending, has_pending, rows_absorbed)

    def sha_digests(self, sha, rows_absorbed: int) -> list[bytes]:
        """Finalize the column states and return each column's digest."""
        return tsha.digests_to_bytes(
            self.fetch(self.sha_finalize(sha, rows_absorbed)))
