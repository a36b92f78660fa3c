"""Torch executor: batched stage pipelines on one device.

Port of ``ligero_prover_tpu.zkp.executor`` in its planar constant-geometry
configuration, on every device: the prover's codewords are limb planes,
encoded by the KB/KE kernels and absorbed by the planar SHA kernel (on CPU
tensors each kernel runs its plain torch version).  The verifier's
192-column samples stay (B, 192, 8) rows, folded by KF and absorbed by K3.
With ``ops.ntt.USE_MXU`` (resolved once when the executor is made) the
k-width encode of commit, check and open goes through the int8 four-step
engine (``ops/mxu_ntt.py``); 2k mask rows, decode and the verifier keep
the butterfly encode.
The contexts queue rows on the host and flush them through one call per
batch:

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

from ..ops import fieldmul as fm
from ..ops import fieldops as fo
from ..ops import sha256 as tsha
from ..ops.fieldops import R2_LIMBS
from ..ops.mxu_ntt import encode_rows_mxu_core
from ..ops.ntt import RSCodec, _mxu_use, decode_rows_cg_planar, \
    encode_rows_cg_planar, encode_rows_cg_planar_core
from ..utils.timer import span

NLIMB = 8
_R2: dict = {}


def _r2(device) -> torch.Tensor:
    """R^2 mod p as (8,) limbs on `device`, made once per device."""
    key = str(device)
    if key not in _R2:
        _R2[key] = fo.to_torch(R2_LIMBS, device)
    return _R2[key]


def _encode_planes(rows, dom_msg, dom_n, n, mxu_tabs):
    """(B, w, 8) rows -> (8, B, n) codeword planes, by the int8 engine
    when its tables are given, else by the planar butterflies."""
    if mxu_tabs is not None:
        return encode_rows_mxu_core(rows, mxu_tabs, n)
    return encode_rows_cg_planar_core(rows, dom_msg, dom_n, n)


def _commit_body(state, pending, has_pending, rows, valid_count,
                 dom_msg, dom_n, n, mxu_tabs=None):
    cws = _encode_planes(rows, dom_msg, dom_n, n, mxu_tabs)
    return tsha.absorb_stream_planar(state, pending, has_pending, cws,
                                     valid_count)


def _verify_terms(code, linear, quad, e, r, code_rs, tri_idx, tri_r,
                  pair_idx, pair_r):
    """The verifier's accumulation of the three tests over the sampled
    columns e (B, S, 8) and the sampled randomness rows r (B, S, 8): code
    and linear tests, then r*(x∘y - z) for each (x,y,z) triple and
    r*(x - y) for each batch-equality pair.  Padded entries carry zero
    scalars and contribute nothing.  Each sum is the reference's
    ``_masked_sum(acc, fo.mulmod(x, y))``: acc plus the B products, added
    in row order, one fused KF launch on CUDA tensors."""
    code = fm.masked_mulsum_aos(code, e, code_rs[:, None, :])
    linear = fm.masked_mulsum_aos(linear, e, r)
    ex = e.index_select(0, tri_idx[:, 0])
    ey = e.index_select(0, tri_idx[:, 1])
    ez = e.index_select(0, tri_idx[:, 2])
    t = fo.submod(fo.mulmod(ex, ey), ez)
    quad = fm.masked_mulsum_aos(quad, t, tri_r[:, None, :])
    px = e.index_select(0, pair_idx[:, 0])
    py = e.index_select(0, pair_idx[:, 1])
    d = fo.submod(px, py)
    return code, linear, fm.masked_mulsum_aos(quad, d, pair_r[:, None, :])


def _tree_sum_mod_planar(x):
    """(8, B, n) -> (8, n) field sum over the row axis by pairwise folds
    (reference ``executor.py:152-172``): log2(B) KE launches on halved
    operands, read in place as plane slices; an odd count carries its
    first row (`head`) to the next fold."""
    while x.shape[1] > 1:
        b = x.shape[1]
        head = x[:, :1] if b % 2 else None
        body = x[:, 1:] if b % 2 else x
        h = body.shape[1] // 2
        x = fm.addmod_planar(body[:, :h], body[:, h:])
        if head is not None:
            x = torch.cat([head, x], dim=1)
    return x[:, 0]


def _check_terms_planar(code, linear, quad, e, r, code_rs, tri_idx, tri_r,
                        pair_idx, pair_r):
    """Stage-2 accumulation (reference ``executor.py:175-252``) of
    the encoded rows e (8, B, n) and encoded randomness rows r (8, B, n),
    or r None when the rands are zero: the codewords stay limb planes; the
    code and linear tests are one KE launch per op over the whole batch
    plus one tree sum, the quadratic test one KQ launch.

    Montgomery prescale: the per-row scalars are taken to s*R by one
    mont_mul with R^2, so each big product is ONE mont_mul
    (x * sR * R^-1 = x*s); the linear test (both operands plain) sums the
    mont_mul products first and scales the (8, n) sum by R once.
    `tri_idx`, `tri_r`, `pair_idx` and `pair_r` are host arrays: KQ checks
    them there and uploads them together."""
    r2 = _r2(e.device)

    def scale_r(v):
        return fm.mont_mul_scalar_planar(v, r2)

    def planes(acc):
        return acc.T.contiguous()                             # (n,8)->(8,n)

    # code test: += sum_b e[b] * code_r[b]
    cr_r = scale_r(code_rs.T.contiguous())                    # (8, B) * R
    prods = fm.mont_mul_planar(e, cr_r[:, :, None])
    code = fm.addmod_planar(planes(code), _tree_sum_mod_planar(prods))
    # linear test: += sum_b e[b] * r[b]  (identity when rands are zero)
    if r is not None:
        lin = scale_r(_tree_sum_mod_planar(fm.mont_mul_planar(e, r)))
        linear = fm.addmod_planar(planes(linear), lin).T.contiguous()
    # quadratic test: += sum_t tri_r[t]*(e_x*e_y - e_z) + pair terms, in
    # one KQ launch: the terms from the rows of e read by index, the
    # scalars' prescale, the products, the tree sum's folds and the add
    # into the (n, 8) accumulator
    quad = fm.quad_acc_planar(quad, e, tri_idx, pair_idx, tri_r, pair_r)
    return code.T.contiguous(), linear, quad


def _check_body(code, linear, quad, rows, rands, code_rs, tri_idx, tri_r,
                pair_idx, pair_r, dom_k, dom_n, n, rands_zero=False,
                mxu_tabs=None):
    """Encode the rows (and the rands) and accumulate the three tests.
    `rands_zero`: the flush carries only batch rows, which have no
    linear-test randomness rows; the second encode and the linear
    accumulation are identities on zeros and are skipped."""
    e = _encode_planes(rows, dom_k, dom_n, n, mxu_tabs)
    r = None if rands_zero else _encode_planes(rands, dom_k, dom_n, n,
                                               mxu_tabs)
    return _check_terms_planar(code, linear, quad, e, r, code_rs, tri_idx,
                               tri_r, pair_idx, pair_r)


def _mask_body(code, linear, quad, cr, lr, qr, dom_k, dom_2k, dom_n, n):
    code = fo.addmod(code, encode_rows_cg_planar(cr[None], dom_k, dom_n,
                                                 n)[0])
    linear = fo.addmod(linear, encode_rows_cg_planar(lr[None], dom_2k,
                                                     dom_n, n)[0])
    quad = fo.addmod(quad, encode_rows_cg_planar(qr[None], dom_2k, dom_n,
                                                 n)[0])
    return code, linear, quad


def _open_body(rows, idx, dom_msg, dom_n, n, mxu_tabs=None):
    """Encode (B, w, 8) rows and keep the sampled columns: (B, S, 8),
    gathered from the limb planes, so only the S sampled columns are
    transposed back."""
    cws = _encode_planes(rows, dom_msg, dom_n, n, mxu_tabs)
    return cws.index_select(2, idx).movedim(0, -1).contiguous()


def _verify_body(state, pending, has_pending, code, linear, quad,
                 samples, rands, code_rs, tri_idx, tri_r, pair_idx, pair_r,
                 idx, valid_count, dom_k, dom_n, n):
    state, pending, has_pending = tsha.absorb_stream(
        state, pending, has_pending, samples, valid_count)
    r = _open_body(rands, idx, dom_k, dom_n, n)
    return (state, pending, has_pending) + _verify_terms(
        code, linear, quad, samples, r, code_rs, tri_idx, tri_r, pair_idx,
        pair_r)


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
        with span("executor.init"):         # the codec's domain tables
            self.codec = RSCodec(k, n, self.device)
        self.batch_rows = batch_rows
        self.use_mxu = _mxu_use(self.device)

    # ---- tensors ---------------------------------------------------------

    def _limbs(self, a) -> torch.Tensor:
        """uint32 limbs (numpy) or a limb tensor -> int32 on the device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return fo.to_torch(a, self.device)

    def _index(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.int64)
        return fo.upload(torch.from_numpy(np.asarray(a, np.int64)),
                         self.device)

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

    def _mxu_tabs(self, width_2k: bool = False):
        """The int8 engine's tables for a k-width encode, or None: 2k mask
        rows (once per proof) keep the butterfly encode, which saves a
        second table set for a cold geometry."""
        return self.codec.mxu_tabs if self.use_mxu and not width_2k else None

    # ---- stage 1: commit -------------------------------------------------

    def commit_step(self, sha, rows, valid_count, *, width_2k=False):
        dom = self.codec.dom_2k if width_2k else self.codec.dom_k
        state, pending, has_pending = sha
        return _commit_body(state, pending, has_pending, self._limbs(rows),
                            int(valid_count), dom, self.codec.dom_n, self.n,
                            self._mxu_tabs(width_2k))

    # ---- stage 2: checks -------------------------------------------------

    def check_step(self, accs, rows, rands, code_rs, tri_idx, tri_r,
                   pair_idx, pair_r, rands_zero=False):
        # KQ checks the quadratic test's indices and scalars on the host
        # and uploads them together
        return _check_body(*accs, self._limbs(rows), self._limbs(rands),
                           self._limbs(code_rs), tri_idx, tri_r, pair_idx,
                           pair_r, self.codec.dom_k, self.codec.dom_n,
                           self.n, rands_zero, self._mxu_tabs())

    def mask_step(self, accs, code_row, linear_row, quad_row):
        return _mask_body(*accs, self._limbs(code_row),
                          self._limbs(linear_row), self._limbs(quad_row),
                          self.codec.dom_k, self.codec.dom_2k,
                          self.codec.dom_n, self.n)

    # ---- stage 3: openings ----------------------------------------------

    def open_step(self, rows, sample_idx, *, width_2k=False):
        dom = self.codec.dom_2k if width_2k else self.codec.dom_k
        return _open_body(self._limbs(rows), self._index(sample_idx), dom,
                          self.codec.dom_n, self.n, self._mxu_tabs(width_2k))

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
        """(n, 8) -> (n, 8) decoded (see ops.ntt.decode_rows_cg_planar)."""
        return decode_rows_cg_planar(self._limbs(codeword)[None],
                                     self.codec.dom_k, self.codec.dom_n,
                                     self.k)[0]

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
