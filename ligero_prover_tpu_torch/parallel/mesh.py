"""Column-sharded prover over the devices of one process.

Port of ``ligero_prover_tpu.parallel.mesh``.  The prover's parallel axis
is the codeword-column axis (n): the per-column SHA-256 states and the
code/linear/quadratic test accumulators never mix columns, and only the
NTT mixes them.  The JAX package lets GSPMD insert collective-permutes for
the NTT stages that cross shards.  Here no stage crosses a shard: shard d
of D owns the strided columns j = d + D*t (t < m = n/D), the evaluations
of each row's polynomial on a coset of the subgroup of order m, and
encodes them itself from the row's coefficients (``ops.ntt``'s coset
encode).  Which shard holds a column never reaches the proof.

Per flush, the iNTT of the rows runs once on the home device (the mesh's
first) and its coefficients go to every shard (``Tensor.to``; PyTorch
orders a copy between cards with events on both devices' current streams,
so a shard's kernels read the coefficients only after they land).  Each
shard then twists, folds and transforms its m columns and absorbs them
into its SHA states (stage 1), accumulates its share of the three tests
(stage 2), or gathers its sampled columns (stage 3).  Digests, fetches and
decodes gather the shards into natural column order on the home device
and run the single-device code; the verifier's 192-column pipelines are
inherited unchanged.  The int8 engine stays off, as in the reference
(``mesh.py:66-67``).  Proof bytes equal the single-device prover's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fieldops as fo
from ..ops import sha256 as tsha
from ..ops.ntt import coset_coeffs, coset_tables, encode_rows_coset, \
    encode_rows_coset_planar_core
from ..zkp.executor import TorchExecutor, _check_terms_aos, \
    _check_terms_planar


class Mesh:
    """A 1-D mesh: the devices of the column shards, shard d on
    ``devices[d]``.  A device may appear more than once, so several shards
    can share one card or the CPU."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None) -> Mesh:
    """A mesh over `devices` (names or ``torch.device``s; repeats allowed),
    by default every visible CUDA device; with no card that raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(): no CUDA device is visible; "
                               "name the devices, e.g. ['cpu'] * 8")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices)


class ColumnShards:
    """A tensor split along its column axis over a mesh: ``parts[d]``
    holds columns d, d + D, d + 2D, ... of the whole, on shard d's
    device."""

    __slots__ = ("parts", "axis")

    def __init__(self, parts, axis: int):
        self.parts = tuple(parts)
        self.axis = axis

    def gather(self, device) -> torch.Tensor:
        """The whole tensor, columns in natural order, on `device`."""
        parts = [p.to(device) for p in self.parts]
        return torch.stack(parts, dim=self.axis + 1) \
            .flatten(self.axis, self.axis + 1)


def shard(x: torch.Tensor, devices, axis: int) -> ColumnShards:
    """Split `x` along `axis` into len(devices) strided column shards,
    shard d on devices[d]."""
    v = x.unflatten(axis, (-1, len(devices)))
    return ColumnShards([v.select(axis + 1, d).contiguous().to(dev)
                         for d, dev in enumerate(devices)], axis)


class ShardedExecutor(TorchExecutor):
    """A :class:`TorchExecutor` whose stage-1 to stage-3 steps run on D
    column shards over `mesh` (D a power of two dividing n).

    Column state (the (8, n) SHA states and (n, 8) pending elements of
    stage 1, the (n, 8) accumulators of stage 2) is held as
    :class:`ColumnShards`; a whole (n, 8) accumulator handed in, as the
    stage-2 context's zeros are, is split at its first use."""

    def __init__(self, k: int, n: int, mesh: Mesh, batch_rows: int = 16):
        self.mesh = mesh
        D = self.mesh.size
        if D & (D - 1) or n % D:
            raise ValueError(f"{D} shards: the shard count must be a power "
                             f"of two dividing n={n}")
        super().__init__(k, n, batch_rows, self.mesh.devices[0])
        self.use_mxu = False
        self.shards = [coset_tables(k, n, D, d, dev)
                       for d, dev in enumerate(self.mesh.devices)]

    # ---- shards ----------------------------------------------------------

    def _split(self, x, axis: int) -> ColumnShards:
        if isinstance(x, ColumnShards):
            return x
        return shard(self._limbs(x), self.mesh.devices, axis)

    def _gather(self, x):
        return x.gather(self.device) if isinstance(x, ColumnShards) else x

    def _spread(self, x: torch.Tensor) -> dict:
        """`x` on every device of the mesh, one copy per device."""
        return {dev: x.to(dev) for dev in set(self.mesh.devices)}

    def _coeffs(self, rows, width_2k: bool = False) -> dict:
        """The rows' iNTT coefficients, computed once on the home device
        and copied to every device of the mesh."""
        dom = self.codec.dom_2k if width_2k else self.codec.dom_k
        return self._spread(coset_coeffs(self._limbs(rows), dom,
                                         self.use_planar))

    def _encode(self, coeffs: dict, d: int) -> torch.Tensor:
        """Shard d's columns of the encoded rows: (8, B, m) planes, or
        (B, m, 8) on the AoS path."""
        c = coeffs[self.mesh.devices[d]]
        if self.use_planar:
            return encode_rows_coset_planar_core(c, self.shards[d])
        return encode_rows_coset(c, self.shards[d])

    def _aos(self, cw: torch.Tensor) -> torch.Tensor:
        return cw.movedim(0, -1).contiguous() if self.use_planar else cw

    # ---- stage 1: commit -------------------------------------------------

    def sha_init(self, num_cols: int):
        """Sharded states for the n codeword columns; whole ones for any
        other count (the verifier's 192 sampled columns)."""
        state, pending, has_pending = super().sha_init(num_cols)
        if num_cols != self.n:
            return state, pending, has_pending
        return self._split(state, 1), self._split(pending, 0), has_pending

    def commit_step(self, sha, rows, valid_count, *, width_2k=False):
        state, pending, has_pending = sha
        if not isinstance(state, ColumnShards):
            return super().commit_step(sha, rows, valid_count,
                                       width_2k=width_2k)
        coeffs = self._coeffs(rows, width_2k)
        absorb = tsha.absorb_stream_planar if self.use_planar \
            else tsha.absorb_stream
        out = [absorb(st, pe, has_pending, self._encode(coeffs, d),
                      int(valid_count))
               for d, (st, pe) in enumerate(zip(state.parts, pending.parts))]
        return (ColumnShards([o[0] for o in out], 1),
                ColumnShards([o[1] for o in out], 0), out[0][2])

    def sha_finalize(self, sha, rows_absorbed: int):
        state, pending, has_pending = sha
        return super().sha_finalize(
            (self._gather(state), self._gather(pending), has_pending),
            rows_absorbed)

    # ---- stage 2: checks -------------------------------------------------

    def check_step(self, accs, rows, rands, code_rs, tri_idx, tri_r,
                   pair_idx, pair_r, rands_zero=False):
        accs = [self._split(a, 0) for a in accs]
        e = self._coeffs(rows)
        r = None if rands_zero else self._coeffs(rands)
        code_rs, tri_r, pair_r = (self._spread(self._limbs(a))
                                  for a in (code_rs, tri_r, pair_r))
        out = []
        for d, dev in enumerate(self.mesh.devices):
            if self.use_planar:    # quad-terms checks host indices
                terms, tri, pair = _check_terms_planar, tri_idx, pair_idx
            else:
                terms = _check_terms_aos
                tri, pair = (self._index(a).to(dev)
                             for a in (tri_idx, pair_idx))
            out.append(terms(
                *(a.parts[d] for a in accs), self._encode(e, d),
                None if r is None else self._encode(r, d), code_rs[dev],
                tri, tri_r[dev], pair, pair_r[dev]))
        return tuple(ColumnShards([o[i] for o in out], 0) for i in range(3))

    def mask_step(self, accs, code_row, linear_row, quad_row):
        accs = [self._split(a, 0) for a in accs]
        code = self._coeffs(self._limbs(code_row)[None])
        masks = self._coeffs(torch.stack([self._limbs(linear_row),
                                          self._limbs(quad_row)]),
                             width_2k=True)
        out = []
        for d in range(self.mesh.size):
            cw = self._aos(self._encode(code, d))[0]
            mw = self._aos(self._encode(masks, d))
            out.append((fo.addmod(accs[0].parts[d], cw),
                        fo.addmod(accs[1].parts[d], mw[0]),
                        fo.addmod(accs[2].parts[d], mw[1])))
        return tuple(ColumnShards([o[i] for o in out], 0) for i in range(3))

    # ---- stage 3: openings ----------------------------------------------

    def open_step(self, rows, sample_idx, *, width_2k=False):
        """(B, S, 8) sampled columns on the home device: shard d encodes
        and gathers the sampled columns it owns (idx % D == d, at local
        index idx // D), put back in `sample_idx` order."""
        idx = np.asarray(sample_idx, np.int64)
        D = self.mesh.size
        coeffs = self._coeffs(rows, width_2k)
        out = torch.empty((len(rows), len(idx), 8), dtype=torch.int32,
                          device=self.device)
        for d, dev in enumerate(self.mesh.devices):
            pos = np.flatnonzero(idx % D == d)
            if not len(pos):
                continue
            local = torch.from_numpy(idx[pos] // D).to(dev)
            cw = self._encode(coeffs, d)
            cols = cw.index_select(2, local).movedim(0, -1) \
                if self.use_planar else cw.index_select(1, local)
            out.index_copy_(1, torch.from_numpy(pos).to(self.device),
                            cols.to(self.device))
        return out

    # ---- whole columns on the home device -------------------------------

    def fetch(self, x) -> np.ndarray:
        return super().fetch(self._gather(x))

    def decode(self, codeword):
        return super().decode(self._gather(codeword))
