"""Column-sharded prover over the devices of one process, or of every
process of a ``torch.distributed`` process group.

Port of ``ligero_prover_tpu.parallel.mesh``.  The prover's parallel axis
is the codeword-column axis (n): the per-column SHA-256 states and the
code/linear/quadratic test accumulators never mix columns, and only the
NTT mixes them.  The JAX package lets GSPMD insert collective-permutes for
the NTT stages that cross shards.  Here no stage crosses a shard: shard d
of D owns the strided columns j = d + D*t (t < m = n/D), the evaluations
of each row's polynomial on a coset of the subgroup of order m, and
encodes them itself from the row's coefficients (``ops.ntt``'s coset
encode).  Which shard holds a column never reaches the proof.

Per flush, every process runs the iNTT of the rows once on its home device
(its first) and copies the coefficients to each of its shards' devices
(``Tensor.to``; PyTorch orders a copy between cards with events on both
devices' current streams, so a shard's kernels read the coefficients only
after they land).  Each shard then twists, folds and transforms its m
columns and absorbs them into its SHA states (stage 1), accumulates its
share of the three tests (stage 2), or gathers its sampled columns (stage
3).  Digests, fetches and decodes gather the shards into natural column
order on the home device and run the single-device code; the verifier's
192-column pipelines are inherited unchanged.  The int8 engine stays off,
as in the reference (``mesh.py:66-67``).  Proof bytes equal the
single-device prover's.

Across processes (the reference's multi-process mesh, ``mesh.py:133-153``)
rank r of P holds shards [r*L, (r+1)*L).  Every rank replays the same
program, so every rank holds the rows, and the ranks make the same
collectives in the same order: a gather of column state is an
``all_gather`` over the group, after which every rank holds the same
bytes and derives the same Fiat-Shamir transcript.  A mesh of one process
makes no ``torch.distributed`` call.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops import fieldops as fo
from ..ops import sha256 as tsha
from ..ops.ntt import coset_coeffs, coset_tables, encode_rows_coset, \
    encode_rows_coset_planar_core
from ..zkp.executor import TorchExecutor, _check_terms_aos, \
    _check_terms_planar


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Mesh:
    """A 1-D mesh of D = P*L column shards: L on each of the P ranks of
    `group`, shard d on rank d // L, on that rank's device
    ``devices[d % L]``.  `devices` are this process's devices; a device
    may appear more than once, so several shards can share one card or
    the CPU.  Without a group, or with a group of one, the mesh is this
    process's devices alone (P = 1) and makes no ``torch.distributed``
    call.

    ``counts`` tallies this rank's collectives: how many, the bytes each
    tensor gather delivers to it, the host seconds they took (the device
    synchronised before and after, so the wait for the slowest rank is
    in them, and the kernels queued before are not), and ``staged_bytes``
    copied through the host because the backend gathers only CPU tensors
    (gloo with CUDA parts)."""

    def __init__(self, devices, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.counts = {"collectives": 0, "bytes": 0, "seconds": 0.0,
                       "staged_bytes": 0}
        self.group, self.rank, self.world, self.backend = None, 0, 1, None
        if group is None or dist.get_world_size(group) == 1:
            return
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        if "nccl" in self.backend:
            # NCCL's object collectives run on the current device
            torch.cuda.set_device(self.devices[0])
        counts = self.all_gather_object(len(self.devices))
        if len(set(counts)) != 1:
            raise ValueError(f"the ranks hold {counts} devices: every rank "
                             f"of a mesh needs as many shards")

    @property
    def size(self) -> int:
        """D, the shard count over every rank."""
        return self.world * len(self.devices)

    @property
    def local_shards(self) -> range:
        """The global indices of this rank's shards, one per device."""
        L = len(self.devices)
        return range(self.rank * L, (self.rank + 1) * L)

    def _counted(self, t0: float, nbytes: int = 0):
        self.counts["collectives"] += 1
        self.counts["bytes"] += nbytes
        self.counts["seconds"] += time.perf_counter() - t0

    def reset_counts(self):
        for key in self.counts:
            self.counts[key] = type(self.counts[key])()

    def all_gather_object(self, obj) -> list:
        """`obj` of every rank, in rank order."""
        t0 = time.perf_counter()
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        self._counted(t0)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """`x` of every rank (equal shapes), stacked in rank order:
        (P, *x.shape) on x's device.  A CUDA tensor goes through the host
        when the group's backend is not NCCL: gloo gathers only CPU
        tensors."""
        dev = x.device
        staged = dev.type == "cuda" and "nccl" not in self.backend
        _sync(dev)
        t0 = time.perf_counter()
        src = x.cpu() if staged else x.contiguous()
        out = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(out, src, group=self.group)
        res = torch.stack(out).to(dev)
        _sync(dev)
        nbytes = res.numel() * res.element_size()
        self._counted(t0, nbytes)
        if staged:
            self.counts["staged_bytes"] += \
                nbytes + src.numel() * src.element_size()
        return res

    def shared_seed(self, seed: bytes | None) -> bytes:
        """The encoding seed every rank proves under: `seed`, which every
        rank must be given alike (compared by SHA-256; all ranks raise if
        any differs), or, when every rank passes None, 32 bytes that rank
        0 draws.  One process draws its own."""
        if self.world == 1:
            return os.urandom(32) if seed is None else seed
        digest = None if seed is None else hashlib.sha256(seed).digest()
        drawn = os.urandom(32) if self.rank == 0 else None
        got = self.all_gather_object((digest, drawn))
        digests = {d for d, _ in got}
        if len(digests) != 1:
            raise ValueError("the ranks of the mesh were given different "
                             "encoding seeds")
        return got[0][1] if seed is None else seed


def make_mesh(devices=None, group=None) -> Mesh:
    """A mesh over every rank of `group` (by default the default process
    group when one is initialized), each rank with `devices` (names or
    ``torch.device``s; repeats allowed).  By default a rank of a group of
    several takes its current CUDA device (the torchrun layout) and a
    single process every visible CUDA device; with no card that raises.
    The caller initializes the group (``init_process_group``) first."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    ranks = dist.get_world_size(group) if group is not None else 1
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(): no CUDA device is visible; "
                               "name the devices, e.g. ['cpu'] * 8")
        devices = [torch.device("cuda", torch.cuda.current_device())] \
            if ranks > 1 else [torch.device("cuda", i)
                               for i in range(torch.cuda.device_count())]
    return Mesh(devices, group)


class ColumnShards:
    """A tensor split along its column axis over a mesh: this rank's
    ``parts[i]`` holds columns d, d + D, d + 2D, ... of the whole, with d
    = ``mesh.local_shards[i]``, on the mesh's device i."""

    __slots__ = ("parts", "axis", "mesh")

    def __init__(self, parts, axis: int, mesh: Mesh):
        self.parts = tuple(parts)
        self.axis = axis
        self.mesh = mesh

    def gather(self, device) -> torch.Tensor:
        """The whole tensor, columns in natural order, on `device`; over
        several ranks an all-gather, after which every rank holds it."""
        parts = [p.to(device) for p in self.parts]
        if self.mesh.world > 1:
            parts = self.mesh.all_gather(torch.stack(parts)) \
                .flatten(0, 1).unbind(0)
        return torch.stack(parts, dim=self.axis + 1) \
            .flatten(self.axis, self.axis + 1)


def shard(x: torch.Tensor, mesh: Mesh, axis: int) -> ColumnShards:
    """This rank's strided column shards of `x` along `axis`: shard d of
    ``mesh.size``, for each d of ``mesh.local_shards``, on its device."""
    v = x.unflatten(axis, (-1, mesh.size))
    return ColumnShards([v.select(axis + 1, d).contiguous().to(dev)
                         for d, dev in zip(mesh.local_shards, mesh.devices)],
                        axis, mesh)


class ShardedExecutor(TorchExecutor):
    """A :class:`TorchExecutor` whose stage-1 to stage-3 steps run on D
    column shards over `mesh` (D a power of two dividing n); this process
    runs its own shards, ``mesh.local_shards``.

    Column state (the (8, n) SHA states and (n, 8) pending elements of
    stage 1, the (n, 8) accumulators of stage 2) is held as
    :class:`ColumnShards`; a whole (n, 8) accumulator handed in, as the
    stage-2 context's zeros are, is split at its first use.  Shard i of
    this process (global shard ``mesh.local_shards[i]``) runs on
    ``mesh.devices[i]``."""

    def __init__(self, k: int, n: int, mesh: Mesh, batch_rows: int = 16):
        self.mesh = mesh
        D = self.mesh.size
        if D & (D - 1) or n % D:
            raise ValueError(f"{D} shards: the shard count must be a power "
                             f"of two dividing n={n}")
        super().__init__(k, n, batch_rows, self.mesh.devices[0])
        self.use_mxu = False
        self.shards = [coset_tables(k, n, D, d, dev) for d, dev
                       in zip(self.mesh.local_shards, self.mesh.devices)]

    # ---- shards ----------------------------------------------------------

    def _split(self, x, axis: int) -> ColumnShards:
        if isinstance(x, ColumnShards):
            return x
        return shard(self._limbs(x), self.mesh, axis)

    def _shards(self, parts, axis: int) -> ColumnShards:
        return ColumnShards(parts, axis, self.mesh)

    def _gather(self, x):
        return x.gather(self.device) if isinstance(x, ColumnShards) else x

    def _spread(self, x: torch.Tensor) -> dict:
        """`x` on every device of this process's shards, one copy per
        device."""
        return {dev: x.to(dev) for dev in set(self.mesh.devices)}

    def _coeffs(self, rows, width_2k: bool = False) -> dict:
        """The rows' iNTT coefficients, computed once on the home device
        and copied to every device of this process's shards."""
        dom = self.codec.dom_2k if width_2k else self.codec.dom_k
        return self._spread(coset_coeffs(self._limbs(rows), dom,
                                         self.use_planar))

    def _encode(self, coeffs: dict, i: int) -> torch.Tensor:
        """Local shard i's columns of the encoded rows: (8, B, m) planes,
        or (B, m, 8) on the AoS path."""
        c = coeffs[self.mesh.devices[i]]
        if self.use_planar:
            return encode_rows_coset_planar_core(c, self.shards[i])
        return encode_rows_coset(c, self.shards[i])

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
        out = [absorb(st, pe, has_pending, self._encode(coeffs, i),
                      int(valid_count))
               for i, (st, pe) in enumerate(zip(state.parts, pending.parts))]
        return (self._shards([o[0] for o in out], 1),
                self._shards([o[1] for o in out], 0), out[0][2])

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
        for i, dev in enumerate(self.mesh.devices):
            if self.use_planar:    # quad-terms checks host indices
                terms, tri, pair = _check_terms_planar, tri_idx, pair_idx
            else:
                terms = _check_terms_aos
                tri, pair = (self._index(a).to(dev)
                             for a in (tri_idx, pair_idx))
            out.append(terms(
                *(a.parts[i] for a in accs), self._encode(e, i),
                None if r is None else self._encode(r, i), code_rs[dev],
                tri, tri_r[dev], pair, pair_r[dev]))
        return tuple(self._shards([o[j] for o in out], 0) for j in range(3))

    def mask_step(self, accs, code_row, linear_row, quad_row):
        accs = [self._split(a, 0) for a in accs]
        code = self._coeffs(self._limbs(code_row)[None])
        masks = self._coeffs(torch.stack([self._limbs(linear_row),
                                          self._limbs(quad_row)]),
                             width_2k=True)
        out = []
        for i in range(len(self.mesh.devices)):
            cw = self._aos(self._encode(code, i))[0]
            mw = self._aos(self._encode(masks, i))
            out.append((fo.addmod(accs[0].parts[i], cw),
                        fo.addmod(accs[1].parts[i], mw[0]),
                        fo.addmod(accs[2].parts[i], mw[1])))
        return tuple(self._shards([o[j] for o in out], 0) for j in range(3))

    # ---- stage 3: openings ----------------------------------------------

    def open_step(self, rows, sample_idx, *, width_2k=False):
        """(B, S, 8) sampled columns on the home device: shard d encodes
        and gathers the sampled columns it owns (idx % D == d, at local
        index idx // D), put back in `sample_idx` order.  Over several
        ranks each fills the columns of its own shards, the ranks
        all-gather their (B, S, 8) tensors, and each column is taken from
        its owner's (a selection: no limbs are added)."""
        idx = np.asarray(sample_idx, np.int64)
        D, L = self.mesh.size, len(self.mesh.devices)
        coeffs = self._coeffs(rows, width_2k)
        out = torch.empty((len(rows), len(idx), 8), dtype=torch.int32,
                          device=self.device)
        for i, (d, dev) in enumerate(zip(self.mesh.local_shards,
                                         self.mesh.devices)):
            pos = np.flatnonzero(idx % D == d)
            if not len(pos):
                continue
            local = torch.from_numpy(idx[pos] // D).to(dev)
            cw = self._encode(coeffs, i)
            cols = cw.index_select(2, local).movedim(0, -1) \
                if self.use_planar else cw.index_select(1, local)
            out.index_copy_(1, torch.from_numpy(pos).to(self.device),
                            cols.to(self.device))
        if self.mesh.world == 1:
            return out
        owner = torch.from_numpy(idx % D // L).to(self.device)
        every = self.mesh.all_gather(out)                   # (P, B, S, 8)
        return every.gather(0, owner.view(1, 1, -1, 1).expand(
            (1,) + out.shape))[0]

    # ---- whole columns on the home device -------------------------------

    def fetch(self, x) -> np.ndarray:
        return super().fetch(self._gather(x))

    def decode(self, codeword):
        return super().decode(self._gather(codeword))
