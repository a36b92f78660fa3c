"""numpy <-> port conversions for tables and executor state.

The JAX package and the port share one ABI: BN254-Fr elements are (..., 8)
little-endian u32 limbs.  These helpers move reference tables and
mid-stream executor state into the port (and back), so both executors can
be started from the same state.  They take anything ``np.asarray``
accepts and never import JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.fieldops import to_torch, to_numpy as _limbs_to_numpy
from .ops.mxu_ntt import TABLE_KEYS, tables_to_device
from .parallel.mesh import ColumnShards, Mesh, shard


def domain_tables_from_numpy(dom: dict, device=None) -> dict:
    """A ``build_domain_tables`` dict of the JAX package -> the port's
    constant-geometry tables (``rev``, ``cg_fwd``, ``cg_inv``, their
    (log2 n, 8, n/2) planar forms ``cg_fwd_pl``/``cg_inv_pl`` as the
    reference's planar scans read them (``tw.T`` per stage), and
    ``n_inv_mont``)."""
    planar = {f"{key}_pl": to_torch(np.ascontiguousarray(
        np.asarray(dom[key]).transpose(0, 2, 1)), device)
        for key in ("cg_fwd", "cg_inv")}
    return planar | {
        "rev": torch.from_numpy(
            np.asarray(dom["rev"]).astype(np.int64)).to(device),
        "cg_fwd": to_torch(np.asarray(dom["cg_fwd"]), device),
        "cg_inv": to_torch(np.asarray(dom["cg_inv"]), device),
        "n_inv_mont": to_torch(np.asarray(dom["n_inv_mont"]), device),
    }


def mxu_tables_from_numpy(tabs: dict, device=None) -> dict:
    """A ``mxu_ntt.build_codec_tables`` dict of the JAX package (int8
    matrices ``w1``, ``wm``, ``w4``, uint32 twiddles ``tw1``, ``tw3`` and
    the ``geom`` tuple) -> the port's device tables of the int8 engine."""
    host = {key: np.asarray(tabs[key]) for key in TABLE_KEYS}
    host["geom"] = tuple(tabs["geom"])
    return tables_to_device(host, device)


def sha_from_numpy(sha, device=None):
    """(state (8, C), pending (C, 8), has_pending) -> executor SHA state."""
    state, pending, has_pending = sha
    return (to_torch(np.asarray(state), device),
            to_torch(np.asarray(pending), device),
            bool(np.asarray(has_pending)))


def accs_from_numpy(accs, device=None):
    """(code, linear, quad) accumulators (…, 8) -> executor tensors."""
    return tuple(to_torch(np.asarray(a), device) for a in accs)


def shard_columns(arr, D: int, axis: int = 0,
                  mesh: Mesh | None = None) -> ColumnShards:
    """Whole column state (a SHA state (8, n): columns on axis 1; pending
    elements or accumulators (n, 8): axis 0) -> the sharded executor's
    :class:`ColumnShards` over D shards, shard d holding columns
    j = d (mod D): all D on the CPU, or with `mesh` (of D shards over P
    ranks, L each) rank r's share, shards [r*L, (r+1)*L) on its
    devices."""
    x = arr if isinstance(arr, torch.Tensor) else to_torch(np.asarray(arr))
    if mesh is None:
        mesh = Mesh([torch.device("cpu")] * D)
    elif mesh.size != D:
        raise ValueError(f"a mesh of {mesh.size} shards, not {D}")
    return shard(x, mesh, axis)


def gather_columns(shards: ColumnShards) -> np.ndarray:
    """:class:`ColumnShards` -> the whole state as uint32 numpy, columns in
    natural order (over several ranks an all-gather: every rank calls
    it)."""
    return _limbs_to_numpy(shards.gather("cpu"))


def to_numpy(x):
    """Executor output -> numpy: limb tensors become uint32, column shards
    are gathered, tuples recurse, Python scalars pass through."""
    if isinstance(x, ColumnShards):
        return gather_columns(x)
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32:
            return _limbs_to_numpy(x)
        return x.detach().cpu().numpy()
    return x
