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


def domain_tables_from_numpy(dom: dict, device=None) -> dict:
    """A ``build_domain_tables`` dict of the JAX package -> the port's
    constant-geometry tables (``rev``, ``cg_fwd``, ``cg_inv``,
    ``n_inv_mont``)."""
    return {
        "rev": torch.from_numpy(
            np.asarray(dom["rev"]).astype(np.int64)).to(device),
        "cg_fwd": to_torch(np.asarray(dom["cg_fwd"]), device),
        "cg_inv": to_torch(np.asarray(dom["cg_inv"]), device),
        "n_inv_mont": to_torch(np.asarray(dom["n_inv_mont"]), device),
    }


def sha_from_numpy(sha, device=None):
    """(state (8, C), pending (C, 8), has_pending) -> executor SHA state."""
    state, pending, has_pending = sha
    return (to_torch(np.asarray(state), device),
            to_torch(np.asarray(pending), device),
            bool(np.asarray(has_pending)))


def accs_from_numpy(accs, device=None):
    """(code, linear, quad) accumulators (…, 8) -> executor tensors."""
    return tuple(to_torch(np.asarray(a), device) for a in accs)


def to_numpy(x):
    """Executor output -> numpy: limb tensors become uint32, tuples recurse,
    Python scalars pass through."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32:
            return _limbs_to_numpy(x)
        return x.detach().cpu().numpy()
    return x
