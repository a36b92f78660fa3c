"""The port's proof codec (``zkp/proof.py``) against the JAX package's:
the same gzip'd bytes from the same inputs, the same arrays, siblings and
metadata back, the same answers on hand-made wire forms, and the same
exceptions on malformed blobs.  CPU only; a few seconds."""

import functools
import gzip

import numpy as np
import pytest

from ligero_prover_tpu.zkp import proof as ref
from ligero_prover_tpu_torch.proto import ligero_proof_pb2 as proof_pb
from ligero_prover_tpu_torch.zkp import proof as port

import _torch_helpers  # noqa: F401  (thread count)
from _torch_helpers import rand_limbs

SAMPLES = 192
TIMESTAMP = 1_700_000_000


def _inputs(seed: int, n: int, rows: int, form: str = "flat") -> tuple:
    """serialize_proof's arguments for a codeword of n columns and `rows`
    opened rows, the vectors given in `form`."""
    gen = np.random.default_rng(seed)
    code, linear, quad = (rand_limbs(gen, (n,)) for _ in range(3))
    samplings = rand_limbs(gen, (rows, SAMPLES))
    leaf_indices = sorted(gen.choice(n, SAMPLES, replace=False).tolist())
    total = 2 * n - 1
    siblings = {pos: gen.bytes(32)
                for pos in ref.sibling_positions(leaf_indices, total)}
    if form == "flat":
        code, linear, quad = (x.reshape(-1) for x in (code, linear, quad))
        samplings = samplings.reshape(-1)
    elif form == "strided":         # every other limb of a wider array
        def strided(x):
            wide = np.zeros(x.shape[:-1] + (16,), np.uint32)
            wide[..., ::2] = x
            return wide[..., ::2]
        code, linear, quad, samplings = map(strided,
                                            (code, linear, quad, samplings))
        assert not code.flags.c_contiguous
    elif form == "int64":
        code, linear, quad, samplings = (
            x.reshape(-1).astype(np.int64)
            for x in (code, linear, quad, samplings))
    else:
        assert form == "rows"       # (n, 8) and (rows, 192, 8) as made
    return (b"\x5a" * 32, code, linear, quad, leaf_indices, siblings,
            samplings)


# name: (seed, n, rows, form); "full" is the benchmark cell's proof
# (k = 8192, n = 32768, 1,437 rows opened)
CASES = {
    "empty_samplings": (1, 1024, 0, "flat"),
    "k256": (2, 1024, 7, "flat"),
    "full": (3, 32768, 1437, "flat"),
    "rows_n8": (4, 1024, 5, "rows"),
    "strided_views": (5, 1024, 5, "strided"),
    "int64": (6, 1024, 5, "int64"),
}


@functools.lru_cache(maxsize=None)
def _case(name: str) -> tuple:
    """(inputs, the reference's blob) of a case."""
    seed, n, rows, form = CASES[name]
    args = _inputs(seed, n, rows, form)
    kw = dict(program_hash=b"\x11" * 32, k=n // 4, n=n,
              timestamp=TIMESTAMP)
    return args, kw, ref.serialize_proof(*args, **kw)


@pytest.mark.parametrize("name", CASES)
def test_serialize_matches_reference(name):
    args, kw, blob = _case(name)
    assert port.serialize_proof(*args, **kw) == blob


def _same_proof(got, want):
    for attr in ("encoded_code_limbs", "encoded_linear_limbs",
                 "encoded_quad_limbs", "host_samplings"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert g.dtype == np.uint32 and g.ndim == 1, attr
        assert g.flags.writeable and g.flags.owndata, attr
        np.testing.assert_array_equal(g, w, err_msg=attr)
    assert got.merkle_root == want.merkle_root
    assert got.leaf_indices == want.leaf_indices
    assert got.siblings == want.siblings
    assert (got.metadata.SerializeToString()
            == want.metadata.SerializeToString())


@pytest.mark.parametrize("name", CASES)
def test_deserialize_matches_reference(name):
    args, _, blob = _case(name)
    got, want = port.deserialize_proof(blob), ref.deserialize_proof(blob)
    _same_proof(got, want)
    np.testing.assert_array_equal(
        got.encoded_code_limbs, np.asarray(args[1], np.uint32).reshape(-1))


# -- hand-made wire forms -------------------------------------------------


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return (port._varint(number << 3 | 2) + port._varint(len(payload))
            + payload)


def _with_vector_part(blob: bytes, vector: int, part: bytes,
                      drop: bool) -> bytes:
    """`blob` with `part` merged into the vector of field number `vector`
    of the LigeroProof (field 2 of the envelope), that vector cleared first
    where `drop`."""
    env = proof_pb.LigeroProofEnvelope()
    env.ParseFromString(gzip.decompress(blob))
    if drop:
        env.ligero_proof.ClearField(
            proof_pb.LigeroProof.DESCRIPTOR.fields_by_number[vector].name)
    raw = env.SerializeToString() + _field(2, _field(vector, part))
    return gzip.compress(raw, compresslevel=6, mtime=0)


def _unpacked(blob: bytes) -> bytes:
    """encoded_linear (field 3) as one fixed32 field 1 per element."""
    values = ref.deserialize_proof(blob).encoded_linear_limbs
    part = b"".join(b"\x0d" + int(v).to_bytes(4, "little") for v in values)
    return _with_vector_part(blob, 3, part, drop=True)


def _unknown_field(blob: bytes) -> bytes:
    """encoded_code (field 2) with a varint field 9 it does not know."""
    return _with_vector_part(blob, 2, b"\x48\x01", drop=False)


def _only_unknown_field(blob: bytes) -> bytes:
    """encoded_code holding that field alone: two bytes, no values."""
    return _with_vector_part(blob, 2, b"\x48\x01", drop=True)


@pytest.mark.parametrize("make", [_unpacked, _unknown_field,
                                  _only_unknown_field],
                         ids=["unpacked_fixed32", "unknown_field",
                              "only_unknown_field"])
def test_hand_made_wire_forms(make):
    blob = make(_case("k256")[2])
    _same_proof(port.deserialize_proof(blob), ref.deserialize_proof(blob))


# -- malformed blobs ------------------------------------------------------


def _no_payload(blob):
    env = proof_pb.LigeroProofEnvelope()
    env.ParseFromString(gzip.decompress(blob))
    env.ClearField("ligero_proof")
    return gzip.compress(env.SerializeToString(), mtime=0)


def _short_root(blob):
    env = proof_pb.LigeroProofEnvelope()
    env.ParseFromString(gzip.decompress(blob))
    env.ligero_proof.merkle_tree.root.value = b"\x00" * 31
    return gzip.compress(env.SerializeToString(), mtime=0)


def _sibling_missing(blob):
    env = proof_pb.LigeroProofEnvelope()
    env.ParseFromString(gzip.decompress(blob))
    del env.ligero_proof.merkle_tree.sibling_hashes[-1]
    return gzip.compress(env.SerializeToString(), mtime=0)


def _truncated(blob):
    return blob[:len(blob) // 2]


@pytest.mark.parametrize("spoil", [_no_payload, _short_root,
                                   _sibling_missing, _truncated],
                         ids=lambda f: f.__name__.strip("_"))
def test_malformed_raises_as_reference(spoil):
    blob = spoil(_case("k256")[2])
    with pytest.raises(Exception) as want:
        ref.deserialize_proof(blob)
    with pytest.raises(Exception) as got:
        port.deserialize_proof(blob)
    assert got.type is want.type
    assert str(got.value) == str(want.value)
