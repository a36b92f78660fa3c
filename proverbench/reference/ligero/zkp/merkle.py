"""Array-backed SHA-256 Merkle tree with multi-index decommitment.

Layout and traversal mirror ``include/zkp/merkle_tree.hpp``: a heap-ordered
array of 2*ceil2(n)-1 digests, node i's children at 2i+1 / 2i+2, inner node
hash = SHA256(left || right).  Decommitments collect the minimal sibling set
level-by-level (bottom-up, left-to-right), which also defines the canonical
sibling ordering used by the proof serializer
(``zkp/proof_serializer.hpp:82-117``).
"""

from __future__ import annotations

import hashlib

ZERO_DIGEST = bytes(32)


def _hash2(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def _bit_ceil(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


class MerkleTree:
    def __init__(self, leaf_digests: list[bytes]):
        leaves = _bit_ceil(len(leaf_digests))
        self.num_nodes = 2 * leaves - 1
        nodes = [ZERO_DIGEST] * self.num_nodes
        off = leaves - 1
        nodes[off:off + len(leaf_digests)] = leaf_digests
        for i in range(off - 1, -1, -1):
            nodes[i] = _hash2(nodes[2 * i + 1], nodes[2 * i + 2])
        self.nodes = nodes

    @property
    def root(self) -> bytes:
        return self.nodes[0]

    def decommit(self, leaf_indices: list[int]) -> dict[int, bytes]:
        """Minimal sibling digests, keyed by tree position."""
        out: dict[int, bytes] = {}
        for pos in sibling_positions(leaf_indices, self.num_nodes):
            out[pos] = self.nodes[pos]
        return out


def sibling_positions(leaf_indices: list[int], total_count: int) -> list[int]:
    """Canonical order of sibling tree positions (bottom-up, left-to-right),
    as in ``proof_serializer.hpp:82-117``."""
    positions: list[int] = []
    known = set(leaf_indices)
    start, end = total_count // 2, total_count
    while start > 0:
        upper = set()
        for i in range(start, end, 2):
            ll = i - start
            lr = ll + 1
            lp = ll // 2
            kl, kr = ll in known, lr in known
            if kl and kr:
                upper.add(lp)
            elif kr:
                positions.append(i)
                upper.add(lp)
            elif kl:
                positions.append(i + 1)
                upper.add(lp)
        known = upper
        start, end = (start - 1) // 2, (end - 1) // 2
    return positions


def recommit(leaf_digests: list[bytes], leaf_indices: list[int],
             siblings: dict[int, bytes], total_count: int) -> bytes:
    """Reconstruct the root from sampled leaves plus sibling set
    (``merkle_tree.hpp:232-318``).  Raises KeyError on a malformed proof."""
    assert len(leaf_digests) == len(leaf_indices)
    buffer: dict[int, bytes] = {leaf_indices[i]: leaf_digests[i]
                                for i in range(len(leaf_indices))}
    known = set(leaf_indices)
    start, end = total_count // 2, total_count
    while start > 0:
        upper = set()
        for i in range(start, end, 2):
            ll = i - start
            lr = ll + 1
            lp = ll // 2
            kl, kr = ll in known, lr in known
            if kl and kr:
                buffer[lp] = _hash2(buffer[ll], buffer[lr])
                upper.add(lp)
            elif kr:
                buffer[lp] = _hash2(siblings[i], buffer[lr])
                upper.add(lp)
            elif kl:
                buffer[lp] = _hash2(buffer[ll], siblings[i + 1])
                upper.add(lp)
        known = upper
        # keep only the upper level entries; indices are level-local
        buffer = {k: buffer[k] for k in upper}
        start, end = (start - 1) // 2, (end - 1) // 2
    return buffer[0]
