"""Columnar packed k-mer arrays — the engine's core data layout.

A column of N kmers is a struct-of-arrays ``PackedKmers(hi, lo, length)``:
two uint32 lanes holding the left-aligned 64-bit key (hi = bases 0..15,
lo = bases 16..31) plus an int32 length.  This is the engine's
replacement for the reference's per-row varlena heap tuples: everything
downstream (predicates, counting, indexing, collectives) operates on these
three dense arrays.

Ordering invariant: lexicographic string order == tuple order
(hi, lo, length), because the 2-bit code order matches the byte order of
lowercase acgt and padding bits are zero (see codec.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import jax
import numpy as np

from . import codec
from .types import Kmer


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PackedKmers:
    """N packed kmers as (hi, lo, length) arrays (jnp or np)."""

    hi: jax.Array | np.ndarray
    lo: jax.Array | np.ndarray
    length: jax.Array | np.ndarray

    def __len__(self) -> int:
        return int(self.hi.shape[-1]) if self.hi.ndim else 1

    @property
    def shape(self):
        return self.hi.shape

    # --- construction --------------------------------------------------------

    @classmethod
    def from_strings(cls, seqs: Iterable[str]) -> "PackedKmers":
        codes, lengths = codec.strings_to_padded_codes(
            list(seqs), width=codec.MAX_K, encoder=codec.encode_kmer
        )
        key64, lengths = codec.pack_batch(codes, lengths)
        hi = (key64 >> np.uint64(32)).astype(np.uint32)
        lo = (key64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return cls(hi=hi, lo=lo, length=lengths)

    @classmethod
    def from_kmers(cls, kmers: Iterable[Kmer]) -> "PackedKmers":
        kmers = list(kmers)
        n = len(kmers)
        hi = np.zeros(n, dtype=np.uint32)
        lo = np.zeros(n, dtype=np.uint32)
        ln = np.zeros(n, dtype=np.int32)
        for i, km in enumerate(kmers):
            h, l = km.hi_lo
            hi[i], lo[i], ln[i] = h, l, len(km)
        return cls(hi=hi, lo=lo, length=ln)

    @classmethod
    def single(cls, kmer: Kmer) -> "PackedKmers":
        return cls.from_kmers([kmer])

    # --- conversion ----------------------------------------------------------

    def to_numpy(self) -> "PackedKmers":
        return PackedKmers(
            hi=np.asarray(self.hi), lo=np.asarray(self.lo), length=np.asarray(self.length)
        )

    def key64(self) -> np.ndarray:
        """Host-side combined uint64 keys (for numpy sorting / searchsorted)."""
        return codec.join_key64(np.asarray(self.hi), np.asarray(self.lo))

    def to_strings(self) -> list[str]:
        hi = np.asarray(self.hi)
        lo = np.asarray(self.lo)
        ln = np.asarray(self.length)
        keys = codec.join_key64(hi, lo)
        return [
            codec.decode_codes(codec.unpack_key64(keys[i], int(ln[i])))
            for i in range(keys.size)
        ]

    def to_kmers(self) -> list[Kmer]:
        return [Kmer(s) for s in self.to_strings()]

    def __getitem__(self, idx) -> "PackedKmers":
        return PackedKmers(hi=self.hi[idx], lo=self.lo[idx], length=self.length[idx])


def concat(columns: Iterable[PackedKmers]) -> PackedKmers:
    cols = list(columns)
    cat = np.concatenate if isinstance(cols[0].hi, np.ndarray) else jax.numpy.concatenate
    return PackedKmers(
        hi=cat([c.hi for c in cols]),
        lo=cat([c.lo for c in cols]),
        length=cat([c.length for c in cols]),
    )
