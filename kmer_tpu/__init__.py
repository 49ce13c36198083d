"""kmer_tpu — an exact k-mer engine in JAX.

Built from scratch in JAX/XLA with the capabilities of the
`kmer-extension` PostgreSQL reference (see SURVEY.md): DNA/kmer/qkmer
datatypes, predicates (=, ^@, @>, <@), sliding-window extraction
(generate_kmers), exact counting (GROUP BY semantics), and an indexed
query path replacing the reference's SP-GiST trie — scaled across
device meshes via shard_map collectives.

Public surface mirrors kmer--1.0.0.sql's 3 types + 11 functions +
4 operators, re-shaped as a columnar batch API.
"""

from .errors import (  # noqa: F401
    InvalidDnaSequenceError,
    InvalidKmerLengthError,
    InvalidQkmerSequenceError,
    KmerEngineError,
    KmerTooLongError,
    QkmerTooLongError,
)
from .types import Dna, Kmer, Qkmer  # noqa: F401
from .packed import PackedKmers  # noqa: F401
from .ops import (  # noqa: F401
    CountTable,
    contains,
    containing,
    count_kmers,
    equals,
    generate_kmers,
    kmer_hash,
    length,
    starts_with,
    starts_with_op,
)
from .ops.count import count_column, count_dna, merge_tables  # noqa: F401
from .index import DeviceHashIndex, DeviceIndex, KmerIndex  # noqa: F401
from .config import EngineConfig  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # KmerTable imports jax-heavy modules; load lazily from the package root
    if name == "KmerTable":
        from .api import KmerTable

        return KmerTable
    raise AttributeError(f"module 'kmer_tpu' has no attribute {name!r}")
