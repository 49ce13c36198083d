from .predicates import (  # noqa: F401
    contains,
    containing,
    equals,
    kmer_hash,
    length,
    starts_with,
    starts_with_op,
    v_contains,
    v_equals,
    v_hash,
    v_starts_with,
)
from .extract import generate_kmers, extract_windows, extract_windows_batch  # noqa: F401
from .count import count_kmers, count_kmers_jit, CountTable  # noqa: F401
