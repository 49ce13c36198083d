"""Typed engine configuration.

The reference's only knobs are a compile-time MAX_KMER_LENGTH
(/root/reference/kmer.h:18) and Postgres GUCs (e.g. SET enable_seqscan,
kmer-tests.sql:1297).  The engine makes configuration first-class: one
dataclass consumed by the CLI, the counting pipeline, and the mesh layer.
"""

from __future__ import annotations

import dataclasses

from .codec import MAX_K


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-wide settings.

    k:            window size for extraction/counting (1..32).
    canonical:    count min(kmer, revcomp) instead of forward kmers
                  (off for reference parity; on for the north-star metric).
    chunk_reads:  reads per device batch for streaming counts.
    read_len:     padded read length for batched pipelines.
    mesh_shape:   (data, seq) device mesh extents; None = single device.
    """

    k: int = 21
    canonical: bool = False
    chunk_reads: int = 1 << 17
    read_len: int = 150
    mesh_shape: tuple[int, int] | None = None

    def __post_init__(self):
        if not (0 < self.k <= MAX_K):
            from .errors import InvalidKmerLengthError

            raise InvalidKmerLengthError()

    def windows_per_read(self) -> int:
        return self.read_len - self.k + 1
