"""KmerCounter flagship pipeline tests."""

import collections

import jax
import numpy as np
import pytest

from kmer_tpu.codec import decode_codes
from kmer_tpu.config import EngineConfig
from kmer_tpu.errors import InvalidKmerLengthError
from kmer_tpu.models import KmerCounter
from kmer_tpu.ops.extract import extract_to_strings, simulate_reads
from kmer_tpu.parallel.mesh import make_mesh


def _oracle(reads, lengths, k, canonical=False):
    comp = {"a": "t", "c": "g", "g": "c", "t": "a"}
    want = collections.Counter()
    for row, ln in zip(reads, lengths):
        if ln < k:
            continue
        for km in extract_to_strings(decode_codes(row[:ln]), k):
            if canonical:
                rc = "".join(comp[c] for c in reversed(km))
                km = min(km, rc)
            want[km] += 1
    return dict(want)


class TestKmerCounter:
    def test_small_k_uses_dense_and_matches(self):
        # small k runs the sort route like every other k
        cfg = EngineConfig(k=6, canonical=True)
        model = KmerCounter(cfg)
        reads = simulate_reads(32, 40, seed=1)
        lengths = np.full(32, 40, np.int32)
        table = model.step(reads, lengths)
        assert table.to_dict() == _oracle(reads, lengths, 6, canonical=True)

    def test_large_k_sort_path(self):
        cfg = EngineConfig(k=21, canonical=False)
        model = KmerCounter(cfg)
        reads = simulate_reads(16, 50, seed=2)
        lengths = np.full(16, 50, np.int32)
        table = model.step(reads, lengths)
        assert table.to_dict() == _oracle(reads, lengths, 21)

    def test_sharded_matches_single(self):
        cfg = EngineConfig(k=11, canonical=True)
        model = KmerCounter(cfg)
        mesh = make_mesh((4, 2), jax.devices()[:8])
        reads = simulate_reads(16, 32, seed=3)
        lengths = np.full(16, 32, np.int32)
        sharded = model.count_sharded(reads, lengths, mesh)
        single = model.step(reads, lengths)
        assert sharded.to_dict() == single.to_dict()

    def test_invalid_k_rejected(self):
        with pytest.raises(InvalidKmerLengthError):
            EngineConfig(k=0)
        with pytest.raises(InvalidKmerLengthError):
            EngineConfig(k=33)
