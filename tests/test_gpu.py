"""Checks that need an NVIDIA GPU; they skip elsewhere.

``chip_smoke.py`` runs the same checks at full size on the card.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_card_has_a_published_peak(gpu):
    from kmer_tpu.bench import hbm_bytes_per_s

    assert hbm_bytes_per_s(gpu.device_kind) > 1e12


def test_count_on_the_card_matches_counter(gpu):
    from kmer_tpu.ops.count import count_kmers_jit
    from kmer_tpu.ops.extract import extract_to_strings, simulate_reads

    reads = simulate_reads(64, 60, seed=1)
    lengths = np.full(64, 60, np.int32)
    with jax.default_device(gpu):
        t = count_kmers_jit(jnp.asarray(reads), jnp.asarray(lengths), 21, False)
    want = collections.Counter()
    for row in reads:
        want.update(extract_to_strings("".join("acgt"[c] for c in row), 21))
    assert t.to_dict() == dict(want)
