"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Exercises the halo exchange and collective table merge without
multi-device hardware (SURVEY.md §4's CI strategy).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmer_tpu.codec import decode_codes
from kmer_tpu.ops.count import count_kmers_jit
from kmer_tpu.ops.extract import extract_to_strings, simulate_reads
from kmer_tpu.parallel import count_kmers_sharded, make_mesh, mesh_shape_for


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest should provide 8 virtual CPU devices"
    return devs


def _oracle(reads, lengths, k, canonical=False):
    comp = {"a": "t", "c": "g", "g": "c", "t": "a"}
    want = collections.Counter()
    for row, ln in zip(reads, lengths):
        s = decode_codes(row[:ln])
        if ln < k:
            continue
        for km in extract_to_strings(s, k):
            if canonical:
                rc = "".join(comp[c] for c in reversed(km))
                km = min(km, rc)
            want[km] += 1
    return dict(want)


class TestShardedCount:
    def test_data_parallel_only(self, devices):
        mesh = make_mesh((8, 1), devices)
        reads = simulate_reads(num_reads=32, read_len=24, seed=1)
        lengths = np.full(32, 24, np.int32)
        k = 5
        table = count_kmers_sharded(reads, lengths, k, mesh)
        assert table.to_dict() == _oracle(reads, lengths, k)

    def test_seq_parallel_halo(self, devices):
        # L=32 sharded over 4 seq shards of 8 -> windows cross shard edges
        mesh = make_mesh((2, 4), devices)
        reads = simulate_reads(num_reads=8, read_len=32, seed=2)
        lengths = np.full(8, 32, np.int32)
        for k in [2, 5, 9]:  # k-1 halo of 1, 4, 8 (halo == full shard width)
            table = count_kmers_sharded(reads, lengths, k, mesh)
            assert table.to_dict() == _oracle(reads, lengths, k), k

    def test_ragged_lengths_across_shards(self, devices):
        mesh = make_mesh((2, 4), devices)
        reads = simulate_reads(num_reads=8, read_len=32, seed=3)
        lengths = np.array([32, 3, 9, 17, 25, 32, 5, 30], np.int32)
        k = 4
        table = count_kmers_sharded(reads, lengths, k, mesh)
        assert table.to_dict() == _oracle(reads, lengths, k)

    def test_canonical_sharded(self, devices):
        mesh = make_mesh((4, 2), devices)
        reads = simulate_reads(num_reads=16, read_len=20, seed=4)
        lengths = np.full(16, 20, np.int32)
        k = 7
        table = count_kmers_sharded(reads, lengths, k, mesh, canonical=True)
        assert table.to_dict() == _oracle(reads, lengths, k, canonical=True)

    def test_matches_single_device(self, devices):
        mesh = make_mesh((8, 1), devices)
        reads = simulate_reads(num_reads=64, read_len=30, seed=5)
        lengths = np.full(64, 30, np.int32)
        k = 11
        sharded = count_kmers_sharded(reads, lengths, k, mesh)
        single = count_kmers_jit(jnp.asarray(reads), jnp.asarray(lengths), k, False)
        assert sharded.to_dict() == single.to_dict()


class TestPartitionedMerge:
    """merge="partition": all_to_all hash-routed tables, sharded output."""

    def test_matches_gather_and_oracle(self, devices):
        mesh = make_mesh((4, 2), devices)
        reads = simulate_reads(num_reads=16, read_len=28, seed=6)
        lengths = np.array([28] * 12 + [28, 4, 11, 20], np.int32)
        for k, canonical in [(5, False), (9, True)]:
            part = count_kmers_sharded(
                reads, lengths, k, mesh, canonical=canonical, merge="partition"
            )
            want = _oracle(reads, lengths, k, canonical=canonical)
            assert part.to_dict() == want, (k, canonical)
            assert int(part.n_unique) == len(want)
            assert part.total() == sum(want.values())

    def test_data_parallel_only_partition(self, devices):
        mesh = make_mesh((8, 1), devices)
        reads = simulate_reads(num_reads=32, read_len=24, seed=7)
        lengths = np.full(32, 24, np.int32)
        table = count_kmers_sharded(reads, lengths, 6, mesh, merge="partition")
        assert table.to_dict() == _oracle(reads, lengths, 6)

    def test_overflow_detected_and_fallback_exact(self, devices):
        from kmer_tpu.parallel.dist import make_sharded_count_step

        mesh = make_mesh((8, 1), devices)
        # one 128bp read per device -> 121 k=8 windows (~all distinct);
        # with cap floored at 8, 8 buckets x cap 8 = 64 < unique groups,
        # so overflow is guaranteed by pigeonhole
        reads = simulate_reads(num_reads=8, read_len=128, seed=8)
        lengths = np.full(8, 128, np.int32)
        step = make_sharded_count_step(mesh, 8, merge="partition", slack=1e-9)
        _, overflow = step(jnp.asarray(reads), jnp.asarray(lengths))
        assert int(overflow) > 0
        # the one-shot API must detect it and still return the exact answer
        table = count_kmers_sharded(reads, lengths, 8, mesh, merge="partition")
        assert table.to_dict() == _oracle(reads, lengths, 8)

    def test_bad_merge_name(self, devices):
        mesh = make_mesh((8, 1), devices)
        with pytest.raises(ValueError, match="merge"):
            count_kmers_sharded(
                simulate_reads(8, 16, seed=9), np.full(8, 16, np.int32), 4, mesh,
                merge="reduce",
            )


class TestMeshHelpers:
    def test_mesh_shape_for(self):
        assert mesh_shape_for(8) == (8, 1)
        assert mesh_shape_for(8, seq_parallel=4) == (2, 4)
        with pytest.raises(ValueError):
            mesh_shape_for(8, seq_parallel=3)


class TestMergeEfficiency:
    def test_stats_shapes(self):
        from kmer_tpu.ops.count import count_windows
        from kmer_tpu.parallel.dist import merge_efficiency

        import jax.numpy as jnp

        hi = jnp.asarray(np.array([1, 1, 2, 3], np.uint32))
        lo = jnp.zeros(4, jnp.uint32)
        t = count_windows(hi, lo, None, 4)
        g = merge_efficiency(t, n_devices=8, merge="gather")
        p = merge_efficiency(t, n_devices=8, merge="partition")
        assert g["live_groups"] == 3 and g["capacity"] == 4
        assert 0 < g["efficiency"] <= 1
        assert p["bytes_sent_per_device"] >= g["useful_bytes"]
        with pytest.raises(ValueError):
            merge_efficiency(t, 8, merge="bogus")


class TestMultihost:
    """initialize_multihost failure surfacing (VERDICT r1 weak #4).

    jax.distributed.initialize hard-aborts the process (abseil FATAL)
    on a dead coordinator, so these tests monkeypatch it to raise —
    what's under test is our strict/best-effort handling, not the dial.
    """

    def _boom(self, monkeypatch):
        def fail(**kw):
            raise ConnectionError("no coordinator")

        monkeypatch.setattr(jax.distributed, "initialize", fail)

    def test_strict_failure_raises(self, monkeypatch):
        from kmer_tpu.parallel.multihost import initialize_multihost

        self._boom(monkeypatch)
        with pytest.raises(RuntimeError, match="multi-host initialization failed"):
            initialize_multihost(
                coordinator_address="127.0.0.1:1", num_processes=2, process_id=0
            )

    def test_best_effort_degrades_with_warning(self, monkeypatch, caplog):
        import logging

        from kmer_tpu.parallel.multihost import initialize_multihost

        self._boom(monkeypatch)
        from kmer_tpu.utils.logging import get_logger

        logger = get_logger()
        monkeypatch.setattr(logger, "propagate", True)  # let caplog see it
        with caplog.at_level(logging.WARNING, logger="kmer_tpu"):
            ok = initialize_multihost(strict=False)
        assert ok is False
        assert any("single-process" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("merge", ["gather", "partition"])
def test_merge_traces_past_2_28_rows(merge):
    """A global batch whose merged tables exceed 2^28 rows (4 x 2^20
    reads x 150 bp) traces: the recount's weights are window counts of
    one batch, so their total fits int32 and the bounded path applies."""
    from kmer_tpu.parallel.dist import make_sharded_count_step

    mesh = make_mesh((4, 1), jax.devices()[:4])
    step = make_sharded_count_step(mesh, 21, canonical=True, merge=merge)
    out = jax.eval_shape(
        step, jax.ShapeDtypeStruct((4 << 20, 150), jnp.uint8),
        jax.ShapeDtypeStruct((4 << 20,), jnp.int32))
    table = out[0] if merge == "partition" else out
    assert table.counts.shape[0] >= 1 << 28
