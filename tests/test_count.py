"""Counting / GROUP BY parity tests — kmer-tests.sql TESTs 12-13."""

import collections
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from kmer_tpu import PackedKmers, generate_kmers
from kmer_tpu.ops.count import (
    count_column,
    count_dna,
    count_kmers_jit,
    count_packed,
    merge_tables,
)
from kmer_tpu.ops.extract import extract_to_strings, simulate_reads


class TestCountBasics:
    def test_count_over_generate(self):
        # TEST 12.1: COUNT over generate_kmers('ACGTACGT', 4) = 5
        table = count_dna("ACGTACGT", 4)
        assert table.total() == 5

    def test_group_by_small(self):
        # TEST 13.1: groups {tacg:1, acgt:2, cgta:1, gtac:1}
        table = count_dna("ACGTACGT", 4)
        assert table.to_dict() == {"tacg": 1, "acgt": 2, "cgta": 1, "gtac": 1}
        assert table.distinct() == 4

    def test_groups_sorted_ascending(self):
        table = count_dna("ACGTACGT", 4).trim()
        keys = list(
            PackedKmers(hi=table.hi, lo=table.lo, length=table.length).to_strings()
        )
        assert keys == sorted(keys)

    def test_matches_python_counter(self):
        rng = np.random.default_rng(7)
        for k in [1, 3, 7, 16, 21, 32]:
            seq = "".join(rng.choice(list("acgt"), size=100))
            want = collections.Counter(extract_to_strings(seq, k))
            got = count_dna(seq, k).to_dict()
            assert got == dict(want), k


class TestCountColumn:
    def test_mixed_length_group_by(self):
        # GROUP BY over a kmer column with mixed lengths (TEST 13.2 shape)
        strs = ["acga", "acg", "acga", "", "t" * 32, "acg", "acga", ""]
        col = PackedKmers.from_strings(strs)
        table = count_column(
            PackedKmers(
                hi=jnp.asarray(col.hi),
                lo=jnp.asarray(col.lo),
                length=jnp.asarray(col.length),
            )
        )
        assert table.to_dict() == {"acga": 3, "acg": 2, "": 2, "t" * 32: 1}

    def test_empty_vs_a_distinct(self):
        # '' and 'a' share packed bits; length disambiguates
        col = PackedKmers.from_strings(["", "a", "a", ""])
        table = count_column(
            PackedKmers(
                hi=jnp.asarray(col.hi),
                lo=jnp.asarray(col.lo),
                length=jnp.asarray(col.length),
            )
        )
        assert table.to_dict() == {"": 2, "a": 2}


class TestWeightsAndMerge:
    def test_zero_weight_slots_absent(self):
        col = PackedKmers.from_strings(["acga", "acg", "tttt"])
        w = jnp.asarray([2, 0, 5], jnp.int32)
        table = count_packed(
            jnp.asarray(col.hi), jnp.asarray(col.lo), jnp.asarray(col.length), w
        )
        assert table.to_dict() == {"acga": 2, "tttt": 5}

    def test_merge_tables(self):
        a = count_dna("ACGTACGT", 4)
        b = count_dna("ACGTACGA", 4)
        merged = merge_tables(a, b)
        want = collections.Counter(extract_to_strings("ACGTACGT", 4))
        want.update(collections.Counter(extract_to_strings("ACGTACGA", 4)))
        assert merged.to_dict() == dict(want)

    def test_merge_associative(self):
        seqs = ["ACGTACGTAC", "TTGCAACGTT", "GGGGGGGGGG"]
        tables = [count_dna(s, 3) for s in seqs]
        left = merge_tables(merge_tables(tables[0], tables[1]), tables[2])
        right = merge_tables(tables[0], merge_tables(tables[1], tables[2]))
        assert left.to_dict() == right.to_dict()

    def test_weighted_totals_wrap_safe_past_2_31(self):
        """ADVICE r3: a call whose TOTAL weight exceeds 2^31 must still
        produce exact per-segment totals (each of which fits int32)."""
        from kmer_tpu.ops.count import _segment_counts

        new = jnp.asarray([True, False, True, True, False])
        w = jnp.asarray(
            [1_000_000_000, 1_000_000_000, 200_000_000, 50_000_000, 50_000_000],
            jnp.int32,
        )
        got = np.asarray(_segment_counts(new, w))
        assert got.tolist() == [0, 2_000_000_000, 200_000_000, 0, 100_000_000]

    def test_weighted_segment_counts_vs_oracle(self):
        from kmer_tpu.ops.count import _segment_counts

        rng = np.random.default_rng(0)
        for _ in range(40):
            n = int(rng.integers(1, 50))
            new = np.zeros(n, bool)
            new[0] = True
            new[rng.random(n) < 0.3] = True
            w = rng.integers(0, 1 << 30, n).astype(np.int32)
            got = np.asarray(_segment_counts(jnp.asarray(new), jnp.asarray(w)))
            exp = np.zeros(n, np.int64)
            seg = 0
            for i in range(1, n + 1):
                if i == n or new[i]:
                    exp[i - 1] = w[seg:i].astype(np.int64).sum()
                    seg = i
            fits = exp < 2**31
            assert np.array_equal(got[fits], exp[fits])

    def test_weighted_rejects_2_28_rows(self):
        """The packed-cummax carry needs (pos+1) << 4 to fit uint32;
        eval_shape triggers the trace-time guard without allocating."""
        import jax
        import pytest

        from kmer_tpu.ops.count import _segment_counts

        with pytest.raises(ValueError, match="2\\^28"):
            jax.eval_shape(
                _segment_counts,
                jax.ShapeDtypeStruct((1 << 28,), bool),
                jax.ShapeDtypeStruct((1 << 28,), jnp.int32),
            )


class TestBatchedReads:
    def test_count_reads_vs_counter(self):
        reads = simulate_reads(num_reads=64, read_len=40, seed=3)
        lengths = np.full(64, 40, np.int32)
        k = 5
        table = count_kmers_jit(jnp.asarray(reads), jnp.asarray(lengths), k, False)
        want = collections.Counter()
        from kmer_tpu.codec import decode_codes

        for row in reads:
            s = decode_codes(row)
            want.update(extract_to_strings(s, k))
        assert table.to_dict() == dict(want)
        assert table.total() == 64 * (40 - k + 1)

    def test_canonical_counts(self):
        reads = simulate_reads(num_reads=16, read_len=30, seed=5)
        lengths = np.full(16, 30, np.int32)
        k = 7
        table = count_kmers_jit(jnp.asarray(reads), jnp.asarray(lengths), k, True)
        from kmer_tpu.codec import decode_codes

        comp = {"a": "t", "c": "g", "g": "c", "t": "a"}
        want = collections.Counter()
        for row in reads:
            s = decode_codes(row)
            for km in extract_to_strings(s, k):
                rc = "".join(comp[c] for c in reversed(km))
                want[min(km, rc)] += 1
        assert table.to_dict() == dict(want)

    def test_ragged_lengths(self):
        reads = simulate_reads(num_reads=8, read_len=20, seed=9)
        lengths = np.array([20, 5, 7, 20, 12, 4, 19, 20], np.int32)
        k = 4
        table = count_kmers_jit(jnp.asarray(reads), jnp.asarray(lengths), k, False)
        from kmer_tpu.codec import decode_codes

        want = collections.Counter()
        for row, ln in zip(reads, lengths):
            s = decode_codes(row[:ln])
            want.update(extract_to_strings(s, k))
        assert table.to_dict() == dict(want)


class TestAllValidFastPath:
    def test_matches_masked_path(self):
        import jax.numpy as jnp

        from kmer_tpu.ops.count import count_windows
        from kmer_tpu.ops.extract import extract_windows_batch, simulate_reads

        reads = simulate_reads(16, 30, seed=11)
        lengths = np.full(16, 30, np.int32)
        wins, valid = extract_windows_batch(jnp.asarray(reads), jnp.asarray(lengths), 6)
        a = count_windows(wins.hi, wins.lo, valid, 6)
        b = count_windows(wins.hi, wins.lo, None, 6)
        assert a.to_dict() == b.to_dict()
        assert int(a.n_unique) == int(b.n_unique)


class TestSortWidthPaths:
    """count_windows narrows sort operands by k; sweep every branch."""

    def test_all_k_masked_and_unmasked(self):
        from kmer_tpu.ops.count import count_windows
        from kmer_tpu.ops.extract import extract_windows_batch, simulate_reads
        from kmer_tpu.codec import decode_codes
        from kmer_tpu.ops.extract import extract_to_strings

        reads = simulate_reads(6, 40, seed=13)
        lengths = np.array([40, 40, 12, 40, 33, 40], np.int32)
        for k in [1, 8, 15, 16, 17, 21, 23, 24, 25, 31, 32]:
            wins, valid = extract_windows_batch(
                jnp.asarray(reads), jnp.asarray(lengths), k
            )
            want = collections.Counter()
            for row, ln in zip(reads, lengths):
                if ln >= k:
                    want.update(extract_to_strings(decode_codes(row[:ln]), k))
            got = count_windows(wins.hi, wins.lo, valid, k)
            assert got.to_dict() == dict(want), ("masked", k)
            # unmasked: full-length rows only
            full = reads[lengths == 40]
            winsf, _ = extract_windows_batch(
                jnp.asarray(full), jnp.asarray(np.full(len(full), 40, np.int32)), k
            )
            wantf = collections.Counter()
            for row in full:
                wantf.update(extract_to_strings(decode_codes(row), k))
            gotf = count_windows(winsf.hi, winsf.lo, None, k)
            assert gotf.to_dict() == dict(wantf), ("unmasked", k)

    def test_all_t_kmers_never_merge_with_sentinel(self):
        from kmer_tpu.ops.count import count_windows
        from kmer_tpu.ops.extract import extract_windows_batch

        # rows of all-t bases: the packed keys are all-ones in every used bit
        for k in [15, 16, 17, 23, 24, 32]:
            reads = np.full((3, 36), 3, np.uint8)
            lengths = np.array([36, k, k - 1], np.int32)  # row 3 yields none
            wins, valid = extract_windows_batch(
                jnp.asarray(reads), jnp.asarray(lengths), k
            )
            table = count_windows(wins.hi, wins.lo, valid, k)
            want = {"t" * k: (36 - k + 1) + 1}
            assert table.to_dict() == want, k


class TestGroupSortPairs:
    """1-key sort + odd-even fixup vs the plain 2-key sort oracle.

    _GROUP_SORT_MIN_N is patched to 0 so CI exercises the real group
    path (skew probe, sweeps, inner fallback) at CPU-friendly sizes.
    """

    def _oracle(self, hi, lo):
        import jax

        return jax.lax.sort((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2,
                            is_stable=False)

    def _check(self, hi, lo, monkeypatch):
        import kmer_tpu.ops.count as cm
        from kmer_tpu.ops.count import group_sort_pairs

        monkeypatch.setattr(cm, "_GROUP_SORT_MIN_N", 0)
        got = group_sort_pairs(jnp.asarray(hi), jnp.asarray(lo))
        want = self._oracle(hi, lo)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])

    def test_random_pairs_bit_identical(self, monkeypatch):
        rng = np.random.default_rng(0)
        for n, dt in [(1, np.uint16), (2, np.uint16), (4097, np.uint16),
                      (5000, np.uint32)]:
            # near-unique his with a few short runs: group path taken
            hi = rng.integers(0, max(n * 8, 16), n).astype(np.uint32)
            lo = rng.integers(0, np.iinfo(dt).max, n, dtype=np.uint64).astype(dt)
            self._check(hi, lo, monkeypatch)

    def test_skew_probe_routes_to_2key(self, monkeypatch):
        """Heavy duplication: the sample probe must route to sort2."""
        rng = np.random.default_rng(1)
        n = 40_000
        hi = rng.integers(0, 100, n).astype(np.uint32)  # runs of ~400
        lo = rng.integers(0, 1 << 16, n).astype(np.uint16)
        self._check(hi, lo, monkeypatch)

    def test_long_run_past_probe_falls_back_exactly(self, monkeypatch):
        """Mostly unique his (passes the probe) + one run of 40 (> 2*iters):
        the inner sortedness check must trigger the 2-key fallback."""
        rng = np.random.default_rng(2)
        n = 40_000
        hi = np.arange(n, dtype=np.uint32) * 7
        hi[20_000:20_040] = 77777  # one long run
        lo = rng.integers(0, 1 << 16, n).astype(np.uint16)
        self._check(hi, lo, monkeypatch)

    def test_small_inputs_use_2key_directly(self):
        from kmer_tpu.ops.count import group_sort_pairs

        hi = np.arange(100, dtype=np.uint32)
        lo = np.zeros(100, np.uint16)
        got = group_sort_pairs(jnp.asarray(hi), jnp.asarray(lo))
        assert np.array_equal(got[0], hi) and np.array_equal(got[1], lo)


def _segment_oracle(keys, drop=None):
    """Counter over sorted key tuples, minus an optional sentinel key."""
    want = collections.Counter(keys)
    if drop is not None:
        want.pop(drop, None)
    return dict(want)


def _sorted_pairs(case, rng):
    """(hi, lo) uint32 lanes for one segment-count case, sorted."""
    if case == "random_duplicates":
        hi = rng.integers(0, 7, 5000).astype(np.uint32)
        lo = rng.integers(0, 5, 5000).astype(np.uint32)
    elif case == "segment_spanning_blocks":
        hi = np.zeros(4096, np.uint32)
        lo = np.zeros(4096, np.uint32)
        hi[-1] = 9  # one giant segment + one singleton
    elif case == "all_unique":
        hi = np.arange(1500, dtype=np.uint32)
        lo = np.arange(1500, dtype=np.uint32)
    elif case == "single":
        hi, lo = np.array([5], np.uint32), np.array([0], np.uint32)
    else:  # "pair"
        hi, lo = np.array([5, 5], np.uint32), np.array([0, 1], np.uint32)
    order = np.lexsort((lo, hi))
    return hi[order], lo[order]


class TestSegmentCounts:
    """The XLA post-sort segment counts against a host Counter."""

    CASES = ["random_duplicates", "segment_spanning_blocks", "all_unique",
             "single", "pair"]

    @pytest.mark.parametrize("case", CASES)
    def test_unit_segment_counts(self, case):
        from kmer_tpu.ops.count import _segment_counts

        shi, slo = _sorted_pairs(case, np.random.default_rng(0))
        new = np.ones(shi.size, bool)
        new[1:] = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
        counts = np.asarray(_segment_counts(jnp.asarray(new)))
        keys = list(zip(shi.tolist(), slo.tolist()))
        got = {}
        for i in np.nonzero(counts > 0)[0]:
            assert keys[i] not in got, "one nonzero count per segment"
            assert new[i], "unit counts sit at the segment head"
            got[keys[i]] = int(counts[i])
        assert got == _segment_oracle(keys)

    @pytest.mark.parametrize("case", CASES)
    def test_count_windows_unmasked(self, case):
        from kmer_tpu.ops.count import count_windows

        hi, lo = _sorted_pairs(case, np.random.default_rng(1))
        perm = np.random.default_rng(2).permutation(hi.size)
        hi, lo = hi[perm], lo[perm]  # count_windows sorts for itself
        t = count_windows(jnp.asarray(hi), jnp.asarray(lo), None, 32).trim()
        got = {(int(a), int(b)): int(c)
               for a, b, c in zip(t.hi, t.lo, t.counts)}
        assert got == _segment_oracle(list(zip(hi.tolist(), lo.tolist())))
        assert int(t.n_unique) == len(got)

    def test_sentinel_folding(self):
        """Invalid slots fold into the sentinel key and are not counted."""
        from kmer_tpu.ops.count import count_windows

        rng = np.random.default_rng(3)
        n = 3000
        hi = (rng.integers(0, 5, n).astype(np.uint32) << np.uint32(22))
        lo = np.zeros(n, np.uint32)
        valid = np.ones(n, bool)
        valid[:700] = False
        t = count_windows(jnp.asarray(hi), jnp.asarray(lo),
                          jnp.asarray(valid), 8).trim()
        got = {int(a): int(c) for a, c in zip(t.hi, t.counts)}
        assert got == dict(collections.Counter(hi[valid].tolist()))
        assert int(t.n_unique) == len(got)

    @pytest.mark.parametrize("k", [8, 21, 30, 32])
    def test_count_windows_masked_vs_counter(self, k):
        """Every sort width of count_windows, masked, with duplicates."""
        from kmer_tpu.ops.count import count_windows

        rng = np.random.default_rng(k)
        n = 2000
        # few distinct left-aligned k-mers so segments repeat
        pool = rng.integers(0, 1 << 62, 40, dtype=np.uint64) << np.uint64(2)
        pool &= ~np.uint64((1 << (64 - 2 * k)) - 1)
        if k == 32:
            pool[0] = np.uint64(2**64 - 1)  # all-t: equal to the sentinel bits
        keys = pool[rng.integers(0, pool.size, n)]
        hi = (keys >> np.uint64(32)).astype(np.uint32)
        lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        valid = rng.random(n) < 0.8
        t = count_windows(jnp.asarray(hi), jnp.asarray(lo),
                          jnp.asarray(valid), k).trim()
        got = {(int(a), int(b)): int(c)
               for a, b, c in zip(t.hi, t.lo, t.counts)}
        want = collections.Counter(zip(hi[valid].tolist(), lo[valid].tolist()))
        assert got == dict(want)
        assert np.all(np.asarray(t.length) == k)


class TestSmallK:
    """Small k counts through the sort route (the only route)."""

    @pytest.mark.parametrize("k", [1, 2, 4, 6])
    def test_small_k_matches_counter(self, k):
        reads = simulate_reads(32, 40, seed=k)
        lengths = np.full(32, 40, np.int32)
        lengths[3] = k - 1 if k > 1 else 0  # a read too short for any window
        t = count_kmers_jit(jnp.asarray(reads), jnp.asarray(lengths), k, False)
        want = collections.Counter()
        for row, ln in zip(reads, lengths):
            s = "".join("acgt"[c] for c in row[:ln])
            want.update(extract_to_strings(s, k) if ln >= k else [])
        assert t.to_dict() == dict(want)


class TestTrimLayouts:
    """CountTable.trim compacts each device's copy on that device and
    returns the live groups in ascending key order for every layout."""

    @staticmethod
    def _table(mixed_lengths: bool):
        from kmer_tpu.ops.count import CountTable

        rng = np.random.default_rng(9)
        n = 4096
        # distinct keys, as a table's live groups are
        key = rng.choice(1 << 20, n, replace=False)
        hi = (key >> 2).astype(np.uint32)
        lo = (key & 3).astype(np.uint32) << np.uint32(30)
        ln = (rng.integers(20, 23, n) if mixed_lengths
              else np.full(n, 21)).astype(np.int32)
        counts = rng.integers(0, 3, n).astype(np.int32)
        return CountTable(hi=hi, lo=lo, length=ln, counts=counts,
                          n_unique=np.int64(0))

    @staticmethod
    def _want(t):
        live = t.counts > 0
        order = np.lexsort((t.length[live], t.lo[live], t.hi[live]))
        return [np.asarray(x)[live][order]
                for x in (t.hi, t.lo, t.length, t.counts)]

    @pytest.mark.parametrize("layout", ["one_device", "replicated", "sharded"])
    @pytest.mark.parametrize("mixed_lengths", [False, True])
    def test_trim_matches_host(self, layout, mixed_lengths):
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        from kmer_tpu.ops.count import CountTable

        host = self._table(mixed_lengths)
        if layout == "one_device":
            put = jnp.asarray
        else:
            mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
            spec = P() if layout == "replicated" else P("d")
            put = functools.partial(jax.device_put,
                                    device=NamedSharding(mesh, spec))
        if layout == "sharded":
            # shards are ascending runs of disjoint keys, as the
            # partition merge leaves them; the global array is not sorted
            pad = (-self._want(host)[0].size) % 4  # dead rows, count 0
            lanes = [np.concatenate(np.array_split(
                np.concatenate([x, np.zeros(pad, x.dtype)]), 4)[::-1])
                for x in self._want(host)]
            host = CountTable(*lanes, n_unique=np.int64(0))
        dev = CountTable(*(put(x) for x in (host.hi, host.lo, host.length,
                                            host.counts)),
                         n_unique=jnp.zeros((), jnp.int32))
        got = dev.trim()
        for a, b in zip((got.hi, got.lo, got.length, got.counts),
                        self._want(host)):
            assert isinstance(a, np.ndarray)
            assert np.array_equal(a, b)
        assert int(got.n_unique) == self._want(host)[0].size
