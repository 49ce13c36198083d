"""Benchmark harness smoke tests (tiny CPU shapes)."""

import collections

import numpy as np

from kmer_tpu.bench import run_bench, run_bench_stream, run_chr_bench, run_query_bench
from kmer_tpu.codec import decode_codes
from kmer_tpu.ops.extract import extract_to_strings, simulate_reads


def _oracle_unique(n_reads, read_len, k, seed=0):
    comp = {"a": "t", "c": "g", "g": "c", "t": "a"}
    want = collections.Counter()
    reads = simulate_reads(n_reads, read_len, seed=seed)
    for row in reads:
        for km in extract_to_strings(decode_codes(row), k):
            rc = "".join(comp[c] for c in reversed(km))
            want[min(km, rc)] += 1
    return len(want)


class TestBenchHarness:
    def test_fused_mode_exact(self):
        r = run_bench(n_reads=512, read_len=48, k=8)
        assert r["detail"]["unique_kmers"] == _oracle_unique(512, 48, 8)
        assert r["detail"]["total_kmers"] == 512 * 41
        assert r["value"] > 0 and r["vs_baseline"] > 0
        # k=8 routes through the 1-lane sort: the hi+lo16 phase model
        # does not apply, so no breakdown is published for it
        assert "phases" not in r["detail"]

    def test_fused_mode_phase_breakdown(self):
        r = run_bench(n_reads=512, read_len=48, k=21)
        assert r["detail"]["unique_kmers"] == _oracle_unique(512, 48, 21)
        assert set(r["detail"]["phases"]) == {
            "extract", "sort", "segment_counts",
        }
        for ph in r["detail"]["phases"].values():
            assert ph["ms"] > 0 and ph["gb_per_s"] >= 0
        assert r["detail"]["phases_sum_ms"] > 0
        # no published peak for a CPU: the share is omitted, not assumed
        assert "hbm_sol_bytes_per_s" not in r["detail"]
        assert all("pct_sol" not in ph for ph in r["detail"]["phases"].values())

    def test_stream_mode_matches_fused(self):
        a = run_bench(n_reads=512, read_len=48, k=21)
        b = run_bench_stream(n_reads=512, read_len=48, k=21)
        assert a["detail"]["unique_kmers"] == b["detail"]["unique_kmers"]

    def test_chr_mode_exact(self):
        # tiny "chromosome": 2048 bases, k=31 -> exact oracle
        rng = np.random.default_rng(0)
        r = run_chr_bench(n_bases=2048, k=31, canonical=False, seed=0)
        codes = rng.integers(0, 4, 2048, dtype=np.uint8)
        want = collections.Counter(
            tuple(codes[i : i + 31]) for i in range(2048 - 31 + 1)
        )
        assert r["detail"]["unique_kmers"] == len(want)
        assert r["detail"]["total_kmers"] == 2048 - 31 + 1

    def test_query_bench(self):
        r = run_query_bench(n_keys=1 << 12, n_queries=1 << 10)
        assert r["metric"] == "index_eq_lookups_per_s_chip"
        assert r["value"] > 0

    def test_sharded_query_bench(self):
        from kmer_tpu.bench import run_sharded_query_bench

        r = run_sharded_query_bench(n_keys=1 << 12, n_queries=1 << 8)
        assert r["metric"] == "sharded_index_eq_lookups_per_s"
        assert r["detail"]["n_devices"] == 8
        assert r["value"] > 0

    def test_coverage_mode_exact(self):
        from kmer_tpu.bench import run_bench
        from kmer_tpu.ops.extract import simulate_coverage_reads

        r = run_bench(n_reads=512, read_len=48, k=8, coverage_genome=2000)
        reads = simulate_coverage_reads(512, 48, 2000, seed=0)
        comp = {"a": "t", "c": "g", "g": "c", "t": "a"}
        want = set()
        for row in reads:
            s = decode_codes(row)
            for km in extract_to_strings(s, 8):
                rc = "".join(comp[c] for c in reversed(km))
                want.add(min(km, rc))
        assert r["detail"]["unique_kmers"] == len(want)
        assert r["detail"]["mode"] == "coverage"
        assert r["detail"]["mean_kmer_multiplicity"] > 2  # real duplication


class TestPeakTable:
    def test_h100_found(self):
        from kmer_tpu.bench import hbm_bytes_per_s

        assert hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12

    def test_unknown_kind_raises(self):
        import pytest

        from kmer_tpu.bench import hbm_bytes_per_s

        with pytest.raises(ValueError, match="no published memory bandwidth"):
            hbm_bytes_per_s("cpu")


def test_bench_trace_reports_scopes(tmp_path, capsys, monkeypatch):
    """bench --trace writes a profiler trace and reduces it by scope
    (the CPU has no device plane, so the reduction is empty here)."""
    import json

    from kmer_tpu import cli
    from kmer_tpu.cli import main

    # the persistent compile cache is process-wide: keep it off here
    monkeypatch.setattr(cli, "enable_compile_cache", lambda: None)

    assert main(["bench", "--reads", "64", "--read-len", "40", "-k", "8",
                 "--trace", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["detail"]["device_ms_by_scope"] == {}
    assert out["detail"]["total_kmers"] == 64 * 33
