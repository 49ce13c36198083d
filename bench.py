#!/usr/bin/env python
"""Benchmark driver entry point: prints ONE JSON line.

Workload: canonical k=21 counting over 1M simulated 150bp reads on a
single chip (BASELINE.json configs[1]).  vs_baseline is measured against
the reference extension's HashAggregate counting throughput (~1.3e6
k-mers/s, BASELINE.md GROUP BY row).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    from kmer_tpu.cli import enable_compile_cache

    enable_compile_cache()
    from kmer_tpu.bench import run_bench, run_bench_stream, run_chr_bench, run_query_bench

    n_reads = int(os.environ.get("KMER_BENCH_READS", 1 << 20))
    mode = os.environ.get("KMER_BENCH_MODE", "fused")
    if mode == "chr":  # BASELINE configs[4] shape: ~250 Mbp, k=31
        result = run_chr_bench()
    elif mode == "query":  # BASELINE configs[2]: index lookups
        result = run_query_bench()
    elif mode == "pattern":  # qkmer @> serving (reference contains scans)
        from kmer_tpu.bench import run_pattern_bench

        result = run_pattern_bench()
    else:
        fn = run_bench_stream if mode == "stream" else run_bench
        result = fn(n_reads=n_reads, read_len=150, k=21, canonical=True)
    detail = result.pop("detail", {})
    print(json.dumps({"detail": detail}), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
