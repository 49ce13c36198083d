"""Throughput benchmark: canonical k-mer counting on one device.

Workload = BASELINE.json configs[1]: k=21 canonical counting over
simulated 150bp reads.  The reference baseline is Postgres HashAggregate
counting at ~1.3e6 k-mers/s on one CPU core (BASELINE.md: 78.7 ms for
100k rows); vs_baseline is measured k-mers/s over that number.

Pipeline under test (a complete exact global count) is ONE fused jit:
unpack packed words -> window extraction -> canonicalize -> group-sort
count -> segment counts (ops/count.py).

The headline metric times the device-resident pipeline (packed reads
already in HBM); the host-wire path (packed words fed from host inside
the timed region) is reported in detail.  Per-phase ms / GB/s / %-of-
speed-of-light detail comes from separate jits over the same data.
Every timed region ends in a host read of a device result.
"""

from __future__ import annotations

import time

import numpy as np

REFERENCE_KMERS_PER_S = 1.3e6

# Device-memory bandwidth by JAX device_kind, for the speed-of-light
# accounting (NVIDIA data sheets: H100 SXM 3.35 TB/s, H100 PCIe 2.0 TB/s,
# H100 NVL 3.9 TB/s).  A device that is not listed is an error, never a
# default: a borrowed peak would make every share wrong.
_HBM_BY_KIND = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


def hbm_bytes_per_s(kind: str | None = None) -> float:
    """Published memory bandwidth of the attached device (or ``kind``)."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    try:
        return _HBM_BY_KIND[kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind {kind!r}; "
            f"known: {sorted(_HBM_BY_KIND)}") from None


def _sol(nbytes: float, dt: float, sol_bytes_per_s: float | None) -> dict:
    out = {"gb_per_s": round(nbytes / dt / 1e9, 1)}
    if sol_bytes_per_s:
        out["pct_sol"] = round(100 * nbytes / dt / sol_bytes_per_s, 1)
    return out


def run_bench(
    n_reads: int = 1 << 20,
    read_len: int = 150,
    k: int = 21,
    canonical: bool = True,
    seed: int = 0,
    coverage_genome: int | None = None,
) -> dict:
    """Headline: ONE fused jit — unpack -> extract -> canonicalize -> count.

    Reads are full-length, so every window is valid: no sentinel slots,
    no validity mask, exactly n_reads*(read_len-k+1) windows go through
    the group sort (ops/count.py group_sort_pairs: 1-key lax.sort +
    in-run odd-even fixup).

    Detail carries a per-phase breakdown (extract / sort / segment
    counts, each timed as its own jit on the same data) with minimal
    HBM-traffic GB/s and %-of-speed-of-light per phase.

    coverage_genome: if set, reads are sampled from one random genome of
    that many bases instead of being uniform-random — the realistic
    sequencing regime with ~(n_reads*read_len/genome) -fold k-mer
    duplication and long equal-prefix runs (exercises the group sort's
    2-key fallback; see PERF.md §2).
    """
    import jax
    import jax.numpy as jnp

    from .ops.count import count_windows, group_sort_pairs
    from .ops.extract import (
        canonicalize, extract_windows_batch, simulate_coverage_reads,
        simulate_reads,
    )

    from .native import device_unpack_rows, pack2bit_rows

    wpr = read_len - k + 1
    total = n_reads * wpr

    if coverage_genome:
        reads = simulate_coverage_reads(n_reads, read_len, coverage_genome,
                                        seed=seed)
    else:
        reads = simulate_reads(n_reads, read_len, seed=seed)
    words_host = pack2bit_rows(reads)
    lengths = jnp.full((n_reads,), read_len, jnp.int32)

    def extract_all(w):
        codes = device_unpack_rows(w, read_len)
        wins, _ = extract_windows_batch(codes, lengths, k)  # valid is DCE'd
        hi, lo = wins.hi, wins.lo
        if canonical:
            hi, lo = canonicalize(hi, lo, k)
        return hi.ravel(), lo.ravel()

    def count_all(w):
        hi, lo = extract_all(w)
        return count_windows(hi, lo, None, k)

    count_j = jax.jit(count_all)

    def sync(x):
        np.asarray(jax.device_get(jax.tree_util.tree_leaves(x)[0]))

    # --- host-wire pass (end to end incl. transfer; compiles off-clock)
    int(count_j(jnp.asarray(words_host)).n_unique)  # warmup
    t0 = time.perf_counter()
    table = count_j(jnp.asarray(words_host))
    n_unique = int(table.n_unique)
    dt_wire = time.perf_counter() - t0

    # --- device-resident headline: input already in device memory
    words = jnp.asarray(words_host)
    sync(words)
    t0 = time.perf_counter()
    n_unique2 = int(count_j(words).n_unique)
    dt_dev = time.perf_counter() - t0
    assert n_unique2 == n_unique

    # --- per-phase breakdown on the same data (separate jits; the
    # fused headline overlaps some of these, so phases sum >= headline).
    # ONE group_sort_pairs invocation with both outputs consumed (two
    # invocations defeat CSE and double the sort cost), and the count phase is
    # the sort-free segment counting on PRE-SORTED lanes — the thing
    # that actually runs after the sort — not a second hidden full sort.
    extract_j = jax.jit(lambda w: [jnp.max(v) for v in extract_all(w)])
    hi, lo = jax.jit(extract_all)(words)
    sync(hi)
    def _shared_out():
        o = _result(total, dt_dev, n_reads, read_len, k, canonical, 1,
                    n_unique, mode="coverage" if coverage_genome else "fused")
        if coverage_genome:
            o["detail"]["genome_bases"] = coverage_genome
            o["detail"]["mean_kmer_multiplicity"] = round(total / n_unique, 2)
        o["detail"]["host_wire_kmers_per_s"] = round(total / dt_wire, 1)
        o["detail"]["host_wire_wall_s"] = round(dt_wire, 3)
        return o

    if not (16 < k <= 24):
        # the lane model below (hi + 16-bit lo) matches count_windows'
        # 16 < k <= 24 branch only; other k values route differently and
        # a mislabeled breakdown is worse than none
        return _shared_out()
    lo16 = (lo >> jnp.uint32(16)).astype(jnp.uint16)
    # consume BOTH sort outputs via max reductions: returning a slice of
    # one lets XLA dead-code-eliminate the other lane's movement and the
    # fixup sweeps entirely
    def _sort_once(a, b):
        sa, sb = group_sort_pairs(a, b)
        return jnp.maximum(jnp.max(sa), sb.max().astype(jnp.uint32))

    sort_j = jax.jit(_sort_once)
    shi, slo16 = jax.jit(group_sort_pairs)(hi, lo16)  # off the clock
    sync(shi)

    def _segment_counts_only(a, b16):
        # max-reductions consume every counts lane (slice-only returns
        # invite DCE of the whole scan chain)
        from .ops.count import _segment_counts

        new = jnp.concatenate(
            [jnp.ones((1,), bool), (a[1:] != a[:-1]) | (b16[1:] != b16[:-1])]
        )
        counts = _segment_counts(new)
        return jnp.sum(new.astype(jnp.int32)) + jnp.max(counts)

    seg_j = jax.jit(_segment_counts_only)
    from .utils.profiling import Profile, phase_timer

    sol_bw = (hbm_bytes_per_s() if jax.devices()[0].platform == "gpu"
              else None)
    prof = Profile()
    for name, fn, args, nbytes in [
        # minimal HBM traffic models: read + write, ignoring XLA's extra
        ("extract", extract_j, (words,), words.nbytes + total * 8),
        ("sort", sort_j, (hi, lo16), 2 * total * 6),
        ("segment_counts", seg_j, (shi, slo16), total * 6 + total * 4),
    ]:
        fn(*args)  # compile
        sync(fn(*args))
        with phase_timer(prof, name, nbytes=nbytes):
            sync(fn(*args))
    phases = {
        name: {"ms": round(dt * 1e3, 1), **_sol(prof.bytes.get(name, 0), dt, sol_bw)}
        for name, dt in prof.phases.items()
    }
    phases_sum_ms = round(sum(prof.phases.values()) * 1e3, 1)

    out = _shared_out()
    out["detail"]["phases"] = phases
    out["detail"]["phases_sum_ms"] = phases_sum_ms
    if sol_bw:
        out["detail"]["hbm_sol_bytes_per_s"] = sol_bw
    return out


def run_bench_stream(
    n_reads: int = 1 << 20,
    read_len: int = 150,
    k: int = 21,
    canonical: bool = True,
    seed: int = 0,
) -> dict:
    """Phase-major variant: windows extracted directly from packed words.

    No code unpack on device (extraction reads 4B per 16 bases); windows
    are produced phase-major with sentinel-masked invalid slots, and the
    count is a sentinel-folded sort over 16*ceil(bases/16) slots.  The
    whole input lives in HBM, so the pipeline is ONE fused jit — no
    chunk loop, no placement buffer.
    """
    import jax
    import jax.numpy as jnp

    from .native import pack2bit_rows
    from .ops.count import count_windows
    from .ops.extract import canonicalize, extract_from_words, phase_major_valid, simulate_reads

    total = n_reads * (read_len - k + 1)
    n_bases = n_reads * read_len
    assert n_bases % 16 == 0, "base count must be word-aligned"
    nw_total = n_bases // 16

    words_host = pack2bit_rows(
        simulate_reads(n_reads, read_len, seed=seed).reshape(1, -1)
    )[0]

    def count_all(words):
        hi, lo = extract_from_words(words, k)  # [16, nw_total]
        if canonical:
            hi, lo = canonicalize(hi, lo, k)
        valid = phase_major_valid(nw_total, read_len, n_reads, k)
        return count_windows(hi.ravel(), lo.ravel(), valid.ravel(), k)

    count_j = jax.jit(count_all)

    words = jnp.asarray(words_host)
    np.asarray(words[-1:])
    warm = count_j(words)
    int(warm.n_unique)
    del warm

    t0 = time.perf_counter()
    table = count_j(words)
    n_unique = int(table.n_unique)
    dt = time.perf_counter() - t0

    return _result(total, dt, n_reads, read_len, k, canonical, 1, n_unique,
                   mode="stream")


def run_chr_bench(
    n_bases: int = 15 << 24,  # ~251.7 Mbp: the r1 workload size, word-aligned
    k: int = 31,
    canonical: bool = True,
    seed: int = 0,
) -> dict:
    """Chromosome-scale single-sequence counting (BASELINE configs[4]).

    One ~250 Mbp sequence (human chr1 scale), k=31 canonical counting as
    ONE fused jit: phase-major extraction straight off the packed wire
    words + the group-sort count.  Input starts device-resident; the
    timed region is the full extract+count.
    """
    import jax
    import jax.numpy as jnp

    from .native import pack2bit_rows
    from .ops.count import count_windows
    from .ops.extract import canonicalize, extract_from_words

    rng = np.random.default_rng(seed)
    n_bases = (n_bases // 16) * 16  # word-aligned packing
    total_windows = n_bases - k + 1
    n_chunks = 1  # fused: the whole sequence is one jit
    nw = n_bases // 16

    # packed words straight on device; ONE fused jit (phase-major
    # extraction off the wire words + group-sort count, r2 engine)
    codes = rng.integers(0, 4, n_bases, dtype=np.uint8)
    words = jnp.asarray(pack2bit_rows(codes[None, :])[0])
    np.asarray(words[-1:])
    del codes

    def count_all(w):
        hi, lo = extract_from_words(w, k)  # [16, nw] phase-major
        if canonical:
            hi, lo = canonicalize(hi, lo, k)
        p = 16 * jnp.arange(nw, dtype=jnp.int32)[None, :] + jnp.arange(
            16, dtype=jnp.int32
        )[:, None]
        valid = p <= (n_bases - k)
        return count_windows(hi.ravel(), lo.ravel(), valid.ravel(), k)

    count_j = jax.jit(count_all)
    int(count_j(words).n_unique)  # warmup/compile
    t0 = time.perf_counter()
    n_unique = int(count_j(words).n_unique)
    dt = time.perf_counter() - t0

    kmers_per_s = total_windows / dt
    return {
        "metric": "chr_scale_kmers_counted_per_s_chip",
        "value": round(kmers_per_s, 1),
        "unit": "kmers/s",
        "vs_baseline": round(kmers_per_s / REFERENCE_KMERS_PER_S, 2),
        "detail": {
            "mode": "chr",
            "n_bases": n_bases,
            "k": k,
            "canonical": canonical,
            "chunks": n_chunks,
            "wall_s": round(dt, 3),
            "total_kmers": total_windows,
            "unique_kmers": n_unique,
        },
    }


def run_query_bench(n_keys: int = 1 << 22, n_queries: int = 1 << 20, seed: int = 0) -> dict:
    """Index lookup throughput (the BASELINE 'prefix-query lookups/s' metric).

    Builds a device-sorted index over random 21-mers and measures three
    batched lookup paths against the reference's SP-GiST scans
    (eq 0.214 ms => ~4.7e3/s; ^@ 0.968 ms => ~1.03e3/s,
    kmer-tests.sql:1321-1353):
    * headline: equality via the bucketized DeviceHashIndex (1-2
      contiguous bucket-row gathers per query);
    * detail: equality + prefix ranges via vectorized lexicographic
      binary search on the sorted column.
    """
    import jax
    import jax.numpy as jnp

    from .index import DeviceHashIndex, device_sort_column, searchsorted_packed
    from .packed import PackedKmers

    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(np.uint32) & np.uint32(0xFFC00000)
    ln = np.full(n_keys, 21, np.int32)
    col = PackedKmers(hi=jnp.asarray(hi), lo=jnp.asarray(lo), length=jnp.asarray(ln))

    build_j = jax.jit(device_sort_column)
    sorted_col, _ = build_j(col)  # warmup: compile off the clock
    np.asarray(sorted_col.hi[-1:])
    t0 = time.perf_counter()
    sorted_col, _ = build_j(col)
    np.asarray(sorted_col.hi[-1:])
    build_s = time.perf_counter() - t0

    qsel = rng.integers(0, n_keys, n_queries)
    qhi = jnp.asarray(hi[qsel])
    qlo = jnp.asarray(lo[qsel])
    qln = jnp.asarray(ln[qsel])

    lookup = jax.jit(
        lambda h, l, n: (
            searchsorted_packed(sorted_col.hi, sorted_col.lo, sorted_col.length,
                                h, l, n, side="left"),
            searchsorted_packed(sorted_col.hi, sorted_col.lo, sorted_col.length,
                                h, l, n, side="right"),
        )
    )
    left, right = lookup(qhi, qlo, qln)
    np.asarray(left[-1:])
    t0 = time.perf_counter()
    left, right = lookup(qhi, qlo, qln)
    hits = int(np.asarray((right - left) > 0).sum())
    dt = time.perf_counter() - t0
    assert hits == n_queries  # every query key exists

    # prefix ranges (^@, strategy 28): random 8-base prefixes drawn from
    # stored keys — the analogue of the reference's SP-GiST ^@ scan
    # (0.968 ms/query, kmer-tests.sql:1346-1353)
    from .index import DeviceIndex

    dev_idx = DeviceIndex(
        hi=sorted_col.hi, lo=sorted_col.lo, length=sorted_col.length,
        row_ids=jnp.arange(n_keys, dtype=jnp.int32),
    )
    p = 8
    phi = qhi & jnp.uint32(0xFFFF0000)  # top 8 bases of each query key
    plo = jnp.zeros_like(qlo)
    pln = jnp.full((n_queries,), p, jnp.int32)
    fence = dev_idx.build_fence(bits=18)
    plookup = jax.jit(
        lambda h, l, n: dev_idx.prefix_ranges(h, l, n, fence=fence)
    )
    pl_, pr_ = plookup(phi, plo, pln)
    np.asarray(pl_[-1:])
    t0 = time.perf_counter()
    pl_, pr_ = plookup(phi, plo, pln)
    phits = int(np.asarray((pr_ - pl_) > 0).sum())
    dt_p = time.perf_counter() - t0
    assert phits == n_queries  # each prefix has at least its source key

    # hash-table equality path (the headline): bucketized open addressing
    col_np = PackedKmers(hi=hi, lo=lo, length=ln)
    t0 = time.perf_counter()
    hidx = DeviceHashIndex.build(col_np)
    np.asarray(hidx.table[-1:, -1:, -1:])
    hbuild_s = time.perf_counter() - t0
    start, cnt, found = hidx.lookup_eq(qhi, qlo, qln)  # warmup/compile
    np.asarray(start[-1:])
    t0 = time.perf_counter()
    start, cnt, found = hidx.lookup_eq(qhi, qlo, qln)
    hhits = int(np.asarray(found).sum())
    dt_h = time.perf_counter() - t0
    assert hhits == n_queries

    return {
        "metric": "index_eq_lookups_per_s_chip",
        "value": round(n_queries / dt_h, 1),
        "unit": "lookups/s",
        "vs_baseline": round((n_queries / dt_h) / 4.7e3, 1),
        "detail": {
            "n_keys": n_keys,
            "n_queries": n_queries,
            "hash_max_chain": hidx.max_chain,
            "hash_build_s": round(hbuild_s, 3),
            "hash_lookup_s": round(dt_h, 4),
            "binsearch_eq_lookups_per_s": round(n_queries / dt, 1),
            "sort_build_s": round(build_s, 3),
            "binsearch_lookup_s": round(dt, 4),
            "prefix_lookups_per_s": round(n_queries / dt_p, 1),
            "prefix_lookup_s": round(dt_p, 4),
            "prefix_vs_baseline": round((n_queries / dt_p) / 1.03e3, 1),
            "device": str(jax.devices()[0]),
        },
    }


def run_pattern_bench(
    n_keys: int = 1 << 22, n_queries: int = 1 << 16, seed: int = 0,
) -> dict:
    """Pattern (``@>`` / qkmer containment) serving throughput (the
    reference publishes timed contains scans: 23.5-25.8 ms over 100k
    rows, kmer-tests.sql:936-944,1092-1100).

    Three regimes on a DeviceIndex over random 21-mers:
    * determinate 12-base prefix + 9 degenerate positions (selective:
      candidate pruning leaves <=~1 candidate per query);
    * determinate 6-base prefix + IUPAC tail (~1k candidates/query);
    * the fully-degenerate worst case (all 'n'): pruning degenerates to
      a whole-table masked compare per query — measured per-query cost,
      small batch.
    """
    import jax
    import jax.numpy as jnp

    from .index import DeviceIndex, device_sort_column
    from .packed import PackedKmers

    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(
        np.uint32
    ) & np.uint32(0xFFC00000)
    ln = np.full(n_keys, 21, np.int32)
    col = PackedKmers(hi=jnp.asarray(hi), lo=jnp.asarray(lo), length=jnp.asarray(ln))
    sorted_col, perm = jax.jit(device_sort_column)(col)
    dev_idx = DeviceIndex(
        hi=sorted_col.hi, lo=sorted_col.lo, length=sorted_col.length,
        row_ids=jnp.asarray(perm, jnp.int32),
    )

    def masks_from_keys(sel, det_len, iupac_tail):
        """[M, MAX_K] uint32 IUPAC masks: first det_len positions one-hot
        from the stored key (so every query has >=1 hit), the rest 'n'
        (15) or a random 2-base IUPAC code when iupac_tail."""
        m = sel.size
        codes = np.zeros((m, 21), np.uint8)
        for i in range(21):
            lane = hi if i < 16 else lo
            codes[:, i] = (lane[sel] >> np.uint32(30 - 2 * (i % 16))) & 3
        masks = np.full((m, 32), 0, np.uint32)
        onehot = np.uint32(1) << codes.astype(np.uint32)
        det = np.arange(21)[None, :] < det_len
        if iupac_tail:
            # pattern bit for the true base plus one random extra base:
            # a 2-base IUPAC code that still matches the source key
            extra = np.uint32(1) << rng.integers(0, 4, (m, 21)).astype(np.uint32)
            tail = onehot | extra
        else:
            tail = np.full((m, 21), 15, np.uint32)  # 'n'
        masks[:, :21] = np.where(det, onehot, tail)
        return masks

    def time_batch(det_len, iupac_tail, nq, cap):
        sel = rng.integers(0, n_keys, nq)
        masks = jnp.asarray(masks_from_keys(sel, det_len, iupac_tail))
        fn = jax.jit(
            lambda mk: dev_idx.pattern_hits(mk, qlen=21, cap=cap)
        )
        rows, ok, trunc = fn(masks)  # compile + warmup
        np.asarray(trunc[-1:])
        t0 = time.perf_counter()
        rows, ok, trunc = fn(masks)
        hits = int(np.asarray(ok).sum())
        truncated = int(np.asarray(trunc).sum())
        dt = time.perf_counter() - t0
        assert hits >= nq, (det_len, hits, nq)  # the source key matches
        assert truncated == 0
        return dt, hits

    dt12, hits12 = time_batch(12, False, n_queries, cap=16)
    dt6, hits6 = time_batch(6, True, max(1, n_queries >> 4), cap=4096)
    n6 = max(1, n_queries >> 4)
    # fully-degenerate worst case: whole-table candidate range
    dtw, hitsw = time_batch(0, False, 8, cap=n_keys)

    ref_rate = 1.0 / 0.0235  # reference contains scan: 23.5 ms/query
    return {
        "metric": "index_pattern_lookups_per_s_chip",
        "value": round(n_queries / dt12, 1),
        "unit": "lookups/s",
        "vs_baseline": round((n_queries / dt12) / ref_rate, 1),
        "detail": {
            "n_keys": n_keys,
            "prefix12_queries": n_queries,
            "prefix12_s": round(dt12, 4),
            "prefix12_hits": hits12,
            "prefix6_iupac_lookups_per_s": round(n6 / dt6, 1),
            "prefix6_s": round(dt6, 4),
            "prefix6_hits": hits6,
            "worst_all_n_ms_per_query": round(dtw / 8 * 1e3, 2),
            "worst_all_n_hits": hitsw,
            "reference_contains_scan_ms": 23.5,
            "device": str(jax.devices()[0]),
        },
    }


def run_sharded_query_bench(
    n_keys: int = 1 << 20, n_queries: int = 1 << 14, seed: int = 0,
    mesh_shape: tuple | None = None,
) -> dict:
    """Multi-device index serving: ShardedIndex build + batched eq/prefix
    lookups over however many devices exist (8-device virtual CPU mesh
    in the tests; a 1-device mesh degenerates gracefully).
    """
    import jax
    import jax.numpy as jnp

    from .packed import PackedKmers
    from .parallel import make_mesh
    from .parallel.shindex import ShardedIndex, _make_lookup

    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(np.uint32)
    lo = np.zeros(n_keys, np.uint32)
    ln = np.full(n_keys, 16, np.int32)
    col = PackedKmers(hi=hi, lo=lo, length=ln)
    mesh = make_mesh(mesh_shape)
    ndev = int(np.prod(mesh.devices.shape))

    t0 = time.perf_counter()
    sidx = ShardedIndex.build(col, mesh)
    np.asarray(sidx.hi[-1:])
    build_s = time.perf_counter() - t0

    qsel = rng.integers(0, n_keys, n_queries)
    qhi = jnp.asarray(hi[qsel])
    qlo = jnp.asarray(lo[qsel])
    qln = jnp.asarray(ln[qsel])
    step = _make_lookup(mesh, "eq", 4)
    args = (sidx.hi, sidx.lo, sidx.length, sidx.row_ids, sidx.live,
            qhi, qlo, qln)
    rows, hit, count = step(*args)  # compile + warmup
    np.asarray(count[-1:])
    t0 = time.perf_counter()
    rows, hit, count = step(*args)
    hits = int(np.asarray(count).sum())
    dt = time.perf_counter() - t0
    assert hits >= n_queries  # every query key exists at least once

    return {
        "metric": "sharded_index_eq_lookups_per_s",
        "value": round(n_queries / dt, 1),
        "unit": "lookups/s",
        "vs_baseline": round((n_queries / dt) / 4.7e3, 1),
        "detail": {
            "n_devices": ndev,
            "n_keys": n_keys,
            "n_queries": n_queries,
            "build_s": round(build_s, 3),
            "lookup_s": round(dt, 4),
            "device": str(jax.devices()[0]),
        },
    }


def _result(total, dt, n_reads, read_len, k, canonical, n_chunks, n_unique, mode):
    import jax

    kmers_per_s = total / dt
    return {
        "metric": "canonical_kmers_counted_per_s_chip",
        "value": round(kmers_per_s, 1),
        "unit": "kmers/s",
        "vs_baseline": round(kmers_per_s / REFERENCE_KMERS_PER_S, 2),
        "detail": {
            "mode": mode,
            "n_reads": n_reads,
            "read_len": read_len,
            "k": k,
            "canonical": canonical,
            "chunks": n_chunks,
            "wall_s": round(dt, 3),
            "total_kmers": total,
            "unique_kmers": n_unique,
            "device": str(jax.devices()[0]),
        },
    }
