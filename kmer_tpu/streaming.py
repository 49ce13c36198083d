"""Streaming counts over long sequences and read streams.

Covers the chromosome-scale shape (BASELINE.json configs[4]: ~250 Mbp,
k=31): the sequence streams through the device in fixed chunks with a
k-1 base overlap between consecutive chunks (every window is counted
exactly once), partial tables merge associatively, and progress can be
checkpointed/resumed via utils.checkpoint.ResumableCount.
"""

from __future__ import annotations

from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from .ops.count import CountTable, count_kmers
from .utils.logging import StatsCounters, get_logger


def iter_chunks_with_overlap(codes: np.ndarray, chunk: int, k: int) -> Iterator[tuple[np.ndarray, int]]:
    """Yield (chunk_codes, n_new_windows): consecutive chunks share k-1
    bases so windows crossing chunk edges are emitted exactly once."""
    n = codes.shape[0]
    if n < k:
        return
    step = chunk - (k - 1)
    assert step > 0, "chunk must exceed k-1"
    start = 0
    while start + k - 1 < n:
        end = min(start + chunk, n)
        yield codes[start:end], min(end, n) - start - (k - 1)
        if end >= n:
            break
        start += step


def count_long_sequence(
    codes: np.ndarray,
    k: int,
    canonical: bool = False,
    chunk: int = 1 << 24,
    resumable=None,
    stats: StatsCounters | None = None,
) -> CountTable:
    """Exact k-mer count of one long 2-bit code sequence, streamed.

    Fast path (no resume): each fixed-shape chunk is *extracted* into a
    preallocated device window buffer, then ONE sort-count runs over all
    windows — a single compiled program per shape, no per-chunk merge
    (a growing accumulator would recompile every step and re-sort the
    same data log(chunks) times).

    Resumable path: per-chunk fused count + associative merge, so
    progress snapshots stay small enough to checkpoint.
    """
    if resumable is not None:
        return _count_long_resumable(codes, k, canonical, chunk, resumable, stats)

    from .native import device_unpack_rows, pack2bit_rows
    from .ops.count import count_windows
    from .ops.extract import canonicalize, extract_windows

    log = get_logger()
    n = int(codes.shape[0])
    total_windows = n - k + 1
    if total_windows <= 0:
        raise ValueError("sequence shorter than k")
    assert chunk % 16 == 0, "chunk must be word-aligned"
    step = chunk - (k - 1)
    n_chunks = -(-total_windows // step)
    cap = n_chunks * step  # buffer capacity (>= total_windows)

    def extract_chunk(words):
        # packed wire format (4x less host->device traffic); unpack fuses
        # into the extraction on device
        part_codes = device_unpack_rows(words, chunk)[0]
        hi, lo = extract_windows(part_codes, k)  # [chunk-k+1] == [step]
        if canonical:
            hi, lo = canonicalize(hi, lo, k)
        return hi, lo

    extract_j = jax.jit(extract_chunk)

    @jax.jit
    def place(bh, bl, hi, lo, start):
        return (
            jax.lax.dynamic_update_slice(bh, hi, (start,)),
            jax.lax.dynamic_update_slice(bl, lo, (start,)),
        )

    def count_all(bh, bl):
        valid = jnp.arange(cap, dtype=jnp.int32) < total_windows
        return count_windows(bh, bl, valid, k)

    count_j = jax.jit(count_all)

    buf_hi = jnp.zeros((cap,), jnp.uint32)
    buf_lo = jnp.zeros((cap,), jnp.uint32)
    part = np.zeros((chunk,), np.uint8)
    for i in range(n_chunks):
        start = i * step
        end = min(start + chunk, n)
        part[:] = 0
        part[: end - start] = codes[start:end]
        hi, lo = extract_j(jnp.asarray(pack2bit_rows(part[None, :])))
        buf_hi, buf_lo = place(buf_hi, buf_lo, hi, lo, start)
        if stats is not None:
            stats.record_batch(0, end - start, max(end - start - k + 1, 0), 0)
        if (i + 1) % 16 == 0:
            log.info("streamed %d/%d chunks", i + 1, n_chunks)
    return count_j(buf_hi, buf_lo)


def _count_long_resumable(codes, k, canonical, chunk, resumable, stats):
    log = get_logger()
    step = jax.jit(lambda c, l: count_kmers(c, l, k, canonical))
    for i, (part, _) in enumerate(iter_chunks_with_overlap(codes, chunk, k)):
        if not resumable.should_process(i):
            continue
        buf = np.zeros((1, chunk), np.uint8)
        buf[0, : part.size] = part
        table = step(jnp.asarray(buf), jnp.asarray([part.size], jnp.int32))
        resumable.update(i, table)
        if stats is not None:
            stats.record_batch(0, part.size, part.size - k + 1, 0)
        if (i + 1) % 16 == 0:
            log.info("streamed %d chunks", i + 1)
    if resumable.table is None:
        raise ValueError("sequence shorter than k")
    return resumable.table


def count_read_stream(
    read_batches: Iterator[tuple[np.ndarray, np.ndarray]],
    k: int,
    canonical: bool = False,
    stats: StatsCounters | None = None,
    capacity: int = 1 << 16,
    max_capacity: int | None = None,
    spill_dir: str | None = None,
):
    """Exact count over an iterator of (codes [B, L], lengths [B]) batches.

    Accumulates through a fixed-capacity 64-bit WideAccumulator
    (ops/wide.py): totals stay exact past 2^31 (the reference's GROUP BY
    has unbounded totals, kmer-tests.sql:1107-1214) and each merge at a
    given (capacity, batch-shape) reuses one compiled program — the r2
    growing-CountTable path recompiled AND re-sorted the whole
    accumulator every batch.  Returns a WideCounts.

    ``max_capacity`` bounds the device accumulator: beyond it, live
    slots spill to host (or ``spill_dir``) as sorted runs and the
    result is their exact K-way merge — distinct-key cardinality is
    then bounded by host RAM/disk, not HBM (the reference inherits
    hash-agg spill from Postgres; SURVEY §1 L0).

    NOTE: this is the generic any-iterator path (one count + one
    accumulator re-sort per batch).  The operational file paths route
    through ``kmer_tpu.pipeline`` instead — fused fold steps, packed
    single-upload wire, producer-thread feed; prefer
    ``pipeline.count_batches_pipelined``
    for fixed-shape batch streams.
    """
    from .ops.wide import WideAccumulator

    import time as _time
    from collections import deque

    from .native import device_unpack_rows, pack2bit_rows

    # host->device wire format: 2-bit packed words (0.25 B/base), with
    # the unpack fused into the count jit — the raw uint8 rows are 4x
    # the bytes, and slow host links make the feed wire-bound
    step = jax.jit(
        lambda w, l, width: count_kmers(
            device_unpack_rows(w, width), l, k, canonical
        ),
        static_argnames=("width",),
    )
    acc = WideAccumulator(capacity, max_capacity=max_capacity,
                          spill_dir=spill_dir)
    inflight: deque = deque()
    n_done = 0
    for codes, lengths in read_batches:
        codes = np.asarray(codes)
        table = step(jnp.asarray(pack2bit_rows(codes)),
                     jnp.asarray(lengths), codes.shape[1])
        acc.add(table)
        if stats is not None:
            nb = int(np.asarray(lengths).sum())
            stats.record_batch(codes.shape[0], nb, max(nb - k + 1, 0), 0)
        # bound dispatch runahead: an unbounded queue holds every queued
        # batch's host rows and transfer buffers in RAM
        inflight.append(table.counts)
        while len(inflight) > 2:
            if inflight[0].is_ready():
                inflight.popleft()
            else:
                _time.sleep(0.02)
        n_done += 1
        if n_done % 8 == 0:
            # release per-upload staging buffers that wait on a GC pass;
            # a long count otherwise creeps ~1 staged batch of host RAM
            # per step
            import gc

            gc.collect()
    if acc.empty:
        raise ValueError("empty read stream")
    return acc.result()
