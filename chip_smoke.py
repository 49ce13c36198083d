#!/usr/bin/env python
"""Proof that the engine's user-facing paths run on NVIDIA GPUs.

    python chip_smoke.py             # one card: every single-card phase
    python chip_smoke.py --cards 4   # four cards: the sharded paths only

One card drives, through the CLI's own entry point (``kmer_tpu.cli.main``,
called in this process):

* file -> table counting at BASELINE configs[1] size: k=21 canonical
  over a seeded FASTQ of 2^20 reads x 150 bp (136,314,880 windows),
  once on the single-shot route and once on the streaming fold route
  with a checkpoint writer (``--ckpt``);
* ``parity --scale 100000``, the reference suite at its real size;
* a TCP ``serve`` session with a write-ahead log over a 100k-row
  ``datagen`` table, answered identically by the same table served
  with ``--no-index``;
* the batched index paths at configs[2] size (2^22 random 21-mer keys):
  hash-index equality, sorted-index equality and prefix ranges, and
  IUPAC pattern hits.

``--cards 4`` runs the sharded counting and serving paths on a mesh of
four cards and nothing else.

Every result is compared with a plain numpy oracle defined in this file
(2-bit codes, uint64 keys, reverse complement, ``min``, ``np.unique``)
that shares no code with ``kmer_tpu.ops``.  The comparison is bit-exact,
tolerance 0: every device result here is an integer.

The script holds the card(s) in this one process: the server runs in a
thread, never in a second JAX process.  It exits non-zero, before any
result line, when JAX finds no GPU; no phase catches its own failure.
The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import queue
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

READ_LEN = 150
K = 21
INDEX_KEYS = 1 << 22
SERVE_ROWS = 100_000


# --- numpy oracle (independent of kmer_tpu.ops) ------------------------------


def fastq_bytes(codes: np.ndarray) -> bytes:
    """FASTQ text for equal-length reads of 2-bit codes (A, C, G, T)."""
    n, length = codes.shape
    if n >= 10**7:
        raise ValueError("read ids are 7 digits")
    ids = np.arange(n, dtype=np.int64)
    head = np.empty((n, 10), np.uint8)
    head[:, 0] = ord("@")
    head[:, 1] = ord("r")
    for p in range(7):
        head[:, 8 - p] = ord("0") + (ids // 10**p) % 10
    head[:, 9] = ord("\n")
    rec = np.empty((n, 10 + length + 3 + length + 1), np.uint8)
    rec[:, :10] = head
    rec[:, 10:10 + length] = np.frombuffer(b"ACGT", np.uint8)[codes]
    rec[:, 10 + length:13 + length] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 13 + length:13 + 2 * length] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def _pool():
    import concurrent.futures

    return concurrent.futures.ThreadPoolExecutor(min(32, os.cpu_count() or 1))


def _keys_of(codes: np.ndarray, k: int, canonical: bool) -> np.ndarray:
    n, length = codes.shape
    m = length - k + 1
    fwd = np.zeros((n, m), np.uint64)
    rev = np.zeros_like(fwd)
    for j in range(k):
        c = codes[:, j:j + m].astype(np.uint64)
        fwd <<= np.uint64(2)
        fwd |= c
        rev |= (np.uint64(3) - c) << np.uint64(2 * j)
    return (np.minimum(fwd, rev) if canonical else fwd).ravel()


def _bucketed(parts: list, top_shift: int, n_buckets: int) -> list:
    """Split each key array by its top bits; returns, per bucket, the
    list of (part index, positions) in that bucket, in part order."""
    out = [[] for _ in range(n_buckets)]
    for i, keys in enumerate(parts):
        b = (keys >> np.uint64(top_shift)).astype(np.uint16)
        order = np.argsort(b, kind="stable")  # radix sort of 16-bit ids
        edges = np.searchsorted(b[order], np.arange(n_buckets + 1))
        for j in range(n_buckets):
            out[j].append((i, order[edges[j]:edges[j + 1]]))
    return out


def oracle_counts(codes: np.ndarray, k: int, canonical: bool = True):
    """(sorted unique keys, counts) over every window of the reads, as
    right-aligned 2k-bit uint64 keys (2-bit codes A=0, C=1, G=2, T=3);
    canonical takes min(key, reverse complement).  Keys are cut into
    buckets by their top bits so threads can sort the buckets apart."""
    step = 1 << 15
    bits = min(8, 2 * k)
    with _pool() as ex:
        parts = list(ex.map(lambda s: _keys_of(codes[s:s + step], k, canonical),
                            range(0, codes.shape[0], step)))
        buckets = _bucketed(parts, 2 * k - bits, 1 << bits)

        def uniq(members):
            keys = np.concatenate([parts[i][pos] for i, pos in members])
            return np.unique(keys, return_counts=True)

        res = list(ex.map(uniq, buckets))
    return (np.concatenate([r[0] for r in res]),
            np.concatenate([r[1] for r in res]))


def sort_by_key(keys: np.ndarray, counts: np.ndarray, k: int):
    """(keys, counts) in ascending key order, sorted by threads over
    top-bit buckets; returns the inputs when already ascending."""
    keys = np.asarray(keys, np.uint64)
    counts = np.asarray(counts, np.int64)
    if keys.size < 2 or bool(np.all(keys[1:] > keys[:-1])):
        return keys, counts
    bits = min(8, 2 * k)
    chunk = 1 << 24
    parts = [keys[s:s + chunk] for s in range(0, keys.size, chunk)]
    with _pool() as ex:
        buckets = _bucketed(parts, 2 * k - bits, 1 << bits)

        def one(members):
            idx = np.concatenate([pos + i * chunk for i, pos in members])
            order = np.argsort(keys[idx], kind="stable")
            return keys[idx[order]], counts[idx[order]]

        res = list(ex.map(one, buckets))
    return (np.concatenate([r[0] for r in res]),
            np.concatenate([r[1] for r in res]))


def engine_keys(hi, lo, k: int) -> np.ndarray:
    """Left-aligned (hi, lo) uint32 lanes -> right-aligned uint64 keys."""
    key = (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
    return key >> np.uint64(64 - 2 * k)


def check_table(name: str, keys, counts, *wants, length=None, k: int = K) -> dict:
    """Bit-exact comparison of a counted table with each of ``wants``
    ((sorted keys, counts) pairs: the oracle, another route's table)."""
    keys, counts = sort_by_key(keys, counts, k)
    if length is not None and not np.all(np.asarray(length) == k):
        raise AssertionError(f"{name}: a live group has length != {k}")
    for i, (want_keys, want_counts) in enumerate(wants):
        what = "the oracle" if i == 0 else f"reference {i}"
        if keys.size != want_keys.size:
            raise AssertionError(
                f"{name}: n_unique {keys.size} != {what}'s {want_keys.size}")
        if not np.array_equal(keys, want_keys):
            raise AssertionError(f"{name}: keys differ from {what}")
        if not np.array_equal(counts, want_counts):
            raise AssertionError(f"{name}: counts differ from {what}")
    return {"n_unique": int(keys.size), "total": int(counts.sum())}


class OracleThread(threading.Thread):
    """Computes the oracle beside the device phases (numpy's bulk work
    releases the interpreter lock); ``result()`` re-raises its error."""

    def __init__(self, codes, k):
        super().__init__(daemon=True)
        self._args = (codes, k)
        self._out = None
        self._err = None

    def run(self):
        try:
            self._out = oracle_counts(*self._args)
        except BaseException as e:  # re-raised in result()
            self._err = e

    def result(self):
        self.join()
        if self._err is not None:
            raise self._err
        return self._out


# --- harness ------------------------------------------------------------------


def phase(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    dt = time.perf_counter() - t0
    print(f"phase {name}: ok in {dt:.3f} s {json.dumps(out)}", flush=True)
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cli(*argv: str) -> str:
    """Run ``kmer_tpu.cli.main`` in-process; returns its standard output."""
    from kmer_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    if rc != 0:
        raise AssertionError(f"kmer_tpu {argv[0]} exited {rc}: {buf.getvalue()[-2000:]}")
    return buf.getvalue()


# --- single-card phases ------------------------------------------------------


def phase_native() -> dict:
    from kmer_tpu.native import native_available

    if not native_available():
        raise AssertionError("native host library did not load or build")
    return {"native": True}


def phase_count_single_shot(fq: str, out: str, oracle) -> dict:
    top = cli("count", "--input", fq, "-k", str(K), "--canonical",
              "--top", "3", "--save", out)
    with np.load(out, allow_pickle=False) as z:
        if "counts_lo" in z.files:
            raise AssertionError("count took the streaming route, not single-shot")
        keys = engine_keys(z["hi"], z["lo"], K)
        res = check_table("single-shot count", keys, z["counts"], oracle,
                          length=z["length"])
    _check_top(top, oracle)
    return res


def phase_count_streaming(fq: str, ckpt: str, oracle) -> dict:
    """The streaming fold route; its final confirmed checkpoint holds the
    whole table, which is what is checked."""
    from kmer_tpu.parallel.streaming import load_wide

    top = cli("count", "--input", fq, "-k", str(K), "--canonical",
              "--top", "3", "--ckpt", ckpt)
    t, meta = load_wide(ckpt)
    if int(meta.get("batches_done", 0)) <= 0:
        raise AssertionError("streaming count wrote no confirmed checkpoint")
    t = t.trim()
    res = check_table("streaming count", engine_keys(t.hi, t.lo, K),
                      t.counts64(), oracle, length=t.length)
    _check_top(top, oracle)
    res["ckpt_batches_done"] = int(meta["batches_done"])
    return res


def _check_top(text: str, oracle) -> None:
    keys, counts = oracle
    order = np.lexsort((keys, -counts))[:3]
    want = [("".join("acgt"[(int(key) >> (2 * (K - 1 - j))) & 3] for j in range(K)),
             int(c)) for key, c in zip(keys[order], counts[order])]
    got = [(km, int(c)) for km, c in
           (ln.split("\t") for ln in text.strip().splitlines()[-3:])]
    if got != want:
        raise AssertionError(f"top-3 rows {got} != oracle {want}")


def phase_memory(fq: str, reads: int) -> dict:
    """Compiled memory of the single-shot count step at this file's size."""
    import jax
    import jax.numpy as jnp

    from kmer_tpu.ops.count import count_windows
    from kmer_tpu.pipeline import file_batch_feed

    _, batch, width, _ = file_batch_feed(fq, "fastq", K, None, None)
    n_batches = -(-reads // batch)
    slots = n_batches * batch * (width - K + 1)
    u32 = jax.ShapeDtypeStruct((slots,), jnp.uint32)
    valid = jax.ShapeDtypeStruct((slots,), jnp.bool_)
    compiled = jax.jit(count_windows, static_argnames=("k",)).lower(
        u32, u32, valid, k=K).compile()
    ma = compiled.memory_analysis()
    out = {"slots": slots}
    for name in ("argument_size_in_bytes", "output_size_in_bytes",
                 "temp_size_in_bytes", "peak_memory_in_bytes"):
        out[name] = int(getattr(ma, name, 0) or 0)
    dev = jax.devices()[0]
    limit = int((dev.memory_stats() or {}).get("bytes_limit", 0))
    out["device_bytes_limit"] = limit
    need = out["argument_size_in_bytes"] + out["output_size_in_bytes"] + out["temp_size_in_bytes"]
    if not 0 < need <= limit:
        raise AssertionError(
            f"single-shot step needs {need} B; the allocator's limit is {limit} B")
    return out


def phase_parity() -> dict:
    text = cli("parity", "--scale", str(SERVE_ROWS))
    fails = [ln for ln in text.splitlines() if ln.startswith("FAIL")]
    if fails:
        raise AssertionError(f"parity failures: {fails}")
    return {"pass_lines": sum(ln.startswith("PASS") for ln in text.splitlines())}


class _StdoutTap(io.TextIOBase):
    """Forwards writes to the real stdout and queues complete lines."""

    def __init__(self, real):
        self.real = real
        self.lines: queue.Queue = queue.Queue()
        self._buf = ""

    def write(self, s):
        self.real.write(s)
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.put(line)
        return len(s)

    def flush(self):
        self.real.flush()


def start_server(*argv: str) -> int:
    """Start ``kmer_tpu serve --tcp 0 ...`` in a daemon thread of this
    process; returns the port from its ready line."""
    from kmer_tpu.cli import main

    errors: list = []

    def run():
        try:
            main(["serve", "--tcp", "0", *argv])
        except BaseException as e:  # reported by the waiting caller
            errors.append(e)

    tap = _StdoutTap(sys.stdout)
    sys.stdout = tap
    try:
        t = threading.Thread(target=run, daemon=True)
        t.start()
        deadline = time.time() + 600
        while True:
            if errors:
                raise errors[0]
            if time.time() > deadline:
                raise TimeoutError("server did not report ready")
            try:
                line = tap.lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if '"tcp"' in line:
                return int(json.loads(line)["tcp"])
    finally:
        sys.stdout = tap.real


def ask(port: int, commands: list[str]) -> list:
    with socket.create_connection(("127.0.0.1", port), timeout=600) as s:
        f = s.makefile("rwb")
        out = []
        for c in commands:
            f.write((c + "\n").encode())
            f.flush()
            out.append(json.loads(f.readline()))
        f.write(b"QUIT\n")
        f.flush()
    return out


def phase_serve(td: str) -> dict:
    import random

    csv = os.path.join(td, "table.csv")
    cli("datagen", "--rows", str(SERVE_ROWS), "--seed", "7", "--out", csv)
    with open(csv) as f:
        rows = [ln.strip().split(",") for ln in f.readlines()[1:]]
    rng = random.Random(7)
    pick = [rows[rng.randrange(len(rows))] for _ in range(8)]
    kmers = [r[1].lower() for r in pick]
    new_row = "ACGTACGTAC,ACGTACGTACGTACGTACGTA,ACGTNNNNNRYACGT"
    reads = (
        [f"EQ {q}" for q in kmers + ["acgtacgtacgtacgtacgta", "t" * 32]]
        + [f"PREFIX {q[:max(1, len(q) // 2)]}" for q in kmers] + ["PREFIX ac"]
        + [f"PATTERN {r[2].lower()}" for r in pick] + ["PATTERN angry", "PATTERN nnnn"]
        + ["COUNT", "DISTINCT", "GROUP 10"]
    )
    session = (
        reads
        + [f"INSERT {new_row}", "INSERT ACGT,ACGX,ACGT",
           f"DELETE {kmers[0]}", f"DELETEDNA {pick[1][0]}"]
        + reads
    )
    wal = os.path.join(td, "serve.wal")
    indexed = start_server("--input", csv, "--wal", wal)
    scan = start_server("--input", csv, "--no-index",
                        "--wal", os.path.join(td, "scan.wal"))
    got = ask(indexed, session)
    want = ask(scan, session)
    for cmd, a, b in zip(session, got, want):
        if a != b:
            raise AssertionError(f"serve {cmd!r}: index {a} != scan {b}")
    if any("error" in r for r in got[:len(reads)]):
        raise AssertionError("a read query returned an error")
    if not all(r["rows"] for r in got[:len(kmers)]):
        raise AssertionError("a stored kmer was not found by EQ")
    ins, bad, dele, deld = got[len(reads):len(reads) + 4]
    if ins != {"inserted": 1} or "error" not in bad or dele["deleted"] < 1:
        raise AssertionError(f"mutations answered {ins}, {bad}, {dele}")
    # replay: a fresh server on the same WAL sees every acknowledged mutation
    count_after = got[len(reads) + 4 + reads.index("COUNT")]["value"]
    replayed = start_server("--input", csv, "--wal", wal)
    (count_replayed,) = [r["value"] for r in ask(replayed, ["COUNT"])]
    if count_replayed != count_after:
        raise AssertionError(f"WAL replay COUNT {count_replayed} != {count_after}")
    return {"commands": len(session), "rows": SERVE_ROWS,
            "count_after_mutations": count_after,
            "deleted": dele["deleted"] + deld["deleted"]}


def random_index_keys(seed: int, n: int):
    """Random 21-mer keys as (hi, lo, length, uint64 key) columns."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo &= np.uint32(0xFFC00000)  # 21 bases: 16 in hi, 5 in lo's top bits
    ln = np.full(n, K, np.int32)
    return hi, lo, ln, (hi.astype(np.uint64) << np.uint64(32)) | lo


def query_keys(seed: int, key64: np.ndarray, n: int) -> np.ndarray:
    """Queries: three quarters stored keys, one quarter random keys."""
    rng = np.random.default_rng(seed + 1)
    q = key64[rng.integers(0, key64.size, n)]
    rnd = rng.integers(0, 2**63, n // 4, dtype=np.uint64) << np.uint64(1)
    q[: n // 4] = rnd & np.uint64(0xFFFFFFFFFFC00000)
    return q


def prefix_oracle(skeys: np.ndarray, q: np.ndarray, plen: np.ndarray):
    """[left, right) in ascending keys of rows starting with each prefix."""
    shift = (64 - 2 * plen).astype(np.uint64)
    lo = (q >> shift) << shift
    step = np.uint64(1) << shift
    wrapped = lo > np.uint64(2**64 - 1) - step
    with np.errstate(over="ignore"):
        hi_key = np.where(wrapped, np.uint64(0), lo + step)
    left = np.searchsorted(skeys, lo, side="left")
    right = np.where(wrapped, skeys.size, np.searchsorted(skeys, hi_key, side="left"))
    return left, right


def pattern_masks(rng, key64, sel, det_len, iupac_tail):
    """[M, 32] IUPAC 4-bit masks matching the selected stored keys: the
    first det_len bases determinate, the rest 'n' or a 2-base code."""
    m = sel.size
    shifts = np.uint64(62) - np.uint64(2) * np.arange(K, dtype=np.uint64)
    codes = ((key64[sel][:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint32)
    onehot = np.uint32(1) << codes
    if iupac_tail:
        tail = onehot | (np.uint32(1) << rng.integers(0, 4, (m, K)).astype(np.uint32))
    else:
        tail = np.full((m, K), 15, np.uint32)
    masks = np.zeros((m, 32), np.uint32)
    masks[:, :K] = np.where(np.arange(K)[None, :] < det_len, onehot, tail)
    return masks


def pattern_oracle(key64, order, skeys, masks, det_len) -> list[np.ndarray]:
    """Rows matching each mask: the determinate leading bases bound the
    candidates to one prefix range of the sorted keys; every base of
    every candidate is then checked against its mask."""
    shifts = np.uint64(62) - np.uint64(2) * np.arange(K, dtype=np.uint64)
    lead = np.zeros(masks.shape[0], np.uint64)
    for i in range(det_len):
        code = np.log2(masks[:, i]).astype(np.uint64)
        lead |= code << shifts[i]
    left, right = prefix_oracle(skeys, lead, np.full(lead.size, det_len))
    out = []
    for mk, a, b in zip(masks, left, right):
        rows = order[a:b]
        codes = ((key64[rows][:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint32)
        ok = np.all((mk[None, :K] >> codes) & 1, axis=1)
        out.append(np.sort(rows[ok]))
    return out


def phase_index(seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from kmer_tpu.index import DeviceHashIndex, DeviceIndex
    from kmer_tpu.packed import PackedKmers

    hi, lo, ln, key64 = random_index_keys(seed, INDEX_KEYS)
    order = np.argsort(key64, kind="stable")
    skeys = key64[order]
    n_q = 1 << 20
    q = query_keys(seed, key64, n_q)
    qhi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
    qlo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    qln = jnp.full((n_q,), K, jnp.int32)
    want_l = np.searchsorted(skeys, q, side="left")
    want_r = np.searchsorted(skeys, q, side="right")

    # hash index equality: group size and the group's rows
    hidx = DeviceHashIndex.build(PackedKmers(hi=hi, lo=lo, length=ln))
    start, cnt, found = jax.device_get(hidx.lookup_eq(qhi, qlo, qln))
    if not np.array_equal(cnt, want_r - want_l):
        raise AssertionError("hash lookup_eq counts != searchsorted oracle")
    if not np.array_equal(found, want_r > want_l):
        raise AssertionError("hash lookup_eq found != searchsorted oracle")
    rid = np.asarray(hidx.row_ids)
    hit = np.flatnonzero(found)
    if not np.array_equal(key64[rid[start[hit]]], q[hit]):
        raise AssertionError("hash lookup_eq points at rows of another key")

    # sorted device index: equality and prefix ranges
    didx = DeviceIndex.build(PackedKmers(hi=jnp.asarray(hi), lo=jnp.asarray(lo),
                                         length=jnp.asarray(ln)))
    fence = didx.build_fence(bits=18)
    left, right = jax.device_get(jax.jit(
        lambda a, b, c: didx.eq_ranges(a, b, c, fence=fence))(qhi, qlo, qln))
    if not (np.array_equal(left, want_l) and np.array_equal(right, want_r)):
        raise AssertionError("eq_ranges != searchsorted oracle")
    if not np.array_equal(key64[np.asarray(didx.row_ids)], skeys):
        raise AssertionError("sorted index row ids do not follow key order")
    rng = np.random.default_rng(seed + 2)
    plen = rng.integers(1, K + 1, n_q).astype(np.int32)
    mask = ~((np.uint64(1) << (np.uint64(64) - 2 * plen.astype(np.uint64))) - np.uint64(1))
    pq = q & mask
    pl, pr = jax.device_get(jax.jit(
        lambda a, b, c: didx.prefix_ranges(a, b, c, fence=fence))(
            jnp.asarray((pq >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((pq & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray(plen)))
    wl, wr = prefix_oracle(skeys, pq, plen)
    if not (np.array_equal(pl, wl) and np.array_equal(pr, wr)):
        raise AssertionError("prefix_ranges != searchsorted oracle")

    # IUPAC pattern hits, two regimes, against a scan of the candidates
    n_hits = 0
    for det, iupac, nq, cap in ((12, False, 256, 16), (6, True, 64, 4096)):
        sel = rng.integers(0, INDEX_KEYS, nq)
        masks = pattern_masks(rng, key64, sel, det, iupac)
        rows, ok, trunc = jax.device_get(jax.jit(
            lambda mk, cap=cap: didx.pattern_hits(mk, qlen=K, cap=cap))(
                jnp.asarray(masks)))
        if trunc.any():
            raise AssertionError(f"pattern cap {cap} truncated")
        for i, want in enumerate(pattern_oracle(key64, order, skeys, masks, det)):
            got = np.sort(rows[i][ok[i]])
            if not np.array_equal(got, want):
                raise AssertionError(f"pattern query {i} (det {det}) != scan")
            n_hits += got.size
    return {"keys": INDEX_KEYS, "eq_queries": n_q,
            "eq_hits": int((want_r > want_l).sum()), "prefix_queries": n_q,
            "pattern_queries": 320, "pattern_hits": int(n_hits)}


def run_one_card(seed: int, reads: int) -> None:
    from kmer_tpu.ops.extract import simulate_reads

    codes = simulate_reads(reads, READ_LEN, seed=seed)
    oracle = OracleThread(codes, K)
    oracle.start()
    phase("native_host_library", phase_native)
    with tempfile.TemporaryDirectory() as td:
        fq = os.path.join(td, "reads.fastq")
        with open(fq, "wb") as f:
            f.write(fastq_bytes(codes))
        print(f"fastq: {reads} reads x {READ_LEN} bp, "
              f"{reads * (READ_LEN - K + 1)} windows, "
              f"{os.path.getsize(fq)} bytes", flush=True)
        phase("single_shot_memory", phase_memory, fq, reads)
        want = oracle.result()
        phase("count_single_shot", phase_count_single_shot, fq,
              os.path.join(td, "single.npz"), want)
        phase("count_streaming_ckpt", phase_count_streaming, fq,
              os.path.join(td, "stream.ckpt"), want)
    del want
    phase("parity_scale", phase_parity)
    with tempfile.TemporaryDirectory() as td:
        phase("serve_tcp_wal", phase_serve, td)
    phase("index_lookups", phase_index, seed)


# --- four-card phases --------------------------------------------------------


def run_four_cards(seed: int, reads: int, devices) -> None:
    import jax
    import jax.numpy as jnp

    from kmer_tpu.ops.count import count_kmers
    from kmer_tpu.ops.extract import simulate_reads
    from kmer_tpu.parallel.dist import count_kmers_sharded
    from kmer_tpu.parallel.driver import run_distcount
    from kmer_tpu.parallel.mesh import make_mesh
    from kmer_tpu.parallel.selfcheck import run_multichip_checks
    from kmer_tpu.parallel.streaming import batches_of, stream_sharded_count

    n = 4 * reads
    codes = simulate_reads(n, READ_LEN, seed=seed)
    lengths = np.full(n, READ_LEN, np.int32)
    oracle = OracleThread(codes, K)  # host work, beside the self-checks
    oracle.start()
    phase("multichip_checks", run_multichip_checks, devices)
    want = oracle.result()

    ref = []  # the single-card table, which every sharded path must equal too

    def single_card():
        with jax.default_device(devices[0]):
            t = jax.jit(count_kmers, static_argnames=("k", "canonical"))(
                jnp.asarray(codes), jnp.asarray(lengths), k=K, canonical=True
            ).trim()
        ref.extend(sort_by_key(engine_keys(t.hi, t.lo, K),
                               np.asarray(t.counts, np.int64), K))
        return check_table("single-card count", *ref, want, length=t.length)

    phase("single_card_count", single_card)

    def sharded(merge):
        mesh = make_mesh((4, 1), devices)
        t = count_kmers_sharded(codes, lengths, K, mesh, canonical=True,
                                merge=merge).trim()
        return check_table(f"sharded {merge}", engine_keys(t.hi, t.lo, K),
                           t.counts, want, ref, length=t.length)

    phase("count_kmers_sharded_gather", sharded, "gather")
    phase("count_kmers_sharded_partition", sharded, "partition")

    # per-card accumulator slots: a quarter of all windows bounds each
    # shard's distinct keys (hash-routed), with headroom for imbalance;
    # the streaming and distcount accumulators hold the whole table
    per_card = 1 << int(n * (READ_LEN - K + 1) // 4 * 5 // 4).bit_length()

    def streamed():
        mesh = make_mesh((2, 2), devices)
        acc, overflow = stream_sharded_count(
            batches_of(codes, lengths, max(4096, n // 16)), K, mesh,
            canonical=True, acc_capacity=per_card)
        if overflow:
            raise AssertionError(f"stream_sharded_count overflow {overflow}")
        t = acc.trim()
        return check_table("stream_sharded_count", engine_keys(t.hi, t.lo, K),
                           t.counts64(), want, ref, length=t.length)

    phase("stream_sharded_count_2x2", streamed)

    def distcount():
        with tempfile.TemporaryDirectory() as td:
            fq = os.path.join(td, "reads.fastq")
            with open(fq, "wb") as f:
                f.write(fastq_bytes(codes))
            # spill-dir set, but the shards never pass the spill
            # threshold at this size: a spill's exact K-way merge of a
            # 545M-row union runs on the host (ops/wide.merge_runs) for
            # minutes; the multichip checks spill and resume on the cards
            local, overflow = run_distcount(
                fq, K, canonical=True, batch=max(4096, n // 8), width=0,
                acc_capacity=per_card, ckpt=os.path.join(td, "ck"),
                ckpt_every=3, spill_dir=os.path.join(td, "spill"))
            spills = len(os.listdir(os.path.join(td, "spill")))
        if overflow:
            raise AssertionError(f"distcount overflow {overflow}")
        t = local.trim()
        out = check_table("distcount", engine_keys(t.hi, t.lo, K),
                          t.counts64(), want, ref, length=t.length)
        out["spill_runs"] = spills
        return out

    phase("distcount_ckpt_spill", distcount)
    del want, ref
    phase("sharded_index", phase_sharded_index, seed, devices)


def phase_sharded_index(seed: int, devices) -> dict:
    import jax.numpy as jnp

    from kmer_tpu.packed import PackedKmers
    from kmer_tpu.parallel.mesh import make_mesh
    from kmer_tpu.parallel.shindex import ShardedIndex, _make_lookup

    hi, lo, ln, key64 = random_index_keys(seed, INDEX_KEYS)
    skeys = np.sort(key64)
    mesh = make_mesh((4, 1), devices)
    sidx = ShardedIndex.build(PackedKmers(hi=hi, lo=lo, length=ln), mesh)
    n_q = 1 << 14
    q = query_keys(seed, key64, n_q)
    rng = np.random.default_rng(seed + 3)
    plen = rng.integers(1, K + 1, n_q).astype(np.int32)
    mask = ~((np.uint64(1) << (np.uint64(64) - 2 * plen.astype(np.uint64))) - np.uint64(1))
    out = {"keys": INDEX_KEYS, "queries": n_q}
    for op, qq, qln, (wl, wr), cap in (
        ("eq", q, np.full(n_q, K, np.int32),
         (np.searchsorted(skeys, q, "left"), np.searchsorted(skeys, q, "right")), 8),
        ("prefix", q & mask, plen, prefix_oracle(skeys, q & mask, plen), 8),
    ):
        step = _make_lookup(mesh, op, cap)
        rows, hit, count = step(
            sidx.hi, sidx.lo, sidx.length, sidx.row_ids, sidx.live,
            jnp.asarray((qq >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((qq & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray(qln))
        rows, hit, count = np.asarray(rows), np.asarray(hit), np.asarray(count)
        if not np.array_equal(count, wr - wl):
            raise AssertionError(f"sharded {op} counts != searchsorted oracle")
        # every materialized row really holds a matching key
        shift = (64 - 2 * qln).astype(np.uint64)
        for d in range(rows.shape[0]):
            r = rows[d][hit[d]]
            qi = np.nonzero(hit[d])[0]
            if not np.array_equal(key64[r] >> shift[qi], qq[qi] >> shift[qi]):
                raise AssertionError(f"sharded {op} returned a non-matching row")
        out[f"{op}_hits"] = int(count.sum())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reads", type=int, default=1 << 20,
                   help="reads per card (150 bp each)")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r}); "
              "this check runs only on NVIDIA cards", file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but JAX sees {len(devices)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from kmer_tpu.cli import enable_compile_cache

    enable_compile_cache()
    print(card_line(), flush=True)  # name, power limit: as nvidia-smi says
    print(f"jax {jax.__version__}, devices {[d.device_kind for d in devices]}",
          flush=True)
    t0 = time.perf_counter()
    if args.cards == 4:
        run_four_cards(args.seed, args.reads, devices[:4])
    else:
        run_one_card(args.seed, args.reads)
    print(f"all phases ok in {time.perf_counter() - t0:.3f} s", flush=True)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": args.cards}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
