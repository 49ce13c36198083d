"""Pipelined disk-to-table counting (kmer_tpu/pipeline.py) — the r5
rebuild of the operational count path (VERDICT r4 item #1).

Oracle: a host Counter over the literal window strings — the same
GROUP BY semantics the reference pins in kmer-tests.sql:1107-1214.
Covers the exactness machinery specifically: in-graph revert on
capacity overflow, rollback-and-replay growth, spill-and-merge at a
device budget, checkpoint/resume at confirmed points, and the native
packed-row assembler against its numpy fallback.
"""

import os
from collections import Counter

import numpy as np
import pytest

from kmer_tpu.pipeline import (
    PipelineCheckpoint,
    auto_batch,
    auto_width,
    column_batch_feed,
    count_batches_pipelined,
    count_file,
    file_batch_feed,
    initial_capacity,
)

LUT = "acgt"


def _oracle_windows(codes: np.ndarray, lens: np.ndarray, k: int) -> Counter:
    c = Counter()
    for r in range(codes.shape[0]):
        s = "".join(LUT[x] for x in codes[r, : lens[r]])
        for i in range(len(s) - k + 1):
            c[s[i : i + k]] += 1
    return c


def _make_batches(rng, n_batches=5, B=48, W=32, k=5):
    batches, oracle = [], Counter()
    for _ in range(n_batches):
        codes = rng.integers(0, 4, (B, W), dtype=np.uint8)
        lens = rng.integers(0, W + 1, B).astype(np.int32)
        oracle.update(_oracle_windows(codes, lens, k))
        batches.append((codes, lens))
    return batches, oracle


def test_pipelined_exact_vs_oracle():
    rng = np.random.default_rng(0)
    batches, oracle = _make_batches(rng, k=5)
    res = count_batches_pipelined(iter(batches), 5, capacity=1 << 12,
                                  sample_every=2, runahead=3)
    assert res.to_dict() == dict(oracle)


def test_pipelined_growth_replay_exact():
    """A tiny starting capacity forces in-graph reverts + rollback-and-
    replay growth; the result must still be exact."""
    rng = np.random.default_rng(1)
    batches, oracle = _make_batches(rng, k=8, n_batches=6)
    res = count_batches_pipelined(iter(batches), 8, capacity=16,
                                  sample_every=2, runahead=3)
    assert res.to_dict() == dict(oracle)
    assert res.capacity >= len(oracle)


def test_pipelined_proactive_growth_exact():
    """Capacity comfortably above any single batch's distinct keys but
    below the cumulative total: growth should happen proactively off
    the sampled n_unique (and exactly, with or without reverts)."""
    rng = np.random.default_rng(16)
    batches, oracle = _make_batches(rng, k=8, n_batches=10, B=48, W=40)
    per_batch = max(len(_oracle_windows(b[0], b[1], 8)) for b in batches)
    cap = 1 << int(per_batch * 2).bit_length()
    assert cap < len(oracle)  # growth must happen across the stream
    res = count_batches_pipelined(iter(batches), 8, capacity=cap,
                                  sample_every=1, runahead=2,
                                  grow_threshold=0.5)
    assert res.to_dict() == dict(oracle)
    assert res.capacity > cap


def test_pipelined_spill_exact(tmp_path):
    """max_capacity below the distinct-key count spills sorted runs;
    the K-way merge must be exact (both host-RAM and spill-dir runs)."""
    rng = np.random.default_rng(2)
    batches, oracle = _make_batches(rng, k=8, n_batches=6, B=64, W=48)
    per_batch_distinct = max(
        len(_oracle_windows(b[0], b[1], 8)) for b in batches
    )
    cap = 1 << int(per_batch_distinct).bit_length()  # one batch fits
    assert cap < len(oracle)  # the union does not: spills must happen
    for sd in (None, str(tmp_path / "spills")):
        res = count_batches_pipelined(
            (iter([(b[0].copy(), b[1].copy()) for b in batches])),
            8, capacity=cap, max_capacity=cap, spill_dir=sd,
            sample_every=2, runahead=3,
        )
        assert res.to_dict() == dict(oracle)


def test_pipelined_oversize_batch_raises():
    rng = np.random.default_rng(3)
    batches, _ = _make_batches(rng, k=8, n_batches=2, B=64, W=48)
    with pytest.raises(ValueError, match="max_capacity"):
        count_batches_pipelined(iter(batches), 8, capacity=16,
                                max_capacity=256, sample_every=2)


def _write_fastq(path, rng, n_reads, k, lmin=10, lmax=120):
    oracle = Counter()
    with open(path, "w") as f:
        for i in range(n_reads):
            L = int(rng.integers(lmin, lmax))
            s = "".join("ACGT"[c] for c in rng.integers(0, 4, L))
            low = s.lower()
            for j in range(max(L - k + 1, 0)):
                oracle[low[j : j + k]] += 1
            f.write(f"@r{i}\n{s}\n+\n{'I' * L}\n")
    return oracle


_RC = {"a": "t", "c": "g", "g": "c", "t": "a"}


def _canon(s: str) -> str:
    rc = "".join(_RC[c] for c in reversed(s))
    return min(s, rc)


def test_count_file_canonical_both_routes(tmp_path):
    """Canonical (min of k-mer and reverse complement) counting — the
    north-star metric's mode — must match a host oracle on both routes."""
    rng = np.random.default_rng(12)
    path = str(tmp_path / "r.fastq")
    oracle = Counter()
    k = 9
    with open(path, "w") as f:
        for i in range(300):
            L = int(rng.integers(k, 120))
            s = "".join("ACGT"[c] for c in rng.integers(0, 4, L))
            low = s.lower()
            for j in range(L - k + 1):
                oracle[_canon(low[j : j + k])] += 1
            f.write(f"@r{i}\n{s}\n+\n{'I' * L}\n")
    for ss in (True, False):
        res = count_file(path, "fastq", k, canonical=True, batch=64,
                         capacity=1 << 12, single_shot=ss)
        assert res.to_dict() == dict(oracle), f"single_shot={ss}"


def test_count_file_exact_single_shot(tmp_path):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "r.fastq")
    oracle = _write_fastq(path, rng, 600, 7)
    res = count_file(path, "fastq", 7, batch=128, capacity=1 << 12,
                     single_shot=True)
    assert res.to_dict() == dict(oracle)


def test_count_file_exact_streaming(tmp_path):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "r.fastq")
    oracle = _write_fastq(path, rng, 600, 7)
    res = count_file(path, "fastq", 7, batch=128, capacity=1 << 12,
                     single_shot=False)
    assert res.to_dict() == dict(oracle)


def test_count_file_routes_match(tmp_path):
    """Auto routing picks single-shot for small files; both routes must
    agree exactly."""
    rng = np.random.default_rng(10)
    path = str(tmp_path / "r.fastq")
    oracle = _write_fastq(path, rng, 400, 9)
    auto = count_file(path, "fastq", 9, batch=64)
    stream = count_file(path, "fastq", 9, batch=64, single_shot=False)
    assert auto.to_dict() == dict(oracle) == stream.to_dict()


def test_count_file_long_reads_split(tmp_path):
    """Reads longer than the row width split with k-1 overlap; every
    window must still be counted exactly once."""
    rng = np.random.default_rng(5)
    path = str(tmp_path / "long.fastq")
    oracle = _write_fastq(path, rng, 60, 9, lmin=200, lmax=900)
    res = count_file(path, "fastq", 9, batch=64, width=160,
                     capacity=1 << 12)
    assert res.to_dict() == dict(oracle)


def test_count_file_resume(tmp_path):
    """A checkpointed partial run resumes to the identical table."""
    rng = np.random.default_rng(6)
    path = str(tmp_path / "r.fastq")
    oracle = _write_fastq(path, rng, 800, 7)
    ck = str(tmp_path / "ck.npz")

    # straight run (no checkpoint) = truth; pin the streaming route so
    # the WideCounts trims compare like-for-like
    straight = count_file(path, "fastq", 7, batch=64, capacity=1 << 12,
                          single_shot=False)

    # partial run: feed only the first 5 batches, checkpoint eagerly
    feed, batch, width, _ = file_batch_feed(path, "fastq", 7, 64, None)
    partial = [b for _, b in zip(range(5), feed)]
    count_batches_pipelined(iter(partial), 7, capacity=1 << 12,
                            ckpt=PipelineCheckpoint(ck), ckpt_every_s=0.0,
                            sample_every=2)
    pc = PipelineCheckpoint(ck)
    assert 0 < pc.batches_done <= 5

    # resumed full run must equal the straight run
    res = count_file(path, "fastq", 7, batch=64, width=width,
                     capacity=1 << 12, ckpt_path=ck)
    st, rt = straight.trim(), res.trim()
    assert np.array_equal(np.asarray(st.hi), np.asarray(rt.hi))
    assert np.array_equal(np.asarray(st.lo), np.asarray(rt.lo))
    assert np.array_equal(st.counts64(), rt.counts64())
    assert res.to_dict() == dict(oracle)


def test_count_file_all_reads_shorter_than_k(tmp_path):
    """Reads below k contribute no windows; the result is an empty
    table, not an error (generate_kmers errors on k>len only for the
    scalar SRF parity form — the bulk path counts zero windows)."""
    rng = np.random.default_rng(15)
    path = str(tmp_path / "short.fastq")
    with open(path, "w") as f:
        for i in range(50):
            s = "".join("ACGT"[c] for c in rng.integers(0, 4, 3))
            f.write(f"@r{i}\n{s}\n+\nIII\n")
    res = count_file(path, "fastq", 9, batch=16, capacity=1 << 10)
    assert res.to_dict() == {}


def test_empty_stream_raises():
    with pytest.raises(ValueError, match="empty"):
        count_batches_pipelined(iter([]), 5, capacity=1 << 10)


def test_max_slots_non_pow2_clamps_not_crashes():
    """A non-power-of-two device budget must clamp the starting
    capacity, not raise a contradiction of our own rounding."""
    rng = np.random.default_rng(17)
    batches, oracle = _make_batches(rng, k=5, n_batches=3)
    res = count_batches_pipelined(iter(batches), 5, capacity=3_000_000,
                                  max_capacity=3_000_000, sample_every=2)
    assert res.to_dict() == dict(oracle)
    assert res.capacity <= 1 << 21  # clamped to the rounded-down budget


def test_resume_flag_mismatch_rejected(tmp_path):
    """Resuming a checkpoint with different k/batch silently corrupts
    counts; it must raise instead."""
    rng = np.random.default_rng(18)
    batches, _ = _make_batches(rng, k=5, n_batches=4)
    ck = str(tmp_path / "ck.npz")
    count_batches_pipelined(
        iter([(b[0].copy(), b[1].copy()) for b in batches][:2]), 5,
        capacity=1 << 12, ckpt=PipelineCheckpoint(ck), ckpt_every_s=0.0,
        sample_every=1)
    with pytest.raises(ValueError, match="k=5"):
        count_batches_pipelined(iter(batches), 6, capacity=1 << 12,
                                ckpt=PipelineCheckpoint(ck))


def test_width_beyond_uint16_rejected():
    from kmer_tpu.native import rows_packed

    codes = np.zeros(10, np.uint8)
    offs = np.asarray([0, 10], np.int64)
    with pytest.raises(ValueError, match="65535"):
        rows_packed(codes, offs, 65536 + 16, 21)


def test_ckpt_with_ram_spill_rejected(tmp_path):
    """--ckpt + --max-slots without --spill-dir would stash spill runs
    in RAM where a restart cannot recover them: refuse up front."""
    rng = np.random.default_rng(13)
    batches, _ = _make_batches(rng, k=8, n_batches=2)
    with pytest.raises(ValueError, match="spill_dir"):
        count_batches_pipelined(
            iter(batches), 8, capacity=16, max_capacity=1024,
            ckpt=PipelineCheckpoint(str(tmp_path / "ck.npz")))


def test_ckpt_spill_resume_carries_runs(tmp_path):
    """Spill runs recorded in checkpoint metadata survive a resume: a
    partial spilled run + a resumed completion equals the straight
    result exactly."""
    rng = np.random.default_rng(14)
    path = str(tmp_path / "r.fastq")
    oracle = _write_fastq(path, rng, 900, 8, lmin=30, lmax=90)
    sd = str(tmp_path / "runs")
    ck = str(tmp_path / "ck.npz")

    feed, batch, width, _ = file_batch_feed(path, "fastq", 8, 64, None)
    all_batches = list(feed)
    per_batch = max(
        len(_oracle_windows_packed(b, 8)) for b in all_batches
    )
    cap = 1 << int(per_batch).bit_length()
    assert cap < len(oracle)  # spills must occur

    # partial run over a prefix, checkpointing eagerly
    count_batches_pipelined(
        iter(all_batches[: len(all_batches) // 2]), 8, capacity=cap,
        max_capacity=cap, spill_dir=sd, ckpt=PipelineCheckpoint(ck),
        ckpt_every_s=0.0, sample_every=2)
    pc = PipelineCheckpoint(ck)
    assert pc.batches_done > 0

    # resumed full run must equal the oracle (spilled + live merged)
    res = count_batches_pipelined(
        iter(all_batches), 8, capacity=cap, max_capacity=cap,
        spill_dir=sd, ckpt=PipelineCheckpoint(ck), ckpt_every_s=0.0,
        sample_every=2)
    assert res.to_dict() == dict(oracle)


def _oracle_windows_packed(b, k):
    """Distinct keys of one wire batch (words+lens combined or tuple)."""
    codes, lens = b
    c = Counter()
    if codes.dtype == np.uint32:  # packed words
        from kmer_tpu.native import pack2bit_rows  # noqa: F401

        # unpack on host: 16 bases/word, left-aligned
        B, NW = codes.shape
        out = np.zeros((B, NW * 16), np.uint8)
        for j in range(16):
            out[:, j::16] = ((codes >> np.uint32(30 - 2 * j)) & 3).astype(
                np.uint8)
        rows = out
    else:
        rows = codes
    for r in range(rows.shape[0]):
        s = "".join(LUT[x] for x in rows[r, : int(lens[r])])
        for i in range(len(s) - k + 1):
            c[s[i : i + k]] += 1
    return {kk for kk in c}


def test_rows_packed_matches_fallback():
    from kmer_tpu.native import native_available, pack2bit_rows, rows_packed
    from kmer_tpu.parallel.driver import split_long_reads

    if not native_available():
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(7)
    lens = np.concatenate(
        [rng.integers(0, 700, 300), [0, 1, 15, 16, 17, 159, 160, 161]]
    )
    offs = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    codes = rng.integers(0, 4, int(offs[-1]), dtype=np.uint8)
    w, l = rows_packed(codes, offs, 160, 21)
    rows, ls = split_long_reads(codes, offs, 160, 21)
    assert np.array_equal(w, pack2bit_rows(rows))
    assert np.array_equal(l.astype(np.int64), ls.astype(np.int64))


def test_column_feed_exact():
    rng = np.random.default_rng(8)
    seqs = []
    oracle = Counter()
    for _ in range(300):
        L = int(rng.integers(1, 200))
        s = "".join(LUT[c] for c in rng.integers(0, 4, L))
        seqs.append(s)
        for j in range(max(L - 6 + 1, 0)):
            oracle[s[j : j + 6]] += 1
    feed, _, _ = column_batch_feed(seqs, 6, batch=64)
    res = count_batches_pipelined(feed, 6, capacity=1 << 12, sample_every=2)
    assert res.to_dict() == dict(oracle)


def test_defaults_pin_measured_knee():
    """Shipped defaults keep large steps: 150 bp reads get >= 256k
    reads per step (4096-read steps were dispatch-bound)."""
    # 150bp reads -> width 160 -> auto batch >= 256k reads
    assert auto_width(np.asarray([150, 150, 150])) == 160
    assert auto_batch(160, 21) >= 1 << 18
    # a step never exceeds ~128M window slots (sort n·log n regression)
    for w in (32, 160, 256, 1024):
        assert auto_batch(w, 21) * max(w - 20, 1) <= 1 << 27
    # small inputs never pay a 16M-slot accumulator
    assert initial_capacity(1 << 24, 8, 10_000) == 16384
    assert initial_capacity(1 << 24, 8, 10 ** 9) == 65536  # 4^8 keyspace
    assert initial_capacity(1 << 24, 21, 10_000) == 16384
    assert initial_capacity(1 << 24, 21, 10 ** 12) == 1 << 24


def test_column_feed_long_rows_split():
    """A chromosome-length dna row splits into width-capped pieces with
    k-1 overlap (every window exactly once), like the r3 bucketed feed."""
    rng = np.random.default_rng(11)
    k = 9
    long_row = "".join("acgt"[c] for c in rng.integers(0, 4, 100_000))
    short = ["".join("acgt"[c] for c in rng.integers(0, 4, 40))
             for _ in range(50)]
    seqs = short[:25] + [long_row] + short[25:]
    oracle = Counter()
    for s in seqs:
        for i in range(max(len(s) - k + 1, 0)):
            oracle[s[i : i + k]] += 1
    feed, _, width = column_batch_feed(seqs, k, batch=64, width_cap=4096)
    assert width <= 4096
    res = count_batches_pipelined(feed, k, capacity=1 << 16, sample_every=2)
    assert res.to_dict() == dict(oracle)


def test_cli_count_from_dna_column(tmp_path, capsys):
    from kmer_tpu.cli import main
    from kmer_tpu.io.datagen import generate_test_rows, rows_to_csv

    csv = str(tmp_path / "t.csv")
    rows = generate_test_rows(50, seed=5)
    rows_to_csv(rows, csv)
    oracle = Counter()
    for dna, _, _ in rows:
        s = dna.lower()
        for i in range(max(len(s) - 4 + 1, 0)):
            oracle[s[i : i + 4]] += 1
    rc = main(["count", "--input", csv, "-k", "4", "--from-dna-column"])
    assert rc == 0
    got = {}
    for line in capsys.readouterr().out.strip().splitlines():
        kmer, cnt = line.split("\t")
        got[kmer] = int(cnt)
    assert got == dict(oracle)


def test_cli_count_fastq(tmp_path, capsys):
    from kmer_tpu.cli import main

    rng = np.random.default_rng(9)
    path = str(tmp_path / "r.fastq")
    oracle = _write_fastq(path, rng, 300, 6)
    rc = main(["count", "--input", path, "-k", "6", "--top", "0"])
    assert rc == 0
    out = capsys.readouterr().out
    got = {}
    for line in out.strip().splitlines():
        kmer, cnt = line.split("\t")
        got[kmer] = int(cnt)
    assert got == dict(oracle)
