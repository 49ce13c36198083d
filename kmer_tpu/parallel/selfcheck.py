"""Self-checks of the sharded paths on a given set of devices.

Run by ``__graft_entry__.dryrun_multichip`` on virtual CPU devices and by
``chip_smoke.py --cards 4`` on four GPUs: the same checks, the same
code, on whatever devices the caller passes.
"""

from __future__ import annotations

import numpy as np


def run_multichip_checks(devices) -> dict:
    """Sharded counting and serving checks over the given devices.

    Builds a 2D (data, seq) mesh (seq extent 2 when the device count
    allows, so the k-1 halo exchange runs) and checks, on small shapes:
    the gather and partition merges agree, a 4-step sharded stream
    equals a one-shot count, the single-device fused fold agrees, the
    sharded index equals the host index, the distcount driver equals a
    host oracle, and a ~1M-kmer distcount stream with forced spills and
    a mid-stream resume is bit-exact.  Returns a summary dict.
    """
    import jax
    import jax.numpy as jnp

    from kmer_tpu.config import EngineConfig
    from kmer_tpu.models.pipeline import KmerCounter
    from kmer_tpu.ops.extract import simulate_reads
    from kmer_tpu.parallel.mesh import make_mesh, mesh_shape_for

    n_dev = len(devices)
    # use both mesh axes when possible: seq extent 2 exercises the halo path
    seq = 2 if n_dev % 2 == 0 and n_dev >= 2 else 1
    shape = mesh_shape_for(n_dev, seq_parallel=seq)
    mesh = make_mesh(shape, devices)

    cfg = EngineConfig(k=5, canonical=True)
    model = KmerCounter(cfg)

    dp, sp = shape
    batch = 4 * dp
    read_len = 8 * sp
    reads = simulate_reads(num_reads=batch, read_len=read_len, seed=1)
    lengths = np.full(batch, read_len, np.int32)
    lengths[0] = max(cfg.k, read_len // 2)  # one ragged read through the halo path

    table = model.count_sharded(jnp.asarray(reads), jnp.asarray(lengths), mesh)
    jax.block_until_ready(table)
    n = int(table.n_unique)
    total = table.total()
    expect_total = int(np.maximum(lengths - cfg.k + 1, 0).sum())
    assert total == expect_total, (total, expect_total)
    assert 0 < n <= total

    # second full step through the partition merge: hash-partitioned
    # all_to_all, output sharded over both mesh axes
    from kmer_tpu.parallel.dist import count_kmers_sharded

    part = count_kmers_sharded(
        jnp.asarray(reads), jnp.asarray(lengths), cfg.k, mesh,
        canonical=cfg.canonical, merge="partition",
    )
    jax.block_until_ready(part)
    assert part.to_dict() == table.to_dict(), "partition merge != gather merge"

    # sharded streaming: 4 accumulation steps through the sharded
    # 64-bit accumulator (hash-partitioned all_to_all + device-local
    # wide merges), equal to one replicated count of all 4 batches
    from kmer_tpu.parallel.streaming import batches_of, stream_sharded_count

    reads4 = simulate_reads(num_reads=4 * batch, read_len=read_len, seed=2)
    lengths4 = np.tile(lengths, 4)
    acc, overflow = stream_sharded_count(
        batches_of(reads4, lengths4, batch), cfg.k, mesh,
        canonical=cfg.canonical, acc_capacity=1024,
    )
    jax.block_until_ready(acc)
    assert overflow == 0, overflow
    ref = model.count_sharded(jnp.asarray(reads4), jnp.asarray(lengths4), mesh)
    assert acc.to_dict() == ref.to_dict(), "streamed accumulator != one-shot"

    # single-device stream fast path (fused one-sort fold of raw windows
    # into the wide accumulator, ops/wide.fold_windows_into_wide) must
    # agree with the sharded stream
    mesh1 = make_mesh((1, 1), devices[:1])
    acc1, ovf1 = stream_sharded_count(
        batches_of(reads4, lengths4, batch), cfg.k, mesh1,
        canonical=cfg.canonical, acc_capacity=1024,
    )
    jax.block_until_ready(acc1)
    assert ovf1 == 0, ovf1
    assert acc1.to_dict() == acc.to_dict(), "fused fold != sharded stream"

    # sharded index serving: per-shard local sorts + replicated queries
    from kmer_tpu.index import KmerIndex
    from kmer_tpu.packed import PackedKmers
    from kmer_tpu.parallel.shindex import ShardedIndex

    kmers = ["acgta", "cgtac", "acgta", "", "t" * 32, "acg"]
    col = PackedKmers.from_strings(kmers)
    sidx = ShardedIndex.build(col, mesh)
    host = KmerIndex.build(col)
    for q in ["acgta", "", "ttt"]:
        assert sidx.search_eq([q], cap=4)[0].tolist() == host.search_eq(q).tolist()
    for q in ["ac", "", "t"]:
        assert (
            sidx.search_prefix([q], cap=8)[0].tolist()
            == host.search_prefix(q).tolist()
        )

    # distcount driver: the multi-host operational entry point, exercised
    # single-process over the same mesh (file batches -> put_global_batch
    # -> sharded stream -> rank checkpoint -> local result)
    import collections
    import tempfile

    from kmer_tpu.parallel.driver import run_distcount

    with tempfile.TemporaryDirectory() as td:
        rng = np.random.default_rng(3)
        seqs = [
            "".join(rng.choice(list("acgt"), int(rng.integers(6, 40))))
            for _ in range(8 * dp)
        ]
        fa = f"{td}/reads.fasta"
        with open(fa, "w") as f:
            for i, s in enumerate(seqs):
                f.write(f">r{i}\n{s}\n")
        local, overflow = run_distcount(
            fa, cfg.k, batch=4 * dp, width=16 * sp, acc_capacity=512,
            mesh=mesh, ckpt=f"{td}/ck", ckpt_every=1,
        )
        assert overflow == 0
        want = collections.Counter()
        for s in seqs:
            for i in range(max(len(s) - cfg.k + 1, 0)):
                want[s[i : i + cfg.k]] += 1
        assert local.to_dict() == dict(want), "distcount != host oracle"

    # spill + resume workout (VERDICT r4 item #7): a ~1M-kmer stream
    # through the distcount driver with capacity forcing SPILLS, plus a
    # mid-stream resume — both must reproduce a host oracle exactly
    spill_stats = _spill_resume_check(mesh, dp)

    return {"mesh": list(shape), "kmers": total, "unique": n,
            "spill_runs": spill_stats["spills"]}


def _spill_resume_check(mesh, dp: int) -> dict:
    """~1M-kmer distcount stream with forced spills and a mid-stream
    resume on the mesh.  The resume is genuine: a first run over
    a half-length prefix file checkpoints and exits; the second run sees
    the full file with the same checkpoint and must skip the done
    batches, keep the spill-run list, and finish bit-exact vs both an
    uninterrupted run and a host oracle."""
    import os
    import tempfile

    import jax
    import numpy as np

    from kmer_tpu.parallel.driver import run_distcount

    K = 8
    READ_LEN = 32  # == row width: one row per read, so a prefix file's
    #                batches are a strict prefix of the full file's
    BATCH = 64 * dp
    N_BATCHES = 64
    n_reads = BATCH * N_BATCHES
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, (n_reads, READ_LEN), dtype=np.uint8)

    # host oracle via numpy (windows as uint16 keys, exact multiplicity)
    keys = []
    for off in range(READ_LEN - K + 1):
        key = np.zeros(n_reads, np.uint16)
        for j in range(K):
            key = (key << np.uint16(2)) | codes[:, off + j].astype(np.uint16)
        keys.append(key)
    uniq, cnt = np.unique(np.concatenate(keys), return_counts=True)
    lut = np.array(list("acgt"))

    def dec(v):
        return "".join(lut[(int(v) >> (2 * (K - 1 - j))) & 3]
                       for j in range(K))

    want = {dec(v): int(c) for v, c in zip(uniq, cnt)}
    total_kmers = int(cnt.sum())
    assert total_kmers == n_reads * (READ_LEN - K + 1)

    rows = ["".join(lut[c]) for c in codes]
    with tempfile.TemporaryDirectory() as td:
        full = os.path.join(td, "full.fasta")
        half = os.path.join(td, "half.fasta")
        with open(full, "w") as f:
            for i, s in enumerate(rows):
                f.write(f">r{i}\n{s}\n")
        cut = (N_BATCHES // 2) * BATCH
        with open(half, "w") as f:
            for i, s in enumerate(rows[:cut]):
                f.write(f">r{i}\n{s}\n")

        # per-shard capacity keeps the GLOBAL capacity (n_parts * cap)
        # constant: per-batch key influx per shard is mesh-invariant
        # here (batch scales with dp), so smaller meshes need LARGER
        # shards or the lagged spill trigger can't keep live < capacity
        n_parts = int(np.prod(mesh.devices.shape))
        common = dict(
            k=K, batch=BATCH, width=READ_LEN,
            acc_capacity=max(4096, 32768 // n_parts),
            mesh=mesh, ckpt_every=2, spill_threshold=0.5,
        )
        # uninterrupted run, spills forced by the small capacity
        straight, ovf = run_distcount(
            full, ckpt=os.path.join(td, "ck_a"),
            spill_dir=os.path.join(td, "runs_a"), **common)
        assert ovf == 0, ovf
        n_runs = len([p for p in os.listdir(os.path.join(td, "runs_a"))])
        assert n_runs > 0, "spill workout did not spill"
        assert straight.to_dict() == want, "spilled distcount != oracle"

        # half-file run -> checkpoint at the cut, then resume on the
        # full file from the same checkpoint
        _part, ovf = run_distcount(
            half, ckpt=os.path.join(td, "ck_b"),
            spill_dir=os.path.join(td, "runs_b"), **common)
        assert ovf == 0
        resumed, ovf = run_distcount(
            full, ckpt=os.path.join(td, "ck_b"),
            spill_dir=os.path.join(td, "runs_b"), **common)
        assert ovf == 0
        st, rt = straight.trim(), resumed.trim()
        assert np.array_equal(np.asarray(st.hi), np.asarray(rt.hi))
        assert np.array_equal(np.asarray(st.lo), np.asarray(rt.lo))
        assert np.array_equal(st.counts64(), rt.counts64()), (
            "mid-stream resume != uninterrupted run")
        jax.block_until_ready(jax.numpy.zeros(1))
        return {"spills": n_runs, "total": total_kmers}
