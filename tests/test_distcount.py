"""Multi-host distcount driver (parallel/driver.py).

VERDICT r2 missing #4: the operational entry point composing
initialize_multihost + pod mesh + per-host batches + sharded streaming +
rank checkpointing.  The 2-process integration test launches two real
CLI processes against a localhost coordinator and checks their merged
rank tables against a single-process run over the concatenated input.
"""

import json
import os
import socket
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

from kmer_tpu.parallel.driver import (
    file_batches_fixed,
    merge_rank_files,
    run_distcount,
    split_long_reads,
)

BASES = "acgt"
K = 5


def _windows(s, k):
    return [s[i : i + k] for i in range(max(len(s) - k + 1, 0))]


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">r{i}\n{s}\n")


def _rand_seqs(n, rng, lo=3, hi=300):
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi))
        out.append("".join(rng.choice(list(BASES), ln)))
    return out


class TestSplitLongReads:
    def test_windows_preserved_exactly(self):
        rng = np.random.default_rng(0)
        seqs = _rand_seqs(40, rng, lo=1, hi=500)
        codes = np.concatenate(
            [[BASES.index(c) for c in s] for s in seqs if s] or [[]]
        ).astype(np.uint8)
        offs = np.concatenate([[0], np.cumsum([len(s) for s in seqs])]).astype(
            np.int64
        )
        rows, lens = split_long_reads(codes, offs, width=64, k=K)
        got = Counter()
        for row, ln in zip(rows, lens):
            s = "".join(BASES[b] for b in row[:ln])
            got.update(_windows(s, K))
        want = Counter()
        for s in seqs:
            want.update(_windows(s, K))
        assert got == want

    def test_short_reads_single_row(self):
        codes = np.asarray([0, 1, 2], np.uint8)
        offs = np.asarray([0, 3], np.int64)
        rows, lens = split_long_reads(codes, offs, width=16, k=K)
        assert rows.shape == (1, 16) and lens.tolist() == [3]

    def test_width_too_small_raises(self):
        with pytest.raises(ValueError):
            split_long_reads(np.zeros(4, np.uint8), np.asarray([0, 4]), 4, K)


class TestSingleProcessDriver:
    def test_matches_host_oracle(self, tmp_path):
        import jax

        from kmer_tpu.parallel.mesh import make_mesh

        rng = np.random.default_rng(1)
        seqs = _rand_seqs(300, rng)
        fa = tmp_path / "reads.fasta"
        _write_fasta(fa, seqs)
        mesh = make_mesh((8, 1), jax.devices()[:8])
        local, overflow = run_distcount(
            str(fa), K, batch=64, width=128, acc_capacity=2048, mesh=mesh,
        )
        assert overflow == 0
        want = Counter()
        for s in seqs:
            want.update(_windows(s, K))
        assert local.to_dict() == dict(want)

    def test_checkpoint_resume(self, tmp_path):
        import jax

        from kmer_tpu.parallel.mesh import make_mesh

        rng = np.random.default_rng(2)
        # lengths < width so each read is exactly one row: the head-file
        # checkpoint then corresponds to a clean batch prefix of the
        # full file (split pieces would break that correspondence)
        seqs = _rand_seqs(200, rng, lo=6, hi=100)
        fa = tmp_path / "reads.fasta"
        _write_fasta(fa, seqs)
        mesh = make_mesh((8, 1), jax.devices()[:8])
        ck = str(tmp_path / "ck")

        # full run with checkpoints every batch
        full, _ = run_distcount(
            str(fa), K, batch=32, width=128, acc_capacity=2048, mesh=mesh,
            ckpt=str(tmp_path / "ck_full"), ckpt_every=1,
        )

        # simulate a crash: run with a wrapper that stops after 2 batches
        batches = list(file_batches_fixed(str(fa), "fasta", K, 32, 128))
        assert len(batches) >= 4

        # drive run_distcount but only feed the first 2 batches by
        # truncating the input file to those reads is fiddly; instead
        # checkpoint every batch and delete later state: run fully, then
        # rewind the checkpoint to batch 2 and resume — resume must skip
        # exactly the first 2 batches and reproduce the full table.
        run_distcount(
            str(fa), K, batch=32, width=128, acc_capacity=2048, mesh=mesh,
            ckpt=ck, ckpt_every=1,
        )
        # rebuild a batch-2 checkpoint: re-run feeding only 2 batches via
        # a truncated fasta (first 64 reads — batches are file-ordered)
        fa2 = tmp_path / "head.fasta"
        _write_fasta(fa2, seqs[:64])
        ck2 = str(tmp_path / "ck2")
        run_distcount(
            str(fa2), K, batch=32, width=128, acc_capacity=2048, mesh=mesh,
            ckpt=ck2, ckpt_every=1,
        )
        # resume from the head checkpoint over the full file
        resumed, overflow = run_distcount(
            str(fa), K, batch=32, width=128, acc_capacity=2048, mesh=mesh,
            ckpt=ck2, ckpt_every=4,
        )
        assert overflow == 0
        assert resumed.to_dict() == full.to_dict()

    def test_mesh_mismatch_rejected(self, tmp_path):
        import jax

        from kmer_tpu.parallel.mesh import make_mesh

        rng = np.random.default_rng(3)
        seqs = _rand_seqs(80, rng)
        fa = tmp_path / "r.fasta"
        _write_fasta(fa, seqs)
        ck = str(tmp_path / "ck")
        mesh8 = make_mesh((8, 1), jax.devices()[:8])
        run_distcount(str(fa), K, batch=32, width=128, mesh=mesh8,
                      acc_capacity=2048, ckpt=ck, ckpt_every=1)
        mesh4 = make_mesh((4, 1), jax.devices()[:4])
        with pytest.raises(ValueError, match="mesh"):
            run_distcount(str(fa), K, batch=32, width=128, mesh=mesh4,
                          acc_capacity=2048, ckpt=ck, ckpt_every=1)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TestTwoProcessIntegration:
    def test_two_ranks_match_single_process(self, tmp_path):
        """Two real CLI processes + localhost coordinator == one process
        over the concatenated input (BASELINE configs[3] N>=2 hosts)."""
        rng = np.random.default_rng(4)
        shard0 = _rand_seqs(150, rng)
        shard1 = _rand_seqs(150, rng)
        _write_fasta(tmp_path / "s0.fasta", shard0)
        _write_fasta(tmp_path / "s1.fasta", shard1)
        port = _free_port()

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        procs = []
        for pid in (0, 1):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kmer_tpu", "distcount",
                 "--input", str(tmp_path / f"s{pid}.fasta"),
                 "-k", str(K), "--batch", "64", "--width", "128",
                 "--acc-capacity", "4096",
                 "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", "2", "--process-id", str(pid),
                 "--out", str(tmp_path / "result")],
                cwd="/root/repo", env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=420)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
        assert {o["rank"] for o in outs} == {0, 1}
        assert all(o["overflow"] == 0 for o in outs)

        merged = merge_rank_files([
            str(tmp_path / "result.rank0.npz"),
            str(tmp_path / "result.rank1.npz"),
        ])
        want = Counter()
        for s in shard0 + shard1:
            want.update(_windows(s, K))
        assert merged.to_dict() == dict(want)


class TestRankDesyncRecovery:
    """r4 advisor (medium): async per-rank checkpoint writes can persist
    different batches_done when a kill lands mid-write; resume must
    either rewind the ahead rank to its .prev generation or fail
    UNIFORMLY — never desynchronize the collective program."""

    def _launch(self, tmp_path, pid, port, ck):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        return subprocess.Popen(
            [sys.executable, "-m", "kmer_tpu", "distcount",
             "--input", str(tmp_path / f"s{pid}.fasta"),
             "-k", str(K), "--batch", "32", "--width", "128",
             "--acc-capacity", "4096", "--ckpt-every", "1",
             "--ckpt", ck,
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--out", str(tmp_path / "result")],
            cwd="/root/repo", env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )

    def _run_pair(self, tmp_path, ck):
        port = _free_port()
        procs = [self._launch(tmp_path, pid, port, ck) for pid in (0, 1)]
        results = []
        for p in procs:
            out, err = p.communicate(timeout=420)
            results.append((p.returncode, out, err))
        return results

    def test_desync_rewinds_via_prev_generation(self, tmp_path):
        import shutil

        rng = np.random.default_rng(21)
        shard0, shard1 = _rand_seqs(128, rng), _rand_seqs(128, rng)
        _write_fasta(tmp_path / "s0.fasta", shard0)
        _write_fasta(tmp_path / "s1.fasta", shard1)
        ck = str(tmp_path / "ck")

        res = self._run_pair(tmp_path, ck)
        assert all(r[0] == 0 for r in res), res
        want = merge_rank_files([
            str(tmp_path / "result.rank0.npz"),
            str(tmp_path / "result.rank1.npz"),
        ]).to_dict()

        # simulate a kill inside rank0's final write window: its main
        # checkpoint is one generation behind rank1's
        assert os.path.exists(ck + ".rank0.npz.prev")
        shutil.copyfile(ck + ".rank0.npz.prev", ck + ".rank0.npz")

        res = self._run_pair(tmp_path, ck)
        assert all(r[0] == 0 for r in res), res
        merged = merge_rank_files([
            str(tmp_path / "result.rank0.npz"),
            str(tmp_path / "result.rank1.npz"),
        ]).to_dict()
        assert merged == want  # rank1 rewound to .prev; result exact

    def test_desync_without_prev_fails_uniformly(self, tmp_path):
        import shutil

        rng = np.random.default_rng(22)
        shard0, shard1 = _rand_seqs(128, rng), _rand_seqs(128, rng)
        _write_fasta(tmp_path / "s0.fasta", shard0)
        _write_fasta(tmp_path / "s1.fasta", shard1)
        ck = str(tmp_path / "ck")
        res = self._run_pair(tmp_path, ck)
        assert all(r[0] == 0 for r in res), res

        shutil.copyfile(ck + ".rank0.npz.prev", ck + ".rank0.npz")
        os.remove(ck + ".rank0.npz.prev")  # rank0 behind, rank1 has no
        os.remove(ck + ".rank1.npz.prev")  # matching generation to rewind
        res = self._run_pair(tmp_path, ck)
        # BOTH ranks must exit nonzero with the desync error (a
        # unilateral raise would leave the other hung in the collective)
        assert all(r[0] != 0 for r in res), res
        assert any("disagree" in r[1] + r[2] for r in res), res


class TestDriverSpill:
    """spill_dir removes the accumulator-overflow failure mode: live
    slots flush to sorted runs and the final table is their exact
    K-way merge (per-rank; shard hash ranges are disjoint)."""

    K8 = 8  # 4^8 key space: per-shard totals far exceed tiny capacities
            # while one batch's new keys still fit (spill handles growth
            # ACROSS batches; a single batch beyond cap is a hard error)

    def _oracle(self, seqs):
        want = Counter()
        for s in seqs:
            want.update(_windows(s, self.K8))
        return dict(want)

    def test_spill_exceeds_capacity_exact(self, tmp_path):
        import jax

        from kmer_tpu.parallel.mesh import make_mesh

        rng = np.random.default_rng(7)
        # enough distinct 5-mers to overflow tiny shard accumulators
        seqs = _rand_seqs(400, rng, lo=40, hi=200)
        fa = tmp_path / "reads.fasta"
        _write_fasta(fa, seqs)
        mesh = make_mesh((8, 1), jax.devices()[:8])
        local, overflow = run_distcount(
            str(fa), self.K8, batch=8, width=256, acc_capacity=512,
            mesh=mesh, ckpt=str(tmp_path / "ck"), ckpt_every=1,
            spill_dir=str(tmp_path / "runs"), spill_threshold=0.4,
        )
        assert overflow == 0
        import os

        assert any(f.startswith("run_") for f in os.listdir(tmp_path / "runs"))
        assert local.to_dict() == self._oracle(seqs)

    def test_spill_resume_carries_runs(self, tmp_path):
        """A resume mid-stream after spills must restore the run list
        from checkpoint metadata and still merge exactly."""
        import jax

        from kmer_tpu.parallel.mesh import make_mesh

        rng = np.random.default_rng(8)
        seqs = _rand_seqs(192, rng, lo=40, hi=150)
        fa = tmp_path / "reads.fasta"
        _write_fasta(fa, seqs)
        mesh = make_mesh((8, 1), jax.devices()[:8])

        # straight run (own ckpt stream)
        straight, ovf = run_distcount(
            str(fa), self.K8, batch=8, width=256, acc_capacity=512,
            mesh=mesh, ckpt=str(tmp_path / "cks"), ckpt_every=1,
            spill_dir=str(tmp_path / "runs_s"), spill_threshold=0.4,
        )
        assert ovf == 0

        # partial run over the head of the file, then resume over the
        # full file from its checkpoint (batches are file-ordered)
        head = tmp_path / "head.fasta"
        _write_fasta(head, seqs[:96])
        run_distcount(
            str(head), self.K8, batch=8, width=256, acc_capacity=512,
            mesh=mesh, ckpt=str(tmp_path / "ckr"), ckpt_every=1,
            spill_dir=str(tmp_path / "runs_r"), spill_threshold=0.4,
        )
        resumed, ovf2 = run_distcount(
            str(fa), self.K8, batch=8, width=256, acc_capacity=512,
            mesh=mesh, ckpt=str(tmp_path / "ckr"), ckpt_every=1,
            spill_dir=str(tmp_path / "runs_r"), spill_threshold=0.4,
        )
        assert ovf2 == 0
        assert resumed.to_dict() == straight.to_dict() == self._oracle(seqs)

    def test_two_ranks_spill_collective(self, tmp_path):
        """Multi-process spill: the trigger is the replicated global
        n_unique, so both ranks reset on the same batch; per-rank runs
        merge exactly and the union matches the oracle."""
        rng = np.random.default_rng(11)
        shard0 = _rand_seqs(100, rng, lo=60, hi=140)
        shard1 = _rand_seqs(100, rng, lo=60, hi=140)
        _write_fasta(tmp_path / "s0.fasta", shard0)
        _write_fasta(tmp_path / "s1.fasta", shard1)
        port = _free_port()

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        procs = []
        for pid in (0, 1):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kmer_tpu", "distcount",
                 "--input", str(tmp_path / f"s{pid}.fasta"),
                 "-k", "8", "--batch", "2", "--width", "256",
                 "--acc-capacity", "768",
                 "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", "2", "--process-id", str(pid),
                 "--ckpt", str(tmp_path / "ck"), "--ckpt-every", "1",
                 "--spill-dir", str(tmp_path / f"runs{pid}"),
                 "--spill-threshold", "0.3",
                 "--out", str(tmp_path / "result")],
                cwd="/root/repo", env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=420)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
        assert all(o["overflow"] == 0 for o in outs)
        # both ranks actually spilled (collective trigger fired)
        for pid in (0, 1):
            rdir = tmp_path / f"runs{pid}"
            assert rdir.exists() and any(
                f.startswith("run_") for f in os.listdir(rdir)
            ), pid

        merged = merge_rank_files([
            str(tmp_path / "result.rank0.npz"),
            str(tmp_path / "result.rank1.npz"),
        ])
        want = Counter()
        for s in shard0 + shard1:
            want.update(_windows(s, 8))
        assert merged.to_dict() == dict(want)
