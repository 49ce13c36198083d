"""Pod-scale sharded streaming counting (parallel/streaming.py) on the
virtual 8-device CPU mesh, vs a pure-host Counter oracle."""

from collections import Counter

import numpy as np
import pytest

from kmer_tpu.parallel.mesh import make_mesh
from kmer_tpu.parallel.streaming import (
    ResumableStream,
    batches_of,
    stream_sharded_count,
)

K = 5
BASES = "acgt"


def _host_oracle(all_codes, all_lengths, k):
    c = Counter()
    for row, ln in zip(all_codes, all_lengths):
        s = "".join(BASES[b] for b in row[:ln])
        for i in range(max(ln - k + 1, 0)):
            c[s[i : i + k]] += 1
    return dict(c)


def _make_batches(n_batches, b, l, seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n_batches * b, l), dtype=np.uint8)
    if ragged:
        lengths = rng.integers(K, l + 1, n_batches * b).astype(np.int32)
    else:
        lengths = np.full(n_batches * b, l, np.int32)
    return codes, lengths


class TestStreamShardedCount:
    def test_32_batches_match_oracle(self):
        mesh = make_mesh((8, 1))
        codes, lengths = _make_batches(32, 8, 24)
        acc, overflow = stream_sharded_count(
            batches_of(codes, lengths, 8), K, mesh, acc_capacity=512
        )
        assert overflow == 0
        assert acc.to_dict() == _host_oracle(codes, lengths, K)

    def test_seq_sharded_mesh(self):
        mesh = make_mesh((4, 2))
        codes, lengths = _make_batches(6, 4, 32, seed=1)
        acc, overflow = stream_sharded_count(
            batches_of(codes, lengths, 4), K, mesh, acc_capacity=512
        )
        assert overflow == 0
        assert acc.to_dict() == _host_oracle(codes, lengths, K)

    def test_resume_matches_full_run(self, tmp_path):
        mesh = make_mesh((8, 1))
        codes, lengths = _make_batches(12, 8, 20, seed=2)
        full, _ = stream_sharded_count(
            batches_of(codes, lengths, 8), K, mesh, acc_capacity=512
        )

        ck = str(tmp_path / "stream.npz")
        # first run: checkpoint after every 4 batches, stop after 8
        r1 = ResumableStream(ck)
        first8 = lambda: list(batches_of(codes, lengths, 8))[:8]  # noqa: E731
        stream_sharded_count(first8(), K, mesh, acc_capacity=512,
                             resumable=r1, ckpt_every=4)
        assert ResumableStream(ck).batches_done == 8
        # second run: resumes past the 8 done batches, finishes the rest
        r2 = ResumableStream(ck)
        acc, overflow = stream_sharded_count(
            batches_of(codes, lengths, 8), K, mesh, acc_capacity=512,
            resumable=r2, ckpt_every=4,
        )
        assert overflow == 0
        assert acc.to_dict() == full.to_dict()

    def test_resume_mesh_shape_mismatch_raises(self, tmp_path):
        mesh = make_mesh((8, 1))
        codes, lengths = _make_batches(4, 8, 20, seed=3)
        ck = str(tmp_path / "s.npz")
        stream_sharded_count(batches_of(codes, lengths, 8), K, mesh,
                             acc_capacity=256, resumable=ResumableStream(ck))
        with pytest.raises(ValueError, match="mesh"):
            stream_sharded_count(
                batches_of(codes, lengths, 8), K, make_mesh((4, 2)),
                acc_capacity=256, resumable=ResumableStream(ck),
            )

    def test_accumulator_overflow_flagged(self):
        mesh = make_mesh((8, 1))
        codes, lengths = _make_batches(8, 8, 24, seed=4)
        _, overflow = stream_sharded_count(
            batches_of(codes, lengths, 8), K, mesh, acc_capacity=8
        )
        assert overflow > 0  # way more than 64 distinct 5-mers

    def test_empty_stream_raises(self):
        with pytest.raises(ValueError, match="empty"):
            stream_sharded_count(iter(()), K, make_mesh((8, 1)))

    def test_ragged_tail_batch_padding(self):
        mesh = make_mesh((8, 1))
        codes, lengths = _make_batches(3, 8, 20, seed=5)
        codes, lengths = codes[:20], lengths[:20]  # 2.5 batches of 8
        acc, overflow = stream_sharded_count(
            batches_of(codes, lengths, 8), K, mesh, acc_capacity=512
        )
        assert overflow == 0
        assert acc.to_dict() == _host_oracle(codes, lengths, K)


class TestCheckpointFormat:
    def test_v2_stamp_and_validation(self, tmp_path):
        """ADVICE r3: compact snapshots stamp v2, and a version/layout
        mismatch fails loudly at load, not at device_put."""
        import json

        from kmer_tpu.ops.wide import WideCounts
        from kmer_tpu.parallel.streaming import load_wide, save_wide

        acc = WideCounts.empty(8)
        p = str(tmp_path / "acc.npz")
        save_wide(acc, p, {"mesh_shape": [1, 1]})
        with np.load(p, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            assert meta["version"] == 2
            assert "live_per_shard" in z.files
        back, _ = load_wide(p)
        assert int(back.n_unique) == 0

        # future-version file must be rejected
        from kmer_tpu.utils.checkpoint import atomic_savez

        bad = str(tmp_path / "future.npz")
        atomic_savez(bad, hi=np.zeros(1, np.uint32), meta=json.dumps({"version": 99}))
        with pytest.raises(ValueError, match="v99"):
            load_wide(bad)

        # a v2 stamp without the compact layout must be rejected
        lying = str(tmp_path / "lying.npz")
        atomic_savez(
            lying,
            hi=np.zeros(1, np.uint32), lo=np.zeros(1, np.uint32),
            length=np.zeros(1, np.int32),
            counts_hi=np.zeros(1, np.int32), counts_lo=np.zeros(1, np.uint32),
            n_unique=np.int64(0),
            meta=json.dumps({"version": 2}),
        )
        with pytest.raises(ValueError, match="live_per_shard"):
            load_wide(lying)


@pytest.mark.parametrize("outgrown", [False, True])
def test_snapshot_writer_outgrown_guess(tmp_path, outgrown, monkeypatch):
    """A checkpoint whose live count outgrew the slicing guess is still
    written exactly — from whole-lane transfers, with no device program
    dispatched from the writer thread."""
    from kmer_tpu.parallel import streaming as st

    mesh = make_mesh((8, 1))
    codes, lengths = _make_batches(4, 8, 24, seed=5)
    acc, overflow = stream_sharded_count(
        batches_of(codes, lengths, 8), K, mesh, acc_capacity=512)
    assert overflow == 0
    snapper = st._StreamSnapshotter(8, 512)
    snap = snapper.snapshot(acc)
    if outgrown:
        snap["guess"] = 1  # as if keys arrived after the guess was set
        monkeypatch.setattr(snapper, "_pack", None)  # must not be called
    path = str(tmp_path / "snap.npz")
    snapper.write(snap, path, {"mesh_shape": [8, 1]})
    got, _ = st.load_wide(path)
    assert got.to_dict() == _host_oracle(codes, lengths, K)
