"""Checkpoint / resume for count tables and indexes.

The reference inherits persistence from Postgres heap/WAL storage
(SURVEY.md §5.4).  The engine serializes packed-key arrays, count
tables, and sorted indexes to npz snapshots so long multi-batch counts
and index builds are resumable: counting is associative/idempotent per
input shard, so a run restarts from the last merged snapshot and
replays only the remaining shards.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..index import KmerIndex
from ..ops.count import CountTable

_FORMAT_VERSION = 1


def atomic_savez(path: str, compress: bool = True, **arrays) -> None:
    """np.savez[_compressed] with crash-safe replace semantics.

    Writing directly over an existing checkpoint would destroy it if
    the process dies mid-write — the exact event checkpoints exist to
    survive.  Write to a temp file in the same directory, fsync the
    data AND the directory entry, then os.replace (atomic on POSIX).
    Without the fsyncs the rename can become durable before the data
    blocks, leaving a truncated file under the final name after power
    loss.

    ``compress=False`` skips zlib (about 1 s per 20 MB checkpoint for a
    2x size saving): in-loop checkpoints choose speed, final tables
    choose size.
    """
    d = os.path.dirname(os.path.abspath(path)) or "."
    import tempfile

    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            (np.savez_compressed if compress else np.savez)(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_table(table: CountTable, path: str, meta: dict | None = None) -> None:
    """Snapshot a (trimmed) count table + metadata to an .npz file."""
    t = table.trim() if not isinstance(table.hi, np.ndarray) else table
    atomic_savez(
        path,
        hi=np.asarray(t.hi, np.uint32),
        lo=np.asarray(t.lo, np.uint32),
        length=np.asarray(t.length, np.int32),
        counts=np.asarray(t.counts, np.int64),
        meta=json.dumps({"version": _FORMAT_VERSION, **(meta or {})}),
    )


def load_table(path: str) -> tuple[CountTable, dict]:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        counts = z["counts"].astype(np.int32)
        table = CountTable(
            hi=z["hi"],
            lo=z["lo"],
            length=z["length"],
            counts=counts,
            # derive from the data: an untrimmed (numpy) table saved by
            # save_table may contain dead slots, so hi.size would lie
            n_unique=np.int64((counts > 0).sum()),
        )
    return table, meta


def save_index(index: KmerIndex, path: str, meta: dict | None = None) -> None:
    atomic_savez(
        path,
        sorted_keys=index.sorted_keys,
        sorted_lens=index.sorted_lens,
        row_ids=index.row_ids,
        meta=json.dumps({"version": _FORMAT_VERSION, **(meta or {})}),
    )


def load_index(path: str) -> tuple[KmerIndex, dict]:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        idx = KmerIndex(
            sorted_keys=z["sorted_keys"],
            sorted_lens=z["sorted_lens"],
            row_ids=z["row_ids"],
        )
    return idx, meta


class ResumableCount:
    """Checkpointed streaming count over an ordered list of input shards.

    Progress = (shards_done, snapshot accumulator).  On restart,
    completed shards are skipped and counting resumes from the snapshot
    — exactness is preserved because merges are associative.  Counts
    accumulate through the 64-bit fixed-capacity WideAccumulator
    (ops/wide.py), so a resumed long count never overflows int32 and
    never hits the r2 growing-accumulator recompile pattern.
    """

    def __init__(self, ckpt_path: str, capacity: int = 1 << 16):
        from ..ops.wide import WideAccumulator

        self.ckpt_path = ckpt_path
        self._acc = WideAccumulator(capacity)
        self.shards_done = 0
        if os.path.exists(ckpt_path):
            from ..parallel.streaming import load_wide

            acc, meta = load_wide(ckpt_path)
            self._acc.seed(acc)
            self.shards_done = int(meta.get("shards_done", 0))

    @property
    def table(self):
        """The accumulated WideCounts so far (None before any update)."""
        return None if self._acc.empty else self._acc.result()

    def should_process(self, shard_idx: int) -> bool:
        return shard_idx >= self.shards_done

    def update(self, shard_idx: int, shard_table: CountTable) -> None:
        self._acc.add(shard_table)
        self.shards_done = shard_idx + 1

    def checkpoint(self) -> None:
        if not self._acc.empty:
            from ..parallel.streaming import save_wide

            save_wide(
                self._acc.result(),
                self.ckpt_path,
                {"shards_done": self.shards_done},
            )
