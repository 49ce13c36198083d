"""Pipelined disk-to-table counting — the single-device operational path.

A generic per-batch count + accumulator re-sort (``streaming.py``) is
bound by its host feed; this module overlaps every host stage with the
device:

* **Producer thread** parses, assembles, and 2-bit-packs fixed-shape
  read batches (native MT parsers; ctypes calls drop the GIL) while the
  main thread dispatches device steps — parse overlaps compute AND the
  one-time jit compile.
* **Packed wire**: batches upload as [B, W/16] uint32 words
  (0.25 B/base) and unpack on device, fused into the extraction.
* **One fused step** per batch: unpack → extract windows → canonicalize
  → `fold_windows_into_wide` (the blocked-compact fold) — in place of a
  per-batch count + full 3-key accumulator re-sort.
* **Revert-and-replay exactness**: the fold drops keys only when the
  merged distinct count exceeds capacity; the step detects that IN
  GRAPH and reverts to the pre-batch accumulator, flagging a carried
  failure counter.  The host samples that counter asynchronously (no
  per-step sync), retains the un-confirmed packed batches, and on a
  failure rolls back to the last confirmed accumulator snapshot (a free
  reference — JAX arrays are immutable), grows capacity (or spills),
  and replays.  Every batch is folded exactly once into the table that
  survives; no input distribution can silently lose counts.

The reference's analogue is COPY + HashAggregate as one integrated
path (kmer-tests.sql:1229-1233, :1205-1214); Postgres inherits spill
and WAL from its runtime (SURVEY §1 L0) — here spill runs and resumable
checkpoints play those roles.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from typing import Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from .ops.wide import WideCounts, merge_runs, pad_wide
from .utils.logging import StatsCounters, get_logger

# state vector lanes carried through every step (int32[3])
_S_FAIL = 0  # count of reverted (not-folded) batches since last reset
_S_NEED = 1  # max merged-distinct observed (sizes the growth target)
_S_NOW = 2  # accumulator n_unique after this step


import functools


@functools.lru_cache(maxsize=64)
def _make_fold_step(k: int, canonical: bool, width: int):
    """jit: (acc, state, words [B, W/16] u32, lengths [B]) -> (acc', state').

    Reverting on overflow keeps every not-folded batch replayable: the
    output accumulator either contains the batch exactly once or is the
    input accumulator unchanged, and state[_S_FAIL] says which.

    Cached by (k, canonical, width): a fresh ``jax.jit`` object per
    call would recompile the step graph on EVERY count_file run.
    """
    from .native import device_unpack_rows
    from .ops.extract import canonicalize as canon
    from .ops.extract import extract_windows_batch
    from .ops.wide import fold_windows_into_wide

    def step(acc: WideCounts, state, combo):
        words = combo[:, :-1]
        lengths = combo[:, -1].astype(jnp.int32)  # last wire column
        codes = device_unpack_rows(words, width)
        wins, valid = extract_windows_batch(codes, lengths, k)
        hi, lo = wins.hi, wins.lo
        if canonical:
            hi, lo = canon(hi, lo, k)
        merged = fold_windows_into_wide(acc, hi, lo, valid, k)
        cap = acc.hi.shape[-1]
        need = jnp.asarray(merged.n_unique, jnp.int32)
        ok = need <= cap
        out = jax.tree_util.tree_map(
            lambda m, a: jnp.where(ok, m, a), merged, acc
        )
        fail = state[_S_FAIL] + jnp.where(ok, jnp.int32(0), jnp.int32(1))
        need_max = jnp.maximum(state[_S_NEED], need)
        n_now = jnp.asarray(out.n_unique, jnp.int32)
        return out, jnp.stack([fail, need_max, n_now])

    return jax.jit(step)


def _combine(words: np.ndarray, lengths) -> np.ndarray:
    """One wire array per batch: [B, W/16 + 1] uint32 with the row
    lengths riding in the last column, so each batch is one upload."""
    b, nw = words.shape
    combo = np.empty((b, nw + 1), np.uint32)
    combo[:, :nw] = words
    combo[:, nw] = np.asarray(lengths).astype(np.uint32)
    return combo


class _Feeder(threading.Thread):
    """Producer: pulls (codes [B, W], lengths) host batches, packs them
    to the 2-bit wire format, and queues (idx, words, lengths).

    Runs the parse/assemble/pack pipeline concurrently with device
    dispatch — the native parsers and numpy packing release the GIL for
    their bulk work, and the main loop spends most of its time waiting
    on the device, so the two genuinely overlap."""

    def __init__(self, batches: Iterable, skip: int, depth: int,
                 combine: bool = True):
        super().__init__(daemon=True)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._batches = batches
        self._skip = skip
        self._combine = combine
        self._stop = threading.Event()

    def stop(self) -> None:
        """Abandon the feed (consumer switched strategy mid-stream)."""
        self._stop.set()
        try:  # unblock a producer stuck on a full queue
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def run(self):
        from .native import pack2bit_rows

        try:
            for i, (rows, lengths) in enumerate(self._batches):
                if self._stop.is_set():
                    return
                if i < self._skip:
                    continue
                rows = np.asarray(rows)
                if rows.dtype != np.uint32:  # raw codes: pack here
                    rows = pack2bit_rows(rows)
                if self._combine:
                    ok = self._put((i, _combine(rows, lengths)))
                else:  # sharded consumers upload words/lengths separately
                    ok = self._put((i, rows,
                                    np.asarray(lengths, np.uint16)))
                if not ok:
                    return
            self._put(None)
        except BaseException as e:  # surfaced in the consumer loop
            self._put(e)


class _SpillSet:
    """Spilled sorted runs (host arrays or npz files under a dir)."""

    def __init__(self, spill_dir: str | None):
        self.dir = spill_dir
        self.runs: list = []  # WideCounts (host) or str paths

    def spill(self, acc: WideCounts) -> None:
        t = acc.trim() if acc is not None else None
        if t is None or int(t.n_unique) == 0:
            return
        if self.dir is not None:
            from .utils.checkpoint import atomic_savez

            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, f"spill_{len(self.runs):05d}.npz")
            atomic_savez(
                path, compress=False,
                hi=np.asarray(t.hi, np.uint32),
                lo=np.asarray(t.lo, np.uint32),
                length=np.asarray(t.length, np.int32),
                counts_hi=np.asarray(t.counts_hi, np.int32),
                counts_lo=np.asarray(t.counts_lo, np.uint32),
            )
            self.runs.append(path)
        else:
            self.runs.append(t)

    def load(self) -> list[WideCounts]:
        out = []
        for r in self.runs:
            if isinstance(r, str):
                with np.load(r, allow_pickle=False) as z:
                    out.append(WideCounts(
                        hi=z["hi"], lo=z["lo"], length=z["length"],
                        counts_hi=z["counts_hi"], counts_lo=z["counts_lo"],
                        n_unique=np.int64(z["hi"].size),
                    ))
            else:
                out.append(r)
        return out


class PipelineCheckpoint:
    """Checkpoint/resume state for count_batches_pipelined.

    Snapshots are written ONLY at confirmed points (the carried failure
    counter was observed zero at that batch), so a resumed accumulator
    always contains every batch below ``batches_done`` exactly once.
    """

    def __init__(self, path: str):
        self.path = path
        self.acc: WideCounts | None = None
        self.batches_done = 0
        self.capacity = 0
        self.spill_runs: list[str] = []
        self.meta: dict = {}
        if os.path.exists(path):
            from .parallel.streaming import load_wide

            self.acc, meta = load_wide(path)
            self.meta = meta
            self.batches_done = int(meta.get("batches_done", 0))
            self.capacity = int(meta.get("capacity", self.acc.capacity))
            self.spill_runs = list(meta.get("spill_runs", []))


def save_pipeline_ckpt(acc: WideCounts, path: str, batches_done: int,
                       capacity: int, spill_runs: list[str],
                       k: int, canonical: bool,
                       batch: int | None = None,
                       width: int | None = None) -> None:
    """Confirmed-point checkpoint via the live-slot v2 writer.

    k/canonical/batch/width are recorded so a resume with different
    flags fails loudly instead of folding mismatched windows (or
    skipping the wrong number of reads) on top of the accumulator.
    """
    from .parallel.streaming import save_wide

    save_wide(acc, path, {
        "batches_done": batches_done,
        "capacity": capacity,
        "spill_runs": spill_runs,
        "k": k,
        "canonical": canonical,
        "batch": batch,
        "width": width,
    })


class _PipelineRun:
    """One pipelined counting run (state shared by the loop helpers)."""

    def __init__(self, k, canonical, cap, max_cap, spills, spill_threshold,
                 grow_threshold, sample_every, runahead, stats, ckpt,
                 ckpt_every_s, start):
        self.k = k
        self.canonical = canonical
        self.cap = cap
        self.max_cap = max_cap
        self.spills: _SpillSet = spills
        self.spill_threshold = spill_threshold
        self.grow_threshold = grow_threshold
        self.sample_every = sample_every
        self.runahead = runahead
        self.stats = stats
        self.ckpt: PipelineCheckpoint | None = ckpt
        self.ckpt_every_s = ckpt_every_s
        self.start = start
        self.log = get_logger()

        self.step = None  # jit, built once the batch width is known
        self.acc: WideCounts | None = None
        self.state = None
        self.last_idx = start - 1  # newest dispatched batch index
        # (idx, acc_ref): newest point where fail == 0 was OBSERVED;
        # the acc ref at that point is the rollback base / ckpt payload
        self.confirmed: tuple[int, WideCounts | None] = (start - 1, None)
        self.retained: deque = deque()  # (idx, words, lengths) unconfirmed
        self.inflight: deque = deque()  # state refs (pacing)
        self.samples: deque = deque()  # (idx, acc_ref, state_ref)
        self.writer = None
        self.last_ckpt_t = time.perf_counter()
        self.n_replays = 0

    # -- device helpers -------------------------------------------------

    def fresh_state(self):
        return jnp.zeros((3,), jnp.int32)

    def block_state(self):
        """Drain the device and return the authoritative host state."""
        jax.block_until_ready(self.acc.counts_lo)
        self.inflight.clear()
        self.samples.clear()
        return np.asarray(jax.device_get(self.state), np.int64)

    # -- recovery / growth / spill -------------------------------------

    def _at_max(self) -> bool:
        return self.max_cap is not None and self.cap >= self.max_cap

    def _confirm_all(self):
        """After a drained fail==0 observation: everything dispatched is
        folded — advance the confirmed point and release retention."""
        self.confirmed = (self.last_idx, self.acc)
        self.retained.clear()

    def _grow(self, need: int):
        new_cap = self.cap
        target = max(2 * self.cap, need + (need >> 2) + 1)
        while new_cap < target:
            new_cap *= 2
        if self.max_cap is not None:
            new_cap = min(new_cap, self.max_cap)
        if new_cap > self.cap:
            self.log.info("pipeline: growing %d -> %d slots",
                          self.cap, new_cap)
            self.cap = new_cap
        return new_cap

    def replay(self, need: int):
        """Rollback to the confirmed base, grow or spill, refold every
        retained batch.  Terminates: capacity only grows; at the budget
        it degrades to one-batch-at-a-time folding with spills between,
        and a batch that cannot fold even into an EMPTY max-capacity
        accumulator is a hard error (its own distinct keys exceed the
        device budget — shrink the batch)."""
        base_idx, base_acc = self.confirmed
        todo = sorted((t for t in self.retained if t[0] > base_idx),
                      key=lambda t: t[0])
        while not self._at_max():
            self.n_replays += 1
            self._grow(need)
            self.acc = (WideCounts.empty(self.cap) if base_acc is None
                        else pad_wide(_device_wide_like(base_acc), self.cap))
            self.state = self.fresh_state()
            for _, combo in todo:
                self.acc, self.state = self.step(
                    self.acc, self.state, jnp.asarray(combo))
            s = self.block_state()
            if s[_S_FAIL] == 0:
                self._confirm_all()
                self.state = self.fresh_state()
                return
            need = int(s[_S_NEED])
        # at the device budget: spill the base, then fold one batch at a
        # time (synchronously), spilling whenever a batch cannot merge
        self.n_replays += 1
        self.log.info(
            "pipeline: replaying %d batches at max capacity %d with "
            "spills", len(todo), self.cap)
        self.spills.spill(base_acc)
        self.acc = WideCounts.empty(self.cap)
        self.state = self.fresh_state()
        for i, combo in todo:
            for attempt in (0, 1):
                self.acc, self.state = self.step(
                    self.acc, self.state, jnp.asarray(combo))
                s = self.block_state()
                if s[_S_FAIL] == 0:
                    break
                if attempt == 1 or int(s[_S_NOW]) == 0:
                    raise ValueError(
                        f"batch {i} needs {int(s[_S_NEED])} distinct slots "
                        f"but max_capacity is {self.cap}; shrink the batch "
                        "or raise --max-slots")
                self.spills.spill(self.acc)
                self.acc = WideCounts.empty(self.cap)
                self.state = self.fresh_state()
        self._confirm_all()
        self.state = self.fresh_state()

    def drain_and_settle(self) -> None:
        """Drain; if any batch was reverted, replay until clean."""
        s = self.block_state()
        if s[_S_FAIL] > 0:
            self.log.info(
                "pipeline: %d batch(es) overflowed capacity %d (need %d) "
                "— rolling back and replaying",
                int(s[_S_FAIL]), self.cap, int(s[_S_NEED]))
            self.replay(int(s[_S_NEED]))
        else:
            self._confirm_all()
            self.state = self.fresh_state()

    # -- async sampling -------------------------------------------------

    def on_sample(self, idx: int, acc_ref: WideCounts, s_host) -> None:
        if s_host[_S_FAIL] > 0:
            self.drain_and_settle()
            return
        # confirmed good through idx
        self.confirmed = (idx, acc_ref)
        while self.retained and self.retained[0][0] <= idx:
            self.retained.popleft()
        n_now = int(s_host[_S_NOW])
        if self._at_max():
            if n_now > self.spill_threshold * self.cap:
                # proactive spill: settle, flush, continue empty (exact:
                # per-key totals add across runs)
                self.drain_and_settle()
                self.spills.spill(self.acc)
                self.acc = WideCounts.empty(self.cap)
                self.state = self.fresh_state()
                self.confirmed = (self.last_idx, self.acc)
        elif n_now > self.grow_threshold * self.cap:
            self.drain_and_settle()
            new_cap = self._grow(max(n_now + 1, int(self.cap / max(
                self.grow_threshold, 0.1)) + 1))
            self.acc = pad_wide(self.acc, new_cap)
            self.confirmed = (self.last_idx, self.acc)
        self.maybe_checkpoint()

    def maybe_checkpoint(self) -> None:
        if self.writer is None:
            return
        now = time.perf_counter()
        ci, ca = self.confirmed
        if (now - self.last_ckpt_t >= self.ckpt_every_s and ca is not None
                and ci + 1 > self.ckpt.batches_done):
            self.writer.submit(ca, ci + 1, self.cap,
                               list(self.spills.runs))
            self.last_ckpt_t = now

    # -- main dispatch --------------------------------------------------

    def dispatch(self, idx: int, combo) -> None:
        self.acc, self.state = self.step(
            self.acc, self.state, jnp.asarray(combo))
        self.last_idx = idx
        self.retained.append((idx, combo))
        self.inflight.append(self.state)
        if (idx - self.start) % self.sample_every == self.sample_every - 1:
            self.samples.append((idx, self.acc, self.state))
        if self.stats is not None:
            ls = combo[:, -1].astype(np.int64)
            self.stats.record_batch(
                int((ls > 0).sum()), int(ls.sum()),
                int(np.maximum(ls - (self.k - 1), 0).sum()), 0)
        # consume ready samples (non-blocking), then pace the runahead
        while self.samples and self.samples[0][2].is_ready():
            i, a, s = self.samples.popleft()
            self.on_sample(i, a, np.asarray(jax.device_get(s), np.int64))
        while len(self.inflight) > self.runahead:
            if self.inflight[0].is_ready():
                self.inflight.popleft()
            else:
                time.sleep(0.01)


def count_batches_pipelined(
    batches: Iterable[tuple[np.ndarray, np.ndarray]],
    k: int,
    canonical: bool = False,
    capacity: int = 1 << 24,
    max_capacity: int | None = None,
    spill_dir: str | None = None,
    spill_threshold: float = 0.85,
    stats: StatsCounters | None = None,
    ckpt: PipelineCheckpoint | None = None,
    ckpt_every_s: float = 60.0,
    sample_every: int = 4,
    runahead: int = 8,
    queue_depth: int = 3,
    grow_threshold: float = 0.7,
) -> WideCounts:
    """Exact 64-bit GROUP BY over fixed-shape (codes [B, W], lengths [B])
    batches, pipelined end to end.  All batches must share one shape
    (pad the tail; zero-length rows contribute nothing).

    Returns a WideCounts (device-resident when nothing spilled, host
    otherwise).  Capacity grows geometrically up to ``max_capacity``
    (rounded down to a power of two; None = unbounded); past it, live
    slots spill to host/``spill_dir`` sorted runs and the result is
    their exact K-way merge.  The result is exact on every input
    distribution — overflowing batches are reverted in-graph and
    replayed after growth/spill, never dropped.
    """
    cap = 1 << max(3, int(capacity - 1).bit_length())
    max_cap = None
    if max_capacity is not None and max_capacity:
        # budget rounds DOWN to a power of two (growth doubles from
        # pow2); the starting capacity then CLAMPS to it rather than
        # raising — capacity rounds UP, so e.g. --slots 3M --max-slots
        # 3M would otherwise be a contradiction of our own rounding
        max_cap = max(8, 1 << (int(max_capacity).bit_length() - 1))
        cap = min(cap, max_cap)
        if ckpt is not None and spill_dir is None:
            # RAM-resident spill runs cannot be persisted in checkpoint
            # metadata, so a resumed run would silently lose them
            raise ValueError(
                "a checkpointed count with a device budget needs "
                "spill_dir: in-RAM spill runs do not survive a restart")
    spills = _SpillSet(spill_dir)
    start = 0
    if ckpt is not None and ckpt.acc is not None:
        start = ckpt.batches_done
        spills.runs = list(ckpt.spill_runs)
        cap = max(cap, 1 << max(3, int(ckpt.capacity - 1).bit_length()))

    run = _PipelineRun(k, canonical, cap, max_cap, spills, spill_threshold,
                       grow_threshold, sample_every, runahead, stats, ckpt,
                       ckpt_every_s, start)

    feeder = _Feeder(batches, start, queue_depth)
    feeder.start()
    first = feeder.q.get()
    if isinstance(first, BaseException):
        raise first
    if first is None:
        if ckpt is not None and ckpt.acc is not None:
            run.acc = _device_wide_like(ckpt.acc)
            return _finish(run.acc, spills)
        raise ValueError("empty batch stream")

    _, c0 = first
    B, NWp1 = c0.shape
    width = (NWp1 - 1) * 16
    if ckpt is not None and ckpt.acc is not None:
        # a resume with different flags would fold mismatched windows
        # (or skip the wrong number of reads) on top of the accumulator
        for name, want in (("k", k), ("canonical", bool(canonical)),
                           ("batch", B), ("width", width)):
            have = ckpt.meta.get(name)
            if have is not None and have != want:
                raise ValueError(
                    f"checkpoint {ckpt.path} was written with "
                    f"{name}={have}; this resume uses {name}={want}")
    run.step = _make_fold_step(k, canonical, width)
    run.acc = WideCounts.empty(run.cap)
    if ckpt is not None and ckpt.acc is not None:
        run.acc = pad_wide(_device_wide_like(ckpt.acc), run.cap)
    run.state = run.fresh_state()
    run.confirmed = (start - 1, run.acc)

    item = first
    while item is not None:
        if isinstance(item, BaseException):
            raise item
        idx, combo = item
        if combo.shape != (B, NWp1):
            raise ValueError(
                f"batch {idx} shape {combo.shape} != first batch "
                f"{(B, NWp1)}; the pipelined path requires one fixed "
                "batch shape")
        if ckpt is not None and run.writer is None:
            from .parallel.streaming import AsyncCheckpointer

            def _write(acc_ref, done, cap_now, runs_now):
                save_pipeline_ckpt(acc_ref, ckpt.path, done, cap_now,
                                   runs_now, k, canonical,
                                   batch=B, width=width)
                ckpt.batches_done = done

            run.writer = AsyncCheckpointer(_write)
        run.dispatch(idx, combo)
        item = feeder.q.get()

    # final settle: every dispatched batch must be confirmed folded
    run.drain_and_settle()
    if run.writer is not None:
        run.writer.close()
        done = run.last_idx + 1
        if done > ckpt.batches_done or ckpt.acc is None:
            save_pipeline_ckpt(run.acc, ckpt.path, done, run.cap,
                               list(spills.runs), k, canonical,
                               batch=B, width=width)
            ckpt.batches_done = done
    return _finish(run.acc, spills)


def _finish(acc: WideCounts | None, spills: _SpillSet) -> WideCounts:
    if not spills.runs:
        if acc is None:
            raise ValueError("empty batch stream")
        return acc
    runs = spills.load()
    if acc is not None:
        runs.append(acc.trim())
    return merge_runs(runs)


def _device_wide_like(acc: WideCounts) -> WideCounts:
    if isinstance(acc.hi, jax.Array) and not isinstance(acc.hi, np.ndarray):
        return acc
    return WideCounts(
        hi=jnp.asarray(np.asarray(acc.hi), jnp.uint32),
        lo=jnp.asarray(np.asarray(acc.lo), jnp.uint32),
        length=jnp.asarray(np.asarray(acc.length), jnp.int32),
        counts_hi=jnp.asarray(np.asarray(acc.counts_hi), jnp.int32),
        counts_lo=jnp.asarray(np.asarray(acc.counts_lo), jnp.uint32),
        n_unique=jnp.asarray(int(acc.n_unique), jnp.int32),
    )


def auto_width(lengths: np.ndarray, cap: int = 1024) -> int:
    """Row width for a read-length sample: the max length rounded up to
    a 16-base word, capped (longer reads split exactly via
    split_long_reads — one chromosome must not widen every row)."""
    mx = int(lengths.max()) if lengths.size else 16
    return max(32, min(cap, -(-mx // 16) * 16))


def auto_batch(width: int, k: int, target_windows: int = 1 << 26) -> int:
    """Reads per step sized so a step carries ~64M window slots (512k
    reads x 150 bp): larger batches grow every step's sort, smaller ones
    pay fixed dispatch cost per step.  The streaming fold step at this
    size keeps its sort operands and accumulator well inside one card's
    memory; the value is not tuned for the H100 yet."""
    per = max(width - k + 1, 1)
    b = max(1, target_windows // per)
    return max(4096, min(1 << 20, 1 << int(b - 1).bit_length()))


def file_batch_feed(path: str, fmt: str, k: int, batch: int | None,
                    width: int | None, chunk_bytes: int | None = None,
                    width_multiple: int = 16,
                    target_windows: int = 1 << 26,
                    ) -> tuple[Iterator, int, int, int | None]:
    """Fixed-shape feed for a FASTA/FASTQ file with auto batch/width.

    Returns (batch iterator, batch, width, est_windows).  Width is
    sampled from the first ingest chunk when not given; reads longer
    than it split exactly (driver.split_long_reads), shorter ones pad.
    ``est_windows`` extrapolates the probe chunk's window count to the
    whole file (None when no probe ran) — the single-shot routing
    signal.
    """
    from .io.ingest import DEFAULT_CHUNK_BYTES, iter_encoded_chunks
    from .native import rows_packed

    cb = chunk_bytes or DEFAULT_CHUNK_BYTES
    est_windows = None
    probe_bytes = min(cb, 16 << 20)
    try:
        fsize = os.path.getsize(path)
    except OSError:
        fsize = None
    for codes, offs in iter_encoded_chunks(path, fmt, probe_bytes):
        lens = np.diff(offs)
        if not width:
            width = auto_width(lens)
        if fsize is not None:
            wins = int(np.maximum(lens - (k - 1), 0).sum())
            scale = max(fsize / min(probe_bytes, fsize), 1.0)
            est_windows = int(wins * scale)
        break
    width = width or 256
    width_multiple = max(16, width_multiple)
    # wire format packs 16 bases per word; sharded consumers need the
    # word axis to split cleanly (width_multiple = 16 * seq)
    width = -(-width // width_multiple) * width_multiple
    while width <= k - 1:
        width += width_multiple
    if width > 0xFFFF:
        raise ValueError(
            f"width {width} exceeds the uint16 row-length bound (65535); "
            "long reads split exactly, so smaller widths lose nothing")
    if not batch:
        batch = auto_batch(width, k, target_windows)
        if est_windows is not None:
            # small files must not pay a full-size batch of padding: a
            # 600-read file in one 512k-row batch would sort 71M mostly
            # -invalid window slots
            need_rows = est_windows // max(width - k + 1, 1) + 1
            batch = min(batch, max(4096, 1 << int(need_rows).bit_length()))

    def gen():
        buf_w: list[np.ndarray] = []
        buf_l: list[np.ndarray] = []
        pending = 0
        for codes, offs in iter_encoded_chunks(path, fmt, cb):
            words, lens = rows_packed(codes, offs, width, k)
            buf_w.append(words)
            buf_l.append(lens)
            pending += words.shape[0]
            if pending >= batch:
                allw = np.concatenate(buf_w)
                alll = np.concatenate(buf_l)
                n_full = (pending // batch) * batch
                for s in range(0, n_full, batch):
                    yield allw[s: s + batch], alll[s: s + batch]
                buf_w = [allw[n_full:]]
                buf_l = [alll[n_full:]]
                pending -= n_full
        if pending:  # zero-length-padded fixed-shape tail
            allw = np.concatenate(buf_w)
            alll = np.concatenate(buf_l)
            for s in range(0, allw.shape[0], batch):
                w = allw[s: s + batch]
                l = alll[s: s + batch]
                if w.shape[0] < batch:
                    pad = batch - w.shape[0]
                    w = np.concatenate(
                        [w, np.zeros((pad, w.shape[1]), np.uint32)])
                    l = np.concatenate([l, np.zeros(pad, l.dtype)])
                yield w, l

    return gen(), batch, width, est_windows


def initial_capacity(capacity: int, k: int, est_windows: int) -> int:
    """Clamp the starting accumulator capacity by what the workload can
    possibly need: distinct keys <= total windows and <= 4^k.  A 1000-row
    CSV must not pay a 16M-slot accumulator merge per batch; growth
    (with exact replay) covers underestimates."""
    upper = max(int(est_windows), 1)
    if k <= 26:
        upper = min(upper, 4 ** k)
    upper = max(1 << 12, 1 << int(upper - 1).bit_length())
    return min(1 << max(3, int(capacity - 1).bit_length()), upper)


def column_batch_feed(seqs, k: int, batch: int | None = None,
                      width: int | None = None,
                      width_cap: int = 1 << 14) -> tuple[Iterator, int, int]:
    """Fixed-shape packed feed over in-memory dna strings (the CSV
    dna-column path).  Long rows split exactly; short ones pad."""
    from .native import encode_dna_fast, rows_packed

    enc = [encode_dna_fast(s) for s in seqs]
    lens = np.asarray([e.size for e in enc], np.int64)
    if not width:
        width = auto_width(lens, cap=width_cap)
    width = -(-width // 16) * 16
    while width <= k - 1:
        width += 16
    if not batch:
        batch = auto_batch(width, k)
    offs = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    stream = np.concatenate(enc) if enc else np.zeros(0, np.uint8)
    words, plens = rows_packed(stream, offs, width, k)

    def gen():
        for s in range(0, max(words.shape[0], 0), batch):
            w = words[s: s + batch]
            l = plens[s: s + batch]
            if w.shape[0] < batch:
                pad = batch - w.shape[0]
                w = np.concatenate(
                    [w, np.zeros((pad, w.shape[1]), np.uint32)])
                l = np.concatenate([l, np.zeros(pad, l.dtype)])
            yield w, l

    return gen(), batch, width


# single-shot ceiling in window SLOTS.  It bounds the route to files whose
# every window fits one device buffer, and keeps total windows < 2^31 so
# int32 counts stay exact.  At 146.8M slots (configs[1]'s 2^20 reads x
# 150 bp) the compiled count step needs 1.32 GB of arguments, 2.35 GB of
# output and 1.20 GB of temporaries (memory_analysis on an H100 80GB
# HBM3, PERF.md) — far inside one card.
_SINGLE_SHOT_MAX = 150 * 1000 * 1000


@functools.lru_cache(maxsize=64)
def _make_place_step(k: int, canonical: bool, width: int):
    """jit: extract one packed batch's windows into flat buffers at a
    dynamic offset (the single-shot assembly step)."""
    from .native import device_unpack_rows
    from .ops.extract import canonicalize as canon
    from .ops.extract import extract_windows_batch

    def place(bh, bl, bv, combo, start):
        words = combo[:, :-1]
        lengths = combo[:, -1].astype(jnp.int32)
        codes = device_unpack_rows(words, width)
        wins, valid = extract_windows_batch(codes, lengths, k)
        hi, lo = wins.hi, wins.lo
        if canonical:
            hi, lo = canon(hi, lo, k)
        return (
            jax.lax.dynamic_update_slice(bh, hi.ravel(), (start,)),
            jax.lax.dynamic_update_slice(bl, lo.ravel(), (start,)),
            jax.lax.dynamic_update_slice(bv, valid.ravel(), (start,)),
        )

    return jax.jit(place)


_count_windows_jit = None


class _SingleShotOverflow(Exception):
    """The routing estimate undershot: the file's real window count
    exceeds the single-shot buffer ceiling — take the streaming fold."""


def _count_single_shot(feed, k: int, canonical: bool, batch: int,
                       width: int, stats: StatsCounters | None = None):
    """One-count route for files whose windows fit a single device
    buffer: upload packed batches as they arrive (overlapping the
    parse), extract+place each into flat window buffers, then run ONE
    count — the benchmark's fused shape, with none of the per-batch
    accumulator fold's merge sorts.  Returns a
    CountTable (int32 counts are exact: total windows < 2^31 here by
    construction)."""
    global _count_windows_jit
    from .ops.count import count_windows

    if _count_windows_jit is None:
        _count_windows_jit = jax.jit(count_windows,
                                     static_argnames=("k",))
    # producer-thread prefetch: without it the parse and the uploads
    # SERIALIZE (each batch parses, then transfers) — overlapping them
    # hides the smaller of the two entirely
    feeder = _Feeder(feed, 0, depth=3)
    feeder.start()
    spb = batch * (width - k + 1)
    ceiling = int(_SINGLE_SHOT_MAX * 1.3)  # routing estimate headroom
    dev = []
    while True:
        item = feeder.q.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        if (len(dev) + 1) * spb > ceiling:
            # the first-chunk extrapolation undershot (e.g. a sparse
            # file head): allocating past the ceiling risks device OOM and
            # the int32-exactness bound — reroute to the streaming fold
            feeder.stop()
            raise _SingleShotOverflow()
        _, combo = item
        dev.append(jax.device_put(combo))
        if stats is not None:
            ls = combo[:, -1].astype(np.int64)
            stats.record_batch(int((ls > 0).sum()), int(ls.sum()),
                               int(np.maximum(ls - (k - 1), 0).sum()), 0)
    if not dev:
        raise ValueError("empty batch stream")
    cap = len(dev) * spb
    place = _make_place_step(k, canonical, width)
    bh = jnp.zeros((cap,), jnp.uint32)
    bl = jnp.zeros((cap,), jnp.uint32)
    bv = jnp.zeros((cap,), bool)
    for i, combo in enumerate(dev):
        bh, bl, bv = place(bh, bl, bv, combo, jnp.int32(i * spb))
    return _count_windows_jit(bh, bl, bv, k)


def count_file(
    path: str,
    fmt: str,
    k: int,
    canonical: bool = False,
    batch: int | None = None,
    width: int | None = None,
    chunk_bytes: int | None = None,
    capacity: int = 1 << 24,
    max_capacity: int | None = None,
    spill_dir: str | None = None,
    stats: StatsCounters | None = None,
    ckpt_path: str | None = None,
    ckpt_every_s: float = 60.0,
    single_shot: bool | None = None,
):
    """Count a FASTA/FASTQ file end to end through the pipelined engine.

    The operational equivalent of the reference's COPY + GROUP BY as one
    integrated path (kmer-tests.sql:1229-1233, :1205-1214): bounded-RSS
    ingest windows, background parse/pack, packed uploads, and either

    * the **single-shot** route (small files: every window fits one
      device buffer) — one global count, returns a CountTable; or
    * the **streaming fold** route — fused per-batch folds into a
      64-bit accumulator with growth/spill/checkpoint, returns a
      WideCounts.

    ``single_shot=None`` routes automatically by an extrapolated window
    estimate; checkpointing or an explicit device budget always takes
    the streaming route.
    """
    feed, batch, width, est_windows = file_batch_feed(
        path, fmt, k, batch, width, chunk_bytes)
    if single_shot is None:
        single_shot = (
            est_windows is not None
            and est_windows * 1.1 <= _SINGLE_SHOT_MAX
            and batch * (width - k + 1) <= _SINGLE_SHOT_MAX
            and not ckpt_path and not spill_dir and not max_capacity
        )
    if single_shot:
        try:
            return _count_single_shot(feed, k, canonical, batch, width,
                                      stats)
        except _SingleShotOverflow:
            # note: stats batches recorded before the abort are counted
            # again by the streaming rerun (metrics only; counts exact)
            get_logger().info(
                "single-shot routing estimate undershot; falling back "
                "to the streaming fold")
            feed, batch, width, est_windows = file_batch_feed(
                path, fmt, k, batch, width, chunk_bytes)
    try:
        fsize = os.path.getsize(path)
        # bases <= file bytes (FASTA ~1x, FASTQ ~0.45x); windows <= bases
        est = fsize // (2 if fmt == "fastq" else 1)
        capacity = initial_capacity(capacity, k, est)
    except OSError:
        pass
    if max_capacity:
        capacity = min(capacity, max_capacity)
    ckpt = PipelineCheckpoint(ckpt_path) if ckpt_path else None
    return count_batches_pipelined(
        feed, k, canonical=canonical, capacity=capacity,
        max_capacity=max_capacity, spill_dir=spill_dir, stats=stats,
        ckpt=ckpt, ckpt_every_s=ckpt_every_s,
    )
