"""Pod-scale streaming counting: many batches, sharded accumulator.

BASELINE configs[3] (100M reads, N>=2 hosts) is a *multi-batch* workload:
each step extracts+counts one read batch across the mesh, hash-partitions
the per-device tables with one all_to_all (dist._partition_merge_local),
and folds the result into a *sharded* 64-bit accumulator — each device
owns a disjoint hash range of the global table, so the per-step fold is
device-local (no gather, no growing replicated state).  Counts use the
two-lane wide representation (ops/wide.py), so totals past 2^31 stay
exact.  Progress checkpoints to npz and resumes batch-exactly.

The reference has no analogue (single-process Postgres; SURVEY.md §2.2);
the behavioral contract is only that the final table equals a host
GROUP BY over all batches (tests pin this against a Counter oracle).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ..ops.count import count_windows
from ..ops.wide import WideCounts, fold_windows_into_wide, merge_into_wide
from ..utils.logging import StatsCounters, get_logger
from .dist import _extract_with_halo, _partition_merge_local, _shard_map
from .mesh import AXIS_DATA, AXIS_SEQ

# v1: full-capacity arrays; v2: ragged live rows + live_per_shard.
# Writers stamp the version they emit; load_wide validates it against
# the layout it finds so an old reader fails loudly, not at device_put.
_CKPT_VERSION = 2


def make_sharded_stream_step(
    mesh, k: int, canonical: bool = False, acc_capacity: int = 1 << 16,
    slack: float = 2.0, packed_width: int | None = None,
):
    """Jitted accumulation step over a ("data", "seq") mesh.

    step(acc, overflow, codes [B, L], lengths [B]) -> (acc', overflow')
    where ``acc`` is a WideCounts whose arrays are sharded over both mesh
    axes (global capacity = n_devices * acc_capacity; each device owns
    the keys hashing to its index) and ``overflow`` is a replicated
    int32 running total of (a) all_to_all bucket-capacity clips and
    (b) per-device accumulator-capacity misses.  The result is exact
    iff the final overflow is 0.

    ``packed_width``: when set, batches arrive as the 2-bit packed wire
    format — [B, packed_width/16] uint32 words (0.25 B/base over the
    host link, 4x less than raw codes) — and unpack on device, fused
    into the extraction.  packed_width must be a multiple of 16*seq so
    the word axis shards cleanly.
    """
    dp, sp = mesh.devices.shape
    n_parts = dp * sp
    axes = (AXIS_DATA, AXIS_SEQ)
    if packed_width is not None and packed_width % (16 * sp):
        raise ValueError(
            f"packed_width {packed_width} must be a multiple of 16*seq "
            f"({16 * sp})")

    def local_step(acc: WideCounts, overflow, codes_l, lengths_l):
        if packed_width is not None:
            from ..native import device_unpack_rows

            codes_l = device_unpack_rows(codes_l, packed_width // sp)
            lengths_l = jnp.asarray(lengths_l).astype(jnp.int32)
        hi, lo, valid = _extract_with_halo(codes_l, lengths_l, k, sp, canonical)
        if n_parts == 1:
            # single device owns the whole hash range: no bucket-route
            # all_to_all needed, AND the per-batch count sort folds into
            # the merge sort — raw windows enter at unit weight
            # (ops/wide.fold_windows_into_wide), one sort instead of two
            acc2 = fold_windows_into_wide(acc, hi, lo, valid, k)
            ovf = jnp.zeros((), jnp.int32)
        else:
            table = count_windows(hi, lo, valid, k)
            n = table.hi.shape[0]
            cap = max(8, int(slack * n / n_parts + 1))
            shard_table, ovf = _partition_merge_local(table, n_parts, cap, axes)
            acc2 = merge_into_wide(acc, shard_table)
        local_miss = jnp.maximum(acc2.n_unique - acc_capacity, 0)
        g_unique = jax.lax.psum(acc2.n_unique, axes)
        acc2 = dataclasses.replace(acc2, n_unique=g_unique)
        overflow = overflow + ovf + jax.lax.psum(local_miss, axes)
        return acc2, overflow

    sharded_spec = P((AXIS_DATA, AXIS_SEQ))
    acc_specs = WideCounts(
        hi=sharded_spec, lo=sharded_spec, length=sharded_spec,
        counts_hi=sharded_spec, counts_lo=sharded_spec, n_unique=P(),
    )
    step = _shard_map(
        local_step,
        mesh,
        in_specs=(acc_specs, P(), P(AXIS_DATA, AXIS_SEQ), P(AXIS_DATA)),
        out_specs=(acc_specs, P()),
    )
    return jax.jit(step)


def empty_sharded_acc(mesh, acc_capacity: int = 1 << 16) -> WideCounts:
    """Sharded all-sentinel accumulator (n_devices * acc_capacity slots)."""
    n_parts = int(np.prod(mesh.devices.shape))
    host = WideCounts.empty(n_parts * acc_capacity)
    spec = P((AXIS_DATA, AXIS_SEQ))
    sh = NamedSharding(mesh, spec)
    return WideCounts(
        hi=jax.device_put(host.hi, sh),
        lo=jax.device_put(host.lo, sh),
        length=jax.device_put(host.length, sh),
        counts_hi=jax.device_put(host.counts_hi, sh),
        counts_lo=jax.device_put(host.counts_lo, sh),
        n_unique=jax.device_put(host.n_unique, NamedSharding(mesh, P())),
    )


class _StreamSnapshotter:
    """Checkpoint snapshots whose device work is dispatched from the
    MAIN loop thread.

    Two facts drive the design.  First, a background thread's
    eager device ops race with the main loop's dispatch and land behind
    the entire next checkpoint interval's steps — the thread then waits
    out ~16 steps before its transfer even starts.  Dispatching the
    live-slot slices on the main thread costs ~ms and orders them
    immediately after the step being snapshotted.  Second, the slice
    bound must be known WITHOUT a device sync (a sync would stall the
    main loop on the dispatch backlog), so the snapshotter slices to an
    adaptive guess grown from the previous checkpoint's observed live
    counts: live counts only grow, the guess is rounded up 25%, and if
    a burst of new keys ever exceeds it the writer thread slices each
    shard on its own device instead (never a program spanning devices).
    The first checkpoint pays one ~step-length sync to seed the guess.
    """

    def __init__(self, n_parts: int, shard_cap: int):
        self.n_parts = n_parts
        self.shard_cap = shard_cap
        self._guess: int | None = None
        # true per-checkpoint cost (transfer + host work + file write),
        # EXCLUDING the wait for the device to reach the snapshotted
        # step — that wait overlaps useful compute and must not inflate
        # the adaptive cadence's gap
        self.last_cost_s = 0.0
        # max per-shard live count observed by the last completed write —
        # the spill trigger reads this (no extra device sync needed)
        self.last_max_live = 0

    def _round_up(self, mx: int) -> int:
        return min(self.shard_cap, (mx + (mx >> 2) + 1024 + 1023) // 1024 * 1024)

    def snapshot(self, acc: WideCounts) -> dict:
        """Main-thread dispatch: returns device arrays, no host sync
        (except once, at the first checkpoint, to seed the bound)."""
        P, C = self.n_parts, self.shard_cap
        live2 = ((acc.counts_hi > 0) | (acc.counts_lo > 0)).reshape(P, C)
        lps_dev = jnp.sum(live2, axis=1, dtype=jnp.int32)
        if self._guess is None:
            lps = np.asarray(jax.device_get(lps_dev), np.int64)
            self._guess = self._round_up(int(lps.max()) if lps.size else 0)
        g = self._guess
        return {"lps_dev": lps_dev, "packed": self._pack(acc, g),
                "guess": g, "n_unique": acc.n_unique, "acc": acc}

    def _pack(self, acc: WideCounts, g: int):
        """All five lanes as ONE [P, 5, g] uint32 device array: a single
        device-to-host transfer instead of five."""
        P, C = self.n_parts, self.shard_cap
        u32 = jnp.uint32

        def lane(x):
            x = jnp.reshape(x, (P, C))[:, :g]
            return jax.lax.bitcast_convert_type(x, u32)

        return jnp.stack(
            [lane(acc.hi), lane(acc.lo), lane(acc.length),
             lane(acc.counts_hi), lane(acc.counts_lo)], axis=1
        )

    def _shard_prefix(self, x, mx: int) -> np.ndarray:
        """[P, mx]: the first mx slots of each of the P shards of lane x,
        sliced per device (whole-lane transfer if x is not P shards).
        The device slice is rounded up to a power of two, so each device
        compiles one slice program per size class, not one per mx."""
        P, C = self.n_parts, self.shard_cap
        by_start = {}
        for s in x.addressable_shards:
            by_start.setdefault(s.index[0].start or 0, s.data)
        if len(by_start) != P or any(d.shape[0] != C
                                     for d in by_start.values()):
            return np.asarray(jax.device_get(x)).reshape(P, C)[:, :mx]
        m = min(C, 1 << max(mx - 1, 0).bit_length())
        return np.stack([np.asarray(jax.device_get(by_start[k][:m]))[:mx]
                         for k in sorted(by_start)])

    def write(self, snap: dict, path: str, meta: dict | None = None) -> None:
        """Writer-thread side: transfer the pre-dispatched slices and
        write a v2 npz (uncompressed: zlib costs more time per
        checkpoint than the bytes it saves)."""
        import time as _time

        from ..utils.checkpoint import atomic_savez
        from ..utils.logging import get_logger

        t0 = _time.perf_counter()
        C = self.shard_cap
        lps = np.asarray(jax.device_get(snap["lps_dev"]), np.int64)
        t1 = _time.perf_counter()
        mx = int(lps.max()) if lps.size else 0
        self.last_max_live = mx
        if mx > snap["guess"]:
            # the guess was outgrown mid-interval: slice each shard on
            # its own device.  No program spanning devices may start
            # from this thread — it can reach the devices in another
            # order than the main loop's collective steps and deadlock.
            acc = snap["acc"]
            host = np.stack([
                self._shard_prefix(x, mx).view(np.uint32)
                for x in (acc.hi, acc.lo, acc.length, acc.counts_hi,
                          acc.counts_lo)
            ], axis=1)
        else:
            host = np.asarray(jax.device_get(snap["packed"]),
                              np.uint32)[:, :, :mx]
        self._guess = self._round_up(mx)
        t2 = _time.perf_counter()
        keep = np.arange(mx, dtype=np.int64)[None, :] < lps[:, None]

        def lane(i, dt):
            return np.ascontiguousarray(host[:, i, :]).view(dt)[keep]

        atomic_savez(
            path,
            hi=lane(0, np.uint32),
            lo=lane(1, np.uint32),
            length=lane(2, np.int32),
            counts_hi=lane(3, np.int32),
            counts_lo=lane(4, np.uint32),
            live_per_shard=lps,
            shard_cap=np.int64(C),
            n_unique=np.int64(snap["n_unique"]),
            meta=json.dumps({"version": _CKPT_VERSION, **(meta or {})}),
            compress=False,
        )
        t3 = _time.perf_counter()
        self.last_cost_s = t3 - t1
        get_logger().info(
            "ckpt write: lps_wait %.2fs, transfer %.2fs (%.1f MB), "
            "write %.2fs",
            t1 - t0, t2 - t1, host.nbytes / 1e6, t3 - t2,
        )


def save_wide(acc: WideCounts, path: str, meta: dict | None = None) -> None:
    """Snapshot a (possibly sharded) wide accumulator to npz (atomic).

    Only LIVE slots are stored (v2 format): each shard of a compacted
    accumulator keeps its live entries at the front, so the snapshot is
    per-shard ragged — concatenated live rows + per-shard live counts +
    the shard capacity.  Checkpoint bytes scale with distinct keys, not
    capacity (the sustained run's 84 MB full-capacity snapshots were
    ~70% sentinels and dominated step overhead once the fold got fast).
    Shard ownership (keys are hash-routed per device) survives because
    reconstruction pads each shard back to capacity in place.
    """
    from ..utils.checkpoint import atomic_savez

    m = dict(meta or {})
    n_parts = 1
    if "mesh_shape" in m and m["mesh_shape"]:
        n_parts = int(np.prod(m["mesh_shape"]))
    cap = int(acc.hi.shape[-1])
    shard_cap = cap // n_parts
    if isinstance(acc.hi, jax.Array) and not isinstance(acc.hi, np.ndarray):
        # Device-resident accumulator: compact ON DEVICE before the
        # transfer.  Each shard keeps its live slots at the front
        # (_compact_fit's invariant), so slicing every shard to the
        # maximum per-shard live count moves only ~live bytes instead of
        # the full capacity (a mostly-empty accumulator would otherwise
        # move several times its live bytes).
        live2 = ((acc.counts_hi > 0) | (acc.counts_lo > 0)).reshape(
            n_parts, shard_cap
        )
        lps_dev = jnp.sum(live2, axis=1, dtype=jnp.int32)
        # verify the front-compaction invariant ON DEVICE before slicing
        # (ADVICE r4): each shard's live mask must equal "first lps slots
        # live, rest dead" — an accumulator that violates it (e.g. one
        # assembled by an external caller) would otherwise be silently
        # truncated into a corrupt checkpoint
        front = (jnp.arange(shard_cap, dtype=jnp.int32)[None, :]
                 < lps_dev[:, None])
        ok_dev, lps_host = jax.device_get(
            (jnp.all(live2 == front), lps_dev))  # one transfer round-trip
        compact_ok = bool(ok_dev)
        lps = np.asarray(lps_host, np.int64)
        if compact_ok:
            mx = int(lps.max()) if lps.size else 0
            keep = np.arange(mx, dtype=np.int64)[None, :] < lps[:, None]

            def slab(x, dt):
                sl = jnp.reshape(x, (n_parts, shard_cap))[:, :mx]
                return np.asarray(jax.device_get(sl), dt)[keep]

            hi = slab(acc.hi, np.uint32)
            lo = slab(acc.lo, np.uint32)
            length = slab(acc.length, np.int32)
            ch = slab(acc.counts_hi, np.int32)
            cl = slab(acc.counts_lo, np.uint32)
            live_per_shard = lps
        else:
            # full-fidelity fallback: host-mask the whole capacity
            hi = np.asarray(jax.device_get(acc.hi), np.uint32)
            lo = np.asarray(jax.device_get(acc.lo), np.uint32)
            length = np.asarray(jax.device_get(acc.length), np.int32)
            ch = np.asarray(jax.device_get(acc.counts_hi), np.int32)
            cl = np.asarray(jax.device_get(acc.counts_lo), np.uint32)
            live = ((ch > 0) | (cl > 0)).reshape(n_parts, shard_cap)
            keep = live.reshape(-1)
            hi, lo, length, ch, cl = (
                hi[keep], lo[keep], length[keep], ch[keep], cl[keep]
            )
            live_per_shard = live.sum(axis=1).astype(np.int64)
    else:
        hi = np.asarray(acc.hi, np.uint32)
        lo = np.asarray(acc.lo, np.uint32)
        length = np.asarray(acc.length, np.int32)
        ch = np.asarray(acc.counts_hi, np.int32)
        cl = np.asarray(acc.counts_lo, np.uint32)
        live = ((ch > 0) | (cl > 0)).reshape(n_parts, shard_cap)
        keep = live.reshape(-1)
        hi, lo, length, ch, cl = (
            hi[keep], lo[keep], length[keep], ch[keep], cl[keep]
        )
        live_per_shard = live.sum(axis=1).astype(np.int64)
    atomic_savez(
        path,
        hi=hi, lo=lo, length=length,
        counts_hi=ch, counts_lo=cl,
        live_per_shard=live_per_shard,
        shard_cap=np.int64(shard_cap),
        n_unique=np.int64(acc.n_unique),
        meta=json.dumps({"version": _CKPT_VERSION, **m}),
    )


def load_wide(path: str) -> tuple[WideCounts, dict]:
    from ..ops.count import SENTINEL, SENTINEL_LEN

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        version = int(meta.get("version", 1))
        if version > _CKPT_VERSION:
            raise ValueError(
                f"checkpoint {path} is format v{version}; this build "
                f"reads up to v{_CKPT_VERSION}"
            )
        if version >= 2 and "live_per_shard" not in z.files:
            raise ValueError(
                f"checkpoint {path} stamps v{version} but lacks the "
                "compact live_per_shard layout that version requires"
            )
        # (v1 + live_per_shard is accepted: round-3 writers emitted the
        # compact layout before bumping the stamp; the feature probe
        # below reads those correctly)
        if "live_per_shard" in z.files:  # v2 compact format
            lps = np.asarray(z["live_per_shard"], np.int64)
            shard_cap = int(z["shard_cap"])
            n_parts = lps.shape[0]
            cap = n_parts * shard_cap

            def expand(src, fill, dtype):
                out = np.full((n_parts, shard_cap), fill, dtype)
                s = 0
                for p, n in enumerate(lps):
                    out[p, : int(n)] = src[s : s + int(n)]
                    s += int(n)
                return out.reshape(-1)

            acc = WideCounts(
                hi=expand(z["hi"], SENTINEL, np.uint32),
                lo=expand(z["lo"], SENTINEL, np.uint32),
                length=expand(z["length"], SENTINEL_LEN, np.int32),
                counts_hi=expand(z["counts_hi"], 0, np.int32),
                counts_lo=expand(z["counts_lo"], 0, np.uint32),
                n_unique=np.int64(z["n_unique"]),
            )
        else:  # v1: full-capacity arrays
            acc = WideCounts(
                hi=z["hi"], lo=z["lo"], length=z["length"],
                counts_hi=z["counts_hi"], counts_lo=z["counts_lo"],
                n_unique=np.int64(z["n_unique"]),
            )
    return acc, meta


class AsyncCheckpointer:
    """Overlapped checkpoint writes (VERDICT r3 weak #2).

    The r3 sustained run charged 23.6% of its wall to synchronous
    in-loop checkpoints: ``save_wide`` device_gets the accumulator and
    compresses an npz while the device idles.  JAX arrays are immutable
    and each step returns NEW accumulator arrays, so a consistent
    snapshot is just a *reference* to the step-N accumulator — no device
    copy needed.  ``submit`` hands that reference to a daemon thread
    which blocks on the transfer and write while the main loop keeps
    dispatching steps; one write is in flight at a time (a new submit
    joins the previous one, which has normally long finished), so
    checkpoint cadence stays deterministic and memory overhead is one
    extra accumulator's worth of HBM at most.

    Crash mid-write is safe: utils.checkpoint.atomic_savez only
    os.replace()s a fully-fsynced temp file, so resume always sees the
    last COMPLETED checkpoint.
    """

    def __init__(self, write_fn):
        import threading

        self._write_fn = write_fn
        self._threading = threading
        self._thread: object | None = None
        self._err: BaseException | None = None
        self.wait_s = 0.0  # total time the MAIN loop stalled on joins
        self.last_write_s = 0.0  # duration of the last completed write

    def _join(self) -> None:
        import time as _time

        if self._thread is not None:
            t0 = _time.perf_counter()
            self._thread.join()
            self.wait_s += _time.perf_counter() - t0
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, *args, **kwargs) -> None:
        self._join()

        def work():
            import time as _time

            t0 = _time.perf_counter()
            try:
                self._write_fn(*args, **kwargs)
                self.last_write_s = _time.perf_counter() - t0
            except BaseException as e:  # surfaced at the next join
                self._err = e

        self._thread = self._threading.Thread(target=work, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Join the in-flight write and re-raise any background error."""
        self._join()


class ResumableStream:
    """Checkpoint/resume state for stream_sharded_count.

    The snapshot stores the *global* accumulator arrays in mesh-sharded
    order plus the number of completed batches and the mesh shape; a
    resume requires the same mesh shape (keys are placed by
    hash % n_devices, so shards are only meaningful on an equal mesh).
    """

    def __init__(self, path: str):
        self.path = path
        self.acc: WideCounts | None = None
        self.batches_done = 0
        self.overflow = 0
        self.mesh_shape: tuple[int, int] | None = None
        self.n_checkpoints = 0  # written by this process
        self.ckpt_wait_s = 0.0  # main-loop stall on checkpoint joins
        if os.path.exists(path):
            self.acc, meta = load_wide(path)
            self.batches_done = int(meta.get("batches_done", 0))
            self.overflow = int(meta.get("overflow", 0))
            self.mesh_shape = tuple(meta.get("mesh_shape", ())) or None

    def checkpoint(self, acc: WideCounts, batches_done: int, overflow: int,
                   mesh_shape: tuple[int, int]) -> None:
        save_wide(acc, self.path, {
            "batches_done": batches_done,
            "overflow": overflow,
            "mesh_shape": list(mesh_shape),
        })
        self.batches_done = batches_done
        self.n_checkpoints += 1

    def checkpoint_snapshot(self, snapper: "_StreamSnapshotter", snap: dict,
                            batches_done: int, overflow: int,
                            mesh_shape: tuple[int, int]) -> None:
        """Write a main-thread-dispatched snapshot (writer-thread side)."""
        snapper.write(snap, self.path, {
            "batches_done": batches_done,
            "overflow": overflow,
            "mesh_shape": list(mesh_shape),
        })
        self.batches_done = batches_done
        self.n_checkpoints += 1


def stream_sharded_count(
    batches: Iterable[tuple[np.ndarray, np.ndarray]],
    k: int,
    mesh,
    canonical: bool = False,
    acc_capacity: int = 1 << 16,
    slack: float = 2.0,
    resumable: ResumableStream | None = None,
    ckpt_every: int = 16,
    stats: StatsCounters | None = None,
    warmup: tuple | None = None,
    ckpt_target_overhead: float | None = None,
) -> tuple[WideCounts, int]:
    """Stream (codes [B, L], lengths [B]) batches into a sharded count.

    Returns (sharded WideCounts accumulator, overflow).  overflow > 0
    means some key ranges were clipped (raise acc_capacity/slack and
    re-run); exactness contract mirrors dist.count_kmers_sharded.
    All batches must share one [B, L] shape (static compile).

    ``ckpt_target_overhead``: when set (e.g. 0.1), checkpoint cadence
    adapts to the measured write time — a checkpoint opportunity (every
    ``ckpt_every`` batches) is skipped while the time since the last
    checkpoint is under ``last_write_time * (1/target - 1)``, bounding
    checkpoint overhead near the target fraction regardless of how slow
    the snapshot channel is.  None (default) checkpoints on every
    opportunity (deterministic cadence for tests/short runs).
    """
    log = get_logger()
    mesh_shape = tuple(mesh.devices.shape)
    step = make_sharded_stream_step(mesh, k, canonical, acc_capacity, slack)
    snapper = _StreamSnapshotter(int(np.prod(mesh_shape)), acc_capacity)

    if warmup is not None:
        # one throwaway step on a scratch accumulator compiles the jit
        # (same instance, same shapes) OUTSIDE any caller timing — a
        # long stream's sustained rate shouldn't charge the one-time
        # compile to the loop
        wcodes, wlengths = warmup
        wacc = empty_sharded_acc(mesh, acc_capacity)
        wacc, wovf = step(wacc, jnp.zeros((), jnp.int32),
                          jnp.asarray(wcodes), jnp.asarray(wlengths))
        # second warmup step feeds the FIRST step's outputs back in:
        # their overflow scalar is now committed/replicated-sharded,
        # which is a different jit cache entry than the fresh uncommitted
        # zeros — without this, step 2 of every timed stream pays the
        # ~36s recompile in-loop (measured: every sustained run ran
        # exactly one compile-time slower than the probe loop)
        wacc, wovf = step(wacc, wovf, jnp.asarray(wcodes),
                          jnp.asarray(wlengths))
        jax.block_until_ready(wacc.counts_lo)
        if resumable is not None:
            # warm the snapshotter too: its eager pack/slice ops remote-
            # compile (~seconds each, once) and its first snapshot seeds
            # the live-bound guess with a device sync — all of which
            # belongs here, not inside the timed loop's first checkpoint
            import time as _t

            wpath = resumable.path + ".warmup"
            t0 = _t.perf_counter()
            try:
                snapper.write(snapper.snapshot(wacc), wpath, {})
            finally:
                if os.path.exists(wpath):
                    os.remove(wpath)
            warm_write_s = _t.perf_counter() - t0
        del wacc
        log.info("stream step warmed up")

    start = 0
    overflow = jnp.zeros((), jnp.int32)
    if resumable is not None and resumable.acc is not None:
        if resumable.mesh_shape != mesh_shape:
            raise ValueError(
                f"checkpoint mesh {resumable.mesh_shape} != current {mesh_shape}"
            )
        spec = P((AXIS_DATA, AXIS_SEQ))
        sh = NamedSharding(mesh, spec)
        r = resumable.acc
        acc = WideCounts(
            hi=jax.device_put(r.hi, sh), lo=jax.device_put(r.lo, sh),
            length=jax.device_put(r.length, sh),
            counts_hi=jax.device_put(r.counts_hi, sh),
            counts_lo=jax.device_put(r.counts_lo, sh),
            n_unique=jax.device_put(jnp.asarray(int(r.n_unique), jnp.int32),
                                    NamedSharding(mesh, P())),
        )
        start = resumable.batches_done
        overflow = overflow + resumable.overflow
    else:
        acc = empty_sharded_acc(mesh, acc_capacity)

    done = 0
    import time as _time_mod

    # -inf: the FIRST checkpoint opportunity always fires — early
    # durability must not depend on the adaptive gap (a run killed
    # before its first checkpoint restarts from zero)
    last_ckpt_t = float("-inf")

    def _write_ckpt(snap_, done_, ovf_, mesh_shape_):
        # int(ovf_) happens HERE, on the background thread: it is the
        # device sync that waits out the dispatch backlog, and moving it
        # off the main loop is most of the async win
        resumable.checkpoint_snapshot(snapper, snap_, done_, int(ovf_),
                                      mesh_shape_)

    ckpt = AsyncCheckpointer(_write_ckpt) if resumable is not None else None
    if ckpt is not None and warmup is not None:
        # seed the adaptive cadence with the warmup write's measured
        # duration — otherwise the first checkpoints fire back-to-back
        # (no write time known yet) and each join stalls the loop for a
        # full in-flight write
        ckpt.last_write_s = warm_write_s
    from collections import deque

    loop_t0 = _time_mod.perf_counter()
    inflight: deque = deque()  # (step, overflow scalar) dispatch window
    for i, (codes, lengths) in enumerate(batches):
        if i < start:
            continue
        acc, overflow = step(acc, overflow, jnp.asarray(codes),
                             jnp.asarray(lengths))
        done = i + 1
        inflight.append(overflow)
        # bound dispatch runahead to ~32 steps so the loop's wall clock
        # tracks device progress (keeps the adaptive checkpoint cadence
        # meaningful and the dispatch queue finite).  Pace with
        # non-blocking is_ready + short host sleeps, so the host keeps
        # feeding while the device works
        while len(inflight) > 32:
            if inflight[0].is_ready():
                inflight.popleft()
            else:
                _time_mod.sleep(0.05)
        if stats is not None:
            ls = np.asarray(lengths, np.int64)
            nb = int(ls.sum())
            # exact per-batch window count; padded zero-length reads
            # (batches_of tail) contribute no reads and no windows
            stats.record_batch(int((ls > 0).sum()), nb,
                               int(np.maximum(ls - (k - 1), 0).sum()), 0)
        if done % 16 == 0:
            log.debug("pace: %d steps dispatched, t+%.1fs",
                      done - start, _time_mod.perf_counter() - loop_t0)
        if ckpt is not None and done % ckpt_every == 0:
            if ckpt_target_overhead is not None:
                import time as _time

                cost = snapper.last_cost_s or ckpt.last_write_s
                gap = cost * (1.0 / ckpt_target_overhead - 1.0)
                if _time.perf_counter() - last_ckpt_t < gap:
                    continue
                last_ckpt_t = _time.perf_counter()
            # snapshot slices dispatch on THIS thread so they are ordered
            # directly after step `done`; the writer thread only moves
            # bytes (see _StreamSnapshotter)
            ckpt.submit(snapper.snapshot(acc), done, overflow, mesh_shape)
            log.info("checkpoint %d submitted", done)
    if done == 0 and start == 0:
        if ckpt is not None:
            ckpt.close()
        raise ValueError("empty batch stream")
    if ckpt is not None:
        t_close = _time_mod.perf_counter()
        ckpt.close()
        resumable.ckpt_wait_s += ckpt.wait_s
        t_final = _time_mod.perf_counter()
        if done > resumable.batches_done:
            # final checkpoint through the fast packed writer, not the
            # 5-transfer compressed save_wide path
            _write_ckpt(snapper.snapshot(acc), done, overflow, mesh_shape)
        log.info("tail: close %.1fs, final ckpt %.1fs",
                 t_final - t_close, _time_mod.perf_counter() - t_final)
    return acc, int(overflow)


def batches_of(codes: np.ndarray, lengths: np.ndarray, batch: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Slice one big [N, L] read array into fixed [batch, L] steps
    (tail padded with zero-length reads so every step has one shape)."""
    n = codes.shape[0]
    for s in range(0, n, batch):
        e = min(s + batch, n)
        if e - s == batch:
            yield codes[s:e], lengths[s:e]
        else:
            c = np.zeros((batch, codes.shape[1]), codes.dtype)
            l = np.zeros((batch,), np.int32)
            c[: e - s] = codes[s:e]
            l[: e - s] = lengths[s:e]
            yield c, l
