"""Sorted radix index — the engine's replacement for the SP-GiST trie.

The reference implements a byte-wise radix trie through five SP-GiST
callbacks driven per-tuple by the Postgres index AM
(/root/reference/kmer_spgist.c:102-566), supporting strategies
= (3), @> (7), <@ (8), ^@ (28) (kmer--1.0.0.sql:174-185).

A pointer-chasing trie is the wrong shape for a vector machine.  Because
our 2-bit code order equals lexicographic byte order and packed keys are
left-aligned with zero padding (codec.py), *every* trie query becomes a
contiguous range of a sorted key array:

* equality      -> binary-search the (key64, length) pair;
* ^@ prefix p   -> keys in [pack(p), pack(p) + 4^(32-|p|)), then filter
                   length >= |p| (short keys that are prefixes of p land
                   in the range but must not match — same rule as
                   kmer_leaf_consistent's prefix case, kmer_spgist.c:520-536);
* qkmer @>      -> prune to the range of the longest determinate leading
                   run (the analogue of inner_consistent's prefix pruning,
                   kmer_spgist.c:395-444), then a vectorized positionwise
                   IUPAC mask check over the candidate range.

Index build is a bulk sort (np.lexsort host-side; jax.lax.sort on device)
instead of per-tuple choose/picksplit inserts — rebuild-on-ingest
(SURVEY.md §3.4).

Parity contract: index search results equal scan results (kmer-tests.sql
TEST 14's seq-scan vs index-scan equivalence).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import codec
from .packed import PackedKmers
from .types import Kmer, Qkmer


@dataclasses.dataclass
class KmerIndex:
    """Host-built sorted index over a kmer column.

    sorted_keys:  [N] uint64 left-aligned packed keys, ascending
    sorted_lens:  [N] int32 lengths (secondary sort key)
    row_ids:      [N] int64 original row positions
    """

    sorted_keys: np.ndarray
    sorted_lens: np.ndarray
    row_ids: np.ndarray

    # --- build ---------------------------------------------------------------

    @classmethod
    def build(cls, column: PackedKmers) -> "KmerIndex":
        col = column.to_numpy()
        keys = codec.join_key64(col.hi, col.lo)
        lens = np.asarray(col.length, np.int32)
        order = np.lexsort((lens, keys))  # primary: keys, secondary: lens
        return cls(
            sorted_keys=keys[order],
            sorted_lens=lens[order],
            row_ids=order.astype(np.int64),
        )

    @classmethod
    def from_strings(cls, kmers) -> "KmerIndex":
        return cls.build(PackedKmers.from_strings(kmers))

    def __len__(self) -> int:
        return int(self.sorted_keys.size)

    # --- range helpers -------------------------------------------------------

    def _key_range(self, key: np.uint64, length: int) -> tuple[int, int]:
        """[l, r) of rows with exactly this (key, length)."""
        l = int(np.searchsorted(self.sorted_keys, key, side="left"))
        r = int(np.searchsorted(self.sorted_keys, key, side="right"))
        if l == r:
            return l, r
        lens = self.sorted_lens[l:r]
        l2 = l + int(np.searchsorted(lens, length, side="left"))
        r2 = l + int(np.searchsorted(lens, length, side="right"))
        return l2, r2

    def _prefix_range(self, codes: np.ndarray) -> tuple[int, int]:
        """[l, r) of rows whose key starts with the given code prefix.

        Computed in Python ints to dodge uint64 overflow when the prefix
        is all-t's (upper bound 2^64).
        """
        p = int(codes.size)
        if p == 0:
            return 0, len(self)
        base = int(codec.pack_key64(codes))
        span = 1 << (64 - 2 * p)
        l = int(np.searchsorted(self.sorted_keys, np.uint64(base), side="left"))
        upper = base + span
        if upper >= 1 << 64:
            r = len(self)
        else:
            r = int(np.searchsorted(self.sorted_keys, np.uint64(upper), side="left"))
        return l, r

    # --- queries (strategies 3, 28, 7/8) ------------------------------------

    def search_eq(self, kmer) -> np.ndarray:
        """Row ids where row = kmer (strategy 3, kmer_spgist.c:510-519)."""
        km = Kmer(kmer)
        l, r = self._key_range(km.key64, len(km))
        return np.sort(self.row_ids[l:r])

    def search_prefix(self, prefix) -> np.ndarray:
        """Row ids where row ^@ prefix (strategy 28, kmer_spgist.c:520-536)."""
        pf = Kmer(prefix)
        l, r = self._prefix_range(pf.codes)
        lens = self.sorted_lens[l:r]
        hit = lens >= len(pf)
        return np.sort(self.row_ids[l:r][hit])

    def search_pattern(self, qkmer) -> np.ndarray:
        """Row ids where qkmer @> row (strategies 7/8, kmer_spgist.c:537-556)."""
        qk = Qkmer(qkmer)
        qlen = len(qk)
        lead = qk.leading_exact_codes()
        l, r = self._prefix_range(lead)
        keys = self.sorted_keys[l:r]
        lens = self.sorted_lens[l:r]
        ok = lens == qlen
        for i in range(len(lead), qlen):
            shift = np.uint64(62 - 2 * i)
            code = ((keys >> shift) & np.uint64(3)).astype(np.uint8)
            ok = ok & (((qk.masks[i] >> code) & 1) != 0)
        return np.sort(self.row_ids[l:r][ok])


# --- device-side range lookup ------------------------------------------------
#
# Batched lexicographic binary search over device-resident sorted
# (hi, lo, length) arrays: 64 fori iterations of a tuple-compare, fully
# vectorized across a query batch — the device analogue of searchsorted
# for our 65-bit-wide composite keys (no uint64 lane needed).


def _lex_less(ahi, alo, aln, bhi, blo, bln, or_equal):
    lt = (ahi < bhi) | ((ahi == bhi) & ((alo < blo) | ((alo == blo) & (aln < bln))))
    if or_equal:
        eq = (ahi == bhi) & (alo == blo) & (aln == bln)
        return lt | eq
    return lt


@dataclasses.dataclass
class SearchFence:
    """Sampled top-level of the sorted column — the SP-GiST inner-node
    analogue.  fence[t] is the first row whose hi's top `bits` equal or
    exceed t, so a lookup jumps straight into a small bucket and the
    binary search needs only `steps` probes (a static bound derived from
    the largest bucket at build time) instead of log2(N)."""

    fence: jax.Array  # [2^bits + 1] int32
    bits: int
    steps: int

    @classmethod
    def build(cls, shi, bits: int = 18) -> "SearchFence":
        n = shi.shape[0]
        shift = jnp.uint32(32 - bits)
        probes = (jnp.arange(1 << bits, dtype=jnp.uint32) << shift).astype(jnp.uint32)
        pos = jnp.searchsorted(jnp.asarray(shi, jnp.uint32), probes, side="left")
        fence = jnp.concatenate(
            [pos.astype(jnp.int32), jnp.full((1,), n, jnp.int32)]
        )
        max_bucket = int(jnp.max(fence[1:] - fence[:-1])) if n else 1
        steps = max(1, int(np.ceil(np.log2(max(max_bucket, 2)))) + 1)
        return cls(fence=fence, bits=bits, steps=steps)


def searchsorted_packed(shi, slo, sln, qhi, qlo, qln, side: str = "left",
                        fence: SearchFence | None = None):
    """Insertion positions of queries (qhi,qlo,qln)[M] into the sorted
    (shi,slo,sln)[N] column; jit-compatible, vectorized over M.

    With a SearchFence, the search starts from the query's fence bucket
    (2 cheap gathers into a small array) and runs fence.steps probes
    instead of log2(N)."""
    n = shi.shape[0]
    qhi = jnp.asarray(qhi, jnp.uint32)
    qlo = jnp.asarray(qlo, jnp.uint32)
    qln = jnp.asarray(qln, jnp.int32)
    if fence is not None:
        t = (qhi >> jnp.uint32(32 - fence.bits)).astype(jnp.int32)
        lo_b = fence.fence[t]
        hi_b = fence.fence[t + 1]
        steps = fence.steps
    else:
        lo_b = jnp.zeros(qhi.shape, jnp.int32)
        hi_b = jnp.full(qhi.shape, n, jnp.int32)
        steps = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)

    def body(_, carry):
        lo_b, hi_b = carry
        active = lo_b < hi_b
        mid = (lo_b + hi_b) // 2
        safe = jnp.clip(mid, 0, n - 1)
        mhi = shi[safe]
        mlo = slo[safe]
        mln = sln[safe]
        if side == "left":
            go_right = _lex_less(mhi, mlo, mln, qhi, qlo, qln, or_equal=False)
        else:
            go_right = _lex_less(mhi, mlo, mln, qhi, qlo, qln, or_equal=True)
        lo_b = jnp.where(active & go_right, mid + 1, lo_b)
        hi_b = jnp.where(active & ~go_right, mid, hi_b)
        return lo_b, hi_b

    lo_b, hi_b = jax.lax.fori_loop(0, steps, body, (lo_b, hi_b))
    return lo_b


def prefix_upper_key(qhi, qlo, qln):
    """Exclusive upper-bound key of a packed prefix: pack(p) + 4^(32-|p|).

    Returns (uhi, ulo, wrapped); wrapped is true where the bound is 2^64
    (the all-t full-length prefix), meaning the range extends to the end.
    Carried across the two uint32 lanes — no uint64 lane needed.
    """
    qhi = jnp.asarray(qhi, jnp.uint32)
    qlo = jnp.asarray(qlo, jnp.uint32)
    qln = jnp.asarray(qln, jnp.int32)
    shift_hi = jnp.clip(32 - 2 * qln, 0, 31).astype(jnp.uint32)
    shift_lo = jnp.clip(64 - 2 * qln, 0, 31).astype(jnp.uint32)
    inc_hi = jnp.where(qln <= 16, jnp.uint32(1) << shift_hi, jnp.uint32(0))
    inc_lo = jnp.where(qln > 16, jnp.uint32(1) << shift_lo, jnp.uint32(0))
    ulo = qlo + inc_lo
    carry = (ulo < qlo).astype(jnp.uint32)
    uhi = qhi + inc_hi + carry
    wrapped = uhi < qhi
    return uhi, ulo, wrapped


def device_sort_column(col: PackedKmers) -> tuple[PackedKmers, jnp.ndarray]:
    """On-device index build: sort (hi, lo, length) + carry row ids."""
    n = col.hi.shape[0]
    rid = jnp.arange(n, dtype=jnp.int32)
    shi, slo, sln, srid = jax.lax.sort(
        (
            jnp.asarray(col.hi, jnp.uint32),
            jnp.asarray(col.lo, jnp.uint32),
            jnp.asarray(col.length, jnp.int32),
            rid,
        ),
        num_keys=3,
    )
    return PackedKmers(hi=shi, lo=slo, length=sln), srid


# --- device-resident serving -------------------------------------------------
#
# DeviceIndex keeps the sorted column + row ids in HBM and answers
# *batches* of queries per dispatch — the serving analogue of the
# reference's per-tuple SP-GiST walks (kmer_spgist.c:339-566), with one
# vectorized binary search replacing each trie descent.  All entry
# points are jit-compatible with static shapes: range queries return
# [M] (start, end) pairs; row-id materialization returns a fixed
# [M, cap] block plus a validity mask.


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    """Sorted (hi, lo, length) column + original row ids, device-resident."""

    hi: jax.Array
    lo: jax.Array
    length: jax.Array
    row_ids: jax.Array

    @classmethod
    def build(cls, column: PackedKmers) -> "DeviceIndex":
        sorted_col, rid = device_sort_column(column)
        return cls(
            hi=sorted_col.hi, lo=sorted_col.lo, length=sorted_col.length, row_ids=rid
        )

    def __len__(self) -> int:
        return int(self.hi.shape[0])

    # -- range queries (batched, jittable) ------------------------------------

    def eq_ranges(self, qhi, qlo, qln, fence: SearchFence | None = None):
        """[start, end) per query with exactly this (key, length) — strategy 3."""
        left = searchsorted_packed(
            self.hi, self.lo, self.length, qhi, qlo, qln, side="left", fence=fence
        )
        right = searchsorted_packed(
            self.hi, self.lo, self.length, qhi, qlo, qln, side="right", fence=fence
        )
        return left, right

    def build_fence(self, bits: int = 18) -> SearchFence:
        return SearchFence.build(self.hi, bits=bits)

    def prefix_ranges(self, qhi, qlo, qln, fence: SearchFence | None = None):
        """[start, end) per query of rows starting with the prefix — strategy 28.

        qhi/qlo: packed prefix (left-aligned, zero-padded); qln: prefix
        lengths (0 => empty prefix => every row, kmer.c:47-48).

        The length filter (len >= |p|, kmer_spgist.c:520-536) folds into
        the bounds: a key strictly inside (pack(p), pack(p)+4^(32-|p|))
        always has length >= |p| (its padding is zero), and the only
        shorter keys in range sit at key == pack(p) with length < |p| —
        excluded by using |p| as the length lane of the left probe.
        """
        n = self.hi.shape[0]
        qhi = jnp.asarray(qhi, jnp.uint32)
        qlo = jnp.asarray(qlo, jnp.uint32)
        qln = jnp.asarray(qln, jnp.int32)
        left = searchsorted_packed(
            self.hi, self.lo, self.length, qhi, qlo, qln, side="left", fence=fence
        )
        uhi, ulo, wrapped = prefix_upper_key(qhi, qlo, qln)
        right = searchsorted_packed(
            self.hi,
            self.lo,
            self.length,
            uhi,
            ulo,
            jnp.full(qln.shape, -1, jnp.int32),
            side="left",
            fence=fence,
        )
        right = jnp.where(wrapped, n, right)
        empty = qln == 0  # empty prefix matches every row
        return jnp.where(empty, 0, left), jnp.where(empty, n, right)

    # -- row-id materialization (fixed capacity) ------------------------------

    def gather_rows(self, left, right, cap: int):
        """Row ids for each [start, end) range, padded to a static cap.

        Returns (rows [M, cap] int32, valid [M, cap] bool).  Ranges wider
        than cap are truncated — callers size cap from count maxima
        (right - left) or re-query.
        """
        n = self.hi.shape[0]
        offs = jnp.arange(cap, dtype=jnp.int32)[None, :]
        pos = left[:, None] + offs
        valid = pos < right[:, None]
        rows = self.row_ids[jnp.clip(pos, 0, max(n - 1, 0))]
        return jnp.where(valid, rows, -1), valid

    def pattern_hits(self, masks, qlen: int, cap: int):
        """Batched qkmer containment (strategies 7/8, kmer_spgist.c:537-556).

        masks: [M, MAX_K] uint32 IUPAC 4-bit masks (qkmer_mask_vector
        rows); qlen: static pattern length shared by the batch; cap:
        static per-query candidate capacity.  Prunes each query to the
        range of its longest determinate leading run, gathers up to cap
        candidates, and checks positionwise masks vectorized.  Returns
        (rows [M, cap] int32 with -1 padding, hit [M, cap] bool,
        truncated [M] bool — true where candidates overflowed cap).
        """
        masks = jnp.asarray(masks, jnp.uint32)
        # leading determinate run per query: mask with exactly one bit set
        is_exact = jnp.isin(masks[:, :qlen], jnp.asarray([1, 2, 4, 8], jnp.uint32))
        lead_len = jnp.argmin(
            jnp.concatenate(
                [is_exact, jnp.zeros((masks.shape[0], 1), bool)], axis=1
            ).astype(jnp.int32),
            axis=1,
        ).astype(jnp.int32)
        # pack the determinate prefix: code = log2(mask) for one-hot masks
        m = masks[:, :qlen]
        codes = (
            (m >> jnp.uint32(1)) & jnp.uint32(1)
            | ((m >> jnp.uint32(2)) & jnp.uint32(1)) * jnp.uint32(2)
            | ((m >> jnp.uint32(3)) & jnp.uint32(1)) * jnp.uint32(3)
        )
        pos = jnp.arange(qlen, dtype=jnp.int32)[None, :]
        in_lead = pos < lead_len[:, None]
        c = jnp.where(in_lead, codes, 0)
        hi_sh = jnp.where(pos < 16, 30 - 2 * pos, 0).astype(jnp.uint32)
        lo_sh = jnp.where(pos >= 16, 62 - 2 * pos, 0).astype(jnp.uint32)
        qhi = jnp.sum(
            jnp.where(pos < 16, c << hi_sh, jnp.uint32(0)), axis=1, dtype=jnp.uint32
        )
        qlo = jnp.sum(
            jnp.where(pos >= 16, c << lo_sh, jnp.uint32(0)), axis=1, dtype=jnp.uint32
        )
        left, right = self.prefix_ranges(qhi, qlo, lead_len)
        truncated = (right - left) > cap

        n = self.hi.shape[0]
        offs = jnp.arange(cap, dtype=jnp.int32)[None, :]
        ppos = left[:, None] + offs
        in_range = ppos < right[:, None]
        safe = jnp.clip(ppos, 0, max(n - 1, 0))
        chi = self.hi[safe]
        clo = self.lo[safe]
        cln = self.length[safe]
        ok = in_range & (cln == qlen)
        for i in range(int(qlen)):
            lane = chi if i < 16 else clo
            shift = jnp.uint32(30 - 2 * (i % 16))
            code = (lane >> shift) & jnp.uint32(3)
            ok = ok & (((masks[:, i : i + 1] >> code) & jnp.uint32(1)) != 0)
        rows = jnp.where(ok, self.row_ids[safe], -1)
        return rows, ok, truncated

    def search_pattern_batch(self, qkmers, cap: int = 64) -> list[np.ndarray]:
        """Exact batched qkmer containment with automatic cap regrowth.

        Host-level recovery path for pattern_hits' fixed candidate cap
        (a fully-degenerate leading pattern makes the candidate range
        the whole table): a group that overflowed is re-issued with 4x
        the cap until nothing truncates — so the result is always
        exact.  Queries are grouped by pattern length (pattern_hits
        takes a static qlen).  Returns sorted row-id arrays per query.
        """

        def group_fn(qlen, masks, c):
            rows, ok, truncated = self.pattern_hits(
                jnp.asarray(masks), qlen=qlen, cap=c
            )
            rows, ok = np.asarray(rows), np.asarray(ok)
            return (
                [np.sort(rows[j][ok[j]]) for j in range(rows.shape[0])],
                bool(np.asarray(truncated).any()),
            )

        zero_rows = np.sort(
            np.asarray(self.row_ids)[np.asarray(self.length) == 0]
        )
        return pattern_search_grouped(
            qkmers, zero_rows, group_fn, cap, cap_limit=max(len(self), 1)
        )


_CAP_LADDER_BASE = 8


def ladder_cap(cap: int, limit: int) -> int:
    """Snap a requested candidate cap up to the fixed geometric ladder
    {8, 32, 128, 512, ...} clamped to ``limit``.

    Serving kernels are compiled per (op, qlen, cap); arbitrary
    user-supplied caps (and 4x regrowth from them) would mint a fresh
    kernel per distinct value.  With every entry point snapping to this
    ladder, the compiled set is small and enumerable: at most
    log4(limit) rungs plus the single whole-shard value (VERDICT r2
    weak #7)."""
    c = _CAP_LADDER_BASE
    while c < cap:
        c *= 4
    return min(c, limit) if limit else c


def pattern_search_grouped(qkmers, zero_len_rows, group_fn, cap: int,
                           cap_limit: int) -> list[np.ndarray]:
    """Shared exact-pattern-search driver (DeviceIndex + ShardedIndex).

    Groups patterns by length (the kernels take a static qlen), handles
    the zero-length special case (matches exactly the empty kmers,
    given as ``zero_len_rows``), and regrows the candidate cap 4x until
    ``group_fn(qlen, masks [M, MAX_K], cap) -> (rows_per_query,
    any_truncated)`` reports no truncation or cap reaches ``cap_limit``
    (a cap covering the whole table/shard, where truncation is
    impossible).
    """
    from .ops.predicates import qkmer_mask_vector

    qkmers = [Qkmer(q) for q in qkmers]
    out: list[np.ndarray | None] = [None] * len(qkmers)
    by_len: dict[int, list[int]] = {}
    for i, q in enumerate(qkmers):
        by_len.setdefault(len(q), []).append(i)
    for qlen, ids in by_len.items():
        if qlen == 0:
            for i in ids:
                out[i] = zero_len_rows
            continue
        masks = np.stack([qkmer_mask_vector(qkmers[i])[0] for i in ids])
        c = ladder_cap(cap, cap_limit)
        while True:
            rows, truncated = group_fn(qlen, masks, min(c, cap_limit))
            if not truncated or c >= cap_limit:
                assert not truncated  # cap_limit covers everything
                for j, i in enumerate(ids):
                    out[i] = rows[j]
                break
            c *= 4
    return out  # type: ignore[return-value]


# --- device hash index ---------------------------------------------------------
#
# The serving analogue of the reference's hash opclass (kmer_hash,
# kmer.c:353-365; kmer_hash_ops, kmer--1.0.0.sql:188-192), and the
# north-star "open-addressing table" shape: equality lookups probe a
# bucketized open-addressing table instead of binary-searching the
# sorted array.  A binary search costs ~log2(N) dependent HBM gathers
# per query; a bucket probe costs max_chain (typically 1-2) row gathers,
# because each bucket's 8 slots are one contiguous 160-byte row and all
# slot fields live in a single [nb, 8, 5] int32 array.


_BUCKET = 8


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclasses.dataclass
class DeviceHashIndex:
    """Bucketized open-addressing hash table over unique (key, length)s.

    table:    [nb, 8, 5] int32 device array — per slot
              (hi, lo, length, group_start, group_count); length == -1
              marks an empty slot.  Groups point into row_ids.
    row_ids:  [N] int32 original row positions, grouped by key
              (ascending key order).
    max_chain: static bucket-probe bound measured at build time.
    """

    table: jax.Array
    row_ids: jax.Array
    max_chain: int
    n_unique: int

    @classmethod
    def build(cls, column: PackedKmers, load: float = 0.25) -> "DeviceHashIndex":
        """Host-side vectorized build (numpy), device-resident result."""
        from .ops.predicates import _hash_finalize_np

        col = column.to_numpy()
        n = len(col)
        keys = codec.join_key64(col.hi, col.lo)
        lens = np.asarray(col.length, np.int32)
        order = np.lexsort((lens, keys))
        skeys, slens = keys[order], lens[order]
        new = np.ones(n, bool)
        new[1:] = (skeys[1:] != skeys[:-1]) | (slens[1:] != slens[:-1])
        gstart = np.flatnonzero(new).astype(np.int32)
        u = gstart.size
        gcount = np.diff(np.append(gstart, n)).astype(np.int32)
        ghi = (skeys[gstart] >> np.uint64(32)).astype(np.uint32)
        glo = (skeys[gstart] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        gln = slens[gstart]

        # capacity must cover every unique key regardless of load factor
        nb = _next_pow2(
            max(1, int(np.ceil(u / (_BUCKET * load))), -(-int(u) // _BUCKET))
        )
        table = np.zeros((nb, _BUCKET, 5), np.int32)
        table[:, :, 2] = -1  # empty
        fill = np.zeros(nb, np.int32)

        home = (_hash_finalize_np(ghi, glo, gln) & np.uint32(nb - 1)).astype(np.int64)
        remaining = np.arange(u, dtype=np.int64)
        cur = home.copy()
        chain = 0
        while remaining.size:
            b = cur[remaining]
            # rank of each remaining group within its current bucket
            o = np.argsort(b, kind="stable")
            bs = b[o]
            run_start = np.ones(bs.size, bool)
            run_start[1:] = bs[1:] != bs[:-1]
            head = np.maximum.accumulate(np.where(run_start, np.arange(bs.size), 0))
            rank = np.arange(bs.size) - head
            slot = fill[bs] + rank
            win = slot < _BUCKET
            gidx = remaining[o]
            wg, wb, ws = gidx[win], bs[win], slot[win]
            table[wb, ws, 0] = ghi[wg].astype(np.int32)
            table[wb, ws, 1] = glo[wg].astype(np.int32)
            table[wb, ws, 2] = gln[wg]
            table[wb, ws, 3] = gstart[wg]
            table[wb, ws, 4] = gcount[wg]
            np.add.at(fill, wb, 1)  # one increment per winner; stays <= _BUCKET
            remaining = gidx[~win]
            if remaining.size:
                cur[remaining] = (cur[remaining] + 1) & (nb - 1)
                chain += 1
                if chain > nb:  # cannot happen: capacity >= u
                    raise RuntimeError("hash index build failed to place keys")

        return cls(
            table=jnp.asarray(table),
            row_ids=jnp.asarray(order.astype(np.int32)),
            max_chain=chain + 1,
            n_unique=int(u),
        )

    def __len__(self) -> int:
        return int(self.row_ids.shape[0])

    def lookup_eq(self, qhi, qlo, qln):
        """Batched equality lookup: (group_start, group_count, found) per query.

        Row ids for query i are row_ids[start_i : start_i + count_i]
        (materialize with gather_rows below).  jit-compatible.
        """
        return _hash_lookup(self.table, qhi, qlo, qln, self.max_chain)

    def gather_rows(self, start, count, cap: int):
        """Row ids per range, padded to static cap (like DeviceIndex)."""
        n = self.row_ids.shape[0]
        offs = jnp.arange(cap, dtype=jnp.int32)[None, :]
        pos = start[:, None] + offs
        valid = offs < count[:, None]
        rows = self.row_ids[jnp.clip(pos, 0, max(n - 1, 0))]
        return jnp.where(valid, rows, -1), valid


@functools.partial(jax.jit, static_argnames=("max_chain",))
def _hash_lookup(table, qhi, qlo, qln, max_chain: int):
    from .ops.predicates import _mix32

    nb = table.shape[0]
    qhi = jnp.asarray(qhi, jnp.uint32)
    qlo = jnp.asarray(qlo, jnp.uint32)
    qln = jnp.asarray(qln, jnp.int32)
    h = _mix32(qhi ^ jnp.uint32(0x9E3779B9))
    h = _mix32(h ^ qlo)
    h = _mix32(h ^ qln.astype(jnp.uint32))
    h = (h & jnp.uint32(nb - 1)).astype(jnp.int32)

    m = qhi.shape[0]
    start = jnp.zeros((m,), jnp.int32)
    count = jnp.zeros((m,), jnp.int32)
    found = jnp.zeros((m,), bool)
    for c in range(max_chain):  # static, small (typically 1-3)
        b = (h + c) & (nb - 1)
        bucket = table[b]  # [M, 8, 5] — ONE contiguous row gather
        mhit = (
            (bucket[:, :, 0].astype(jnp.uint32) == qhi[:, None])
            & (bucket[:, :, 1].astype(jnp.uint32) == qlo[:, None])
            & (bucket[:, :, 2] == qln[:, None])
        )
        any_hit = mhit.any(axis=1)
        sel = mhit.astype(jnp.int32)
        st = jnp.sum(bucket[:, :, 3] * sel, axis=1)  # at most one hit
        ct = jnp.sum(bucket[:, :, 4] * sel, axis=1)
        take = any_hit & ~found
        start = jnp.where(take, st, start)
        count = jnp.where(take, ct, count)
        found = found | any_hit
    return start, count, found
