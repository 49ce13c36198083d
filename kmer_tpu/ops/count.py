"""Exact k-mer counting — GROUP BY / COUNT / DISTINCT semantics on device.

The reference counts via Postgres HashAggregate (hash opclass,
kmer--1.0.0.sql:188-192; plan at kmer-tests.sql:1176-1214).  The engine
is *sort-based*: lexicographically sort the packed keys with XLA's sort
(a CUB radix sort on the GPU), find segment boundaries, and derive
per-segment counts positionally — scatter-free.

Table layout ("sorted-run" form): a CountTable's key arrays hold the
*sorted keys with duplicates in place*; ``counts`` holds each equal-key
segment's total weight in exactly one slot of that segment (unit-weight
counts use the head, weighted counts the tail) and 0 elsewhere.  Live groups
are therefore ``counts > 0``, in ascending key order.  Consumers must
not assume a positional relationship between a searchsorted hit and its
count slot.  No compaction runs until a caller trims the table.

Two paths:
* unit-weight (``count_windows``/``count_kmers``): fixed-k extraction
  counting; sorts 3 operands (hi, lo, validity-as-length) and derives
  counts from boundary positions alone.
* weighted (``count_packed``): general GROUP BY / table merge with int32
  weights; adds a weight cumsum.

All functions are jit-compatible with static shapes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..packed import PackedKmers
from .extract import canonicalize, extract_windows_batch

# Sentinel key for invalid/padding slots: sorts after every real key
# (real length <= 32 < SENTINEL_LEN, and boundaries include the length
# lane, so a real all-t 32-mer never merges with sentinels).
SENTINEL = np.uint32(0xFFFFFFFF)
SENTINEL_LEN = np.int32(0x7FFFFFFF)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CountTable:
    """Sorted-run (keys, counts) table; groups live where counts > 0."""

    hi: jax.Array
    lo: jax.Array
    length: jax.Array
    counts: jax.Array
    n_unique: jax.Array

    @property
    def capacity(self) -> int:
        return int(self.hi.shape[-1])

    def trim(self) -> "CountTable":
        """Compact to the live groups (ascending key order), host result.

        Device-resident tables compact ON DEVICE (a live-first sort) and
        transfer the live rows as ONE packed array: a single-shot count's
        table spans its full window-slot capacity, and np.asarray per
        lane would move every dead slot over the host link.  Each copy
        compacts on its own device, never in a program spanning devices:
        a replicated table compacts one copy; a sharded table (the
        partition merge) compacts each shard where it lives, and the
        shards' ascending runs merge on the host.
        """
        parts = _device_parts(self)
        if parts is not None:
            host = []
            for lanes in parts:
                packed, n = _live_first(*lanes)
                host.append(np.asarray(
                    jax.device_get(packed[:, :int(n)]), np.uint32))
            host = np.concatenate(host, axis=1)
            hi, lo = host[0], host[1]
            ln, cnt = host[2].view(np.int32), host[3].view(np.int32)
            if len(parts) > 1:
                order = _host_key_order(hi, lo, ln)
                hi, lo, ln, cnt = hi[order], lo[order], ln[order], cnt[order]
            return CountTable(hi=hi, lo=lo, length=ln, counts=cnt,
                              n_unique=np.int64(hi.size))
        counts = np.asarray(self.counts)
        live = counts > 0
        n = int(live.sum())
        return CountTable(
            hi=np.asarray(self.hi)[live],
            lo=np.asarray(self.lo)[live],
            length=np.asarray(self.length)[live],
            counts=counts[live],
            n_unique=np.int64(n),
        )

    def keys(self) -> PackedKmers:
        t = self.trim()
        return PackedKmers(hi=t.hi, lo=t.lo, length=t.length)

    def to_dict(self) -> dict[str, int]:
        """{kmer string: count} — the GROUP BY result as a host dict."""
        t = self.trim()
        strs = PackedKmers(hi=t.hi, lo=t.lo, length=t.length).to_strings()
        return {s: int(c) for s, c in zip(strs, np.asarray(t.counts))}

    def total(self) -> int:
        """COUNT(*) — total weight across groups."""
        t = self.trim()
        return int(np.asarray(t.counts, dtype=np.int64).sum())

    def distinct(self) -> int:
        """COUNT(DISTINCT kmer)."""
        return int(self.n_unique)


@jax.jit
def _live_first(hi, lo, length, counts):
    """([4, n] uint32 lanes hi, lo, length, count with the live rows
    first in ascending key order, live count) of one device's table."""
    cnt = jnp.asarray(counts, jnp.int32)
    live = cnt > 0
    tag = jnp.where(live, jnp.int32(0), jnp.int32(1))
    hi = jnp.where(live, jnp.asarray(hi, jnp.uint32), jnp.uint32(SENTINEL))
    lo = jnp.where(live, jnp.asarray(lo, jnp.uint32), jnp.uint32(SENTINEL))
    ln = jnp.where(live, jnp.asarray(length, jnp.int32), jnp.int32(SENTINEL_LEN))
    # 4 keys keep live rows in ascending key order (an unstable 1-key
    # tag sort would scramble them)
    _, shi, slo, sln, sc = jax.lax.sort(
        (tag, hi, lo, ln, cnt), num_keys=4, is_stable=False
    )
    packed = jnp.stack([
        shi, slo,
        jax.lax.bitcast_convert_type(sln, jnp.uint32),
        jax.lax.bitcast_convert_type(sc, jnp.uint32),
    ])
    return packed, jnp.sum(live.astype(jnp.int32))


def _device_parts(t: "CountTable"):
    """The table's lanes as per-device pieces, in shard order: one copy
    of a replicated table, every shard of a sharded one.  None for host
    tables and for lanes that are not 1-D or not laid out alike."""
    lanes = (t.hi, t.lo, t.length, t.counts)
    if not all(isinstance(x, jax.Array) and x.ndim == 1 for x in lanes):
        return None
    if not t.hi.is_fully_addressable:
        raise ValueError("trim needs every shard of the table in this process")
    by_lane = [{(s.index[0].start or 0, s.device): s.data
                for s in x.addressable_shards} for x in lanes]
    owner = {}  # piece start -> the device of its first copy
    for start, dev in by_lane[0]:
        owner.setdefault(start, dev)
    parts = []
    for start in sorted(owner):
        at = (start, owner[start])
        if not all(at in p and p[at].shape == by_lane[0][at].shape
                   for p in by_lane):
            return None
        parts.append([p[at] for p in by_lane])
    return parts


def _host_key_order(hi, lo, ln):
    """Ascending (hi, lo, length) order of host rows made of a few
    ascending runs (a stable sort merges the runs)."""
    if ln.size and np.all(ln == ln[0]):
        key = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        return np.argsort(key, kind="stable")
    return np.lexsort((ln, lo, hi))


def _segment_counts(new, weights=None, bounded=False):
    """Per-segment totals, positionally (scatter-free, gather-free).

    new: [n] bool, True at each segment head (new[0] must be True).
    weights: optional [n] int32, all >= 0; None means unit weights.
    Returns int32 [n]: each segment's total in exactly one of its slots
    (unit weights: the head; weighted: the TAIL), 0 elsewhere — both
    satisfy the CountTable sorted-run contract, which pins no slot.

    The weighted form is wrap-safe past 2^31 of *call-total* weight: the
    prefix sum runs in uint32 (per-segment differences stay exact mod
    2^32, so each segment total is exact whenever it fits the int32
    output — the CountTable contract; totals beyond that need ops/wide).
    "The prefix sum at the previous segment's tail" cannot ride a plain
    cummax once the cumsum may wrap (it is no longer monotone), and an
    explicit ``csum[prev_tail]`` lookup would be an arbitrary-index
    gather.  Instead the csum value is *carried through the cummax itself*: eight
    uint32 lanes each pack (tail position + 1) << 4 | one csum nibble,
    positions dominate the comparison, so every running max selects the
    latest preceding tail and its low bits deliver that tail's csum
    nibble — O(n) passes, no data-dependent indexing, any weight total.
    """
    n = new.shape[0]
    if weights is None:
        pos = jnp.arange(n, dtype=jnp.int32)
        # next segment head strictly after i (n if none)
        b = jnp.where(new, pos, n)
        sufmin = jax.lax.cummin(b, reverse=True)
        nxt = jnp.concatenate([sufmin[1:], jnp.full((1,), n, jnp.int32)])
        return jnp.where(new, nxt - pos, 0).astype(jnp.int32)
    if bounded:
        # caller guarantees the CALL-TOTAL weight fits int32 (e.g. unit/
        # validity weights with n < 2^31): the cumsum is then monotone,
        # so the previous tail's csum rides a plain cummax — no nibble
        # carry, no 2^28 row limit (a >=268M-row GROUP BY over a kmer
        # column is exactly this shape)
        csum = jnp.cumsum(weights.astype(jnp.int32))
        tail = jnp.concatenate([new[1:], jnp.ones((1,), bool)])
        key = jnp.where(tail, csum, 0)
        prev = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jax.lax.cummax(key)[:-1]]
        )
        return jnp.where(tail, csum - prev, 0).astype(jnp.int32)
    if n >= 1 << 28:
        # (pos+1) << 4 must fit uint32; no engine path builds a single
        # UNBOUNDED weighted GROUP BY this large (merges are 2*capacity
        # sized) — split the input and merge_tables the halves instead
        raise ValueError(
            f"weighted segment counts support < 2^28 rows, got {n}; "
            "split the input and merge the partial tables"
        )
    csum = jnp.cumsum(weights.astype(jnp.uint32))
    tail = jnp.concatenate([new[1:], jnp.ones((1,), bool)])
    pos1 = (jnp.arange(n, dtype=jnp.uint32) + jnp.uint32(1)) << jnp.uint32(4)
    prev = jnp.zeros((n,), jnp.uint32)
    for j in range(8):
        nib = (csum >> jnp.uint32(4 * j)) & jnp.uint32(0xF)
        key = jnp.where(tail, pos1 | nib, jnp.uint32(0))
        run = jnp.concatenate(
            [jnp.zeros((1,), jnp.uint32), jax.lax.cummax(key)[:-1]]
        )
        prev = prev | ((run & jnp.uint32(0xF)) << jnp.uint32(4 * j))
    # positions start at 1, so run == 0 in every lane iff no preceding
    # tail exists — prev's assembled nibbles are then 0, which is the
    # correct empty prefix; no extra mask needed
    return jnp.where(tail, csum - prev, jnp.uint32(0)).astype(jnp.int32)


def _boundaries(shi, slo, sln):
    first = jnp.ones((1,), bool)
    return jnp.concatenate(
        [
            first,
            (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1]) | (sln[1:] != sln[:-1]),
        ]
    )


def _use_group_sort() -> bool:
    """1-key sort + in-segment fixup vs plain 2-key sort (see group_sort_pairs).

    KMER_TPU_NO_GROUPSORT=1 forces the plain 2-key sort.
    """
    import os

    return not os.environ.get("KMER_TPU_NO_GROUPSORT")


_FIXUP_ITERS = 4  # fixed even+odd sweeps: sorts equal-hi runs up to 8 long
_GROUP_SORT_MIN_N = 1 << 20  # below this either sort is sub-ms: use 2-key
_SKEW_SAMPLE = 1 << 17  # hi-sample size for the skew probe


def group_sort_pairs(hi, lo):
    """Sort (hi, lo) pairs lexicographically — grouping engine of the counts.

    Strategy: lax.sort by hi alone (num_keys=1, lo rides as payload),
    then restore lo order *within equal-hi runs* with a fixed number of
    vectorized odd-even transposition sweeps.  Equal-hi runs are tiny
    for high-entropy keys (max multiplicity of ~2^27 draws from 2^32
    bins is ~8), so _FIXUP_ITERS even+odd sweeps sort every run.

    On the H100 the 1-key sort runs as a CUB radix sort of (uint32 key,
    uint16 payload) pairs; at 136.3M canonical k=21 windows the group
    sort took 13.8 ms against 90.6 ms for the plain 2-key sort
    (PERF.md, Findings).  Measurement trap: returning only a slice of
    one output lets XLA eliminate the other lane's movement AND the
    sweeps (making payloads look free — they are not); consume every
    output lane.  The sweep count must be static: a lax.while_loop with
    an any(swap) convergence reduction serializes the sweep loop.

    Two protections keep skewed data (real genomes: a 27x-coverage
    workload has ~27-long equal-hi runs everywhere) from paying the
    wasted 1-key sort before the fallback:

    * an in-graph **skew probe** — sort a contiguous 128k sample of hi
      (sub-ms) and count duplicate neighbors; more than sample/512
      duplicates routes the whole input straight to the 2-key sort via
      lax.cond (a coverage workload shows thousands of sample
      duplicates, a uniform one ~2);
    * a final sortedness check that falls back to the 2-key sort when
      some run still exceeds 2*_FIXUP_ITERS (adversarial data the
      sample missed) — exactness never depends on the distribution.

    Returns (shi, slo) ascending by (hi, lo); bit-identical to
    lax.sort((hi, lo), num_keys=2).
    """
    n = hi.shape[0]
    if not _use_group_sort() or n < _GROUP_SORT_MIN_N:
        # small inputs: either sort is sub-ms; skip the extra graph
        return jax.lax.sort((hi, lo), num_keys=2, is_stable=False)

    def sort2(h, l):
        return jax.lax.sort((h, l), num_keys=2, is_stable=False)

    def group(h, l):
        shi, slo = jax.lax.sort((h, l), num_keys=1, is_stable=False)
        eqv = shi[1:] == shi[:-1]  # hi fixed from here on
        par = jnp.arange(n - 1, dtype=jnp.int32) & 1
        eq0 = eqv & (par == 0)
        eq1 = eqv & (par == 1)

        def sweep(lo_c, eqp):
            do = eqp & (lo_c[:-1] > lo_c[1:])
            # element i swaps down if do[i], up if do[i-1]
            up = jnp.concatenate([jnp.zeros((1,), bool), do])
            down = jnp.concatenate([do, jnp.zeros((1,), bool)])
            nxt = jnp.concatenate([lo_c[1:], lo_c[-1:]])
            prv = jnp.concatenate([lo_c[:1], lo_c[:-1]])
            return jnp.where(down, nxt, jnp.where(up, prv, lo_c))

        slo = jax.lax.fori_loop(
            0, _FIXUP_ITERS, lambda _, l_: sweep(sweep(l_, eq0), eq1), slo
        )
        unsorted = jnp.any(eqv & (slo[:-1] > slo[1:]))
        return jax.lax.cond(
            unsorted, sort2, lambda h_, l_: (h_, l_), shi, slo
        )

    # strided sample so the probe sees the whole input's duplication
    # profile (a contiguous prefix misses files whose early windows are
    # high-entropy but whose bulk is skewed); stride is static at trace
    # time, and reading the array once costs <1ms of HBM bandwidth
    sample = hi[:: max(1, n // _SKEW_SAMPLE)][:_SKEW_SAMPLE]
    ssorted = jax.lax.sort((sample,), num_keys=1, is_stable=False)[0]
    dups = jnp.sum((ssorted[1:] == ssorted[:-1]).astype(jnp.int32))
    skewed = dups > (sample.shape[0] >> 9)
    return jax.lax.cond(skewed, sort2, group, hi, lo)


def count_windows(hi, lo, valid, k: int) -> CountTable:
    """Unit-weight fixed-k counting (the extraction hot path).

    Counts derived from positions only (scatter-free), and the sort
    payload is narrowed to the bits k actually uses:

    * k <= 16 (no mask) / k <= 15 (masked): the lo lane is identically
      zero (left-aligned keys) — 1-operand sort;
    * k <= 24 (no mask) / k <= 23 (masked): lo uses only its top 16 bits
      — it sorts as a uint16 lane;
    * otherwise: two uint32 lanes; k == 32 with a mask adds a length
      lane, because an all-t 32-mer is bitwise equal to the sentinel.

    With a validity mask, invalid slots fold into all-ones sentinel keys,
    which real keys cannot equal in the cases above (their padding bits
    are zero).
    """
    hi = jnp.asarray(hi, jnp.uint32).ravel()
    lo = jnp.asarray(lo, jnp.uint32).ravel()
    masked = valid is not None
    if masked:
        valid = jnp.asarray(valid).ravel()
        hi = jnp.where(valid, hi, jnp.uint32(SENTINEL))
        lo = jnp.where(valid, lo, jnp.uint32(SENTINEL))

    # lanes: the sorted key lanes, compared to find segment boundaries
    if k <= (15 if masked else 16):
        with jax.named_scope("sort"):
            (shi,) = jax.lax.sort((hi,), num_keys=1, is_stable=False)
        slo = jnp.zeros_like(shi)
        # slo is identically 0 (incl. sentinel slots), so the unified
        # sentinel pair compares lo against 0
        sent = (int(SENTINEL), 0) if masked else None
        lanes = (shi,)
    elif k <= (23 if masked else 24):
        lo16 = (lo >> jnp.uint32(16)).astype(jnp.uint16)
        with jax.named_scope("sort"):
            shi, slo16 = group_sort_pairs(hi, lo16)
        slo = slo16.astype(jnp.uint32) << jnp.uint32(16)
        sent = (int(SENTINEL), 0xFFFF0000) if masked else None
        lanes = (shi, slo16)
    elif k < 32 or not masked:
        with jax.named_scope("sort"):
            shi, slo = group_sort_pairs(hi, lo)
        sent = (int(SENTINEL), int(SENTINEL)) if masked else None
        lanes = (shi, slo)
    else:
        kln = jnp.where(valid, jnp.int32(k), jnp.int32(SENTINEL_LEN))
        with jax.named_scope("sort"):
            shi, slo, sln = jax.lax.sort((hi, lo, kln), num_keys=3, is_stable=False)
        with jax.named_scope("segment_counts"):
            new = _boundaries(shi, slo, sln)
            counts = _segment_counts(new)
            counts = jnp.where(sln == jnp.int32(SENTINEL_LEN), 0, counts)
            n_unique = jnp.sum((counts > 0).astype(jnp.int32))
        return CountTable(hi=shi, lo=slo, length=sln, counts=counts, n_unique=n_unique)

    with jax.named_scope("segment_counts"):
        if masked:
            is_sent = (shi == jnp.uint32(sent[0])) & (slo == jnp.uint32(sent[1]))
            sln = jnp.where(is_sent, jnp.int32(SENTINEL_LEN), jnp.int32(k))
        else:
            sln = jnp.full(shi.shape, k, jnp.int32)
        neq = lanes[0][1:] != lanes[0][:-1]
        for lane in lanes[1:]:
            neq = neq | (lane[1:] != lane[:-1])
        new = jnp.concatenate([jnp.ones((1,), bool), neq])
        counts = _segment_counts(new)
        if masked:
            counts = jnp.where(is_sent, 0, counts)
            n_unique = jnp.sum((counts > 0).astype(jnp.int32))
        else:
            n_unique = jnp.sum(new.astype(jnp.int32))
    return CountTable(hi=shi, lo=slo, length=sln, counts=counts, n_unique=n_unique)


def count_packed(hi, lo, length, weights,
                 bounded_weights: bool = False) -> CountTable:
    """Weighted GROUP BY over (hi, lo, length) keys (general/merge path).

    Slots with weight 0 are treated as absent.  Jit-compatible; result
    capacity equals input size; groups ascend in key order.

    ``bounded_weights=True`` asserts the total weight of the call fits
    int32 (true for unit/validity weights over < 2^31 rows): the cheaper
    monotone-cummax segment totals apply and the 2^28-row wrap-safety
    limit does not (count_column over a >=268M-row column).
    """
    hi = jnp.asarray(hi, jnp.uint32).ravel()
    lo = jnp.asarray(lo, jnp.uint32).ravel()
    length = jnp.asarray(length, jnp.int32).ravel()
    weights = jnp.asarray(weights, jnp.int32).ravel()

    live = weights > 0
    hi = jnp.where(live, hi, jnp.uint32(SENTINEL))
    lo = jnp.where(live, lo, jnp.uint32(SENTINEL))
    length = jnp.where(live, length, jnp.int32(SENTINEL_LEN))

    shi, slo, sln, sw = jax.lax.sort(
        (hi, lo, length, weights), num_keys=3, is_stable=False
    )
    new = _boundaries(shi, slo, sln)
    counts = _segment_counts(new, sw, bounded=bounded_weights)
    counts = jnp.where(sln == jnp.int32(SENTINEL_LEN), 0, counts)
    n_unique = jnp.sum((counts > 0).astype(jnp.int32))
    return CountTable(hi=shi, lo=slo, length=sln, counts=counts, n_unique=n_unique)


def count_column(col: PackedKmers, valid=None) -> CountTable:
    """GROUP BY over a kmer column (mixed lengths OK) — TEST 13 semantics."""
    w = (
        jnp.ones(jnp.asarray(col.hi).shape, jnp.int32)
        if valid is None
        else jnp.asarray(valid, jnp.int32)
    )
    # unit/validity weights: total <= n < 2^31, so the bounded fast path
    # applies at any column size
    return count_packed(col.hi, col.lo, col.length, w, bounded_weights=True)


def merge_tables(a: CountTable, b: CountTable) -> CountTable:
    """Associative merge of two tables (counts add per key)."""
    hi = jnp.concatenate([a.hi, b.hi])
    lo = jnp.concatenate([a.lo, b.lo])
    ln = jnp.concatenate([a.length, b.length])
    w = jnp.concatenate([a.counts, b.counts])
    return count_packed(hi, lo, ln, w)


def count_kmers(reads_codes, lengths, k: int, canonical: bool = False) -> CountTable:
    """Extract all k-windows from padded reads and count them.

    reads_codes: [B, L] 2-bit codes; lengths: [B]; k static.
    canonical=True counts min(kmer, revcomp) — the north-star metric's
    mode; off for reference parity.
    """
    wins, valid = extract_windows_batch(reads_codes, lengths, k)
    hi, lo = wins.hi, wins.lo
    if canonical:
        hi, lo = canonicalize(hi, lo, k)
    return count_windows(hi, lo, valid, k)


count_kmers_jit = jax.jit(count_kmers, static_argnames=("k", "canonical"))


def count_dna(dna, k: int, canonical: bool = False) -> CountTable:
    """Single-sequence convenience: generate_kmers + GROUP BY in one shot."""
    from ..types import Dna

    d = Dna(dna)
    codes = jnp.asarray(d.codes)[None, :]
    lengths = jnp.asarray([len(d)], jnp.int32)
    return count_kmers_jit(codes, lengths, k, canonical)
