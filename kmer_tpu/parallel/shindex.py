"""Sharded index serving — the multi-device SP-GiST replacement.

The reference's SP-GiST trie serves one query at a time inside a single
Postgres backend (/root/reference/kmer_spgist.c:339-566).  The
single-device analogue is DeviceIndex (kmer_tpu/index.py); this module
scales it over a device mesh for BASELINE configs[4] (index build
across devices):

* **Build**: the column shards over the "data" axis and every device
  sorts its own shard locally (one lax.sort per device, no global
  merge).  Ranges are shard-relative, so no cross-device exchange is
  needed at build time at all.
* **Serve**: queries are replicated; every device answers each query
  with a local lexicographic binary search (the same
  ``searchsorted_packed`` as single-device serving) and materializes up
  to ``cap`` candidate rows; the per-shard (range, rows) results travel
  once via the all_gather implied by the replicated output
  spec.  A query's global answer is the union of its per-shard answers
  (global row ids are stored in the shard).

Padding rows (to even shard sizes) carry sentinel keys that sort last
within each shard, and every lookup clamps its range to the shard's
live-row count, so padding can never match — including the wrapped
all-t prefix range whose upper bound is 2^64.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..index import DeviceIndex, prefix_upper_key, searchsorted_packed
from ..ops.count import SENTINEL, SENTINEL_LEN
from ..packed import PackedKmers
from ..types import Kmer
from .dist import _shard_map
from .mesh import AXIS_DATA


@functools.lru_cache(maxsize=None)
def _make_build(mesh):
    """Jitted sharded build: each device sorts its local shard."""

    def local(hi_l, lo_l, ln_l, rid_l):
        shi, slo, sln, srid = jax.lax.sort(
            (hi_l, lo_l, ln_l, rid_l), num_keys=3
        )
        live = jnp.sum((sln != jnp.int32(SENTINEL_LEN)).astype(jnp.int32))
        return shi, slo, sln, srid, live[None]

    spec = P(AXIS_DATA)
    return jax.jit(
        _shard_map(
            local,
            mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=(spec, spec, spec, spec, spec),
        )
    )


@functools.lru_cache(maxsize=None)
def _make_pattern_lookup(mesh, qlen: int, cap: int):
    """Jitted sharded qkmer containment (strategies 7/8 at pod scale).

    Each shard prunes to its local range of the pattern's determinate
    leading run and mask-checks candidates — the same kernel as
    DeviceIndex.pattern_hits, run per shard on shard-local sorted data.
    Returns (rows [ndev, M, cap], hit [ndev, M, cap],
    truncated [M] — psum'd over shards).
    """

    def local(hi_l, lo_l, ln_l, rid_l, live_l, masks):
        # a shard-local DeviceIndex view over the live prefix: padding
        # rows sort last and pattern ranges are clamped by prefix_ranges
        # only via key order, so reuse pattern_hits with the sentinel
        # rows included — they can never equal a real qlen (length is
        # SENTINEL_LEN) so the final ok-mask excludes them.
        view = DeviceIndex(hi=hi_l, lo=lo_l, length=ln_l, row_ids=rid_l)
        rows, hit, truncated = view.pattern_hits(masks, qlen=qlen, cap=cap)
        del live_l
        return rows[None], hit[None], jax.lax.psum(
            truncated.astype(jnp.int32), AXIS_DATA
        )

    spec = P(AXIS_DATA)
    return jax.jit(
        _shard_map(
            local,
            mesh,
            in_specs=(spec, spec, spec, spec, spec, P()),
            out_specs=(P(AXIS_DATA), P(AXIS_DATA), P()),
        )
    )


@functools.lru_cache(maxsize=None)
def _make_lookup(mesh, op: str, cap: int):
    """Jitted sharded lookup: local binary search + candidate gather.

    op: "eq" (strategy 3) or "prefix" (strategy 28).  Returns per-shard
    stacked results: rows [ndev, M, cap] global row ids (-1 padding),
    hit [ndev, M, cap] bool, count [M] exact global hit counts (psum —
    exact even when cap truncates the materialized rows).
    """
    if op not in ("eq", "prefix"):
        raise ValueError(f"unknown sharded lookup op {op!r}")

    def local(hi_l, lo_l, ln_l, rid_l, live_l, qhi, qlo, qln):
        n_loc = hi_l.shape[0]
        live = live_l[0]
        left = searchsorted_packed(hi_l, lo_l, ln_l, qhi, qlo, qln, side="left")
        if op == "eq":
            right = searchsorted_packed(
                hi_l, lo_l, ln_l, qhi, qlo, qln, side="right"
            )
        else:
            uhi, ulo, wrapped = prefix_upper_key(qhi, qlo, qln)
            right = searchsorted_packed(
                hi_l, lo_l, ln_l, uhi, ulo,
                jnp.full(qln.shape, -1, jnp.int32), side="left",
            )
            right = jnp.where(wrapped, live, right)
            empty = qln == 0  # empty prefix matches every live row
            left = jnp.where(empty, 0, left)
            right = jnp.where(empty, live, right)
        left = jnp.minimum(left, live)
        right = jnp.minimum(right, live)

        offs = jnp.arange(cap, dtype=jnp.int32)[None, :]
        pos = left[:, None] + offs
        hit = pos < right[:, None]
        rows = rid_l[jnp.clip(pos, 0, max(n_loc - 1, 0))]
        rows = jnp.where(hit, rows, -1)
        count = jax.lax.psum(right - left, AXIS_DATA)
        return rows[None], hit[None], count

    spec = P(AXIS_DATA)
    return jax.jit(
        _shard_map(
            local,
            mesh,
            in_specs=(spec, spec, spec, spec, spec, P(), P(), P()),
            out_specs=(P(AXIS_DATA), P(AXIS_DATA), P()),
        )
    )


@dataclasses.dataclass
class ShardedIndex:
    """Sorted-per-shard kmer index over a ("data", ...) mesh.

    hi/lo/length/row_ids: [ndev * n_loc] device-sharded arrays, each
    shard independently sorted ascending with sentinel padding last;
    live: [ndev] live-row count per shard.
    """

    hi: jax.Array
    lo: jax.Array
    length: jax.Array
    row_ids: jax.Array
    live: jax.Array
    mesh: jax.sharding.Mesh
    n: int

    @classmethod
    def build(cls, column: PackedKmers, mesh) -> "ShardedIndex":
        ndev = int(np.prod(mesh.devices.shape))
        hi = np.asarray(column.hi, np.uint32).ravel()
        lo = np.asarray(column.lo, np.uint32).ravel()
        ln = np.asarray(column.length, np.int32).ravel()
        n = hi.size
        pad = (-n) % ndev if n else ndev
        hi = np.pad(hi, (0, pad), constant_values=int(SENTINEL))
        lo = np.pad(lo, (0, pad), constant_values=int(SENTINEL))
        ln = np.pad(ln, (0, pad), constant_values=int(SENTINEL_LEN))
        rid = np.pad(np.arange(n, dtype=np.int32), (0, pad), constant_values=-1)
        shi, slo, sln, srid, live = _make_build(mesh)(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(ln), jnp.asarray(rid)
        )
        return cls(hi=shi, lo=slo, length=sln, row_ids=srid, live=live,
                   mesh=mesh, n=n)

    def __len__(self) -> int:
        return self.n

    def _query_batch(self, kmers):
        pk = PackedKmers.from_strings([str(Kmer(s)) for s in kmers])
        return (
            jnp.asarray(np.asarray(pk.hi, np.uint32)),
            jnp.asarray(np.asarray(pk.lo, np.uint32)),
            jnp.asarray(np.asarray(pk.length, np.int32)),
        )

    def _lookup(self, op: str, kmers, cap: int):
        from ..index import ladder_cap

        cap = ladder_cap(cap, self.shard_rows)
        qhi, qlo, qln = self._query_batch(kmers)
        step = _make_lookup(self.mesh, op, cap)
        rows, hit, count = step(
            self.hi, self.lo, self.length, self.row_ids, self.live,
            qhi, qlo, qln,
        )
        rows = np.asarray(rows)     # [ndev, M, cap]
        hit = np.asarray(hit)
        count = np.asarray(count)   # [M]
        out = []
        for q in range(rows.shape[1]):
            r = rows[:, q][hit[:, q]]
            if r.size < count[q]:
                raise OverflowError(
                    f"sharded lookup cap {cap} truncated a shard's hits "
                    f"for query {q} ({count[q]} total); re-query with "
                    f"cap >= {int(count[q])}"
                )
            out.append(np.sort(r))
        return out, count

    # -- host conveniences (exact; auto-regrow cap on truncation) -----------

    def search_eq(self, kmers, cap: int = 32) -> list[np.ndarray]:
        """Global row ids per query kmer (strategy 3); union over shards."""
        return self._auto(op="eq", kmers=kmers, cap=cap)

    def search_prefix(self, prefixes, cap: int = 128) -> list[np.ndarray]:
        """Global row ids per prefix (strategy 28)."""
        return self._auto(op="prefix", kmers=prefixes, cap=cap)

    @property
    def shard_rows(self) -> int:
        """Rows held per data-axis shard (arrays shard over "data" only
        and replicate over any other mesh axis)."""
        dp = int(self.mesh.shape[AXIS_DATA])
        return self.hi.shape[0] // max(dp, 1)

    def search_pattern(self, qkmers, cap: int = 128) -> list[np.ndarray]:
        """Global row ids per qkmer pattern (strategies 7/8); exact via
        automatic cap regrowth, grouped by pattern length."""
        from ..index import pattern_search_grouped

        def group_fn(qlen, masks, c):
            step = _make_pattern_lookup(self.mesh, qlen, c)
            rows, hit, trunc = step(
                self.hi, self.lo, self.length, self.row_ids, self.live,
                jnp.asarray(masks),
            )
            rows, hit = np.asarray(rows), np.asarray(hit)
            return (
                [np.sort(rows[:, j][hit[:, j]]) for j in range(rows.shape[1])],
                bool(np.asarray(trunc).any()),
            )

        zero_rows = np.sort(
            np.asarray(self.row_ids)[np.asarray(self.length) == 0]
        )
        return pattern_search_grouped(
            qkmers, zero_rows, group_fn, cap, cap_limit=self.shard_rows
        )

    def _auto(self, op, kmers, cap):
        while True:
            try:
                rows, _ = self._lookup(op, kmers, cap)
                return rows
            except OverflowError:
                cap *= 4
                if cap >= self.shard_rows:
                    # cap covers a whole shard: cannot truncate
                    rows, _ = self._lookup(op, kmers, self.shard_rows)
                    return rows
