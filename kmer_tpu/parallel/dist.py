"""Distributed extraction + counting over a ("data", "seq") mesh.

Green-field layer (the reference is single-process; SURVEY.md §2.2).
Design per BASELINE.json: read batches stream data-parallel, the
sequence axis shards with a k-1 halo exchange between ring neighbors
(jax.lax.ppermute), per-shard count tables are built with the
local sort-based kernel, and tables merge via collectives.

Two merge strategies:

* ``merge="gather"`` — all_gather the local (key, count) tables over
  both mesh axes and re-run the weighted count locally.  Exact,
  replicated output; payload is the *deduplicated* local table, not the
  raw windows.  Memory per device grows with device count.
* ``merge="partition"`` — hash-partition each local table into one
  bucket per device, exchange buckets with a single all_to_all, and
  recount locally.  Each device ends up owning a disjoint hash range of
  the global table (reduce-scatter shape): per-device memory is
  ~slack × local size regardless of device count, which is the
  path for many devices.  Bucket routing is a pure gather (sort by bucket +
  searchsorted offsets) — no scatter anywhere.  Fixed per-bucket
  capacity means pathological skew can overflow; the step reports a
  replicated overflow counter (0 in any sane configuration) so callers
  can detect and re-run with more slack or the gather path.

All collective code is pure shard_map + lax collectives; XLA lowers them
to NCCL over NVLink between the cards of one host.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops.count import SENTINEL, SENTINEL_LEN, CountTable, count_packed, count_windows
from ..ops.extract import canonicalize
from ..ops.predicates import _mix32
from .mesh import AXIS_DATA, AXIS_SEQ


def _shard_map(f, mesh, in_specs, out_specs):
    """shard_map across jax versions (check_rep was renamed check_vma)."""
    kwargs = dict(mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    params = inspect.signature(jax.shard_map).parameters
    if "check_vma" in params:
        kwargs["check_vma"] = False
    elif "check_rep" in params:
        kwargs["check_rep"] = False
    return jax.shard_map(f, **kwargs)


def _extract_with_halo(codes_l, lengths_l, k: int, seq_size: int, canonical: bool):
    """Local windows of a sequence-sharded read batch.

    codes_l: [b_loc, l_loc] local chunk of the base axis; each device owns
    the windows *starting* in its chunk, which need the first k-1 bases of
    the right neighbor (ring halo exchange; wrap-around data is never
    used because windows past a read's length are masked invalid).
    """
    b_loc, l_loc = codes_l.shape
    if seq_size > 1 and k > 1:
        halo = jax.lax.ppermute(
            codes_l[:, : k - 1],
            AXIS_SEQ,
            perm=[((s + 1) % seq_size, s) for s in range(seq_size)],
        )
        ext = jnp.concatenate([codes_l, halo], axis=1)
    else:
        ext = codes_l if k == 1 else jnp.pad(codes_l, ((0, 0), (0, k - 1)))
    # windows starting at local columns 0..l_loc-1
    hi = jnp.zeros((b_loc, l_loc), jnp.uint32)
    lo = jnp.zeros((b_loc, l_loc), jnp.uint32)
    for j in range(k):
        c = ext[:, j : j + l_loc].astype(jnp.uint32)
        if j < 16:
            hi = hi | (c << jnp.uint32(30 - 2 * j))
        else:
            lo = lo | (c << jnp.uint32(30 - 2 * (j - 16)))
    s_idx = jax.lax.axis_index(AXIS_SEQ)
    global_start = s_idx * l_loc + jnp.arange(l_loc, dtype=jnp.int32)[None, :]
    valid = global_start <= (lengths_l.astype(jnp.int32)[:, None] - k)
    if canonical:
        hi, lo = canonicalize(hi, lo, k)
    return hi, lo, valid


def _bucket_of(hi, lo, length, n_parts: int):
    """Hash bucket in [0, n_parts) per key (murmur-style finalizer).

    Matches ops.predicates.v_hash's mixing so routing quality equals the
    hash opclass's (kmer.c:353-365 analogue); the modulus differs per
    device count, which is fine — routing only needs that equal keys
    land in equal buckets on every device.
    """
    h = _mix32(hi ^ jnp.uint32(0x9E3779B9))
    h = _mix32(h ^ lo)
    h = _mix32(h ^ length.astype(jnp.uint32))
    return (h % jnp.uint32(n_parts)).astype(jnp.int32)


def _partition_merge_local(table: CountTable, n_parts: int, cap: int, axes,
                           bounded: bool = False):
    """all_to_all merge of per-device sorted-run tables (device-local body).

    Routes each live group to device ``hash(key) % n_parts`` via a
    [n_parts, cap] send buffer built with gathers only:

    1. sort local groups by bucket id (dead slots sort last);
    2. bucket offsets via searchsorted over the sorted bucket lane;
    3. send slot (b, w) reads sorted position offsets[b] + w — a gather;
    4. one all_to_all swaps bucket b to device b;
    5. weighted recount of the received groups.

    ``bounded``: the received weights total < 2^31 (see count_packed).
    Returns (local shard of the global table, global overflow count).
    Buckets larger than ``cap`` lose their tail — reported in overflow,
    which callers must check (exactness contract).
    """
    n = table.hi.shape[0]
    live = table.counts > 0
    bucket = jnp.where(
        live, _bucket_of(table.hi, table.lo, table.length, n_parts), jnp.int32(n_parts)
    )
    sb, shi, slo, sln, sct = jax.lax.sort(
        (bucket, table.hi, table.lo, table.length, table.counts), num_keys=1
    )
    offsets = jnp.searchsorted(
        sb, jnp.arange(n_parts + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    per_bucket = offsets[1:] - offsets[:-1]
    overflow = jnp.sum(jnp.maximum(per_bucket - cap, 0))

    w = jnp.arange(cap, dtype=jnp.int32)[None, :]
    src = jnp.clip(offsets[:-1, None] + w, 0, n - 1)  # [n_parts, cap]
    slot_live = w < per_bucket[:, None]
    send_hi = jnp.where(slot_live, shi[src], jnp.uint32(SENTINEL))
    send_lo = jnp.where(slot_live, slo[src], jnp.uint32(SENTINEL))
    send_ln = jnp.where(slot_live, sln[src], jnp.int32(SENTINEL_LEN))
    send_ct = jnp.where(slot_live, sct[src], 0)

    recv = [
        jax.lax.all_to_all(x, axes, split_axis=0, concat_axis=0)
        for x in (send_hi, send_lo, send_ln, send_ct)
    ]
    merged = count_packed(*recv, bounded_weights=bounded)
    merged = dataclasses.replace(
        merged, n_unique=jax.lax.psum(merged.n_unique, axes)
    )
    return merged, jax.lax.psum(overflow, axes)


def make_sharded_count_step(
    mesh, k: int, canonical: bool = False, merge: str = "gather", slack: float = 2.0
):
    """Build the jitted multi-device counting step.

    Returns step(codes [B, L], lengths [B]) -> CountTable for
    merge="gather" (table replicated), or (CountTable, overflow) for
    merge="partition" (table sharded over both mesh axes — each device
    owns a disjoint hash range; overflow is a replicated int that must
    be 0 for the result to be exact).  B shards over "data", L over
    "seq"; lengths shard over "data" and replicate over "seq".
    """
    if merge not in ("gather", "partition"):
        raise ValueError(f"unknown merge strategy {merge!r}")
    dp, sp = mesh.devices.shape
    n_parts = dp * sp
    axes = (AXIS_DATA, AXIS_SEQ)

    def local_step(codes_l, lengths_l):
        # every weight the merge recounts is a window count of this one
        # global batch, so the recount's total fits int32 (the cheaper
        # bounded segment totals, with no 2^28-row limit) whenever the
        # batch has fewer than 2^31 base slots
        bounded = codes_l.shape[0] * dp * codes_l.shape[1] * sp < 1 << 31
        hi, lo, valid = _extract_with_halo(codes_l, lengths_l, k, sp, canonical)
        table = count_windows(hi, lo, valid, k)
        if merge == "partition":
            n = table.hi.shape[0]
            cap = max(8, int(slack * n / n_parts + 1))
            return _partition_merge_local(table, n_parts, cap, axes, bounded)
        # gather: deduplicated local tables over both axes, then recount
        ghi = jax.lax.all_gather(table.hi, axes, tiled=True)
        glo = jax.lax.all_gather(table.lo, axes, tiled=True)
        gln = jax.lax.all_gather(table.length, axes, tiled=True)
        gct = jax.lax.all_gather(table.counts, axes, tiled=True)
        return count_packed(ghi, glo, gln, gct, bounded_weights=bounded)

    if merge == "partition":
        sharded_spec = P((AXIS_DATA, AXIS_SEQ))
        out_specs = (
            CountTable(
                hi=sharded_spec,
                lo=sharded_spec,
                length=sharded_spec,
                counts=sharded_spec,
                n_unique=P(),
            ),
            P(),
        )
    else:
        out_specs = CountTable(hi=P(), lo=P(), length=P(), counts=P(), n_unique=P())

    sharded = _shard_map(
        local_step,
        mesh,
        in_specs=(P(AXIS_DATA, AXIS_SEQ), P(AXIS_DATA)),
        out_specs=out_specs,
    )
    return jax.jit(sharded)


def merge_efficiency(table: CountTable, n_devices: int, merge: str = "gather",
                     slack: float = 2.0) -> dict:
    """Merge-efficiency stats for a local table (BASELINE metric #3).

    Efficiency = useful payload bytes / bytes put on the interconnect by
    this device's merge step (16 bytes per (hi, lo, length, count) slot):

    * gather: every slot of the fixed-capacity sorted-run table travels,
      live or not, and the exchange replicates to all devices;
    * partition: n_devices bucket slabs of ``cap`` slots travel once
      (all_to_all), so dead slack slots are the only waste.
    """
    capacity = int(table.capacity)
    live = int((jnp.asarray(table.counts) > 0).sum())
    entry_bytes = 16
    useful = live * entry_bytes
    if merge == "gather":
        sent = capacity * entry_bytes
    elif merge == "partition":
        cap = max(8, int(slack * capacity / n_devices + 1))
        sent = n_devices * cap * entry_bytes
    else:
        raise ValueError(f"unknown merge strategy {merge!r}")
    return {
        "merge": merge,
        "n_devices": n_devices,
        "live_groups": live,
        "capacity": capacity,
        "bytes_sent_per_device": sent,
        "useful_bytes": useful,
        "efficiency": (useful / sent) if sent else 1.0,
    }


def count_kmers_sharded(
    codes, lengths, k: int, mesh, canonical: bool = False, merge: str = "gather"
) -> CountTable:
    """One-shot sharded count (builds + runs the step).

    merge="partition" verifies the overflow counter on host and falls
    back to the gather merge in the (pathological-skew) overflow case,
    so the result is always exact.
    """
    step = make_sharded_count_step(mesh, k, canonical, merge=merge)
    if merge == "partition":
        table, overflow = step(jnp.asarray(codes), jnp.asarray(lengths))
        if int(overflow) == 0:
            return table
        step = make_sharded_count_step(mesh, k, canonical, merge="gather")
    return step(jnp.asarray(codes), jnp.asarray(lengths))
