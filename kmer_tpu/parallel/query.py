"""Distributed predicate queries over sharded kmer columns.

The reference's query path is a single-backend scan or index scan; the
engine's multi-device equivalent shards the column over the "data" mesh
axis, evaluates the vectorized predicate locally (elementwise ops), and
gathers per-shard hit masks with an all_gather — the
"query-result gathers via collectives" of BASELINE.json.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..ops.predicates import qkmer_mask_vector, v_contains, v_equals, v_starts_with
from ..packed import PackedKmers
from ..types import Kmer, Qkmer
from .dist import _shard_map
from .mesh import AXIS_DATA


def _scalar_query(km: Kmer):
    pk = PackedKmers.single(km)
    return (
        jnp.uint32(pk.hi[0]),
        jnp.uint32(pk.lo[0]),
        jnp.int32(pk.length[0]),
    )


def make_filter_step(mesh, op: str, query) -> "callable":
    """Build a jitted sharded filter: column arrays -> global bool mask.

    op: "eq" | "prefix" | "pattern"; query: Kmer/Qkmer literal.
    The column shards over "data"; the result mask is replicated
    (all_gather).
    """
    if op in ("eq", "prefix"):
        qhi, qlo, qln = _scalar_query(Kmer(query))
    else:
        masks, qlen = qkmer_mask_vector(Qkmer(query))
        masks = jnp.asarray(masks)

    def local(hi_l, lo_l, ln_l):
        col = PackedKmers(hi=hi_l, lo=lo_l, length=ln_l)
        if op == "eq":
            m = v_equals(col, PackedKmers(hi=qhi, lo=qlo, length=qln))
        elif op == "prefix":
            m = v_starts_with(col, PackedKmers(hi=qhi, lo=qlo, length=qln))
        elif op == "pattern":
            m = v_contains(col, masks, qlen)
        else:
            raise ValueError(op)
        return jax.lax.all_gather(m, AXIS_DATA, tiled=True)

    return jax.jit(
        _shard_map(
            local,
            mesh,
            in_specs=(P(AXIS_DATA), P(AXIS_DATA), P(AXIS_DATA)),
            out_specs=P(),
        )
    )


def filter_sharded(col: PackedKmers, op: str, query, mesh) -> np.ndarray:
    """Row ids matching the predicate, computed data-parallel."""
    n = col.hi.shape[0]
    ndev = mesh.devices.size
    pad = (-n) % ndev
    hi = jnp.asarray(np.pad(np.asarray(col.hi), (0, pad)))
    lo = jnp.asarray(np.pad(np.asarray(col.lo), (0, pad)))
    # padding rows get length -1 -> never match any query
    ln = jnp.asarray(
        np.pad(np.asarray(col.length), (0, pad), constant_values=-1)
    )
    step = make_filter_step(mesh, op, query)
    mask = np.asarray(step(hi, lo, ln))[:n]
    return np.flatnonzero(mask)
