"""KmerCounter — the engine's flagship pipeline.

Fuses the reference's two hot paths — generate_kmers extraction
(/root/reference/kmer.c:287-351) and HashAggregate counting
(kmer--1.0.0.sql:188-192) — into one jitted device program:
encode -> window-extract -> (canonicalize) -> sort-count, optionally
sharded over a ("data", "seq") mesh with halo exchange + collective
merge.  This is the unit the benchmark and the multi-chip dryrun drive.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import EngineConfig
from ..ops.count import CountTable, count_kmers
from ..parallel.dist import make_sharded_count_step
from ..parallel.mesh import make_mesh


class KmerCounter:
    """Configured extract+count pipeline over padded read batches."""

    def __init__(self, config: EngineConfig):
        self.config = config
        self._step = jax.jit(self._forward)
        self._sharded_steps: dict[tuple, object] = {}

    # --- single device -------------------------------------------------------

    def _forward(self, codes, lengths) -> CountTable:
        return count_kmers(
            codes, lengths, self.config.k, canonical=self.config.canonical
        )

    def step(self, codes, lengths) -> CountTable:
        """Jitted forward: padded reads [B, L] + lengths [B] -> CountTable."""
        return self._step(jnp.asarray(codes), jnp.asarray(lengths))

    # --- multi device --------------------------------------------------------

    def sharded_step(self, mesh=None):
        """The jitted multi-device step for a mesh (built once per mesh)."""
        if mesh is None:
            mesh = make_mesh(self.config.mesh_shape)
        key = (id(mesh), self.config.k, self.config.canonical)
        if key not in self._sharded_steps:
            self._sharded_steps[key] = make_sharded_count_step(
                mesh, self.config.k, self.config.canonical
            )
        return self._sharded_steps[key]

    def count_sharded(self, codes, lengths, mesh=None) -> CountTable:
        return self.sharded_step(mesh)(jnp.asarray(codes), jnp.asarray(lengths))
