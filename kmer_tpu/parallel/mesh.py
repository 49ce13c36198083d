"""Device-mesh construction.

The reference has no parallelism of any kind (SURVEY.md §2.2) — this
layer is green-field, specified by BASELINE.json: data-parallel read
streaming + sequence sharding, expressed as a 2D
``("data", "seq")`` jax mesh.

"data" shards read batches (DP); "seq" shards the base-position axis of
long sequences (the k-mer analogue of sequence/context parallelism, with
a k-1 halo exchange between neighbors — SURVEY.md §5.7).

Devices are taken in ``jax.devices()`` order with no topology: the cards
of one host are joined all to all by NVLink, so any order is as good.
"""

from __future__ import annotations

import jax
import numpy as np

AXIS_DATA = "data"
AXIS_SEQ = "seq"


def mesh_shape_for(n_devices: int, seq_parallel: int | None = None) -> tuple[int, int]:
    """Pick a (data, seq) factorization of n_devices.

    Counting workloads are embarrassingly data-parallel, so default all
    devices to "data"; callers doing long-sequence extraction pass an
    explicit seq extent.
    """
    if seq_parallel is None:
        return (n_devices, 1)
    if n_devices % seq_parallel:
        raise ValueError(f"{n_devices} devices not divisible by seq={seq_parallel}")
    return (n_devices // seq_parallel, seq_parallel)


def make_mesh(shape: tuple[int, int] | None = None, devices=None) -> jax.sharding.Mesh:
    """Build a ("data", "seq") mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = mesh_shape_for(len(devices))
    n = shape[0] * shape[1]
    dev = np.asarray(devices[:n]).reshape(shape)
    return jax.sharding.Mesh(dev, (AXIS_DATA, AXIS_SEQ))
