"""Multi-process group initialization and the all-device mesh.

For multi-process runs (BASELINE.json configs[3]): each process calls
``initialize_multihost()`` (a thin wrapper over
``jax.distributed.initialize``), then builds a mesh whose "data" axis
spans every device of every process.  On GPUs each process drives one
card: a multi-process GPU run that sees more than one local device is
refused, because every JAX process reserves most of each card it opens
(launch each process with ``CUDA_VISIBLE_DEVICES`` set to its card).

Single-process runs skip initialization and work unchanged; the tests
run the same shard_map code on a virtual CPU mesh (tests/conftest.py).
"""

from __future__ import annotations

import jax

from .mesh import make_mesh, mesh_shape_for


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    strict: bool | None = None,
    timeout_s: int = 300,
) -> bool:
    """Initialize the jax distributed runtime; returns True if multi-host.

    With no arguments, relies on the environment (cluster metadata or
    JAX_COORDINATOR_ADDRESS etc.) and degrades to single-process mode
    with a logged warning if that auto-detection fails.  When any
    argument is given explicitly — i.e. the caller *asked* for a
    specific topology — a failure raises instead of silently
    shrinking the job to one process (strict defaults to True then;
    pass strict=False to opt back into best-effort).
    """
    explicit = any(
        x is not None for x in (coordinator_address, num_processes, process_id)
    )
    if strict is None:
        strict = explicit
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            initialization_timeout=timeout_s,
        )
    except Exception as e:
        if strict:
            raise RuntimeError(
                "multi-host initialization failed for the requested topology "
                f"(coordinator={coordinator_address!r}, "
                f"num_processes={num_processes}, process_id={process_id}): {e}"
            ) from e
        from ..utils.logging import get_logger

        get_logger().warning(
            "jax.distributed.initialize failed (%s); continuing single-process",
            e,
        )
        return False
    check_one_card_per_process()
    return jax.process_count() > 1


def check_one_card_per_process() -> None:
    """Refuse a multi-process GPU run in which a process sees several cards.

    Each JAX process reserves most of every card it opens, so two
    processes that both open all the cards of a host starve each other.
    """
    if (jax.process_count() > 1 and jax.default_backend() == "gpu"
            and jax.local_device_count() > 1):
        raise RuntimeError(
            f"process {jax.process_index()} of {jax.process_count()} sees "
            f"{jax.local_device_count()} GPUs; run one process per card "
            "(set CUDA_VISIBLE_DEVICES to one card for each process)")


def make_pod_mesh(seq_parallel: int | None = None) -> jax.sharding.Mesh:
    """Mesh over every device of every process."""
    n = len(jax.devices())
    return make_mesh(mesh_shape_for(n, seq_parallel))


def host_local_batch(global_batch: int) -> int:
    """Per-host read-batch size for an evenly sharded global batch."""
    pc = jax.process_count()
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} not divisible by {pc} hosts")
    return global_batch // pc
