"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding logic (shard_map + collectives) is exercised on one
machine via XLA's host-platform device-count override, per SURVEY.md §4.
Must run before jax is imported anywhere.  ``JAX_PLATFORMS`` defaults to
``cpu``; tests marked ``gpu`` need the card and skip without it (run them
there with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first NVIDIA GPU; skips the test where JAX has none."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (JAX found none)")
    return devices[0]
