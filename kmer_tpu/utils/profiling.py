"""Tracing / profiling helpers.

The engine's analogue of the reference's EXPLAIN ANALYZE (SURVEY.md
§5.1): jax.profiler trace annotations around pipeline phases, wall-clock
phase accounting with bytes/s against a speed-of-light budget, and the
reduction of a device trace to time per named scope.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import time

import jax


class Profile:
    """Accumulates per-phase wall time and optional byte counts."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self.bytes: dict[str, int] = {}

    def report(self, hbm_bw_bytes_per_s: float | None = None) -> str:
        lines = []
        for name, dt in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            line = f"{name}: {dt * 1e3:.2f} ms"
            nbytes = self.bytes.get(name)
            if nbytes:
                gbs = nbytes / dt / 1e9
                line += f", {gbs:.1f} GB/s"
                if hbm_bw_bytes_per_s:
                    line += f" ({100 * nbytes / dt / hbm_bw_bytes_per_s:.0f}% of SoL)"
            lines.append(line)
        return "\n".join(lines)


@contextlib.contextmanager
def phase_timer(profile: Profile | None, name: str, nbytes: int = 0, sync=None):
    """Times a phase (blocking on `sync` if given) and annotates the
    jax profiler trace so phases show up in xprof captures."""
    with jax.profiler.TraceAnnotation(name):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            jax.block_until_ready(sync)
        dt = time.perf_counter() - t0
    if profile is not None:
        profile.phases[name] = profile.phases.get(name, 0.0) + dt
        if nbytes:
            profile.bytes[name] = profile.bytes.get(name, 0) + nbytes


def device_time_by_scope(trace_dir: str) -> dict[tuple[str, str], float]:
    """Device kernel time (ms) per (jitted module, top-level named scope).

    Reads the newest ``*.xplane.pb`` under ``trace_dir`` (written by
    ``jax.profiler.trace``) and sums the durations of the events on the
    device planes.  The scope is the first ``jax.named_scope`` inside
    the jitted function (ops/count.py names ``sort`` and
    ``segment_counts``), or the op's own name outside any scope; kernels
    XLA generated with no source op fall under ``"?"``.  XLA:GPU's
    command buffers hide the kernels inside them: trace with
    ``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` to attribute them.
    """
    import jax

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    out: dict = collections.defaultdict(float)
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                parts = str(stats.get("name", "")).split("/")
                scope = parts[1] if len(parts) > 1 else "?"
                out[(str(stats.get("hlo_module", "?")), scope)] += (
                    ev.duration_ns / 1e6)
    return dict(out)
