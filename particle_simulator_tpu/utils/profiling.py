"""Profiling and throughput instrumentation.

The reference has no in-tree profiler — just an stderr log macro
(cuda_simulator/src/lib/log.hpp), ptxas register dumps, and one externally
captured nsight trace analyzed in the report (doc/project.typ:710-724). This
module gives this build a first-class story:

- ``trace(dir)``: jax.profiler trace context (XLA host + device timeline, viewable in
  TensorBoard / Perfetto) around any code region;
- ``StepMeter``: running steps/sec + particle-steps/sec counter, the number
  the benchmark and the engine daemon report;
- ``annotate``: named trace regions (jax.profiler.TraceAnnotation) so engine
  phases (prepare/dispatch/readback/ship) show up on the timeline.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace of the enclosed region into ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region on the profiler timeline."""
    return jax.profiler.TraceAnnotation(name)


class StepMeter:
    """Exponentially-smoothed steps/sec + particle-steps/sec meter."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self._last: float | None = None
        self.steps_per_sec = 0.0
        self.particle_steps_per_sec = 0.0
        self.total_steps = 0

    def tick(self, steps: int, particles: int) -> None:
        """Record that ``steps`` physics steps over ``particles`` particles
        just completed."""
        now = time.perf_counter()
        self.total_steps += steps
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                inst = steps / dt
                self.steps_per_sec += self.alpha * (inst - self.steps_per_sec)
                self.particle_steps_per_sec += self.alpha * (
                    inst * particles - self.particle_steps_per_sec
                )
        self._last = now

    def report(self) -> dict:
        return {
            "steps_per_sec": round(self.steps_per_sec, 2),
            "particle_steps_per_sec": round(self.particle_steps_per_sec, 1),
            "total_steps": self.total_steps,
        }
