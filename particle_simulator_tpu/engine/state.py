"""Device-resident simulation state and in-band parameters.

Device layout decisions (vs the reference's 20-byte AoS ``Particle``):

- **SoA**: positions/velocities/types live as separate flat arrays so the
  device streams each field contiguously (coalesced loads) and XLA can fuse
  elementwise chains.
- **Static capacity + tombstones**: arrays are capacity-padded, dead slots have
  ``ty < 0`` (the reference's own tombstone convention,
  particle_io/src/particle.rs:21-23). Shapes never change inside jit.
- **u32 fixed-point positions** are kept verbatim: uniform absolute precision
  across the box, wrap-free distance math, bucket ids are bit shifts
  (reference: cuda_simulator/src/particle.cuh:33-47).
- **All of FrameMetadata enters jit as arrays** (``SimParams``), never as Python
  constants, so live parameter edits from the editor take effect next frame with
  zero recompilation (reference hot-update path: cuda_simulator.cu:11-14).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from particle_simulator_tpu.io.frame import PARTICLE_DTYPE

U32_MAX_F = np.float32(4294967295.0)
HALF_U32 = np.uint32(2147483647)  # UINT32_MAX / 2 with C integer division

# The reference hardcodes Argon's mass for every particle
# (cuda_simulator/src/particle.cuh:51); it is not part of FrameMetadata.
PARTICLE_MASS = np.float32(6.63352599e-26)


class ParticleState(NamedTuple):
    """SoA particle state. All arrays share the same leading shape — flat
    ``(capacity,)`` for the compact path, ``(BY, BX, BUCKET_CAP)`` for the
    bucket path."""

    x: jnp.ndarray  # u32 fixed point in [0, box_width)
    y: jnp.ndarray  # u32 fixed point in [0, box_height)
    vx: jnp.ndarray  # f32 m/s
    vy: jnp.ndarray  # f32 m/s
    ty: jnp.ndarray  # i32 species; < 0 means null/tombstone

    @property
    def capacity(self) -> int:
        return int(np.prod(self.x.shape))

    def reshape(self, shape) -> "ParticleState":
        return ParticleState(*(a.reshape(shape) for a in self))


def empty_state(shape) -> ParticleState:
    """All-tombstone state of the given leading shape."""
    return ParticleState(
        x=jnp.zeros(shape, jnp.uint32),
        y=jnp.zeros(shape, jnp.uint32),
        vx=jnp.zeros(shape, jnp.float32),
        vy=jnp.zeros(shape, jnp.float32),
        ty=jnp.full(shape, -1, jnp.int32),
    )


def state_from_numpy(parts: np.ndarray, capacity: int) -> ParticleState:
    """Pad a ``PARTICLE_DTYPE`` array to ``capacity`` with tombstones."""
    n = len(parts)
    if n > capacity:
        raise ValueError(f"{n} particles exceed capacity {capacity}")
    x = np.zeros(capacity, np.uint32)
    y = np.zeros(capacity, np.uint32)
    vx = np.zeros(capacity, np.float32)
    vy = np.zeros(capacity, np.float32)
    ty = np.full(capacity, -1, np.int32)
    x[:n] = parts["x"]
    y[:n] = parts["y"]
    vx[:n] = parts["vx"]
    vy[:n] = parts["vy"]
    ty[:n] = parts["ty"]
    return ParticleState(jnp.asarray(x), jnp.asarray(y), jnp.asarray(vx), jnp.asarray(vy), jnp.asarray(ty))


def state_to_numpy(state: ParticleState) -> np.ndarray:
    """Full (padded) state as a ``PARTICLE_DTYPE`` array, tombstones included.
    Use ``Frame.compact`` / boolean masking to drop them."""
    fields = [np.asarray(a).reshape(-1) for a in state]
    parts = np.empty(fields[0].shape[0], dtype=PARTICLE_DTYPE)
    parts["x"], parts["y"], parts["vx"], parts["vy"], parts["ty"] = fields
    return parts


class SimParams(NamedTuple):
    """The jit-traced mirror of ``FrameMetadata`` — every field is a 0-d array
    so editor tweaks never trigger recompilation. Only species 0 drives the
    physics, matching the reference (kernel_bucket.cuh:52, doc/project.typ:610);
    species 1 params ride along for wire roundtrips.
    """

    sigma: jnp.ndarray
    epsilon: jnp.ndarray
    n: jnp.ndarray
    m: jnp.ndarray
    sigma1: jnp.ndarray
    epsilon1: jnp.ndarray
    n1: jnp.ndarray
    m1: jnp.ndarray
    cursor_x: jnp.ndarray
    cursor_y: jnp.ndarray
    cursor_size: jnp.ndarray
    step_dt: jnp.ndarray
    steps_per_frame: jnp.ndarray  # i32
    box_width: jnp.ndarray
    box_height: jnp.ndarray

    @staticmethod
    def from_record(meta: np.ndarray) -> "SimParams":
        """Build from a ``METADATA_DTYPE`` record (0-d numpy structured)."""
        p0 = meta["particles"][0] if meta["particles"].ndim == 1 else meta["particles"][..., 0]
        p1 = meta["particles"][1] if meta["particles"].ndim == 1 else meta["particles"][..., 1]
        f32 = np.float32
        return SimParams(
            sigma=f32(p0["sigma"]),
            epsilon=f32(p0["epsilon"]),
            n=f32(p0["n"]),
            m=f32(p0["m"]),
            sigma1=f32(p1["sigma"]),
            epsilon1=f32(p1["epsilon"]),
            n1=f32(p1["n"]),
            m1=f32(p1["m"]),
            cursor_x=f32(meta["cursor_pos"][0]),
            cursor_y=f32(meta["cursor_pos"][1]),
            cursor_size=f32(meta["cursor_size"]),
            step_dt=f32(meta["step_dt"]),
            steps_per_frame=np.int32(meta["steps_per_frame"]),
            box_width=f32(meta["box_width"]),
            box_height=f32(meta["box_height"]),
        )

    def no_cursor(self) -> "SimParams":
        return self._replace(cursor_x=np.float32(-1.0), cursor_y=np.float32(-1.0))
