"""Multi-device spatial domain decomposition: shard_map + halo exchange.

The reference is single-GPU; its scale-out axis is the uniform bucket grid
(cuda_simulator/src/kernel_bucket.cuh). Here that grid shards by 2D spatial
domain across a device mesh:

- the (BY, BX, CAP) bucket grid is sharded ``P("dy", "dx", None)`` over a
  ``Mesh(devices, ("dy", "dx"))`` — each device owns a rectangle of buckets;
- before every step, each device exchanges a **one-bucket halo ring** with
  its mesh neighbors via ``lax.ppermute`` (NCCL over NVLink between GPUs of
  one host). This is the direct analog of the reference's 3x3 bucket
  neighborhood crossing a shard edge;
- the pull-based rebucket pass (bucket_move_direct_halo) doubles as particle
  **migration**: a particle that drifts into a neighbor's domain is pulled by
  that neighbor from the exchanged halo, and dropped locally by the owner's own
  move pass. No extra migration protocol is needed because the reference's move
  cadence (every 16 steps) already bounds drift to one bucket;
- boundary devices see tombstone halos (the box walls), matching the
  single-device edge clamp.

Halo exchange is two-phase (x then y) so corner buckets propagate through the
edge neighbors — the y-phase ships rows that already contain the x-halo.
``lax.ppermute`` zero-fills devices that receive nothing (the mesh boundary);
we ship ``ty + 1`` so that zero-fill decodes to the tombstone ``ty = -1``.

Single-device semantics are preserved: tests check a sharded run on 2-8
virtual CPU devices against the single-device bucket path (bucket layout
exact, positions and velocities within f32 summation-order ulps).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from particle_simulator_tpu.engine.state import ParticleState, SimParams
from particle_simulator_tpu.physics.bucket import (
    GridConfig,
    bucket_move_direct_halo,
    bucket_step_nbr,
    chunked_frame_schedule,
    stack9,
)

AXIS_Y, AXIS_X = "dy", "dx"


def factor_mesh(n_devices: int) -> tuple[int, int]:
    """Factor n into the most-square (ny, nx) pair with nx a power of two.

    Bucket counts are powers of two (bucket id = coordinate top bits), so the
    x mesh axis must divide a power of two exactly; the y axis may be any
    size — rows can be padded (pad_rows_for_mesh). Powers of two split
    near-square; odd factors all land on y."""
    nx = 1
    while n_devices % (nx * 2) == 0 and (nx * 2) ** 2 <= n_devices:
        nx *= 2
    return n_devices // nx, nx


def make_mesh(devices=None, n_devices: int | None = None) -> Mesh:
    """A 2D ("dy", "dx") mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    ny, nx = factor_mesh(len(devices))
    return Mesh(np.asarray(devices).reshape(ny, nx), (AXIS_Y, AXIS_X))


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (BY, BX, CAP) bucket-grid state arrays."""
    return NamedSharding(mesh, P(AXIS_Y, AXIS_X, None))


def shard_state(state: ParticleState, mesh: Mesh) -> ParticleState:
    s = grid_sharding(mesh)
    return ParticleState(*(jax.device_put(a, s) for a in state))


def pad_rows_for_mesh(state: ParticleState, mesh: Mesh) -> tuple[ParticleState, int]:
    """Append tombstone bucket rows so the row count divides the mesh's dy
    axis (needed when the device count has non-power-of-two factors).
    Returns (padded_state, original_rows)."""
    ny = mesh.devices.shape[0]
    by = state.x.shape[0]
    target = ny * ((by + ny - 1) // ny)
    if target == by:
        return state, by
    pad = [(0, target - by), (0, 0), (0, 0)]

    def pad_field(a, fill):
        return jnp.pad(a, pad, constant_values=fill)

    return (
        ParticleState(
            x=pad_field(state.x, jnp.uint32(0)),
            y=pad_field(state.y, jnp.uint32(0)),
            vx=pad_field(state.vx, jnp.float32(0)),
            vy=pad_field(state.vy, jnp.float32(0)),
            ty=pad_field(state.ty, jnp.int32(-1)),
        ),
        by,
    )


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------

def _shift_from_prev(x: jnp.ndarray, axis_name: str, n: int) -> jnp.ndarray:
    """Each device receives its lower-index neighbor's payload (device 0 gets
    zeros — the mesh boundary)."""
    if n == 1:
        return jnp.zeros_like(x)
    return jax.lax.ppermute(x, axis_name, [(i, i + 1) for i in range(n - 1)])


def _shift_from_next(x: jnp.ndarray, axis_name: str, n: int) -> jnp.ndarray:
    if n == 1:
        return jnp.zeros_like(x)
    return jax.lax.ppermute(x, axis_name, [(i + 1, i) for i in range(n - 1)])


def exchange_halo(state: ParticleState, ny: int, nx: int) -> ParticleState:
    """(ly, lx, cap) local grid -> (ly+2, lx+2, cap) with neighbor halos.

    Must run inside shard_map over a ("dy", "dx") mesh of shape (ny, nx).
    """
    # encode so that ppermute zero-fill at the mesh boundary = tombstone
    fields = (state.x, state.y, state.vx, state.vy, (state.ty + 1).astype(jnp.int32))

    def pad_axis(a, axis, axis_name, n):
        lo_edge = jax.lax.slice_in_dim(a, 0, 1, axis=axis)
        hi_edge = jax.lax.slice_in_dim(a, a.shape[axis] - 1, a.shape[axis], axis=axis)
        lo_halo = _shift_from_prev(hi_edge, axis_name, n)  # prev device's high edge
        hi_halo = _shift_from_next(lo_edge, axis_name, n)  # next device's low edge
        return jnp.concatenate([lo_halo, a, hi_halo], axis=axis)

    # x-phase first, then y-phase ships x-padded rows => corners propagate
    fields = tuple(pad_axis(a, 1, AXIS_X, nx) for a in fields)
    fields = tuple(pad_axis(a, 0, AXIS_Y, ny) for a in fields)

    x, y, vx, vy, typ = fields
    return ParticleState(x, y, vx, vy, typ - 1)


# ---------------------------------------------------------------------------
# sharded frame runner
# ---------------------------------------------------------------------------

def _local_frame(
    state: ParticleState,
    p: SimParams,
    cfg: GridConfig,
    ny: int,
    nx: int,
) -> ParticleState:
    """Per-device body: steps_per_frame physics steps with halo exchange before
    each step and a migration/rebucket pass on the reference's cadence."""
    ly = state.x.shape[0]
    lx = state.x.shape[1]
    row_offset = jax.lax.axis_index(AXIS_Y).astype(jnp.int32) * ly
    col_offset = jax.lax.axis_index(AXIS_X).astype(jnp.int32) * lx

    def move(s):
        return bucket_move_direct_halo(
            exchange_halo(s, ny, nx), cfg.bx_log2, cfg.by_log2,
            row_offset, col_offset,
        )

    def step(s):
        return bucket_step_nbr(s, stack9(exchange_halo(s, ny, nx)), p)

    # chunked cadence, identical op sequence to the reference's per-step
    # `if i % k == 1: move` schedule without a branch per step
    return chunked_frame_schedule(
        state, p.steps_per_frame, cfg.move_every, step, move,
    )


def make_sharded_frame_fn(cfg: GridConfig, mesh: Mesh, donate: bool = True):
    """Build the jitted multi-device frame runner for a grid config + mesh.

    Returns ``fn(state, p) -> state`` where state is (BY, BX, CAP) sharded
    ``P("dy", "dx", None)`` and p is replicated.
    """
    ny, nx = mesh.devices.shape
    if cfg.bx % nx:
        raise ValueError(f"grid bx={cfg.bx} not divisible by mesh nx={nx}")
    # Rows may be PADDED: bucket counts must be powers of two (bucket id =
    # coordinate top bits), so a non-power-of-two mesh axis can't divide them.
    # Callers append tombstone rows to (ny * ceil(by/ny)); padded rows have
    # global row index >= cfg.by, are never force-visible (they are
    # tombstoned, and the step kernel rejects tombstoned candidates) and
    # never targeted by the move (targets come from coordinate bits < by).
    body = functools.partial(_local_frame, cfg=cfg, ny=ny, nx=nx)
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            ParticleState(*([P(AXIS_Y, AXIS_X, None)] * 5)),
            SimParams(*([P()] * len(SimParams._fields))),
        ),
        out_specs=ParticleState(*([P(AXIS_Y, AXIS_X, None)] * 5)),
    )
    return jax.jit(sharded, donate_argnums=(0,) if donate else ())
