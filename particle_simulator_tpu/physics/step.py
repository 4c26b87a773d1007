"""Step functions: all-pairs (CompactArray) path and whole-frame runners.

The reference's ``DataStructure::CompactArray`` kernel is an all-pairs O(N^2)
force loop, one thread per particle (kernel_compact.cuh:4-42). Here the same
computation is one (N, N) pair tile of elementwise math reduced over j under
jit. XLA stores that tile: one (N, N) f32 array per step, 1 GiB at 16k
particles (chip_smoke.py's all-pairs phase prints ``memory_analysis``), which
bounds how large a CompactArray scene fits. A tiled all-pairs kernel that
reduces each tile in place would remove it (ROADMAP, "worth rewriting").

A whole editor frame — ``steps_per_frame`` physics steps, default 100 — is ONE
device dispatch: ``lax.fori_loop`` with a *traced* trip count so the editor can
change steps_per_frame live without recompiling (the analog of
``compact_kernel_run_async``'s ping-pong loop, kernel_compact.cuh:78-92; the
ping-pong double buffering itself is unnecessary under XLA, which owns scheduling
and buffer reuse).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from particle_simulator_tpu.engine.state import ParticleState, SimParams
from particle_simulator_tpu.physics.mie import (
    cursor_force,
    leapfrog_apply,
    pair_force_accum,
    wall_force,
)


def external_forces(state: ParticleState, p: SimParams):
    """Cursor repulsion + wall forces — shared by every data-structure path
    (kernel_compact.cuh:10-24, kernel_bucket.cuh:54-69)."""
    fcx, fcy = cursor_force(state.x, state.y, p)
    fwx, fwy = wall_force(state.x, state.y, p)
    return fcx + fwx, fcy + fwy


def allpairs_step(state: ParticleState, p: SimParams) -> ParticleState:
    """One physics step, all-pairs forces (CompactArray semantics)."""
    n = state.x.shape[0]
    fx, fy = external_forces(state, p)

    row = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    pfx, pfy = pair_force_accum(
        state.x, state.y, state.ty, state.x, state.y, state.ty, p, self_mask=row == col
    )
    fx = fx + pfx
    fy = fy + pfy

    nx, ny, nvx, nvy = leapfrog_apply(state.x, state.y, state.vx, state.vy, state.ty, fx, fy, p)
    return ParticleState(nx, ny, nvx, nvy, state.ty)


def allpairs_step_euler(state: ParticleState, p: SimParams) -> ParticleState:
    """allpairs_step with the explicit-Euler update instead of leapfrog —
    the broken integrator from the reference report's stability analysis
    (doc/project.typ:208); see physics/mie.py euler_apply. Test-only."""
    from particle_simulator_tpu.physics.mie import euler_apply

    n = state.x.shape[0]
    fx, fy = external_forces(state, p)
    row = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    pfx, pfy = pair_force_accum(
        state.x, state.y, state.ty, state.x, state.y, state.ty, p, self_mask=row == col
    )
    nx, ny, nvx, nvy = euler_apply(
        state.x, state.y, state.vx, state.vy, state.ty, fx + pfx, fy + pfy, p
    )
    return ParticleState(nx, ny, nvx, nvy, state.ty)


def run_frame(state: ParticleState, p: SimParams, step_fn=allpairs_step) -> ParticleState:
    """Advance one frame = p.steps_per_frame physics steps, fully on device.

    The trip count is a traced value (lowers to a while loop), so live editor
    changes to steps_per_frame don't recompile.
    """
    return jax.lax.fori_loop(
        0, p.steps_per_frame, lambda _, s: step_fn(s, p), state
    )


@functools.partial(jax.jit, static_argnames=("step_fn",), donate_argnames=("state",))
def run_frame_jit(state: ParticleState, p: SimParams, step_fn=allpairs_step) -> ParticleState:
    """Jitted frame runner with donated state buffers (in-place ping-pong on
    device, the analog of the reference's D_BUFFER_0/1/INTERNAL rotation)."""
    return run_frame(state, p, step_fn)
