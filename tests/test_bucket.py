"""MatrixBuckets path tests: bucketize, neighborhood forces, lazy rebucketing.

Mirrors the equivalence oracle the reference relied on informally: the bucket
kernel must agree with the all-pairs kernel whenever every interacting pair is
within the 3x3 bucket neighborhood (doc/project.typ:245-341).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from particle_simulator_tpu.engine.state import SimParams, state_from_numpy, state_to_numpy
from particle_simulator_tpu.io.frame import Frame, PARTICLE_DTYPE
from particle_simulator_tpu.io.presets import ParticleLattice
from particle_simulator_tpu.physics.bucket import (
    GridConfig,
    REFERENCE_GRID,
    bucket_move,
    bucket_step,
    bucketize_numpy,
    run_frame_bucket,
    state_to_grid,
)
from particle_simulator_tpu.physics.step import allpairs_step


def droplet_frame(nx=6, ny=6, vel=(0.0, 20.0), seed=0):
    frame = Frame.new()
    meta = frame.metadata
    lat = ParticleLattice((nx, ny), distance_factor=1.1, velocity=vel)
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2), rng=np.random.default_rng(seed))
    return frame


def grid_state(parts, cfg=REFERENCE_GRID):
    layout = bucketize_numpy(parts, cfg)
    return state_to_grid(state_from_numpy(layout, cfg.capacity), cfg)


def live_sorted(parts):
    """Live particles sorted by (x, y) for order-insensitive comparison."""
    live = parts[parts["ty"] >= 0]
    return np.sort(live, order=["x", "y", "vx"])


def test_bucketize_assigns_top_bits():
    cfg = REFERENCE_GRID
    parts = np.zeros(3, dtype=PARTICLE_DTYPE)
    # bucket coordinates are the top 6 bits of each u32 coordinate
    parts["x"] = [0x04000000, 0xFC000000, 0x80000001]
    parts["y"] = [0x00000000, 0xFC000000, 0x80000001]
    parts["ty"] = [0, 1, 2]
    out = bucketize_numpy(parts, cfg)

    assert out[(1 + 0 * 64) * 16]["ty"] == 0  # bx=1, by=0
    assert out[(63 + 63 * 64) * 16]["ty"] == 1  # bx=63, by=63
    assert out[(32 + 32 * 64) * 16]["ty"] == 2
    assert np.count_nonzero(out["ty"] >= 0) == 3


def test_bucketize_overflow_drops_extras():
    cfg = GridConfig(2, 2, cap=4)
    parts = np.zeros(7, dtype=PARTICLE_DTYPE)
    parts["x"] = 0x10000000  # all in the same bucket
    parts["y"] = 0x10000000
    parts["vx"] = np.arange(7)
    parts["ty"] = 0
    out = bucketize_numpy(parts, cfg)
    kept = out[out["ty"] >= 0]
    assert len(kept) == 4
    np.testing.assert_array_equal(kept["vx"], [0, 1, 2, 3])  # first-kept order


def test_bucket_step_matches_allpairs_for_compact_droplet():
    # droplet spans only a couple of buckets -> every pair is inside the 3x3
    # neighborhood and the two data structures compute the same forces
    frame = droplet_frame()
    parts = frame.particles.copy()
    meta = frame.metadata.copy()
    meta["step_dt"] = 10e-15
    p = SimParams.from_record(meta)

    flat = state_from_numpy(parts, len(parts))
    grid = grid_state(parts)

    step_flat = jax.jit(allpairs_step)
    step_grid = jax.jit(bucket_step)
    # 10 steps: long enough to exercise force + integration interplay, short
    # enough that chaotic amplification of f32 summation-order ulps (the stiff
    # r^-14 force roughly doubles any perturbation each step) stays inside the
    # physical envelope below on every backend (CPU and GPU fuse differently).
    for _ in range(10):
        flat = step_flat(flat, p)
        grid = step_grid(grid, p)

    a = live_sorted(state_to_numpy(flat))
    b = live_sorted(state_to_numpy(grid))
    assert len(a) == len(b) == len(parts)
    # same particles modulo f32 summation order; the stiff r^-14 force amplifies
    # ulp-level differences, so compare against a physical envelope: 1e-3 of the
    # equilibrium distance, in u32 fixed-point units
    r0 = frame.metadata.species(0).force0_r()
    tol_u32 = r0 * 1e-3 / float(meta["box_width"]) * 4294967295.0
    np.testing.assert_allclose(
        a["x"].astype(np.float64), b["x"].astype(np.float64), rtol=0, atol=tol_u32
    )
    np.testing.assert_allclose(
        a["y"].astype(np.float64), b["y"].astype(np.float64), rtol=0, atol=tol_u32
    )
    np.testing.assert_allclose(a["vx"], b["vx"], rtol=1e-3, atol=0.5)
    np.testing.assert_allclose(a["vy"], b["vy"], rtol=1e-3, atol=0.5)


def test_bucket_move_rehomes_crossers():
    cfg = REFERENCE_GRID
    parts = np.zeros(2, dtype=PARTICLE_DTYPE)
    # particle 0 sits in bucket (0,0) but its position says bucket (1,0)
    parts["x"] = [0x04000001, 0x00000001]
    parts["y"] = [0x00000001, 0x00000001]
    parts["vx"] = [7.0, 8.0]
    parts["ty"] = [0, 1]
    layout = np.zeros(cfg.capacity, dtype=PARTICLE_DTYPE)
    layout["ty"] = -1
    layout[0] = parts[0]  # misplaced into bucket 0
    layout[1] = parts[1]  # correctly in bucket 0

    grid = state_to_grid(state_from_numpy(layout, cfg.capacity), cfg)
    moved = state_to_numpy(jax.jit(bucket_move)(grid))

    # particle 0 pulled into bucket (bx=1, by=0); particle 1 stays in bucket 0
    b1 = moved[1 * cfg.cap : 2 * cfg.cap]
    b0 = moved[0 : cfg.cap]
    assert (b1["vx"] == 7.0).any()
    assert (b0["vx"] == 8.0).any()
    assert np.count_nonzero(moved["ty"] >= 0) == 2


def test_bucket_move_preserves_droplet():
    frame = droplet_frame(nx=8, ny=8)
    parts = frame.particles.copy()
    grid = grid_state(parts)
    moved = jax.jit(bucket_move)(grid)
    a = live_sorted(state_to_numpy(grid))
    b = live_sorted(state_to_numpy(moved))
    np.testing.assert_array_equal(a, b)


def test_bucket_move_drops_fast_escapers():
    # a particle more than one bucket away from home is lost — documented
    # reference behavior (kernel_bucket.cuh:30-31 keeps the pull local)
    cfg = REFERENCE_GRID
    layout = np.zeros(cfg.capacity, dtype=PARTICLE_DTYPE)
    layout["ty"] = -1
    p = np.zeros((), dtype=PARTICLE_DTYPE)
    p["x"] = 0x20000000  # bucket bx=8
    p["y"] = 0x00000001
    p["ty"] = 0
    layout[0] = p  # stored in bucket 0: 8 buckets from home
    grid = state_to_grid(state_from_numpy(layout, cfg.capacity), cfg)
    moved = state_to_numpy(jax.jit(bucket_move)(grid))
    assert np.count_nonzero(moved["ty"] >= 0) == 0


def test_run_frame_bucket_full_frame():
    frame = droplet_frame(nx=10, ny=10, vel=(0.0, 50.0))
    parts = frame.particles.copy()
    meta = frame.metadata.copy()
    meta["steps_per_frame"] = 40
    p = SimParams.from_record(meta)

    grid = grid_state(parts)
    out = jax.jit(run_frame_bucket)(grid, p)
    final = state_to_numpy(out)
    live = final[final["ty"] >= 0]
    assert len(live) == len(parts)  # nothing lost at droplet speeds
    assert np.all(np.isfinite(live["vx"]))
    # the droplet did evolve
    assert not np.array_equal(live_sorted(final)["x"], live_sorted(parts)["x"])


def test_bucket_move_sorted_matches_pull():
    """The global-sort rebucket pass is bit-identical to the pull-based one,
    including overflow-drop and >1-bucket drift-drop semantics."""
    from particle_simulator_tpu.physics.bucket import bucket_move_sorted

    cfg = GridConfig(4, 4, 8)
    frame = Frame.new()
    meta = frame.metadata
    lat = ParticleLattice((20, 20), distance_factor=1.3, velocity=(0.0, 400.0))
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2), rng=np.random.default_rng(5))
    layout = bucketize_numpy(frame.particles, cfg)
    state = state_to_grid(state_from_numpy(layout, cfg.capacity), cfg)
    p = SimParams.from_record(meta.copy())
    for _ in range(30):
        state = jax.jit(bucket_step)(state, p)

    a = jax.tree.map(np.asarray, jax.jit(bucket_move)(state))
    b = jax.tree.map(np.asarray, jax.jit(bucket_move_sorted)(state))
    for name, u, v in zip(a._fields, a, b):
        np.testing.assert_array_equal(u, v, err_msg=f"field {name}")
