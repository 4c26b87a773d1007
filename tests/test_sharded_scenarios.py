"""The sharded jnp frame program on 2, 4 and 8 virtual CPU devices against the
single-device frame runner, over the scenarios the single-device checks use:
the cursor, sparse occupancy, a hot scene with drops and cross-shard
migration, random boxes with tombstones, and a production-sized slab
(64x64 buckets, so each shard holds many rows).

Bucket layout (``ty``) must agree exactly; positions and velocities within
the f32 summation-order envelope of tests/test_parallel.py (the sharded tile
shape may change XLA's reduction order)."""

import numpy as np
import pytest

import jax

from particle_simulator_tpu.engine.state import SimParams, state_from_numpy
from particle_simulator_tpu.io.frame import PARTICLE_DTYPE, Frame, default_metadata
from particle_simulator_tpu.io.presets import ParticleLattice
from particle_simulator_tpu.parallel.domain import (
    make_mesh,
    make_sharded_frame_fn,
    pad_rows_for_mesh,
    shard_state,
)
from particle_simulator_tpu.physics.bucket import (
    GridConfig,
    bucketize_numpy,
    run_frame_bucket,
    state_to_grid,
)


def _grid(cfg, parts):
    return state_to_grid(state_from_numpy(bucketize_numpy(parts, cfg), cfg.capacity), cfg)


def _lattice(cfg, side, vel, meta=None, seed=3):
    frame = Frame.new()
    if meta is not None:
        frame.header["metadata"] = meta
    m = frame.metadata
    ParticleLattice((side, side), distance_factor=1.1, velocity=vel).hex_square(
        frame, (m.box_width / 2, m.box_height / 2), rng=np.random.default_rng(seed))
    return _grid(cfg, frame.particles), m.copy()


def _random(cfg, n, seed, y_span=0.9, tomb=0.1):
    rng = np.random.default_rng(seed)
    parts = np.zeros(n, dtype=PARTICLE_DTYPE)
    side = int(np.ceil(np.sqrt(n)))
    cells = rng.choice(side * side, n, replace=False)
    jitter = rng.integers(0, 2**32 // (side * 8), (2, n), dtype=np.uint64)
    off = int(0.05 * 2**32)
    parts["x"] = (off + (cells % side) * (int(0.9 * 2**32) // side) + jitter[0]).astype(np.uint32)
    parts["y"] = (off + (cells // side) * (int(y_span * 2**32) // side) + jitter[1]).astype(np.uint32)
    parts["vx"] = rng.normal(0, 50, n)
    parts["vy"] = rng.normal(0, 50, n)
    parts["ty"] = rng.integers(0, 2, n)
    parts["ty"][rng.random(n) < tomb] = -1
    meta = default_metadata()
    meta["step_dt"] = 10e-15
    return _grid(cfg, parts), meta


def scenario(name):
    """(grid config, state, metadata record, steps per frame)."""
    if name == "cursor":
        cfg = GridConfig(4, 4, 4, move_every=4)
        meta = Frame.new().metadata.copy()
        meta["cursor_pos"] = (0.45, 0.55)
        meta["cursor_size"] = 0.3
        state, meta = _lattice(cfg, 12, (0.0, 40.0), meta=meta)
        return cfg, state, meta, 10
    if name == "sparse":
        cfg = GridConfig(4, 4, 16, move_every=4)
        state, meta = _random(cfg, 220, 5, y_span=0.35, tomb=0.0)
        return cfg, state, meta, 10
    if name == "hot":
        cfg = GridConfig(4, 4, 8, move_every=2)
        state, meta = _lattice(cfg, 16, (500.0, 400.0))
        return cfg, state, meta, 9
    if name == "random":
        cfg = GridConfig(4, 4, 8, move_every=4)
        state, meta = _random(cfg, 600, 42)
        return cfg, state, meta, 10
    if name == "production_slab":
        cfg = GridConfig(6, 6, 8, move_every=4)
        state, meta = _random(cfg, 2000, 3, tomb=0.0)
        return cfg, state, meta, 6
    raise KeyError(name)


@pytest.mark.parametrize("n_devices", [2, 4, 8])
@pytest.mark.parametrize("name", ["cursor", "sparse", "hot", "random", "production_slab"])
def test_sharded_scenario_matches_single_device(name, n_devices):
    cfg, state, meta, steps = scenario(name)
    params = SimParams.from_record(meta)._replace(steps_per_frame=np.int32(steps))
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda s, p: run_frame_bucket(s, p, move_every=cfg.move_every))(state, params))

    mesh = make_mesh(n_devices=n_devices)
    padded, rows = pad_rows_for_mesh(state, mesh)
    fn = make_sharded_frame_fn(cfg, mesh, donate=False)
    got = jax.tree.map(lambda a: np.asarray(a)[:rows], fn(shard_state(padded, mesh), params))

    np.testing.assert_array_equal(ref.ty, got.ty)
    live = ref.ty >= 0
    assert live.any()
    for f in ("x", "y"):
        delta = np.abs(getattr(ref, f).astype(np.int64) - getattr(got, f).astype(np.int64))
        assert delta[live].max() <= 8, f
    np.testing.assert_allclose(ref.vx[live], got.vx[live], rtol=1e-3, atol=0.05)
    np.testing.assert_allclose(ref.vy[live], got.vy[live], rtol=1e-3, atol=0.05)


@pytest.mark.parametrize("n_devices", [3, 6])
def test_sharded_odd_mesh_pads_rows(n_devices):
    """Device counts with odd factors put them on the mesh's y axis and pad
    the grid with tombstone rows; the padded rows stay dead and the live
    rows match the single-device run."""
    cfg, state, meta, steps = scenario("random")
    params = SimParams.from_record(meta)._replace(steps_per_frame=np.int32(steps))
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda s, p: run_frame_bucket(s, p, move_every=cfg.move_every))(state, params))
    mesh = make_mesh(n_devices=n_devices)
    padded, rows = pad_rows_for_mesh(state, mesh)
    assert padded.x.shape[0] % mesh.devices.shape[0] == 0
    out = make_sharded_frame_fn(cfg, mesh, donate=False)(shard_state(padded, mesh), params)
    ty = np.asarray(out.ty)
    assert (ty[rows:] < 0).all()
    np.testing.assert_array_equal(ref.ty, ty[:rows])
    live = ref.ty >= 0
    np.testing.assert_allclose(ref.vx[live], np.asarray(out.vx)[:rows][live],
                               rtol=1e-3, atol=0.05)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_sharded_frame_keeps_the_cadence_across_calls(n_devices):
    """Two sharded frames of 7 steps (move_every 2, so the second frame
    starts mid-cadence as the engine's frames do) give what two single-device
    frames give: the schedule restarts per frame identically on every
    shard."""
    cfg, state, meta, _ = scenario("hot")
    params = SimParams.from_record(meta)._replace(steps_per_frame=np.int32(7))
    single = jax.jit(lambda s, p: run_frame_bucket(s, p, move_every=cfg.move_every))
    ref = jax.tree.map(np.asarray, single(single(state, params), params))
    mesh = make_mesh(n_devices=n_devices)
    fn = make_sharded_frame_fn(cfg, mesh, donate=False)
    got = jax.tree.map(np.asarray, fn(fn(shard_state(state, mesh), params), params))
    np.testing.assert_array_equal(ref.ty, got.ty)
    live = ref.ty >= 0
    assert live.any()
    for f in ("x", "y"):
        delta = np.abs(getattr(ref, f).astype(np.int64) - getattr(got, f).astype(np.int64))
        assert delta[live].max() <= 8, f
    np.testing.assert_allclose(ref.vx[live], got.vx[live], rtol=1e-3, atol=0.05)
    np.testing.assert_allclose(ref.vy[live], got.vy[live], rtol=1e-3, atol=0.05)
