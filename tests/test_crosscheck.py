"""The jnp step, all-pairs and rebucket paths against independent references,
over the scenarios the engine meets: capacity sweeps, the cursor, tombstones,
random boxes and parameters, sparse and non-contiguous occupancy, hot scenes
that overflow and drift.

- steps: physics/crosscheck.py against the NumPy oracle (physics/oracle.py),
  at the CPU suite's tolerances;
- rebucket: ``bucket_move_direct`` (the pass the frame runners use) bit for
  bit against the argsort pull pass ``bucket_move`` and the NumPy host pass
  (physics/host.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from particle_simulator_tpu.engine.state import (
    ParticleState,
    SimParams,
    state_from_numpy,
)
from particle_simulator_tpu.io.frame import PARTICLE_DTYPE, Frame, default_metadata
from particle_simulator_tpu.io.presets import ParticleLattice
from particle_simulator_tpu.physics import crosscheck
from particle_simulator_tpu.physics.bucket import (
    GridConfig,
    bucket_move,
    bucket_move_direct,
    bucket_step,
    bucketize_numpy,
    state_to_grid,
)
from particle_simulator_tpu.physics.host import host_bucket_move


def lattice_grid(cfg, nx=20, ny=20, vel=(0.0, 30.0), seed=1, center=None):
    frame = Frame.new()
    meta = frame.metadata
    lat = ParticleLattice((nx, ny), distance_factor=1.1, velocity=vel)
    if center is None:
        center = (meta.box_width / 2, meta.box_height / 2)
    lat.hex_square(frame, center, rng=np.random.default_rng(seed))
    layout = bucketize_numpy(frame.particles, cfg)
    state = state_to_grid(state_from_numpy(layout, cfg.capacity), cfg)
    return state, meta.copy()


def random_grid(cfg, rng, n, meta, y_span=0.9, tomb=0.1):
    """Spread-out random particles (no overlapping pairs) confined to the
    central part of the box: a particle jammed against a wall sits on the
    r^-m singularity, where one ulp of formulation difference (the device's
    exp/log form vs the oracle's powf) becomes a huge force delta in both."""
    parts = np.zeros(n, dtype=PARTICLE_DTYPE)
    side = int(np.ceil(np.sqrt(n)))
    cells = rng.choice(side * side, n, replace=False)
    jitter = rng.integers(0, 2**32 // (side * 8), (2, n), dtype=np.uint64)
    span_x, span_y = int(0.9 * 2**32), int(y_span * 2**32)
    off = int(0.05 * 2**32)
    parts["x"] = (off + ((cells % side) * (span_x // side) + jitter[0])).astype(np.uint32)
    parts["y"] = (off + ((cells // side) * (span_y // side) + jitter[1])).astype(np.uint32)
    parts["vx"] = rng.normal(0, 100, n)
    parts["vy"] = rng.normal(0, 100, n)
    parts["ty"] = rng.integers(0, 2, n)
    parts["ty"][rng.random(n) < tomb] = -1
    layout = bucketize_numpy(parts, cfg)
    return state_to_grid(state_from_numpy(layout, cfg.capacity), cfg), meta


def assert_ok(result):
    assert result["ok"], result
    assert result["compared"] > 0


# ---------------------------------------------------------------------------
# bucket step vs oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [GridConfig(4, 4, 16), GridConfig(3, 3, 8), GridConfig(5, 4, 4)],
                         ids=["16x16x16", "8x8x8", "32x16x4"])
def test_bucket_step_matches_oracle(cfg):
    state, meta = lattice_grid(cfg, nx=16, ny=16)
    assert_ok(crosscheck.bucket_step_vs_oracle(state, meta))


def test_bucket_step_with_cursor_matches_oracle():
    state, meta = lattice_grid(GridConfig(4, 4, 16))
    meta["cursor_pos"] = (0.5, 0.5)
    meta["cursor_size"] = 0.3
    assert_ok(crosscheck.bucket_step_vs_oracle(state, meta))


def test_bucket_step_tombstones_inert():
    state, meta = lattice_grid(GridConfig(4, 4, 16), nx=8, ny=8)
    got = jax.tree.map(np.asarray, jax.jit(bucket_step)(state, SimParams.from_record(meta)))
    dead = np.asarray(state.ty) < 0
    for name in ParticleState._fields:
        np.testing.assert_array_equal(getattr(got, name)[dead],
                                      np.asarray(getattr(state, name))[dead], err_msg=name)


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_bucket_step_random_scenes_match_oracle(trial):
    """Random boxes, time steps, species parameters, velocities, occupancy
    and tombstones; the cursor is on in trial 2."""
    rng = np.random.default_rng(42 + trial)
    cfg = GridConfig(4, 4, 8)
    meta = default_metadata()
    meta["box_width"] = rng.uniform(20e-9, 200e-9)
    meta["box_height"] = meta["box_width"]
    meta["step_dt"] = rng.uniform(1e-15, 10e-15)
    meta["particles"][0]["sigma"] = rng.uniform(2e-10, 5e-10)
    meta["particles"][0]["n"] = rng.uniform(10.0, 16.0)
    meta["particles"][0]["m"] = rng.uniform(5.0, 7.0)
    if trial == 2:
        meta["cursor_pos"] = (0.5, 0.5)
        meta["cursor_size"] = 0.4
    state, meta = random_grid(cfg, rng, int(rng.integers(50, 400)), meta)
    assert_ok(crosscheck.bucket_step_vs_oracle(state, meta))


def test_bucket_step_sparse_occupancy_matches_oracle():
    """Particles in the lower 40% of the box: low occupancy (max slot << cap)
    and whole dead bucket rows."""
    cfg = GridConfig(4, 4, 16)
    state, meta = random_grid(cfg, np.random.default_rng(5), 220, default_metadata(),
                              y_span=0.35, tomb=0.0)
    ty = np.asarray(state.ty)
    assert ((ty >= 0) * (np.arange(cfg.cap) + 1)).max() <= 8
    assert (ty.max(axis=(1, 2)) < 0).any()
    assert_ok(crosscheck.bucket_step_vs_oracle(state, meta))


def test_bucket_step_non_contiguous_slots_match_oracle():
    """Live particles scattered to high slots of their buckets (legal states
    arise packed, but the step must not assume it)."""
    cfg = GridConfig(4, 4, 16)
    state, meta = random_grid(cfg, np.random.default_rng(9), 220, default_metadata(),
                              y_span=0.35, tomb=0.0)
    perm = np.random.default_rng(3).permutation(cfg.cap)
    state = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[:, :, perm]), state)
    ty = np.asarray(state.ty)
    assert ((ty >= 0) * (np.arange(cfg.cap) + 1)).max() > (ty >= 0).sum(axis=2).max()
    assert_ok(crosscheck.bucket_step_vs_oracle(state, meta))


def test_neighbour_candidates_cover_the_3x3_window():
    ty = np.full((4, 4, 2), -1, np.int32)
    ty[0, 0, 0] = ty[1, 1, 1] = ty[3, 3, 0] = 0
    rows = np.array([0, (1 * 4 + 1) * 2 + 1])
    cands = crosscheck.neighbour_candidates(ty, rows)
    assert cands.shape == (2, 18)
    assert sorted(c for c in cands[0] if c >= 0) == [0, 11]
    assert sorted(c for c in cands[1] if c >= 0) == [0, 11]  # (3,3) is 2 away


# ---------------------------------------------------------------------------
# all-pairs step vs oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side,sample,cursor", [(10, None, False), (12, None, True),
                                                (17, 100, False)],
                         ids=["100", "144_cursor", "289_sampled"])
def test_allpairs_matches_oracle(side, sample, cursor):
    """Live particles padded to the engine's 1024-slot capacity (tombstone
    tail), against the oracle on every row or a seeded sample."""
    frame = Frame.new()
    meta = frame.metadata
    ParticleLattice((side, side), distance_factor=1.1, velocity=(0.0, 30.0)).hex_square(
        frame, (meta.box_width / 2, meta.box_height / 2), rng=np.random.default_rng(2))
    meta = meta.copy()
    if cursor:
        meta["cursor_pos"] = (0.5, 0.5)
        meta["cursor_size"] = 0.3
    result = crosscheck.allpairs_vs_oracle(frame.particles, meta, sample=sample)
    assert_ok(result)
    assert result["compared"] == (sample or side * side)


def test_compare_reports_each_violation():
    parts = np.zeros(4, dtype=PARTICLE_DTYPE)
    parts["vx"] = 1.0
    assert crosscheck.compare(parts, parts)["ok"]
    for field, value in (("ty", -1), ("x", 5), ("vx", 1.001), ("vy", np.nan)):
        bad = parts.copy()
        bad[field][0] = value
        assert not crosscheck.compare(bad, parts)["ok"], field


# ---------------------------------------------------------------------------
# rebucket: direct pass vs pull pass vs host pass, bit for bit
# ---------------------------------------------------------------------------

def assert_moves_agree(state):
    direct = jax.tree.map(np.asarray, jax.jit(bucket_move_direct)(state))
    pull = jax.tree.map(np.asarray, jax.jit(bucket_move)(state))
    host = host_bucket_move(jax.tree.map(np.asarray, state))
    for name in ParticleState._fields:
        np.testing.assert_array_equal(getattr(direct, name), getattr(pull, name),
                                      err_msg=f"pull {name}")
        np.testing.assert_array_equal(getattr(direct, name), np.asarray(getattr(host, name)),
                                      err_msg=f"host {name}")
    return direct


def stepped(state, meta, n):
    step = jax.jit(bucket_step)
    p = SimParams.from_record(meta)
    for _ in range(n):
        state = step(state, p)
    return state


@pytest.mark.parametrize("cfg,vel", [(GridConfig(4, 4, 8), (0.0, 400.0)),
                                     (GridConfig(5, 4, 8), (500.0, 400.0)),
                                     (GridConfig(4, 4, 16), (500.0, 400.0))],
                         ids=["16x16x8_vertical", "32x16x8_hot", "16x16x16_hot"])
def test_move_after_hot_steps_is_bit_identical(cfg, vel):
    """A hot lattice stepped 30 times: crossings in x and y, overflow drops
    and drift drops."""
    state, meta = lattice_grid(cfg, vel=vel, seed=5)
    assert_moves_agree(stepped(state, meta, 30))


def test_move_sparse_corner_is_bit_identical():
    """A scene in one corner of the box: most of the grid is vacuum and must
    come out as all-tombstone; the survivors are placed identically."""
    cfg = GridConfig(5, 4, 8)
    meta = Frame.new().metadata
    state, meta = lattice_grid(cfg, nx=6, ny=6, vel=(900.0, -700.0), seed=11,
                               center=(meta.box_width / 8, meta.box_height / 8))
    out = assert_moves_agree(stepped(state, meta, 20))
    assert (out.ty >= 0).sum() > 0


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_move_random_drift_is_bit_identical(trial):
    """Random occupancy and species, positions drifted by up to +-1 bucket
    (the state a move exists to fix) and further (must drop)."""
    rng = np.random.default_rng(7 + trial)
    cfg = GridConfig(4, 4, 8)
    n = int(rng.integers(100, 800))
    parts = np.zeros(n, dtype=PARTICLE_DTYPE)
    parts["x"] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    parts["y"] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    parts["vx"] = rng.normal(0, 100, n)
    parts["ty"] = rng.integers(0, 3, n)
    state = state_to_grid(state_from_numpy(bucketize_numpy(parts, cfg), cfg.capacity), cfg)
    drift = rng.integers(-(2**27), 2**27, state.x.shape, dtype=np.int64)
    x2 = (np.asarray(state.x).astype(np.int64) + drift) % 2**32
    assert_moves_agree(state._replace(x=jnp.asarray(x2.astype(np.uint32))))


def test_move_dead_rows_are_bit_identical():
    """A scene confined to the top bucket rows and the left half: whole
    blocks of the output have no live source in their neighbourhood."""
    rng = np.random.default_rng(11)
    cfg = GridConfig(4, 5, 8)
    n = 400
    parts = np.zeros(n, dtype=PARTICLE_DTYPE)
    parts["x"] = rng.integers(0, 2**31, n, dtype=np.uint64).astype(np.uint32)
    parts["y"] = rng.integers(0, 2**32 // 10, n, dtype=np.uint64).astype(np.uint32)
    parts["vx"] = rng.normal(0, 100, n)
    parts["ty"] = rng.integers(0, 2, n)
    state = state_to_grid(state_from_numpy(bucketize_numpy(parts, cfg), cfg.capacity), cfg)
    drift = rng.integers(-(2**27), 2**27, state.x.shape, dtype=np.int64)
    y2 = (np.asarray(state.y).astype(np.int64) + drift) % 2**32
    state = state._replace(y=jnp.asarray(y2.astype(np.uint32)))
    assert np.nonzero((np.asarray(state.ty) >= 0).any(axis=(1, 2)))[0].max() < 8
    assert_moves_agree(state)


@pytest.mark.parametrize("by,bx,cap", [(16, 8, 4), (32, 16, 8), (8, 32, 16)])
def test_move_heavy_drift_geometries_are_bit_identical(by, bx, cap):
    """Every slot jittered up to one bucket in x and y around its own
    bucket: overflow ranks, >1-bucket drifters, tombstones and grid-edge
    cells, over three grid geometries."""
    rng = np.random.default_rng(0)
    n = by * bx * cap
    bxb, byb = int(np.log2(bx)), int(np.log2(by))
    iy, ix, _ = np.meshgrid(np.arange(by), np.arange(bx), np.arange(cap), indexing="ij")
    jx = rng.integers(-(1 << (32 - bxb)), 1 << (32 - bxb), n).astype(np.int64)
    jy = rng.integers(-(1 << (32 - byb)), 1 << (32 - byb), n).astype(np.int64)
    x = ((ix.ravel().astype(np.int64) << (32 - bxb)) + (1 << (31 - bxb)) + jx * 2) % (1 << 32)
    y = ((iy.ravel().astype(np.int64) << (32 - byb)) + (1 << (31 - byb)) + jy * 2) % (1 << 32)
    ty = np.where(rng.random(n) < 0.6, rng.integers(0, 2, n), -1).astype(np.int32)
    state = ParticleState(
        x=jnp.asarray(x.astype(np.uint32)).reshape(by, bx, cap),
        y=jnp.asarray(y.astype(np.uint32)).reshape(by, bx, cap),
        vx=jnp.asarray(rng.normal(size=n).astype(np.float32)).reshape(by, bx, cap),
        vy=jnp.zeros((by, bx, cap), jnp.float32),
        ty=jnp.asarray(ty).reshape(by, bx, cap),
    )
    assert_moves_agree(state)
