"""Device-side readback compaction (ops/readback.py + the Simulator ticket
path): the dense-pack readback must reproduce the full-grid host mask
byte-for-byte — outbound wire frames are a frozen contract
(frontend.hpp:50-56 compaction semantics; CLAUDE.md wire invariants)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from particle_simulator_tpu.engine.simulator import ReadbackTicket, Simulator
from particle_simulator_tpu.engine.state import ParticleState, state_to_numpy
from particle_simulator_tpu.ops.readback import (
    dense_readback,
    dense_to_particles,
    pow2_at_least,
)
from particle_simulator_tpu.scenes.library import _scene


def _random_state(rng, shape, density):
    # Real grid states keep each bucket's live particles in ascending slots
    # (bucketize_numpy + all three rebucket passes — CLAUDE.md invariant);
    # the dense-pack readback depends on it, so generate to the contract:
    # a random count per bucket, occupying the slot prefix.
    by, bx, cap = shape
    cnt = rng.binomial(cap, density, (by, bx))
    occ = np.arange(cap)[None, None, :] < cnt[..., None]
    return ParticleState(
        x=jnp.asarray(rng.integers(0, 2**32, shape, dtype=np.uint32)),
        y=jnp.asarray(rng.integers(0, 2**32, shape, dtype=np.uint32)),
        vx=jnp.asarray(rng.normal(size=shape).astype(np.float32)),
        vy=jnp.asarray(rng.normal(size=shape).astype(np.float32)),
        ty=jnp.asarray(np.where(occ, rng.integers(0, 5, shape), -1).astype(np.int32)),
    )


def _check_dense(st, kcap=None, ncap=None):
    """dense_readback against the host-mask ground truth; returns scalars."""
    ref = state_to_numpy(st)
    mask = ref["ty"] >= 0
    ref_counts = (np.asarray(st.ty) >= 0).sum(axis=-1)
    total_ref = int(mask.sum())

    kcap = pow2_at_least(int(ref_counts.max(initial=0))) if kcap is None else kcap
    ncap = pow2_at_least(total_ref) if ncap is None else ncap
    scalars, packed = dense_readback(st, kcap, ncap)
    mx, total = (int(v) for v in np.asarray(scalars))
    assert mx == int(ref_counts.max(initial=0))
    assert total == total_ref
    live = dense_to_particles(total, ParticleState(*jax.device_get(tuple(packed))))
    for f in ("x", "y", "vx", "vy", "ty"):
        assert np.array_equal(live[f], ref[f][mask]), f
    # the pad tail past ``total`` is tombstoned
    assert (np.asarray(packed.ty)[total:] == -1).all()
    return mx, total


@pytest.mark.parametrize("density", [0.0, 0.07, 0.5, 0.93, 1.0])
def test_dense_pack_matches_host_mask(density):
    rng = np.random.default_rng(int(density * 100))
    _check_dense(_random_state(rng, (8, 16, 8), density))


def test_dense_pack_empty_bucket_runs():
    """Leading/trailing/interior runs of EMPTY buckets stack their start
    marks on one offset — the bucket_of cumsum must still name the right
    owner for every packed position."""
    rng = np.random.default_rng(3)
    st = _random_state(rng, (4, 8, 8), 0.6)
    ty = np.asarray(st.ty).copy()
    ty[0, :, :] = -1          # leading empty row
    ty[-1, :, :] = -1         # trailing empty row
    ty[2, 1:5, :] = -1        # interior empty run
    st = st._replace(ty=jnp.asarray(ty))
    _check_dense(st)


def test_dense_pack_ncap_padding():
    """ncap far above the live total: pack unaffected, tail tombstoned."""
    rng = np.random.default_rng(11)
    st = _random_state(rng, (4, 4, 8), 0.4)
    total = int((np.asarray(st.ty) >= 0).sum())
    _check_dense(st, ncap=pow2_at_least(total) * 4)


def test_scalars_exact_even_when_kcap_overflows():
    """kcap smaller than the fullest bucket: the pack is garbage but the
    scalars stay exact — that is what makes overflow detectable for the
    host retry."""
    rng = np.random.default_rng(7)
    st = _random_state(rng, (4, 8, 8), 0.9)
    ref_counts = (np.asarray(st.ty) >= 0).sum(axis=-1)
    scalars, packed = dense_readback(st, 2, pow2_at_least(int(ref_counts.sum())))
    mx, total = (int(v) for v in np.asarray(scalars))
    assert mx == int(ref_counts.max(initial=0)) and mx > 2
    assert total == int(ref_counts.sum())


def _frames_equal(a, b):
    assert a.particle_count == b.particle_count
    assert a.bytes == b.bytes


def test_simulator_fast_path_matches_slow_path():
    """The ticket path (force_device_readback drives it on the CPU test
    backend) ships byte-identical frames to the full-grid readback, across
    fresh loads and stepped states."""
    frame = _scene(24, 24, distance_factor=1.1, speed=20.0, box_fill=0.5)
    frame.metadata.steps_per_frame = 3

    slow = Simulator()
    slow.load_frame(frame)
    fast = Simulator()
    fast.force_device_readback = True
    fast.load_frame(frame)

    _frames_equal(fast.read_frame(), slow.read_frame())
    for _ in range(3):
        slow.frame_async()
        fast.frame_async()
        _frames_equal(fast.read_frame(), slow.read_frame())

    # explicit ticket round-trip (the daemon's enqueue/ship split)
    t = fast.start_readback()
    assert isinstance(t, ReadbackTicket) and t.packed is not None
    _frames_equal(fast.read_frame(t), slow.read_frame())


def test_simulator_kcap_overflow_grows_sticky_width():
    """A scene whose buckets outgrow the seeded prefix width still reads back
    exactly; the sticky kcap widens for subsequent frames."""
    frame = _scene(16, 16, distance_factor=1.1, speed=5.0, box_fill=0.4)
    sim = Simulator()
    sim.force_device_readback = True
    sim.load_frame(frame)
    ref = sim._state_numpy(sim.state)
    ref = ref[ref["ty"] >= 0]
    seeded = sim._readback_k
    assert seeded >= 1

    sim._readback_k = 1  # force overflow against the real occupancy
    out = sim.read_frame()
    assert out.particle_count == len(ref)
    assert np.array_equal(out.particles, ref)
    assert sim._readback_k == seeded  # grew back to the true pow2 width


def test_simulator_ncap_overflow_grows_sticky_length():
    """Defensive path: a pack length smaller than the live total (cannot
    happen between loads — physics only drops — but guarded) widens and
    retries instead of truncating the wire frame."""
    frame = _scene(16, 16, distance_factor=1.1, speed=5.0, box_fill=0.4)
    sim = Simulator()
    sim.force_device_readback = True
    sim.load_frame(frame)
    ref = sim._state_numpy(sim.state)
    ref = ref[ref["ty"] >= 0]
    seeded = sim._readback_ncap

    sim._readback_ncap = max(1, seeded // 4)
    out = sim.read_frame()
    assert out.particle_count == len(ref)
    assert np.array_equal(out.particles, ref)
    assert sim._readback_ncap >= seeded


def test_sticky_kcap_shrinks_after_sustained_low_occupancy():
    frame = _scene(16, 16, distance_factor=1.1, speed=5.0, box_fill=0.4)
    sim = Simulator()
    sim.force_device_readback = True
    sim.load_frame(frame)
    true_k = sim._readback_k
    sim._readback_k = max(4, true_k * 4)  # pretend occupancy collapsed
    for _ in range(256):
        sim.read_frame()
    assert sim._readback_k == max(4, true_k * 4) // 2
    # and the shipped frame stayed exact throughout
    ref = sim._state_numpy(sim.state)
    assert sim.read_frame().particle_count == int((ref["ty"] >= 0).sum())


def test_compact_array_and_host_states_fall_back():
    """CompactArray (1D) layouts never take the grid-pack fast path."""
    from particle_simulator_tpu.io.frame import DataStructure

    frame = _scene(8, 8, distance_factor=1.2, speed=10.0, box_fill=0.5)
    frame.metadata.data_structure = DataStructure.COMPACT_ARRAY
    sim = Simulator()
    sim.force_device_readback = True
    sim.load_frame(frame)
    t = sim.start_readback()
    assert t.packed is None
    assert sim.read_frame(t).particle_count == 64
