"""engine/platform.py: the one place a platform picks its frame program."""

import numpy as np
import pytest

import jax

from particle_simulator_tpu.engine import platform
from particle_simulator_tpu.io.frame import DataStructure

MB = DataStructure.MATRIX_BUCKETS
CA = DataStructure.COMPACT_ARRAY


@pytest.mark.parametrize(
    "name,structure,sharded,kernel",
    [
        ("gpu", MB, False, "bucket-gpu"),
        ("gpu", MB, True, "sharded-gpu"),
        ("gpu", CA, False, "allpairs-gpu"),
        ("gpu", CA, True, "allpairs-gpu"),  # all-pairs never shards
        ("cpu", MB, False, "bucket-cpu"),
        ("cpu", MB, True, "sharded-cpu"),
        ("cpu", CA, False, "allpairs-cpu"),
        ("cpu", CA, True, "allpairs-cpu"),
    ],
)
def test_kernel_name_per_platform_structure_and_mesh(name, structure, sharded, kernel):
    assert platform.kernel_name(name, structure, sharded) == kernel


@pytest.mark.parametrize("name", ["rocm", "metal", "", None])
def test_unknown_platform_is_an_error(name):
    with pytest.raises(ValueError, match="no frame plan"):
        platform.plan(name)
    with pytest.raises(ValueError):
        platform.kernel_name(name, MB, False)
    with pytest.raises(ValueError):
        platform.frame_runner(name, MB)


def test_plans_unroll_and_dense_readback():
    """The GPU packs on device before its PCIe copy; the CPU reads the full
    grid (free there). The move cadence has one loop form, so the readback
    is all a plan holds."""
    assert platform.plan("gpu").dense_readback
    assert not platform.plan("cpu").dense_readback
    assert platform.Plan._fields == ("dense_readback",)
    assert set(platform.PLANS) == {"gpu", "cpu"}


def test_no_accelerator_on_cpu_only_jax():
    assert platform.accelerator() is None


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        platform.require_gpu("probe")


def _tiny_bucket_scene():
    from particle_simulator_tpu.engine.state import SimParams, state_from_numpy
    from particle_simulator_tpu.io.frame import Frame
    from particle_simulator_tpu.io.presets import ParticleLattice
    from particle_simulator_tpu.physics.bucket import (
        GridConfig,
        bucketize_numpy,
        state_to_grid,
    )

    cfg = GridConfig(4, 4, 8)
    frame = Frame.new()
    meta = frame.metadata
    ParticleLattice((12, 12), distance_factor=1.1, velocity=(20.0, 60.0)).hex_square(
        frame, (meta.box_width / 2, meta.box_height / 2), rng=np.random.default_rng(4))
    state = state_to_grid(state_from_numpy(bucketize_numpy(frame.particles, cfg),
                                           cfg.capacity), cfg)
    params = SimParams.from_record(meta.copy())._replace(steps_per_frame=np.int32(37))
    return cfg, state, params


@pytest.mark.parametrize("steps,move_every", [(0, 16), (1, 16), (2, 16), (17, 16),
                                              (33, 16), (37, 16), (9, 2), (10, 4)])
def test_chunked_schedule_is_the_reference_op_sequence(steps, move_every):
    """The frame schedule runs ``move`` before steps 1, 1+k, 1+2k, ... and
    nothing else — the reference's per-step ``if i % k == 1: move``
    (kernel_bucket.cuh:181-206) — including frames shorter than one cadence
    chunk and a trailing partial chunk. Step and move log their order."""
    import jax.numpy as jnp

    from particle_simulator_tpu.physics.bucket import chunked_frame_schedule

    def record(op):
        return lambda s: (s[0].at[s[1]].set(op), s[1] + 1)

    want = []
    for i in range(steps):
        if i % move_every == 1:
            want.append(2)
        want.append(1)
    run = jax.jit(lambda n: chunked_frame_schedule(
        (jnp.zeros(64, jnp.int32), jnp.int32(0)), n, move_every,
        record(1), record(2)))
    log, count = run(jnp.int32(steps))
    assert int(count) == len(want)
    assert np.asarray(log)[:len(want)].tolist() == want


def test_frame_runner_matches_the_physics_frame():
    """The runner the CPU plan hands out is run_frame_bucket itself."""
    from particle_simulator_tpu.physics.bucket import run_frame_bucket

    _, state, params = _tiny_bucket_scene()
    got = platform.frame_runner("cpu", MB)(state, params)
    want = jax.jit(run_frame_bucket)(state, params)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def test_simulator_reports_the_selected_runner():
    """Simulator asks the platform module for its program: a GPU request
    without a GPU falls back to the CPU thread pool (reference semantics,
    echoed in outbound metadata) and runs the CPU runners."""
    from particle_simulator_tpu.engine.simulator import Simulator
    from particle_simulator_tpu.io.frame import Device
    from particle_simulator_tpu.scenes.library import gas_diffusion

    for ds, kernel in ((MB, "bucket-cpu"), (CA, "allpairs-cpu")):
        frame = gas_diffusion(8)
        frame.metadata.data_structure = ds
        frame.metadata.steps_per_frame = 2
        sim = Simulator()
        sim.load_frame(frame)
        sim.frame_async()
        assert sim.platform == "cpu"
        assert sim.active_kernel == kernel
        out = sim.read_frame()
        assert out.metadata.device == Device.CPU_THREAD_POOL
        assert out.particle_count == 64
