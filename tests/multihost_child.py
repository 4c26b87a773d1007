"""Child process for the 2-process multihost test (test_parallel.py).

Each process owns 2 virtual CPU devices; jax.distributed stitches them into a
4-device global mesh (local coordinator + gloo collectives). The process
runs one sharded frame over the GLOBAL mesh and checks bit-identity against
the single-device bucket path computed locally.

Usage: python multihost_child.py <process_id>   (env: PS_COORDINATOR,
PS_NUM_PROCESSES set by the parent)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = [f for f in os.environ.get("XLA_FLAGS", "").split() if "device_count" not in f]
_flags.append("--xla_force_host_platform_device_count=2")
os.environ["XLA_FLAGS"] = " ".join(_flags)
os.environ["PS_PROCESS_ID"] = sys.argv[1]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from particle_simulator_tpu.engine.state import SimParams, state_from_numpy  # noqa: E402
from particle_simulator_tpu.io.frame import Frame  # noqa: E402
from particle_simulator_tpu.io.presets import ParticleLattice  # noqa: E402
from particle_simulator_tpu.parallel import multihost  # noqa: E402
from particle_simulator_tpu.parallel.domain import make_sharded_frame_fn  # noqa: E402
from particle_simulator_tpu.physics.bucket import (  # noqa: E402
    GridConfig,
    bucketize_numpy,
    run_frame_bucket,
    state_to_grid,
)


def main() -> int:
    assert multihost.init_distributed() is True
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, len(jax.devices())
    assert multihost.is_frame_owner() == (jax.process_index() == 0)

    # deterministic scene, identical in both processes
    cfg = GridConfig(4, 4, 8, move_every=4)
    frame = Frame.new()
    meta = frame.metadata
    lat = ParticleLattice((10, 10), distance_factor=3.0, velocity=(40.0, -25.0))
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2),
                   rng=np.random.default_rng(11))
    layout = bucketize_numpy(frame.particles, cfg)
    state = state_to_grid(state_from_numpy(layout, cfg.capacity), cfg)
    params = SimParams.from_record(meta.copy())._replace(steps_per_frame=np.int32(6))

    # single-device reference, computed locally
    ref = jax.tree.map(np.asarray, run_frame_bucket(state, params,
                                                    move_every=cfg.move_every))

    mesh = multihost.global_mesh()
    assert mesh.devices.size == 4
    gstate = multihost.shard_state_global(state, mesh)
    fn = make_sharded_frame_fn(cfg, mesh, donate=False)
    out = fn(gstate, params)
    got = multihost.gather_global(out)

    # same envelopes as the single-process sharded tests: bucket layout exact,
    # positions/velocities within summation-order ulps (XLA picks a different
    # f32 reduction tree for the sharded tile shape)
    np.testing.assert_array_equal(ref.ty, got.ty)
    np.testing.assert_allclose(ref.x.astype(np.int64), got.x.astype(np.int64), rtol=0, atol=8)
    np.testing.assert_allclose(ref.y.astype(np.int64), got.y.astype(np.int64), rtol=0, atol=8)
    np.testing.assert_allclose(ref.vx, got.vx, rtol=1e-3, atol=0.05)
    np.testing.assert_allclose(ref.vy, got.vy, rtol=1e-3, atol=0.05)
    live = got.ty.reshape(-1) >= 0
    assert live.sum() == (ref.ty.reshape(-1) >= 0).sum()
    assert live.sum() > 0
    print(f"MULTIHOST_OK process={jax.process_index()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
