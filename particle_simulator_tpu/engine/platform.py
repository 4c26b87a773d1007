"""The one place that maps a device platform to the frame program it runs.

Every platform runs the same jnp step, rebucket and all-pairs code
(physics/) and the same move cadence. What differs per platform is how a
frame is read back, and nothing else in the repository branches on the
platform:

- ``dense_readback``: whether ``read_frame`` packs the live particles on the
  device before the host copy (ops/readback.py). On the GPU that copy
  crosses PCIe; on the CPU backend the full-grid read is already free.

A platform missing from ``PLANS`` is an error, not a default: the engine has
no measured plan for it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax

from particle_simulator_tpu.io.frame import DataStructure


class Plan(NamedTuple):
    dense_readback: bool


PLANS = {
    "gpu": Plan(dense_readback=True),
    "cpu": Plan(dense_readback=False),
}


def plan(platform: str) -> Plan:
    try:
        return PLANS[platform]
    except KeyError:
        raise ValueError(
            f"no frame plan for platform {platform!r} (known: {sorted(PLANS)})"
        ) from None


def kernel_name(platform: str, structure: DataStructure, sharded: bool) -> str:
    """The runner's label, reported as ``Simulator.active_kernel`` and in the
    daemon's log: ``allpairs-<platform>``, ``bucket-<platform>`` or
    ``sharded-<platform>``. CompactArray never shards (all-pairs has no
    spatial locality to split)."""
    plan(platform)
    if structure == DataStructure.COMPACT_ARRAY:
        return f"allpairs-{platform}"
    return f"{'sharded' if sharded else 'bucket'}-{platform}"


# NOT donated: the engine loop reads back frame k's state while frame k+1
# computes from it (the reference's compute/readback overlap,
# cuda_simulator.cu:7-26) — donating would delete the buffer being shipped.
@jax.jit
def _run_compact(state, p):
    from particle_simulator_tpu.physics.step import allpairs_step, run_frame

    return run_frame(state, p, allpairs_step)


@jax.jit
def _run_bucket(state, p):
    from particle_simulator_tpu.physics.bucket import run_frame_bucket

    return run_frame_bucket(state, p)


def frame_runner(platform: str, structure: DataStructure, grid=None, mesh=None):
    """The jitted frame program ``fn(state, params) -> state`` for this
    (platform, data structure, mesh). ``grid`` is needed only with a mesh:
    the sharded program is built per grid shape. Callers cache the result
    (building the sharded program traces nothing, but a fresh jit wrapper
    per frame would)."""
    plan(platform)
    if structure == DataStructure.COMPACT_ARRAY:
        return _run_compact
    if mesh is not None:
        from particle_simulator_tpu.parallel.domain import make_sharded_frame_fn

        return make_sharded_frame_fn(grid, mesh, donate=False)
    return _run_bucket


def accelerator():
    """The first GPU device, or None when JAX has no GPU backend."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        return None
    return devices[0] if devices else None


def require_gpu(tool: str):
    """The default device, which must be a GPU: measurement tools refuse to
    time anything else (a CPU number is not a device number)."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(
            f"{tool}: needs a GPU; JAX's default device is {device.platform!r}"
        )
    return device
