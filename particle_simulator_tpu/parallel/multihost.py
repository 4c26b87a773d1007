"""Multi-host scaling scaffolding.

The reference is single-node (its only cluster artifact is a SLURM sbatch
script, cuda_simulator/job.sh). Scale-out beyond one host uses
jax.distributed: every host runs the same engine binary, JAX stitches the
hosts' devices into one global device set, and the spatial domain
decomposition (parallel/domain.py) shards the bucket grid over the *global*
mesh — halo exchanges between GPUs of one host ride NVLink, shard edges
that cross hosts ride the data-center network. Host 0 owns the editor TCP
connection and the frame gather/readback.

Single-host runs need none of this; ``init_distributed`` is a no-op when the
coordinator env vars are absent. The production entry point is
``scripts/launch_multihost.sh`` (the reference's SLURM-script analog,
cuda_simulator/job.sh): one invocation per host runs the engine daemon with
``--devices all``; the daemon's ``DistributedFrontend`` (engine/daemon.py)
broadcasts editor input from process 0 so every process issues the identical
sharded computation sequence.

Multi-host hardware is not available in this environment, so CI exercises
the REAL multi-process path on CPU two ways (tests/test_parallel.py): a
2-process sharded frame bit-identity check, and a full editor + 2-daemon
end-to-end run over a 4-virtual-device global mesh (gloo collectives over a
local coordinator).
"""

from __future__ import annotations

import os

import jax
import numpy as np

from particle_simulator_tpu.engine.state import ParticleState
from particle_simulator_tpu.parallel.domain import grid_sharding, make_mesh


def init_distributed() -> bool:
    """Initialize jax.distributed from env vars.

    Reads ``PS_COORDINATOR`` (host:port of process 0), ``PS_NUM_PROCESSES``
    and ``PS_PROCESS_ID``. Returns True if a multi-process runtime was
    initialized, False (a no-op) when ``PS_COORDINATOR`` is unset.
    """
    coord = os.environ.get("PS_COORDINATOR")
    if coord:
        # jax.default_backend() must NOT be consulted here — it would
        # initialize the XLA backend before jax.distributed.initialize()
        if (os.environ.get("JAX_PLATFORMS") or "").startswith("cpu"):
            # multi-process CPU needs an inter-process collectives backend
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["PS_NUM_PROCESSES"]),
            process_id=int(os.environ["PS_PROCESS_ID"]),
        )
        return True
    return False


def global_mesh():
    """2D ("dy","dx") mesh over every device of every host (jax.devices() is
    global after init_distributed)."""
    return make_mesh(jax.devices())


def is_frame_owner() -> bool:
    """Host 0 talks to the editor; other hosts only compute."""
    return jax.process_index() == 0


def shard_state_global(state: ParticleState, mesh) -> ParticleState:
    """Place a host-replicated numpy ParticleState onto a GLOBAL mesh.

    Unlike ``domain.shard_state`` (single-process ``device_put``), this works
    when the mesh spans devices of other processes: every process contributes
    only its addressable shards via ``jax.make_array_from_callback``. All
    processes must hold the same full ``state`` (true for scene loads: the
    frame-owner broadcasts the scene bytes; in tests every process builds the
    scene deterministically)."""
    sharding = grid_sharding(mesh)

    def put(a):
        a = np.asarray(a)
        return jax.make_array_from_callback(a.shape, sharding, lambda idx: a[idx])

    return ParticleState(*(put(a) for a in state))


def gather_global(state: ParticleState) -> ParticleState:
    """Fetch a globally-sharded ParticleState to host numpy on EVERY process
    (host 0 uses it for the editor readback; a cross-host allgather)."""
    from jax.experimental import multihost_utils

    return ParticleState(
        *(np.asarray(multihost_utils.process_allgather(a, tiled=True)) for a in state)
    )
