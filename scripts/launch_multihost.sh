#!/usr/bin/env bash
# Multi-host engine launcher — the analog of the reference's SLURM sbatch
# scripts (cuda_simulator/job.sh:11-22, which queue the CUDA binary on
# RTX 4090 / 3080 nodes).
#
# Every host runs the SAME engine daemon; jax.distributed stitches all hosts'
# GPUs into one global device set and parallel/domain.py shards the bucket
# grid over the global ("dy", "dx") mesh — intra-host halo exchange rides
# NVLink, cross-host shard edges the network. Host 0 owns the editor TCP
# connection (see parallel/multihost.py).
#
# Usage — one invocation per host (ssh, sbatch task, or container):
#   scripts/launch_multihost.sh <coordinator-host:port> <num_hosts> <host_id> \
#       [extra daemon args...]
#
# Local 2-host smoke test (CPU, 2 virtual devices per "host", gloo over
# localhost — the same path tests/test_parallel.py::
# test_multihost_two_process_sharded_frame exercises in CI):
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2 \
#     scripts/launch_multihost.sh 127.0.0.1:9911 2 0 --max-frames 4 &
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2 \
#     scripts/launch_multihost.sh 127.0.0.1:9911 2 1 --max-frames 4

set -euo pipefail

if [ $# -lt 3 ]; then
    sed -n '2,20p' "$0" | sed 's/^# \{0,1\}//'
    exit 2
fi

COORD=$1
NUM=$2
ID=$3
shift 3

export PS_COORDINATOR="$COORD"
export PS_NUM_PROCESSES="$NUM"
export PS_PROCESS_ID="$ID"

exec python -m particle_simulator_tpu.engine.daemon --devices all "$@"
