"""BASELINE.json named-config benchmarks: one JSON line per config.

Covers configs 1-3, the ones without dedicated scripts (config 4 =
scripts/phase_sweep_chip.py, config 5 = scripts/interactive_1m_chip.py):

  1. 2D liquid droplet, ~2k particles, all-pairs forces + leapfrog
  2. Gas diffusion, 16k particles, all-pairs forces, single GPU
  3. Solid crystal lattice, 64k particles, cell-list neighbor search

Each config runs through the engine's own Simulator (the daemon's dispatch
path: _grid_for grid choice, per-frame dispatch, dense-pack readback), with
the data structure the config names (1-2: CompactArray all-pairs, 3:
MatrixBuckets cell list). Small-N runs are dispatch-bound, so the defaults
use 60 timed frames. Refuses to run anywhere but a GPU.

Usage (GPU host):  python scripts/bench_configs.py [--configs 1 2 3] [--frames 60]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NORTH_STAR = 1_000_000 * 60  # particle-steps/s


def bench_config(num: int, frames: int, steps: int) -> dict:
    import numpy as np

    import jax

    from particle_simulator_tpu.engine.simulator import Simulator
    from particle_simulator_tpu.io.frame import DataStructure
    from particle_simulator_tpu.utils.card import card_info
    from particle_simulator_tpu.scenes.library import (
        gas_diffusion,
        liquid_droplet,
        solid_crystal,
    )

    name, frame, structure = {
        1: ("liquid-droplet-2k", liquid_droplet(), DataStructure.COMPACT_ARRAY),
        2: ("gas-diffusion-16k", gas_diffusion(), DataStructure.COMPACT_ARRAY),
        3: ("solid-crystal-64k", solid_crystal(), DataStructure.MATRIX_BUCKETS),
    }[num]
    frame.metadata.data_structure = structure
    frame.metadata.steps_per_frame = steps
    # dense lattices explode at the 50 fs default (the reference's own
    # stability envelope is 10 fs, doc/project.typ:209)
    frame.metadata.step_dt = 10e-15

    sim = Simulator()
    sim.load_frame(frame)
    n = int(np.count_nonzero(frame.particles["ty"] >= 0))

    sim.frame_async()  # compile
    sim.sync()

    t0 = time.perf_counter()
    for _ in range(frames):
        sim.frame_async()
    sim.sync()
    elapsed = time.perf_counter() - t0

    out = sim.read_frame()
    assert np.isfinite(out.particles["vx"]).all(), f"config {num} diverged"

    value = n * steps * frames / elapsed
    rec = {
        "metric": "particle-steps/sec",
        "config": num,
        "scene": name,
        "value": round(value, 1),
        "unit": "particle*steps/s",
        "vs_baseline": round(value / NORTH_STAR, 4),
        "particles": n,
        "live_after": out.particle_count,
        "steps_per_frame": steps,
        "frames": frames,
        "elapsed_s": round(elapsed, 3),
        "sim_steps_per_sec": round(steps * frames / elapsed, 1),
        "kernel": sim.active_kernel,
        "data_structure": structure.name,
        "device": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "card": card_info(),
    }
    if structure == DataStructure.MATRIX_BUCKETS:
        g = sim.grid
        rec["grid"] = [g.by, g.bx, g.cap]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--frames", type=int, default=60, help="timed frames")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)

    from particle_simulator_tpu.engine.platform import require_gpu
    from particle_simulator_tpu.utils.compile_cache import enable_compilation_cache

    require_gpu("bench_configs")
    enable_compilation_cache()
    for num in args.configs:
        print(json.dumps(bench_config(num, args.frames, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
