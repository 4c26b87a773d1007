"""Replicate the reference's full leapfrog stability claim on hardware.

The reference states leapfrog holds **>10 ns of sim-time at dt = 10 fs with
no explosion** (doc/project.typ:209) — that is 1e6 steps, 100x the envelope
the CPU suite covers (tests/test_physics.py, 10k steps = 0.1 ns). This soak
runs the full 1e6 steps through the engine's bucket frame program on the
GPU (engine/platform.py), with an oracle (all-pairs NumPy) energy readback
every ``--check-every`` steps, and prints one JSON line with the drift
envelope.

Scene: a 10 nm box, 8x8 hex lattice, 2x bucket-occupancy headroom so no
overflow drops skew the energy budget — the reference's claim is about the
integrator, not scale; scale throughput is bench.py's job.

Usage (GPU host):
    python scripts/soak_leapfrog_1e6.py [--steps 1000000] [--check-every 10000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1_000_000)
    ap.add_argument("--check-every", type=int, default=10_000)
    args = ap.parse_args(argv)

    import jax

    from particle_simulator_tpu.engine import platform
    from particle_simulator_tpu.utils.compile_cache import enable_compilation_cache

    dev = platform.require_gpu("soak_leapfrog_1e6")
    enable_compilation_cache()

    from particle_simulator_tpu.engine.state import (
        SimParams,
        state_from_numpy,
        state_to_numpy,
    )
    from particle_simulator_tpu.io.frame import DataStructure, Frame
    from particle_simulator_tpu.io.presets import ParticleLattice
    from particle_simulator_tpu.physics import oracle
    from particle_simulator_tpu.physics.bucket import (
        GridConfig,
        bucketize_numpy,
        state_to_grid,
    )

    # 10 nm box over 8x8 buckets, 8x8 hex lattice at 1.12 r0, dt = 10 fs
    cfg = GridConfig(3, 3, 16)
    frame = Frame.new()
    meta = frame.metadata
    meta.box_width = meta.box_height = 10e-9
    lat = ParticleLattice((8, 8), distance_factor=1.12, velocity=(0.0, 10.0))
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2),
                   rng=np.random.default_rng(3))
    meta.step_dt = 10e-15
    meta.steps_per_frame = args.check_every
    rec = meta.copy()

    layout = bucketize_numpy(frame.particles, cfg)
    state = jax.device_put(
        state_to_grid(state_from_numpy(layout, cfg.capacity), cfg), dev
    )
    p = SimParams.from_record(rec)

    fn = platform.frame_runner(dev.platform, DataStructure.MATRIX_BUCKETS)

    def energy(s):
        parts = state_to_numpy(s)
        live = parts[parts["ty"] >= 0]
        return len(live), oracle.total_energy(live, rec)

    n0, e0 = energy(state)
    scale = max(abs(e0), 1e-21)
    checks = args.steps // args.check_every
    worst = 0.0
    t0 = time.perf_counter()
    for i in range(checks):
        state = fn(state, p)
        n, e = energy(state)
        if not np.isfinite(e):
            print(json.dumps({"metric": "leapfrog-1e6-soak", "ok": False,
                              "exploded_at_step": (i + 1) * args.check_every}))
            return 1
        drift = abs(e - e0) / scale
        worst = max(worst, drift)
        if (i + 1) % 10 == 0:
            el = time.perf_counter() - t0
            print(f"  {(i+1)*args.check_every} steps  drift={drift:.4%} "
                  f"worst={worst:.4%} live={n}/{n0}  {el:.0f}s",
                  file=sys.stderr, flush=True)
    elapsed = time.perf_counter() - t0

    n_end, e_end = energy(state)
    sim_ns = args.steps * float(rec["step_dt"]) * 1e9
    print(json.dumps({
        "metric": "leapfrog-1e6-soak",
        "ok": True,
        "steps": args.steps,
        "sim_time_ns": round(sim_ns, 3),
        "dt_fs": float(rec["step_dt"]) * 1e15,
        "worst_energy_drift": round(worst, 5),
        "final_energy_drift": round(abs(e_end - e0) / scale, 5),
        "live_start": n0,
        "live_end": n_end,
        "elapsed_s": round(elapsed, 1),
        "device": dev.platform,
        "device_kind": dev.device_kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
