"""Config-4 benchmark: the 256k states-of-matter sweep on real hardware.

The reference's headline demo is the interactive solid -> liquid -> gas
transition (doc/project.typ:169-191, doc/StatesOfMatterTransitions.svg). This
script replays it at 256k particles (the BASELINE.json config-4 scale) on the
GPU and CLASSIFIES each phase quantitatively via scenes/order.py:

- solid:  psi6 high (hex order), ~6 first-shell neighbors, clustered
- liquid: psi6 well below solid, still condensed (neighbors >= 3.5)
- gas:    first-shell neighbors < 1.5, occupancy >> the condensed phases

Prints one JSON line per phase plus a final verdict line; exits non-zero if
the ordering checks fail. Optionally writes a docs GIF of the sweep.

Usage (GPU host; --device 1 runs the CPU path for smoke tests):
    python scripts/phase_sweep_chip.py [--n-side 512] [--gif docs/images/phase_sweep.gif]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (label, initial speed m/s, steps, seed, dt): speeds chosen so mean kinetic
# energy lands well below / near / well above the Mie well depth (~1.3e-21 J
# for the N2 defaults, i.e. thermal speed ~200 m/s). The gas phase runs at
# dt = 2 fs: at >= ~1000 m/s head-on collisions overshoot the r^-12 core with
# the 10 fs step and runaway-heat the scene (measured: mean speed -> 1e12 m/s
# within 1k steps at dt = 10 fs, stable plateau at ~574 m/s at 2 fs); the
# extra steps give the vapor time to cross the half-box vacuum and fill it.
PHASES = [
    ("solid", 5.0, 5_000, 0, 10e-15),
    ("liquid", 600.0, 30_000, 1, 10e-15),
    ("gas", 1200.0, 200_000, 2, 2e-15),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-side", type=int, default=512, help="lattice side (512 -> 262k particles)")
    ap.add_argument("--gif", default=None, help="write a sweep GIF here")
    ap.add_argument("--size", type=int, default=384, help="GIF frame size")
    ap.add_argument("--device", type=int, default=None, help="1 = CPU jnp path")
    ap.add_argument("--steps-scale", type=float, default=1.0,
                    help="scale the per-phase step budgets (CPU smoke testing)")
    args = ap.parse_args(argv)

    from particle_simulator_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    from particle_simulator_tpu.engine.simulator import Simulator
    from particle_simulator_tpu.scenes.library import _scene
    from particle_simulator_tpu.scenes.order import order_parameters

    gif_frames = []
    results = {}
    for label, speed, steps, seed, dt in PHASES:
        frame = _scene(args.n_side, args.n_side, distance_factor=1.05,
                       speed=speed, box_fill=0.5, seed=seed, dt=dt)
        meta = frame.metadata
        meta.steps_per_frame = 1000
        if args.device is not None:
            from particle_simulator_tpu.io.frame import Device

            meta.device = Device(args.device)
        sim = Simulator()
        sim.load_frame(frame)

        n_frames = max(1, int(steps * args.steps_scale) // 1000)
        snap_every = max(1, n_frames // 4)
        snapshots = []  # device-side state refs; read back after timing
        t0 = time.perf_counter()
        for i in range(n_frames):
            sim.frame_async()
            if args.gif and (i + 1) % snap_every == 0:
                snapshots.append(sim.state)
        sim.sync()
        elapsed = time.perf_counter() - t0
        out = sim.read_frame()

        op = order_parameters(out.particles, out.metadata.copy())
        results[label] = op
        print(json.dumps({
            "phase": label,
            "initial_speed": speed,
            "dt": dt,
            "steps": n_frames * 1000,
            "sim_steps_per_sec": round(n_frames * 1000 / elapsed, 1),
            **op.as_dict(),
        }), flush=True)

        if args.gif:
            from particle_simulator_tpu.editor.render import render_frame

            for st in snapshots:
                gif_frames.append(
                    render_frame(sim.read_frame(state=st), args.size, args.size))

    solid, liquid, gas = results["solid"], results["liquid"], results["gas"]
    checks = {
        "solid_is_hexatic": solid.psi6 > 0.6,
        "solid_first_shell": 5.0 <= solid.mean_neighbors <= 7.0,
        "liquid_lost_order": liquid.psi6 < solid.psi6 - 0.2,
        "liquid_still_condensed": liquid.mean_neighbors >= 3.0,
        "gas_unbound": gas.mean_neighbors < 1.5,
        "gas_fills_box": gas.occupied_fraction > 2.0 * solid.occupied_fraction,
    }
    ok = all(checks.values())
    print(json.dumps({"metric": "phase-sweep-256k", "ok": ok, "checks": checks}))

    if args.gif and gif_frames:
        from particle_simulator_tpu.editor.render import write_gif

        write_gif(args.gif, gif_frames, delay_cs=100)
        print(f"wrote {args.gif}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
