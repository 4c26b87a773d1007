"""Headline benchmark: bucket-path particle-steps/sec on one GPU.

Scene: a full 1M-particle bucket grid (256x512 buckets x 8 slots; the
reference caps at 65,536 = 64x64x16, kernel.cuh:14-20) at condensed-phase
density, advanced with the engine's own frame program (100 leapfrog steps per
dispatch, rebucket every 16 — the reference's defaults), chosen by
engine/platform.py. Grid choice: the step's pair work per slot scales with
bucket capacity, so cap 8 over a 2x-finer grid does half the
pair-enumeration work of cap 16 at the same slot count, with the 3x3 window
still covering the full force range.

Prints ONE JSON line, naming the device (platform, kind, count) and the card
(name, power limit). Exits non-zero, printing no rate, when JAX's default
device is not a GPU. ``vs_baseline`` is measured against the BASELINE.json
north star: 1M particles x 60 sim-steps/sec = 6.0e7 particle-steps/sec.

Usage: python bench.py [--particles N] [--frames K] [--steps S]
                       [--sharded] [--user-scene] [--per-frame]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


NORTH_STAR = 6.0e7  # particle-steps/sec: >=1M particles x >=60 steps/s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=1_048_576)
    ap.add_argument("--frames", type=int, default=10, help="timed frame dispatches")
    ap.add_argument("--steps", type=int, default=100, help="physics steps per frame")
    ap.add_argument("--fill", type=int, default=8, help="particles per bucket")
    ap.add_argument("--sharded", action="store_true",
                    help="run the multi-device program (shard_map + halo "
                         "exchange) over a mesh of the available devices — on "
                         "one device this measures the shard overhead vs the "
                         "single-device runner")
    ap.add_argument("--user-scene", action="store_true",
                    help="bench the editor-drawn configuration instead of the "
                         "dense grid: a hex lattice at 1.1 r0 spacing filling "
                         "half the box, grid chosen by the engine's own "
                         "density-aware _grid_for, stepped through Simulator")
    ap.add_argument("--per-frame", action="store_true",
                    help="wait for every frame and report the per-frame time "
                         "distribution (variance / throttling diagnosis)")
    args = ap.parse_args(argv)

    import jax

    from particle_simulator_tpu.engine import platform

    device = platform.require_gpu("bench")

    from particle_simulator_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    if args.user_scene:
        return bench_user_scene(args)

    from particle_simulator_tpu.engine.state import SimParams
    from particle_simulator_tpu.io.frame import DataStructure
    from particle_simulator_tpu.scenes.library import (
        dense_grid_config,
        dense_grid_scene,
    )

    cfg = dense_grid_config(args.particles, args.fill)
    state, meta, n = dense_grid_scene(cfg)
    params = SimParams.from_record(meta)._replace(steps_per_frame=np.int32(args.steps))

    mesh = None
    if args.sharded:
        from particle_simulator_tpu.parallel.domain import grid_sharding, make_mesh

        mesh = make_mesh()
        state = jax.device_put(state, grid_sharding(mesh))
    else:
        state = jax.device_put(state, device)
    frame_fn = platform.frame_runner(
        device.platform, DataStructure.MATRIX_BUCKETS, grid=cfg, mesh=mesh
    )

    # warmup/compile
    t0 = time.perf_counter()
    state = jax.block_until_ready(frame_fn(state, params))
    compile_s = time.perf_counter() - t0

    frame_times = []
    t0 = time.perf_counter()
    for _ in range(args.frames):
        tf = time.perf_counter()
        state = frame_fn(state, params)
        if args.per_frame:
            jax.block_until_ready(state)
            frame_times.append(time.perf_counter() - tf)
    state = jax.block_until_ready(state)
    elapsed = time.perf_counter() - t0
    if not np.isfinite(np.asarray(state.vx)).all():
        raise SystemExit("bench: benchmark scene diverged")
    live_end = int(np.count_nonzero(np.asarray(state.ty) >= 0))

    value = n * args.steps * args.frames / elapsed
    print(
        json.dumps(
            {
                "metric": "particle-steps/sec",
                "value": round(value, 1),
                "unit": "particle*steps/s",
                "vs_baseline": round(value / NORTH_STAR, 3),
                "particles": n,
                "steps_per_frame": args.steps,
                "frames": args.frames,
                "elapsed_s": round(elapsed, 3),
                "compile_s": round(compile_s, 3),
                "sim_steps_per_sec": round(args.steps * args.frames / elapsed, 2),
                # bucket-overflow drops are reference semantics
                # (kernel_bucket.cuh:30-31); reported for transparency —
                # per-step compute is slot-based and unaffected by drops
                "live_fraction_end": round(live_end / n, 4),
                **_device_fields(device),
                **(
                    {"sharded_mesh": list(mesh.devices.shape)}
                    if mesh is not None
                    else {}
                ),
                **(
                    {
                        "frame_s": {
                            "min": round(min(frame_times), 4),
                            "p50": round(float(np.median(frame_times)), 4),
                            "max": round(max(frame_times), 4),
                            "cv": round(
                                float(np.std(frame_times) / np.mean(frame_times)), 3
                            ),
                        },
                    }
                    if frame_times
                    else {}
                ),
            }
        )
    )
    return 0


def _device_fields(device) -> dict:
    import jax

    from particle_simulator_tpu.utils.card import card_info

    return {
        "device": device.platform,
        "device_kind": device.device_kind,
        "device_count": len(jax.devices()),
        "card": card_info(),
    }


def bench_user_scene(args) -> int:
    """Editor-drawn configuration: lattice scene through the engine's own
    Simulator (grid via _grid_for, per-frame dispatch like the daemon)."""
    import jax

    from particle_simulator_tpu.engine.simulator import Simulator
    from particle_simulator_tpu.scenes.library import _scene

    side = max(2, int(round(args.particles ** 0.5)))
    frame = _scene(side, side, distance_factor=1.1, speed=1.0, box_fill=0.5)
    frame.metadata.steps_per_frame = args.steps
    mesh = None
    if args.sharded:
        from particle_simulator_tpu.parallel.domain import make_mesh

        mesh = make_mesh()
    sim = Simulator(mesh=mesh)
    sim.load_frame(frame)
    n = int(np.count_nonzero(frame.particles["ty"] >= 0))

    t0 = time.perf_counter()
    sim.frame_async()
    sim.sync()
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.frames):
        sim.frame_async()
    sim.sync()
    elapsed = time.perf_counter() - t0

    # per-frame readback measured separately (the daemon overlaps it with
    # compute via the ticket pipeline; serializing it into the step-rate
    # window would double-count)
    t0 = time.perf_counter()
    out = sim.read_frame()
    readback_s = time.perf_counter() - t0
    if not np.isfinite(out.particles["vx"]).all():
        raise SystemExit("bench: benchmark scene diverged")

    g = sim.grid
    value = n * args.steps * args.frames / elapsed
    print(
        json.dumps(
            {
                "metric": "particle-steps/sec",
                "scene": "user-lattice",
                "value": round(value, 1),
                "unit": "particle*steps/s",
                "vs_baseline": round(value / NORTH_STAR, 3),
                "particles": n,
                "steps_per_frame": args.steps,
                "frames": args.frames,
                "elapsed_s": round(elapsed, 3),
                "compile_s": round(compile_s, 3),
                "sim_steps_per_sec": round(args.steps * args.frames / elapsed, 2),
                "readback_ms": round(readback_s * 1e3, 1),
                "grid": [g.by, g.bx, g.cap],
                "kernel": sim.active_kernel,
                **_device_fields(jax.devices()[0]),
                **(
                    {"sharded_mesh": list(mesh.devices.shape)}
                    if mesh is not None
                    else {}
                ),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
