"""Scene builders + a headless runner.

The reference demonstrates solid/liquid/gas phases interactively
(doc/project.typ:169-191). These builders reproduce those regimes — phase is
set by lattice spacing (potential energy) and initial speed (kinetic energy /
temperature) — at the benchmark sizes from BASELINE.json. Boxes are sized to
the particle count so density, not count, selects the phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from particle_simulator_tpu.io.frame import DataStructure, Frame, MieParams
from particle_simulator_tpu.io.presets import ParticleLattice

# leapfrog stability envelope: dt = 10 fs is stable long-horizon
# (doc/project.typ:209); the 50 fs default is only safe for sparse scenes
STABLE_DT = 10e-15


def _scene(
    nx: int,
    ny: int,
    distance_factor: float,
    speed: float,
    box_fill: float = 0.5,
    dt: float = STABLE_DT,
    steps_per_frame: int = 100,
    seed: int = 0,
) -> Frame:
    """Lattice scene centered in a box sized so the lattice spans ``box_fill``
    of the box diagonal-wise."""
    frame = Frame.new()
    meta = frame.metadata
    r0 = MieParams.nitrogen().force0_r()
    span = max(nx, ny) * r0 * distance_factor
    box = span / box_fill
    meta.box_width = box
    meta.box_height = box
    meta.step_dt = dt
    meta.steps_per_frame = steps_per_frame
    lat = ParticleLattice((nx, ny), distance_factor=distance_factor, velocity=(0.0, speed))
    lat.hex_square(frame, (box / 2, box / 2), rng=np.random.default_rng(seed))
    return frame


def liquid_droplet(n_side: int = 45) -> Frame:
    """~2k-particle droplet: near-equilibrium spacing, warm enough to flow
    (the reference's default interactive regime)."""
    return _scene(n_side, n_side, distance_factor=1.1, speed=80.0, box_fill=0.45)


def gas_diffusion(n_side: int = 128) -> Frame:
    """16k-particle gas: sparse start, hot — particles fill the box."""
    return _scene(n_side, n_side, distance_factor=2.5, speed=400.0, box_fill=0.7)


def solid_crystal(n_side: int = 256) -> Frame:
    """64k-particle crystal: equilibrium spacing, cold — the hex lattice holds."""
    return _scene(n_side, n_side, distance_factor=1.0, speed=5.0, box_fill=0.6)


def phase_sweep_frames(n_side: int = 512, temps=(5.0, 80.0, 250.0, 600.0)) -> list[tuple[str, Frame]]:
    """States-of-matter temperature ramp at 256k particles: the same lattice
    re-thermalized at increasing speeds (kinetic temperature). Send each frame
    in sequence to sweep solid -> liquid -> gas."""
    return [
        (f"T{int(v)}", _scene(n_side, n_side, distance_factor=1.05, speed=v, box_fill=0.5, seed=i))
        for i, v in enumerate(temps)
    ]


def dense_grid_config(particles: int, fill: int = 8):
    """Smallest power-of-two bucket grid holding ``particles`` at ``fill``
    per bucket, grown y-first so buckets stay square or 2:1. Cap 8 over a
    finer grid: the pair work per slot scales with cap, so at equal slot
    count a cap-8 grid does HALF the pair-enumeration work of cap 16, while
    the 3x3 window (>= 2 bucket widths >= 4.4 sigma) still covers the full
    force range like the reference's own ~2-sigma buckets
    (kernel.cuh:14-20)."""
    from particle_simulator_tpu.physics.bucket import GridConfig

    kx = ky = 2
    while (1 << (kx + ky)) * fill < particles:
        if kx == ky:
            ky += 1
        else:
            kx += 1
    return GridConfig(kx, ky, fill)


def dense_grid_scene(cfg):
    """The benchmark's dense scene: fill every interior bucket with ``fill`` particles jittered inside the
    bucket at ~equilibrium spacing (condensed phase: every bucket interaction
    is live, no NaN-prone overlaps), cold (sigma = 1 m/s), with the boundary
    bucket ring left empty as a wall margin. Spacing 1.0 r0 + cold + margin
    minimize bucket-overflow drops over long runs (an attractive 1.1-spacing
    scene slowly condenses and sheds ~14%/1000 steps; this one ~5-7%, mostly
    the square->hex lattice relaxation transient). ``fill`` = the grid's
    bucket capacity. Returns (grid state, metadata record, live count)."""
    from particle_simulator_tpu.engine.state import state_from_numpy
    from particle_simulator_tpu.io.frame import PARTICLE_DTYPE, default_metadata
    from particle_simulator_tpu.physics.bucket import state_to_grid

    fill = cfg.cap
    meta = default_metadata()
    n = cfg.buckets * fill
    r0 = MieParams.nitrogen().force0_r()

    # Bucket-ALIGNED hexagonal lattice — the 2D ground state — so the crystal
    # neither relaxes (a square lattice is a saddle point: it melts, clumps,
    # and overflows buckets over thousands of steps) nor straddles bucket
    # boundaries: each bucket holds exactly `fill` particles as `cols` hex
    # columns x `rows` hex rows, at spacing d = r0.
    rows = 2 if fill <= 8 else 4
    assert fill % rows == 0, "fill must split into hex rows"
    cols = fill // rows
    d = r0
    box_w = float(cfg.bx * cols * d)
    box_h = float(cfg.by * rows * (np.sqrt(3.0) / 2.0) * d)
    meta["box_width"] = box_w
    meta["box_height"] = box_h
    # the reference's stability envelope: leapfrog is stable at dt = 10 fs for
    # >10 ns sim-time (doc/project.typ:209); the 50 fs metadata default blows
    # up at condensed-phase density
    meta["step_dt"] = 10e-15

    rng = np.random.default_rng(0)
    bxs = np.arange(cfg.bx, dtype=np.int64)
    bys = np.arange(cfg.by, dtype=np.int64)
    parts = np.zeros(n, dtype=PARTICLE_DTYPE)
    gx, gy, gs = np.meshgrid(bxs, bys, np.arange(fill, dtype=np.int64), indexing="xy")
    gx, gy, gs = gx.ravel(), gy.ravel(), gs.ravel()
    col = gs % cols
    row = gs // cols
    ixg = gx * cols + col  # global hex column
    iyg = gy * rows + row  # global hex row
    # odd rows offset by d/2; +d/4 centering keeps every particle inside its
    # own bucket's [4k, 4k+4) d window
    px = (ixg + 0.5 * (iyg % 2) + 0.25) * d
    py = (iyg + 0.5) * (np.sqrt(3.0) / 2.0) * d
    # ~1% of the spacing of jitter to break exact symmetry
    px = px + rng.uniform(-0.01, 0.01, n) * d
    py = py + rng.uniform(-0.01, 0.01, n) * d
    parts["x"] = np.clip(px / box_w * 2**32, 0, 2**32 - 1).astype(np.uint64).astype(np.uint32)
    parts["y"] = np.clip(py / box_h * 2**32, 0, 2**32 - 1).astype(np.uint64).astype(np.uint32)
    parts["vx"] = rng.normal(0, 1.0, n).astype(np.float32)
    parts["vy"] = rng.normal(0, 1.0, n).astype(np.float32)
    parts["ty"] = 0
    # wall margin: the outer bucket ring stays empty, else the repulsive walls
    # compress the edge rows and the resulting density wave overflows buckets
    interior = (gx > 0) & (gx < cfg.bx - 1) & (gy > 0) & (gy < cfg.by - 1)
    parts["ty"][~interior] = -1

    state = state_to_grid(state_from_numpy(parts, cfg.capacity), cfg)
    return state, meta, int(np.count_nonzero(interior))


SCENES = {
    "liquid_droplet": liquid_droplet,
    "gas_diffusion": gas_diffusion,
    "solid_crystal": solid_crystal,
}


@dataclasses.dataclass
class SceneStats:
    frames: int
    particles: int
    steps_per_frame: int
    elapsed_s: float
    steps_per_sec: float
    mean_speed: float

    def json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def run_scene(
    frame: Frame,
    frames: int = 10,
    render_dir: str | None = None,
    size: int = 512,
    data_structure: DataStructure = DataStructure.MATRIX_BUCKETS,
    device=None,
    gif: str | None = None,
    gif_delay_cs: int = 8,
) -> SceneStats:
    """Advance a scene on-device with the production Simulator; optionally
    render each produced frame to PNG and/or an animated GIF (the analog of
    the reference's doc/*.gif demos)."""
    from particle_simulator_tpu.engine.simulator import Simulator
    from particle_simulator_tpu.editor.render import render_frame, write_gif, write_png

    frame.metadata.data_structure = data_structure
    if device is not None:
        frame.metadata.device = device
    sim = Simulator()
    sim.load_frame(frame)

    outputs = []
    t0 = time.perf_counter()
    for _ in range(frames):
        sim.frame_async()
        outputs.append(sim.read_frame())
    elapsed = time.perf_counter() - t0

    if render_dir:
        import os

        os.makedirs(render_dir, exist_ok=True)
        for i, f in enumerate(outputs):
            write_png(os.path.join(render_dir, f"frame_{i:05d}.png"), render_frame(f, size, size))
    if gif:
        write_gif(gif, (render_frame(f, size, size) for f in outputs),
                  delay_cs=gif_delay_cs)

    last = outputs[-1]
    speed = np.hypot(last.particles["vx"], last.particles["vy"])
    spf = frame.metadata.steps_per_frame
    return SceneStats(
        frames=frames,
        particles=last.particle_count,
        steps_per_frame=spf,
        elapsed_s=round(elapsed, 4),
        steps_per_sec=round(frames * spf / elapsed, 2),
        mean_speed=float(speed.mean()) if len(speed) else 0.0,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scene", choices=sorted(SCENES) + ["phase_sweep"])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--render", default=None, help="directory for PNG output")
    ap.add_argument("--gif", default=None, help="write an animated GIF here")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", type=int, default=None,
                    help="0 = accelerator (default), 1 = CPU thread pool, "
                         "2 = CPU main thread")
    args = ap.parse_args(argv)

    if args.scene == "phase_sweep":
        for label, frame in phase_sweep_frames():
            stats = run_scene(frame, frames=args.frames,
                              render_dir=f"{args.render}/{label}" if args.render else None,
                              size=args.size, device=args.device)
            print(label, stats.json())
        return 0

    stats = run_scene(SCENES[args.scene](), frames=args.frames,
                      render_dir=args.render, size=args.size, device=args.device,
                      gif=args.gif)
    print(stats.json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
