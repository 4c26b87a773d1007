"""Where the device time goes: trace a few frames of the plain programs and
reduce the trace to per-fusion times and the device's idle share.

Cases (each one JSON line):
- ``dense_<slots>``: bench.py's dense scene (cap 8) through the bucket frame
  runner, ``--frames`` frames of ``--steps`` steps;
- ``allpairs_<n>``: the gas scene on CompactArray through the all-pairs
  frame runner.

Each line holds, per device process of the trace (``/device:GPU:0``): the
span from the first op's start to the last op's end, the busy time (union of
op intervals), ``idle_share = 1 - busy / span``, busy ms per step, and the
ops that took the most time (XLA's fusion names). The program is compiled
and run once before the traced window.

Usage (GPU host):
    python scripts/trace_probe.py [--dense 1048576 16777216] [--allpairs 16384]
                                  [--out traces/]
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _union_ms(intervals) -> float:
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def reduce_trace(trace: dict, steps: int, top: int = 12) -> dict:
    """Per device process of a Chrome-format trace (``traceEvents``; times
    in microseconds): span, busy, idle share, busy per step, top ops."""
    names = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    out = {}
    for pid, name in names.items():
        if not name.startswith("/device:"):
            continue
        ops = [e for e in trace["traceEvents"]
               if e.get("ph") == "X" and e.get("pid") == pid and "dur" in e]
        if not ops:
            continue
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in ops]
        span_ms = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3
        busy_ms = _union_ms(spans)
        per_op: dict[str, float] = {}
        for e in ops:
            per_op[e["name"]] = per_op.get(e["name"], 0.0) + float(e["dur"]) / 1e3
        out[name] = {
            "span_ms": span_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / span_ms if span_ms > 0 else 0.0,
            "busy_ms_per_step": busy_ms / steps,
            "top_ms_per_step": [[k, v / steps] for k, v in sorted(
                per_op.items(), key=lambda kv: -kv[1])[:top]],
        }
    return out


def traced(name: str, fn, state, params, frames: int, root: Path) -> dict:
    """Run ``fn`` once untraced, then ``frames`` chained calls under the
    profiler; return the reduced trace."""
    import jax

    state = jax.block_until_ready(fn(state, params))
    log_dir = root / name
    t0 = time.perf_counter()
    with jax.profiler.trace(str(log_dir)):
        for _ in range(frames):
            state = fn(state, params)
        jax.block_until_ready(state)
    wall_s = time.perf_counter() - t0
    files = sorted(log_dir.rglob("*.trace.json.gz"))
    if not files:
        raise SystemExit(f"trace_probe: no trace written under {log_dir}")
    with gzip.open(files[-1]) as f:
        trace = json.load(f)
    steps = int(params.steps_per_frame) * frames
    return {"case": name, "frames": frames, "steps": steps, "wall_s": wall_s,
            "devices": reduce_trace(trace, steps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dense", type=int, nargs="*", default=[1 << 20, 1 << 24])
    ap.add_argument("--allpairs", type=int, nargs="*", default=[16384])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--out", default="traces", help="trace directory")
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    from particle_simulator_tpu.engine import platform
    from particle_simulator_tpu.engine.simulator import Simulator
    from particle_simulator_tpu.engine.state import SimParams
    from particle_simulator_tpu.io.frame import DataStructure
    from particle_simulator_tpu.scenes.library import (
        dense_grid_config,
        dense_grid_scene,
        gas_diffusion,
    )
    from particle_simulator_tpu.utils.card import card_info
    from particle_simulator_tpu.utils.compile_cache import enable_compilation_cache

    device = platform.require_gpu("trace_probe")
    enable_compilation_cache()
    print(card_info(), flush=True)
    root = Path(args.out)
    for n_slots in args.dense:
        cfg = dense_grid_config(n_slots, 8)
        state, meta, _ = dense_grid_scene(cfg)
        params = SimParams.from_record(meta)._replace(
            steps_per_frame=np.int32(args.steps))
        fn = platform.frame_runner(device.platform, DataStructure.MATRIX_BUCKETS)
        frames = args.frames if n_slots <= 1 << 22 else 1
        print(json.dumps(traced(f"dense_{n_slots}", fn, jax.device_put(state, device),
                                params, frames, root)), flush=True)
        del state
    for n in args.allpairs:
        frame = gas_diffusion(int(round(n ** 0.5)))
        frame.metadata.data_structure = DataStructure.COMPACT_ARRAY
        sim = Simulator()
        sim.load_frame(frame)
        fn = platform.frame_runner(device.platform, DataStructure.COMPACT_ARRAY)
        print(json.dumps(traced(f"allpairs_{n}", fn, sim.state, sim.params,
                                args.frames, root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
