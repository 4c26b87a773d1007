#!/usr/bin/env python3
"""Smoke test of the engine on NVIDIA GPUs: the main paths, run and checked.

Run from the root of a checkout, on a machine with a GPU:

    python chip_smoke.py              # every phase below, on one GPU
    python chip_smoke.py --devices 4  # only the sharded daemon on 4 GPUs,
                                      # compared frame by frame with one GPU

Phases (each in child processes, one after another; this parent process
never imports JAX, so at most one process holds a card at any time):

1. device   — JAX's default platform is "gpu", with its kind and count.
2. editor   — the users' main path: the headless editor and the engine
              daemon over real TCP, a 1024x1024 lattice (~1.05M particles)
              on MatrixBuckets at 100 steps/frame. Every frame arrives, the
              live count never grows, every field is finite, and the daemon
              ran the GPU bucket runner.
3. dense    — bench.py's dense scene (cap 8) at 1M and 16M slots through the
              bucket frame runner: compile (cold, and warm from the
              persistent cache), steady rate, memory_analysis, peak memory;
              one step and one rebucket timed alone, and whether the step
              stores the 3x3 neighbourhood stack.
4. allpairs — the 2k droplet and 16k gas scenes through Simulator on
              CompactArray: rate, compile, memory_analysis.
5. numerics — the GPU against the NumPy oracle (physics/crosscheck.py):
              all-pairs at 2k (all rows) and 16k (1024 rows), the bucket
              step on the 1M dense grid (4096 rows), dense_readback at 1M.
6. hw_tests — ``pytest -m gpu tests/test_gpu_hw.py``.

Every phase prints one JSON line naming the card (nvidia-smi's name and
power limit, read by this parent). The last line is
``{"ok": true, "device": {...}}`` only when every phase passed; a failed
phase ends the run with exit code 1 and no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUDGET_S = 1140.0  # the whole run ends inside 1200 s, compiles included

EDITOR_LATTICE = (1024, 1024)
EDITOR_FRAMES = 8  # the scene's echo + 7 computed frames
DENSE_SLOTS = (1 << 20, 1 << 24)
DENSE_FRAMES = 10
NUMERICS = {"allpairs_2k": None, "allpairs_16k": 1024, "bucket_1m": 4096}


class PhaseError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# phases that run inside a child process (they import JAX)
# ---------------------------------------------------------------------------

def _device_fields() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "jax": jax.__version__}


def phase_device(require_gpu: bool = True) -> dict:
    out = _device_fields()
    if require_gpu and out["platform"] != "gpu":
        raise PhaseError(f"JAX's default platform is {out['platform']!r}, not 'gpu'")
    return out


def _memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    return {k: int(getattr(ma, f"{k}_size_in_bytes"))
            for k in ("temp", "argument", "output")}


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _entry_buffers(hlo_text: str, dims: tuple[int, ...]) -> int:
    """Instructions of the optimized HLO's ENTRY computation whose result
    has shape ``dims`` — buffers the program stores in device memory (what a
    fusion computes internally has no such line)."""
    entry = hlo_text[hlo_text.index("ENTRY"):]
    shape = "[" + ",".join(str(d) for d in dims) + "]"
    return sum(1 for line in entry.splitlines()
               if "=" in line and shape in line.split("=", 1)[1].split("(", 1)[0])


def _timed_frames(fn, state, params, frames: int):
    """Steady window: ``frames`` dispatches, one wait at the end."""
    import jax

    t0 = time.perf_counter()
    for _ in range(frames):
        state = fn(state, params)
    state = jax.block_until_ready(state)
    return state, time.perf_counter() - t0


def _compile_bucket_runner(state, params) -> tuple:
    """Lower + compile the bucket frame runner twice: cold, then (after
    clearing JAX's in-memory caches) warm from the persistent cache."""
    import jax

    from particle_simulator_tpu.physics.bucket import run_frame_bucket

    fn = jax.jit(run_frame_bucket)
    t0 = time.perf_counter()
    lowered = fn.lower(state, params)
    t1 = time.perf_counter()
    compiled = lowered.compile()
    t2 = time.perf_counter()
    jax.clear_caches()
    fn = jax.jit(run_frame_bucket)
    t3 = time.perf_counter()
    fn.lower(state, params).compile()
    t4 = time.perf_counter()
    return compiled, {"lower_s": t1 - t0, "compile_cold_s": t2 - t1,
                      "compile_warm_s": t4 - t3}


def _bucket_run(state, params, live: int, frames: int) -> dict:
    import jax
    import numpy as np

    compiled, times = _compile_bucket_runner(state, params)
    out = jax.block_until_ready(compiled(state, params))  # first run, untimed
    out, elapsed = _timed_frames(compiled, out, params, frames)
    steps = int(params.steps_per_frame) * frames
    if not np.isfinite(np.asarray(out.vx)).all():
        raise PhaseError("bucket frame runner produced non-finite velocities")
    return {
        "live": live, "frames": frames,
        "sim_steps_per_s": steps / elapsed,
        "particle_steps_per_s": live * steps / elapsed,
        "frame_s": elapsed / frames,
        "live_end": int(np.count_nonzero(np.asarray(out.ty) >= 0)),
        **times, "memory": _memory(compiled), "peak_bytes_in_use": _peak_bytes(),
    }


def _timed_calls(fn, state, calls: int) -> float:
    """Mean seconds per call of ``fn(state) -> state`` over ``calls`` chained
    calls, after one untimed call."""
    import jax

    out = jax.block_until_ready(fn(state))
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn(out)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / calls


def _step_and_move(state, params, calls: int = 20) -> dict:
    """The frame's two programs compiled and timed alone: one bucket step
    (with its temp bytes and how many (BY, BX, 9*CAP) buffers its ENTRY
    computation stores) and one rebucket pass."""
    import jax

    from particle_simulator_tpu.physics.bucket import bucket_move_direct, bucket_step

    by, bx, cap = state.x.shape
    step = jax.jit(bucket_step)
    compiled = step.lower(state, params).compile()
    n = _entry_buffers(compiled.as_text(), (by, bx, 9 * cap))
    return {"step_memory": _memory(compiled), "stack9_buffers": n,
            "stack9_materialised": n > 0,
            "stack9_bytes_per_field": 9 * by * bx * cap * 4,
            "pair_tile_bytes": by * bx * cap * 9 * cap * 4,
            "step_ms": 1e3 * _timed_calls(lambda s: step(s, params), state, calls),
            "move_ms": 1e3 * _timed_calls(jax.jit(bucket_move_direct), state, calls)}


def phase_dense(slots=DENSE_SLOTS, frames: int = DENSE_FRAMES, steps: int = 100) -> dict:
    import jax
    import numpy as np

    from particle_simulator_tpu.engine.state import SimParams
    from particle_simulator_tpu.scenes.library import dense_grid_config, dense_grid_scene

    device = jax.devices()[0]
    out = {}
    for n_slots in slots:
        cfg = dense_grid_config(n_slots, 8)
        state, meta, live = dense_grid_scene(cfg)
        params = SimParams.from_record(meta)._replace(steps_per_frame=np.int32(steps))
        state = jax.device_put(state, device)
        out[f"dense_{n_slots}"] = {"grid": [cfg.by, cfg.bx, cfg.cap],
                                   **_step_and_move(state, params),
                                   **_bucket_run(state, params, live, frames)}
        del state
    return out


def phase_allpairs(sides=(45, 128), frames: int = DENSE_FRAMES) -> dict:
    import jax
    import numpy as np

    from particle_simulator_tpu.engine import platform
    from particle_simulator_tpu.engine.simulator import Simulator
    from particle_simulator_tpu.io.frame import DataStructure
    from particle_simulator_tpu.scenes.library import gas_diffusion, liquid_droplet

    out = {}
    for name, build, side in (("droplet", liquid_droplet, sides[0]),
                              ("gas", gas_diffusion, sides[1])):
        frame = build(side)
        frame.metadata.data_structure = DataStructure.COMPACT_ARRAY
        sim = Simulator()
        sim.load_frame(frame)
        n = frame.particle_count
        t0 = time.perf_counter()
        sim.frame_async()
        sim.sync()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(frames):
            sim.frame_async()
        sim.sync()
        elapsed = time.perf_counter() - t0
        got = sim.read_frame()
        if not (np.isfinite(got.particles["vx"]).all()
                and np.isfinite(got.particles["vy"]).all()):
            raise PhaseError(f"{name}: non-finite velocities")
        compiled = platform.frame_runner(
            sim.platform, DataStructure.COMPACT_ARRAY
        ).lower(sim.state, sim.params).compile()
        steps = int(sim.params.steps_per_frame) * frames
        capacity = int(sim.state.x.shape[0])
        out[name] = {
            "particles": n, "capacity": capacity, "kernel": sim.active_kernel,
            "first_frame_s": first_s, "sim_steps_per_s": steps / elapsed,
            "pairs_per_s": capacity * capacity * steps / elapsed,
            "memory": _memory(compiled),
            "nxn_f32_bytes": capacity * capacity * 4,
            "peak_bytes_in_use": _peak_bytes(),
        }
        expect = platform.kernel_name(jax.devices()[0].platform,
                                      DataStructure.COMPACT_ARRAY, False)
        if sim.active_kernel != expect:
            raise PhaseError(f"{name}: ran {sim.active_kernel}, expected {expect}")
    return out


def phase_numerics(droplet_side: int = 45, gas_side: int = 128,
                   dense_slots: int = 1 << 20, samples=NUMERICS) -> dict:
    from particle_simulator_tpu.physics import crosscheck
    from particle_simulator_tpu.scenes.library import (
        dense_grid_config,
        dense_grid_scene,
        gas_diffusion,
        liquid_droplet,
    )

    out = {"tolerance": crosscheck.TOLERANCE._asdict()}
    f = liquid_droplet(droplet_side)
    out["allpairs_2k"] = crosscheck.allpairs_vs_oracle(
        f.particles, f.metadata.copy(), sample=samples["allpairs_2k"])
    f = gas_diffusion(gas_side)
    out["allpairs_16k"] = crosscheck.allpairs_vs_oracle(
        f.particles, f.metadata.copy(), sample=samples["allpairs_16k"], seed=1)
    state, meta, _ = dense_grid_scene(dense_grid_config(dense_slots, 8))
    out["bucket_1m"] = crosscheck.bucket_step_vs_oracle(
        state, meta, sample=samples["bucket_1m"], seed=2)
    out["dense_readback_1m"] = crosscheck.dense_readback_vs_host(state)
    bad = [k for k, v in out.items() if isinstance(v, dict) and v.get("ok") is False]
    if bad:
        raise PhaseError(f"outside tolerance: {bad}: {json.dumps(out)}")
    return out


CHILD_PHASES = {"device": phase_device, "dense": phase_dense,
                "allpairs": phase_allpairs, "numerics": phase_numerics}


def _run_child_phase(name: str) -> int:
    from particle_simulator_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    if name != "device":
        phase_device()  # a measurement on anything but the GPU is refused
    print(json.dumps(CHILD_PHASES[name]()), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the parent: orchestration without JAX
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(cmd, timeout: float, env=None) -> subprocess.CompletedProcess:
    """Run a child to completion; on timeout kill its whole process group."""
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=max(1.0, timeout))
    except subprocess.TimeoutExpired:
        _kill(proc)
        out, err = proc.communicate()
        raise PhaseError(f"timed out after {timeout:.0f}s: {' '.join(map(str, cmd))}"
                         f"\n{err[-3000:]}")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def _kill(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, 9)
        except ProcessLookupError:
            pass
    proc.wait()


def _last_json(text: str) -> dict:
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise PhaseError("child printed no JSON result")


def child_phase(name: str, timeout: float, env=None) -> dict:
    r = _run([sys.executable, str(ROOT / "chip_smoke.py"), "--phase", name],
             timeout, env=env)
    if r.returncode != 0:
        raise PhaseError(f"rc={r.returncode}\n{r.stderr[-4000:]}")
    return _last_json(r.stdout)


def read_record(path: Path) -> list:
    """Frames of a daemon ``--record`` stream."""
    from particle_simulator_tpu.io.transport import Disconnected, Reader

    reader = Reader.open_file(str(path))  # parses on a reader thread
    frames = []
    while True:
        try:
            f = reader.read()
        except Disconnected:  # end of file, every frame delivered
            return frames
        if f is None:
            time.sleep(0.001)
        else:
            frames.append(f)


def run_editor_session(lattice, frames: int, workdir: Path, timeout: float,
                       env=None, daemon_args=(), steps: int = 100,
                       step_dt: float = 1e-14) -> dict:
    """Headless editor (TCP server) + engine daemon (client) as two
    processes; returns the editor's stats, the daemon's log facts and the
    recorded outbound frames."""
    port = _free_port()
    record = workdir / f"record_{port}.bin"
    editor_cmd = [
        sys.executable, "-m", "particle_simulator_tpu.editor.headless",
        "--addr", f"127.0.0.1:{port}", "--lattice", f"{lattice[0]}x{lattice[1]}",
        "--frames", str(frames), "--steps-per-frame", str(steps),
        "--step-dt", str(step_dt), "--timeout", str(int(timeout)),
    ]
    daemon_cmd = [
        sys.executable, "-m", "particle_simulator_tpu.engine.daemon",
        "--addr", f"127.0.0.1:{port}", "--max-frames", str(frames),
        "--retry-s", "60", "--record", str(record), *daemon_args,
    ]
    logs = {(k, s): workdir / f"{k}_{port}.{s}" for k in ("editor", "daemon")
            for s in ("out", "err")}
    procs = []
    try:
        with open(logs["editor", "out"], "w") as eo, \
                open(logs["editor", "err"], "w") as ee, \
                open(logs["daemon", "out"], "w") as do, \
                open(logs["daemon", "err"], "w") as de:
            editor = subprocess.Popen(editor_cmd, cwd=ROOT, env=env, stdout=eo,
                                      stderr=ee, start_new_session=True)
            procs.append(editor)
            daemon = subprocess.Popen(daemon_cmd, cwd=ROOT, env=env, stdout=do,
                                      stderr=de, start_new_session=True)
            procs.append(daemon)
            try:
                editor.wait(timeout=timeout)
                daemon.wait(timeout=60)
            except subprocess.TimeoutExpired:
                raise PhaseError("editor session timed out: " + logs[
                    "daemon", "err"].read_text()[-3000:]) from None
    finally:
        for p in procs:
            _kill(p)
    e_out, e_err, d_err = (logs[k].read_text() for k in (
        ("editor", "out"), ("editor", "err"), ("daemon", "err")))
    if editor.returncode != 0 or daemon.returncode != 0:
        raise PhaseError(f"editor rc={editor.returncode} daemon rc="
                         f"{daemon.returncode}\n{e_err[-2000:]}\n{d_err[-3000:]}")
    stats = _last_json(e_out)
    m = re.search(r"disconnected after (\d+) frames \(kernel (\S+)\)", d_err)
    dev = re.search(r"engine: (\d+) (\w+) device\(s\), (.+)", d_err)
    if not m or not dev:
        raise PhaseError(f"daemon log lacks its summary lines\n{d_err[-3000:]}")
    recorded = read_record(record)
    record.unlink(missing_ok=True)
    return {"stats": stats, "shipped": int(m.group(1)), "kernel": m.group(2),
            "device": {"platform": dev.group(2), "kind": dev.group(3).strip(),
                       "count": int(dev.group(1))},
            "frames": recorded}


def phase_editor(workdir: Path, timeout: float, lattice=EDITOR_LATTICE,
                 frames: int = EDITOR_FRAMES, expect_kernel: str = "bucket-gpu",
                 env=None) -> dict:
    import numpy as np

    s = run_editor_session(lattice, frames, workdir, timeout, env=env)
    counts = [f.particle_count for f in s["frames"]]
    problems = []
    if s["stats"].get("frames_received", 0) < frames or len(counts) != frames:
        problems.append(f"frames: editor got {s['stats'].get('frames_received')}, "
                        f"daemon recorded {len(counts)} of {frames}")
    if any(b > a for a, b in zip(counts, counts[1:])):
        problems.append(f"live count grew: {counts}")
    if counts and counts[0] != lattice[0] * lattice[1]:
        problems.append(f"scene echo holds {counts[0]} particles")
    for f in s["frames"]:
        p = f.particles
        if not all(np.isfinite(p[k]).all() for k in ("vx", "vy")):
            problems.append("non-finite velocities")
            break
    if s["kernel"] != expect_kernel:
        problems.append(f"daemon ran {s['kernel']}, expected {expect_kernel}")
    out = {"particles": counts[0] if counts else 0, "live_counts": counts,
           "kernel": s["kernel"], "device": s["device"],
           "first_frame_s": s["stats"].get("first_frame_s"),
           "frames_per_s": s["stats"].get("frames_per_s")}
    if problems:
        raise PhaseError("; ".join(problems) + f" {json.dumps(out)}")
    return out


def phase_hw_tests(workdir: Path, timeout: float) -> dict:
    import xml.etree.ElementTree as ET

    xml = workdir / "hw_tests.xml"
    env = dict(os.environ, PS_TEST_PLATFORM="cuda,cpu")
    r = _run([sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p",
              "no:cacheprovider", f"--junitxml={xml}", "tests/test_gpu_hw.py"],
             timeout, env=env)
    suite = ET.parse(xml).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    counts = {k: int(suite.get(k, 0))
              for k in ("tests", "failures", "errors", "skipped")}
    if r.returncode != 0 or counts["tests"] == 0 or counts["skipped"] \
            or counts["failures"] or counts["errors"]:
        raise PhaseError(f"rc={r.returncode} {counts}\n{r.stdout[-3000:]}")
    return counts


def compare_streams(ref: list, got: list, tol) -> dict:
    """Frame-by-frame comparison of two recorded streams of one scene."""
    from particle_simulator_tpu.physics.crosscheck import compare

    if len(ref) != len(got):
        return {"ok": False, "error": f"{len(ref)} vs {len(got)} frames"}
    worst = {"pos_max_units": 0, "v_max_abs": 0.0, "v_tol_ratio": 0.0}
    per_frame = []
    ok = True
    for i, (a, b) in enumerate(zip(ref, got)):
        if a.particle_count != b.particle_count:
            per_frame.append({"frame": i, "ok": False,
                              "counts": [a.particle_count, b.particle_count]})
            ok = False
            continue
        c = compare(b.particles, a.particles, tol)
        per_frame.append({"frame": i, **c})
        ok &= c["ok"]
        for k in worst:
            worst[k] = max(worst[k], c[k])
    return {"ok": ok, "frames": len(ref), **worst, "per_frame": per_frame}


def phase_sharded(workdir: Path, timeout: float, n_devices: int,
                  lattice=EDITOR_LATTICE, frames: int = 6,
                  platform: str = "gpu") -> tuple[dict, dict]:
    """The 1M editor scene through the daemon on one GPU, then sharded over
    ``n_devices`` GPUs, compared frame by frame: species exact, positions
    within 8 fixed-point units, velocities rtol 1e-4 / atol 1e-6 (shard
    shapes may change fusion and f32 summation order)."""
    from particle_simulator_tpu.physics.crosscheck import Tolerance

    one = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    t0 = time.monotonic()
    ref = run_editor_session(lattice, frames, workdir, timeout / 2, env=one)
    t1 = time.monotonic()
    got = run_editor_session(lattice, frames, workdir, timeout / 2,
                             daemon_args=("--devices", str(n_devices)))
    t2 = time.monotonic()
    cmp = compare_streams(ref["frames"], got["frames"], Tolerance(8, 1e-4, 1e-6))
    out = {
        "one_device": {"kernel": ref["kernel"], "device": ref["device"],
                       "session_s": t1 - t0,
                       "frames_per_s": ref["stats"].get("frames_per_s")},
        "sharded": {"kernel": got["kernel"], "device": got["device"],
                    "session_s": t2 - t1,
                    "frames_per_s": got["stats"].get("frames_per_s")},
        "comparison": cmp,
    }
    if got["device"]["count"] < n_devices or got["kernel"] != f"sharded-{platform}":
        raise PhaseError(f"sharded run used {got['device']}, {got['kernel']}: "
                         + json.dumps(out))
    if not cmp["ok"]:
        raise PhaseError("sharded frames outside tolerance: " + json.dumps(out))
    return out, got["device"]


def result_line(device: dict) -> str:
    """The run's last line: exactly the keys the contract names."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1 (default): every phase on one GPU; N > 1: only "
                         "the sharded daemon over N GPUs against one GPU")
    ap.add_argument("--phase", choices=sorted(CHILD_PHASES),
                    help=argparse.SUPPRESS)  # child entry point
    args = ap.parse_args(argv)
    if args.phase:
        return _run_child_phase(args.phase)

    from particle_simulator_tpu.utils.card import card_info

    deadline = time.monotonic() + BUDGET_S
    card = card_info()
    print(json.dumps({"phase": "card", "card": card}), flush=True)
    workdir = ROOT / ".smoke_tmp"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir()

    def remaining(cap: float) -> float:
        return min(cap, deadline - time.monotonic())

    def report(name: str, fn, cap: float):
        t0 = time.monotonic()
        try:
            result = fn(remaining(cap))
        except PhaseError as e:
            print(json.dumps({"phase": name, "ok": False, "card": card,
                              "seconds": time.monotonic() - t0,
                              "error": str(e)[-6000:]}), flush=True)
            raise
        print(json.dumps({"phase": name, "ok": True, "card": card,
                          "seconds": time.monotonic() - t0, **result}),
              flush=True)
        return result

    try:
        if args.devices > 1:
            held = {}

            def sharded(t):
                out, held["device"] = phase_sharded(workdir, t, args.devices)
                return out

            report(f"sharded_{args.devices}", sharded, 900)
            device = held["device"]
        else:
            device = report("device", lambda t: child_phase("device", t), 120)
            report("editor", lambda t: phase_editor(workdir, t), 420)
            report("dense", lambda t: child_phase("dense", t), 480)
            report("allpairs", lambda t: child_phase("allpairs", t), 240)
            report("numerics", lambda t: child_phase("numerics", t), 240)
            report("hw_tests", lambda t: phase_hw_tests(workdir, t), 300)
    except PhaseError:
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(result_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
