"""Config-5 benchmark: the ASSEMBLED interactive editor at 1M on real hardware.

BASELINE.json's config 5 ("interactive editor at 1M+") was previously
evidenced piecewise (engine throughput, /frame.bin payload rate, browser
draw) — this script measures the assembled system end-to-end: a real webview
process (editor side, CPU) and a real daemon process (engine side, GPU)
over a real TCP socket, with a 1024x1024 ~1M-particle lattice drawn through
the HTTP surface exactly like a user would.

Reported (one JSON line):
- engine_fps: engine frames/s arriving in the editor timeline (frame_count
  growth over the window) — the number the reference's own trace analysis
  bounds at "~30 fps needed" for its 2-stream overlap (doc/project.typ:710-724)
- sim_steps_per_sec: engine_fps x steps_per_frame
- payloads_per_sec / payload_mb: sustained /frame.bin fetch rate under load
  (the WebGL client's data feed; one fetch per browser rAF tick, capped here
  by loopback HTTP)
- limiter: which side bounds the assembled loop — the engine feed
  (compute + shipping, = engine_fps) or the /frame.bin fetch path

Logs of both processes go to .smoke_tmp/ in the checkout.

Usage (GPU host):
    python scripts/interactive_1m_chip.py [--seconds 60] [--steps-per-frame 100]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def post(base: str, path: str, payload: dict) -> dict:
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read() or b"{}")


def get_json(base: str, path: str) -> dict:
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--n-side", type=int, default=1024)
    ap.add_argument("--steps-per-frame", type=int, default=100,
                    help="reference default interactive cadence (particle.rs:139-142)")
    ap.add_argument("--http-port", type=int, default=8731)
    ap.add_argument("--tcp-port", type=int, default=53141)
    ap.add_argument("--compile-wait", type=float, default=300.0,
                    help="first-frame budget, compile included")
    ap.add_argument("--readback-pipeline", type=int, default=1)
    args = ap.parse_args(argv)

    base = f"http://127.0.0.1:{args.http_port}"
    env_cpu = dict(os.environ, JAX_PLATFORMS="cpu")
    logs = os.path.join(REPO, ".smoke_tmp")
    os.makedirs(logs, exist_ok=True)
    # spawn INSIDE the try: a failure spawning the daemon must still tear
    # down the webview (a leaked listener makes the next unattended queue
    # run fail to bind the same ports)
    web = daemon = None
    try:
        web = subprocess.Popen(
            [sys.executable, "-m", "particle_simulator_tpu.editor.webview",
             "--http", f"127.0.0.1:{args.http_port}",
             "--addr", f"127.0.0.1:{args.tcp_port}"],
            cwd=REPO, env=env_cpu,
            stdout=open(os.path.join(logs, "i1m_webview.log"), "wb"),
            stderr=subprocess.STDOUT)
        daemon = subprocess.Popen(
            [sys.executable, "-m", "particle_simulator_tpu.engine.daemon",
             "--addr", f"127.0.0.1:{args.tcp_port}",
             "--readback-pipeline", str(args.readback_pipeline),
             "--retry-s", "60"],
            cwd=REPO,
            stdout=open(os.path.join(logs, "i1m_daemon.log"), "wb"),
            stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                get_json(base, "/stats")
                break
            except Exception:
                time.sleep(0.5)
        else:
            raise RuntimeError("webview HTTP never came up")

        # size the box to the lattice (user-scene density: 2x occupancy
        # headroom -> the cap-16 grid, the honest interactive configuration),
        # stable dt for a dense lattice (10 fs, doc/project.typ:209)
        from particle_simulator_tpu.io.frame import MieParams

        r0 = MieParams.nitrogen().force0_r()
        span = args.n_side * 1.1 * r0
        box = span / 0.5
        post(base, "/params", {"box_width": box, "box_height": box,
                               "step_dt": 10e-15,
                               "steps_per_frame": args.steps_per_frame})
        post(base, "/control", {"action": "lattice",
                                "nx": args.n_side, "ny": args.n_side})
        n_expect = args.n_side * args.n_side

        # wait out connect + first compile until engine frames flow
        t0 = time.monotonic()
        first = st = None
        while time.monotonic() - t0 < args.compile_wait:
            st = get_json(base, "/stats")
            if st["particle_count"] >= 0.9 * n_expect and st["frame_count"] >= 2:
                first = st
                break
            time.sleep(1.0)
        if first is None:
            raise RuntimeError(f"engine frames never arrived: {st}")
        ttff = time.monotonic() - t0
        print(json.dumps({"event": "first_frames", "wait_s": round(ttff, 1),
                          "stats": {k: first[k] for k in
                                    ("frame_count", "particle_count", "device")}}),
              flush=True)

        # measurement window: timeline growth + sustained /frame.bin fetching
        fetch_stats = {"count": 0, "bytes": 0, "errors": 0}
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    req = urllib.request.urlopen(base + "/frame.bin", timeout=30)
                    fetch_stats["bytes"] += len(req.read())
                    fetch_stats["count"] += 1
                except Exception:
                    fetch_stats["errors"] += 1
                    time.sleep(0.1)

        th = threading.Thread(target=hammer, daemon=True)
        s0 = get_json(base, "/stats")
        w0 = time.monotonic()
        th.start()
        time.sleep(args.seconds)
        s1 = get_json(base, "/stats")
        stop.set()
        elapsed = time.monotonic() - w0
        th.join(timeout=10)

        frames = s1["frame_count"] - s0["frame_count"]
        engine_fps = frames / elapsed
        payload_rate = fetch_stats["count"] / elapsed
        result = {
            "metric": "interactive-editor-1m",
            "particles": s1["particle_count"],
            "seconds": round(elapsed, 1),
            "engine_frames": frames,
            "engine_fps": round(engine_fps, 2),
            "sim_steps_per_sec": round(engine_fps * args.steps_per_frame, 1),
            "steps_per_frame": args.steps_per_frame,
            "frame_bin_payloads_per_sec": round(payload_rate, 1),
            "frame_bin_mb_per_payload": round(
                fetch_stats["bytes"] / max(1, fetch_stats["count"]) / 1e6, 2),
            "fetch_errors": fetch_stats["errors"],
            "timeline_ram_mb": round(s1["timeline_ram"] / 1e6, 1),
            "first_frames_wait_s": round(ttff, 1),
            "device": s1["device"],
            # JS-half verdict archived from the hardware run: the in-page
            # self-test POSTs to /selftest when a browser attaches during the
            # window; headless runs report null (ARCHITECTURE.md section 7's
            # split self-test strategy, closed per VERDICT r3 item 8)
            "selftest": s1.get("selftest"),
            # which side bounds the assembled loop: the engine feed (compute
            # + shipping = engine_fps) or the /frame.bin fetch path; the two
            # rates above give the margin
            "limiter": "engine" if engine_fps < payload_rate else "frame.bin-fetch",
        }
        print(json.dumps(result), flush=True)
        return 0
    finally:
        # graceful engine teardown first: the editor disconnect lets the
        # daemon drain its ship pipeline and exit on its own
        try:
            post(base, "/control", {"action": "disconnect"})
        except Exception:
            pass
        try:
            if daemon is not None:
                daemon.terminate()
                daemon.wait(timeout=120)
        except Exception:
            pass
        try:
            if web is not None:
                web.terminate()
                web.wait(timeout=30)
        except Exception:
            pass


if __name__ == "__main__":
    sys.exit(main())
