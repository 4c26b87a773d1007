"""The engine daemon: TCP main loop speaking the editor protocol.

Process-for-process replacement of the reference simulator binary
(cuda_simulator/src/cuda_simulator.cu:7-54):

1. connect to the editor's TCP server as a client,
2. spin (1 ms sleep) until a frame with particles arrives,
3. then loop: dispatch the next frame's physics on device (async) / poll the
   editor (metadata-only = live reconfigure, non-empty = scene reset + echo) /
   read back and ship the *previous* frame — so device compute of frame k+1
   overlaps host readback and TCP send of frame k, exactly the reference's
   double-buffered overlap, provided here by JAX async dispatch.

Run:  python -m particle_simulator_tpu.engine.daemon [--addr HOST:PORT] [--files DIR]
"""

from __future__ import annotations

import argparse
import sys
import time

from particle_simulator_tpu.engine.simulator import Simulator
from particle_simulator_tpu.io.frame import Frame
from particle_simulator_tpu.io.transport import (
    Disconnected,
    Reader,
    Writer,
    new_tcp_client,
)


class Frontend:
    """Connection glue (frontend.hpp analog): newest-wins reads, compacted writes."""

    def __init__(self, reader: Reader, writer: Writer, verbose: bool = True,
                 record: Writer | None = None):
        self.reader = reader
        self.writer = writer
        self.is_connected = True
        self.verbose = verbose
        # optional tee of every outbound frame to a file — the frame stream IS
        # the checkpoint format (replay with editor.headless --replay)
        self.record = record

    @staticmethod
    def connect_tcp(addr, retry_s: float = 0.0, native: bool = False) -> "Frontend":
        """``native=True`` routes the transport through the C++ particle_io
        library (io/native.py) — the same native frontend role the reference's
        simulator binary plays (frontend.hpp) — instead of the Python codec."""
        if native:
            from particle_simulator_tpu.io.native import new_tcp_client_native as connect
        else:
            connect = new_tcp_client
        deadline = time.monotonic() + retry_s
        while True:
            try:
                reader, writer = connect(addr)
                return Frontend(reader, writer)
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)

    @staticmethod
    def open_files(in_path: str, out_path: str) -> "Frontend":
        """File-pair transport alternative (frontend.hpp:16-20)."""
        return Frontend(Reader.open_file(in_path), Writer.open_file(out_path))

    def read(self) -> Frame | None:
        """Newest pending editor frame, or None."""
        if not self.is_connected:
            return None
        try:
            frame = self.reader.read_last()
        except Disconnected:
            self.is_connected = False
            return None
        if frame is not None and self.verbose:
            print(frame.print(), file=sys.stderr)
        return frame

    def write(self, frame: Frame) -> None:
        if not self.is_connected:
            return
        if self.record is not None:
            self.record.write(frame)
        if not self.writer.write(frame):
            self.is_connected = False


class DistributedFrontend:
    """Multi-process (jax.distributed) coordination around the editor link.

    SPMD rule: every process must issue the SAME sequence of global-array
    computations, but only process 0 holds the editor TCP connection
    (parallel/multihost.py). So process 0 reads the editor and broadcasts a
    (code, frame-bytes) pair each poll; every process then makes identical
    load_frame / update_metadata / frame_async decisions from identical
    bytes. Writes are real only on process 0; a disconnect broadcasts so all
    processes exit their loops together."""

    _NONE, _FRAME, _CLOSED = 0, 1, 2

    def __init__(self, inner: Frontend | None):
        import jax

        self.inner = inner  # the real Frontend on process 0, else None
        self.is_proc0 = jax.process_index() == 0
        assert (inner is not None) == self.is_proc0
        self.is_connected = True
        self.record = None

    @staticmethod
    def _bcast(arr):
        from jax.experimental import multihost_utils

        return multihost_utils.broadcast_one_to_all(arr)

    @classmethod
    def broadcast_abort(cls) -> None:
        """One CLOSED header broadcast — releases peers blocked in read()
        when process 0 dies before a frontend exists (editor unreachable)."""
        import numpy as np

        cls._bcast(np.array([cls._CLOSED, 0], np.int64))

    def read(self) -> Frame | None:
        import numpy as np

        payload = np.zeros(0, np.uint8)
        code = self._NONE
        frame = None
        if self.is_proc0:
            frame = self.inner.read()
            # A frame read in the same poll that detected the disconnect is
            # still delivered (the single-process Frontend would deliver it);
            # CLOSED broadcasts on the FOLLOWING poll, when read() is None.
            if frame is not None:
                code = self._FRAME
                payload = np.frombuffer(frame.bytes, np.uint8)
            elif not self.inner.is_connected:
                code = self._CLOSED
        hdr = self._bcast(np.array([code, len(payload)], np.int64))
        code, length = int(hdr[0]), int(hdr[1])
        if code == self._CLOSED:
            self.is_connected = False
            return None
        if code == self._NONE:
            return None
        buf = payload if self.is_proc0 else np.zeros(length, np.uint8)
        buf = np.asarray(self._bcast(buf), np.uint8)
        return frame if self.is_proc0 else Frame.from_bytes(buf.tobytes())

    def write(self, frame: Frame) -> None:
        if self.is_proc0:
            self.inner.write(frame)  # a failure surfaces via the next read()


def main_loop(frontend: Frontend, sim: Simulator, max_frames: int | None = None,
              readback_depth: int = 1, ship_thread: bool = True) -> int:
    """The compute_frame loop (cuda_simulator.cu:7-38). Returns frames shipped.

    ``readback_depth`` pipelines the device->host readback: each iteration
    dispatches frame k+1, starts an async host copy of frame k's state, and
    ships the state whose copy was started ``readback_depth`` iterations ago
    — so the host copy's latency is hidden behind compute instead of
    serializing with it. Depth 0 is the reference's exact
    cadence (ship frame k while k+1 computes, cuda_simulator.cu:7-26); depth
    1 ships one frame later. Scene resets flush the queue first, so frame
    order on the wire never changes.

    ``ship_thread`` moves the ship stage off the compute loop onto a
    two-stage worker pipeline (readback wait -> wire pack + TCP send), so
    frame k's TCP send overlaps frame k+1's readback wait AND frame k+2's
    compute — the reference ships while computing (cuda_simulator.cu:7-26);
    this ships while computing all the way through the TCP send, without the
    send serializing into the readback cycle. Each stage is a single
    consumer over a FIFO queue: the wire byte stream is identical to inline
    shipping. Forced off under multi-process SPMD, where every process must
    issue device operations in one global order (a concurrent worker would
    interleave readback collectives differently per process)."""
    import queue as queue_mod
    import threading
    from collections import deque

    from particle_simulator_tpu.utils.profiling import StepMeter

    import jax

    if jax.process_count() > 1:
        ship_thread = False

    meter = StepMeter()
    pending: deque = deque()  # states awaiting shipment, oldest first
    shipped = 0  # frames actually written to the wire (worker-owned)
    next_report = time.monotonic() + 30.0

    import os

    trace = os.environ.get("PS_SHIP_TRACE") == "1"
    stage_s = {"readback": 0.0, "send": 0.0}  # cumulative, worker-owned

    def ship_readback(ticket, meta):
        """Stage 1: wait out the device->host copy. Returns the wire Frame,
        or None when the wire budget is already spent (`shipped` only grows,
        so a stale read here just costs one wasted readback — the authoritative
        gate is in ship_send)."""
        if max_frames is not None and shipped >= max_frames:
            return None
        t0 = time.perf_counter()
        frame = sim.read_frame(ticket, meta=meta)
        if trace:
            stage_s["readback"] += time.perf_counter() - t0
        return frame

    def ship_send(frame) -> None:
        """Stage 2: wire pack + TCP send + accounting. Sole writer of
        ``shipped``; runs on the send worker (or inline without one), so the
        wire sees frames in exactly the readback-commit order either way."""
        nonlocal shipped, next_report
        if frame is None or (max_frames is not None and shipped >= max_frames):
            return  # budget spent on the wire; drop the queued extra
        t1 = time.perf_counter()
        frontend.write(frame)
        if trace:
            stage_s["send"] += time.perf_counter() - t1
        shipped += 1
        meter.tick(frame.metadata.steps_per_frame, frame.particle_count)
        # every 64 frames, but at least every 30 s — big scenes ship well
        # under 1 fps and would otherwise never surface their throughput
        if shipped % 64 == 0 or time.monotonic() >= next_report:
            # name the frame program so throughput lines are attributable
            suffix = f" [{sim.active_kernel}]"
            if trace:
                suffix += (f" [ship: readback {stage_s['readback']:.2f}s"
                           f" send {stage_s['send']:.2f}s / {shipped} frames]")
            print(f"engine: {meter.report()}{suffix}", file=sys.stderr)
            next_report = time.monotonic() + 30.0

    # -- ship pipeline: two single-consumer FIFO stages (readback worker ->
    #    send worker), so the device->host wait of frame k+1 overlaps the
    #    TCP send of frame k instead of serializing with it. Both queues are
    #    FIFO and each stage has exactly one consumer, so the wire byte
    #    stream stays identical to inline shipping. Bounded queues keep backpressure (each
    #    pending ticket pins device + host buffers).
    ship_q: queue_mod.Queue | None = None
    workers: list = []
    if ship_thread:
        ship_q = queue_mod.Queue(maxsize=max(2, readback_depth + 1))
        send_q: queue_mod.Queue = queue_mod.Queue(maxsize=2)

        def _readback_loop() -> None:
            # after a failure: keep CONSUMING (drop items) so the main loop's
            # bounded ship_q.put never deadlocks; it exits via is_connected
            failed = False
            while True:
                item = ship_q.get()
                if item is None:
                    send_q.put(None)  # propagate shutdown in order
                    return
                if failed:
                    continue
                try:
                    frame = ship_readback(*item)
                    # a None frame is a budget-spent drop — never enqueue it
                    # (None on send_q means SHUTDOWN to the send worker)
                    if frame is not None:
                        send_q.put(frame)
                except Exception as e:  # surface, then stop shipping
                    print(f"engine: ship readback failed: {e!r}",
                          file=sys.stderr)
                    frontend.is_connected = False
                    failed = True

        def _send_loop() -> None:
            # same drop-after-failure discipline: the readback worker's
            # bounded send_q.put must always find a consumer
            failed = False
            while True:
                frame = send_q.get()
                if frame is None:
                    return
                if failed:
                    continue
                try:
                    ship_send(frame)
                except Exception as e:  # surface, then stop shipping
                    print(f"engine: ship send failed: {e!r}", file=sys.stderr)
                    frontend.is_connected = False
                    failed = True

        workers = [
            threading.Thread(target=_readback_loop, daemon=True, name="ship-rb"),
            threading.Thread(target=_send_loop, daemon=True, name="ship-tx"),
        ]
        for w in workers:
            w.start()

    def commit_ship(ticket, meta) -> None:
        """Hand one frame to the wire (via the workers when enabled)."""
        if ship_q is not None:
            ship_q.put((ticket, meta))
        else:
            ship_send(ship_readback(ticket, meta))

    def ship_now() -> None:
        """Ship the CURRENT state (prime / scene-reset echo): capture the
        readback ticket and metadata snapshot synchronously so a deferred
        worker send still serializes exactly this state."""
        commit_ship(sim.start_readback(), sim.meta_record.copy())

    def can_ship() -> bool:
        # gate on the WIRE count, not the commit count: with a ship worker
        # the main loop runs ahead of the wire by the queue depth, and
        # spending the budget at commit time would end the loop (and stop
        # polling the editor) frames before the stream actually finishes —
        # the worker's own shipped-check keeps the wire at exactly the budget
        return max_frames is None or shipped < max_frames

    def flush() -> None:
        # honor max_frames here too: a scene reset with readback_depth > 0
        # must not overshoot the frame budget via the queued backlog
        while pending and can_ship():
            commit_ship(*pending.popleft())

    # prime: echo the prepared first scene and dispatch its first frame
    ship_now()
    sim.frame_async()
    # metadata snapshot at each dispatch — what the in-flight frame was
    # actually computed under (update_metadata only affects the NEXT dispatch)
    dispatched_meta = sim.meta_record.copy()

    while frontend.is_connected and can_ship():
        # Start the readback of the frame just dispatched BEFORE enqueueing
        # the next frame's compute: the device-side compaction
        # (sim.start_readback, ops/readback.py) then lands right behind
        # frame k on the device queue and its host copy overlaps frame k+1.
        prev_ticket = sim.start_readback()
        prev_meta = dispatched_meta
        sim.frame_async()  # enqueue NEXT frame's steps (overlaps readback below)
        dispatched_meta = sim.meta_record.copy()

        incoming = frontend.read()
        if incoming is not None:
            if incoming.particle_count == 0:
                sim.update_metadata(incoming)  # live param tweak (next dispatch)
            else:
                flush()  # ship pending pre-reset frames in order
                sim.load_frame(incoming)  # full scene reset
                # Echo the loaded scene verbatim BEFORE dispatching the next
                # frame (mirrors the prime path above and the reference, which
                # writes the incoming frame as-is, cuda_simulator.cu:16-20);
                # writing after frame_async would ship the post-step state and
                # then re-send it next iteration via prev_state.
                if can_ship():
                    ship_now()
                sim.frame_async()
                dispatched_meta = sim.meta_record.copy()
                continue

        pending.append((prev_ticket, prev_meta))
        if len(pending) > readback_depth:
            commit_ship(*pending.popleft())
    while pending and frontend.is_connected and can_ship():
        commit_ship(*pending.popleft())
    if ship_q is not None:
        ship_q.put(None)
        for w in workers:
            w.join()
    return shipped


def serve(addr=("127.0.0.1", 53123), grid=None, max_frames=None, retry_s: float = 10.0,
          n_devices: int | str | None = None, record: str | None = None,
          native_io: bool = False, readback_depth: int = 1,
          ship_thread: bool = True) -> int:
    from particle_simulator_tpu.physics.bucket import REFERENCE_GRID

    import jax

    devices = jax.devices()
    print(f"engine: {len(devices)} {devices[0].platform} device(s), "
          f"{devices[0].device_kind}", file=sys.stderr)
    if n_devices == "all":
        n_devices = len(devices)
    mesh = None
    if n_devices and n_devices > 1:
        from particle_simulator_tpu.parallel.domain import make_mesh

        mesh = make_mesh(n_devices=n_devices)
        print(f"engine: sharding over a {mesh.devices.shape} device mesh", file=sys.stderr)
    sim = Simulator(grid or REFERENCE_GRID, mesh=mesh)

    multiproc = jax.process_count() > 1
    if multiproc and (not mesh or {
        d.process_index for d in mesh.devices.flat
    } != set(range(jax.process_count()))):
        raise SystemExit(
            "engine: multi-process run needs --devices all (or a count "
            "spanning every host's devices) so EVERY process owns mesh devices"
        )
    if not multiproc or jax.process_index() == 0:
        try:
            frontend = Frontend.connect_tcp(addr, retry_s=retry_s, native=native_io)
        except OSError:
            if multiproc:
                # peers are (or will be) blocked in the broadcast — release
                # them with a CLOSED code before dying
                DistributedFrontend.broadcast_abort()
            raise
        if record:
            frontend.record = Writer.open_file(record)
            print(f"engine: recording outbound frames to {record}", file=sys.stderr)
        print(f"engine: connected to editor at {addr}", file=sys.stderr)
    else:
        frontend = None
    if multiproc:
        frontend = DistributedFrontend(frontend)

    # wait for the first non-empty frame (cuda_simulator.cu:43-49)
    while frontend.is_connected:
        frame = frontend.read()
        if frame is not None and frame.particle_count > 0:
            sim.load_frame(frame)
            break
        time.sleep(0.01 if multiproc else 0.001)

    if not frontend.is_connected:
        print("engine: editor disconnected before first scene", file=sys.stderr)
        return 0

    shipped = main_loop(frontend, sim, max_frames=max_frames,
                        readback_depth=readback_depth, ship_thread=ship_thread)
    print(f"engine: disconnected after {shipped} frames "
          f"(kernel {sim.active_kernel})", file=sys.stderr)
    return shipped


def main(argv=None) -> int:
    # multi-host (no-op unless the PS_COORDINATOR env vars are set — see
    # scripts/launch_multihost.sh); must run before the XLA backend wakes up
    from particle_simulator_tpu.parallel.multihost import init_distributed

    if init_distributed():
        import jax

        print(
            f"engine: distributed process {jax.process_index()}/{jax.process_count()}",
            file=sys.stderr,
        )
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--addr", default="127.0.0.1:53123", help="editor TCP address")
    ap.add_argument("--files", default=None, help="DIR: use DIR/backend_in.bin + DIR/backend_out.bin instead of TCP")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--retry-s", type=float, default=10.0, help="keep retrying the connection this long")
    ap.add_argument("--record", default=None,
                    help="tee every outbound frame to this file (replayable "
                         "with editor.headless --replay)")
    ap.add_argument("--devices", default=None,
                    help="shard the bucket grid over this many devices "
                         "(spatial domain decomposition; default: single "
                         "device). 'all' = every device of every host — with the "
                         "multihost env vars set (scripts/launch_multihost.sh) "
                         "that is the GLOBAL device set")
    ap.add_argument("--readback-pipeline", type=int, default=1,
                    help="frames of device->host readback pipelining (hides "
                         "the host copy's latency behind compute; 0 = the "
                         "reference's exact ship-while-computing cadence)")
    ap.add_argument("--ship-thread", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="ship frames (readback wait + pack + TCP send) from "
                         "a dedicated worker thread so shipping overlaps the "
                         "next frames' compute dispatch (identical wire "
                         "stream; auto-disabled under multi-process SPMD)")
    ap.add_argument("--native-io", action="store_true",
                    help="use the C++ particle_io transport (native/) instead "
                         "of the Python codec for the editor connection")
    args = ap.parse_args(argv)

    from particle_simulator_tpu.utils.compile_cache import enable_compilation_cache

    print(f"engine: compilation cache at {enable_compilation_cache()}",
          file=sys.stderr)

    if args.files:
        frontend = Frontend.open_files(f"{args.files}/backend_in.bin", f"{args.files}/backend_out.bin")
        sim = Simulator()
        while frontend.is_connected:
            frame = frontend.read()
            if frame is not None and frame.particle_count > 0:
                sim.load_frame(frame)
                break
            time.sleep(0.001)
        return 0 if main_loop(frontend, sim, args.max_frames,
                              readback_depth=args.readback_pipeline,
                              ship_thread=args.ship_thread) else 1

    host, port = args.addr.rsplit(":", 1)
    devices = args.devices if args.devices in (None, "all") else int(args.devices)
    serve((host, int(port)), max_frames=args.max_frames, retry_s=args.retry_s,
          n_devices=devices, record=args.record, native_io=args.native_io,
          readback_depth=args.readback_pipeline, ship_thread=args.ship_thread)
    return 0


if __name__ == "__main__":
    sys.exit(main())
