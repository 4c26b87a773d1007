"""End-to-end engine-daemon tests: the full editor<->engine protocol loop over
a real TCP socket, in-process (editor stand-in on the main thread, daemon on a
worker thread) — the analog of running the reference's two binaries on one
machine (doc/project.typ:511-520).

Regression anchor: the daemon ships frame k's state while frame k+1 computes
from it, so the frame runner must NOT donate its input buffers.
"""

import os
import threading
import time

import numpy as np
import pytest

from particle_simulator_tpu.engine.daemon import Frontend, main_loop
from particle_simulator_tpu.engine.simulator import Simulator
from particle_simulator_tpu.io.frame import Frame
from particle_simulator_tpu.io.presets import ParticleLattice
from particle_simulator_tpu.io.transport import new_tcp_client, new_tcp_server
from particle_simulator_tpu.physics.bucket import GridConfig


def scene_frame(n=8, steps=5):
    """Sparse lattice: spacing ~4 equilibrium distances so no bucket of the
    16x16-cap-8 test grid overflows (overflow legitimately drops particles —
    that behavior is tested in test_bucket.py, not here)."""
    frame = Frame.new()
    meta = frame.metadata
    lat = ParticleLattice((n, n), distance_factor=4.0, velocity=(0.0, 10.0))
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2), rng=np.random.default_rng(0))
    meta.steps_per_frame = steps
    return frame


def accept_blocking(server, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        conn = server.try_accept()
        if conn:
            return conn
        time.sleep(0.005)
    raise TimeoutError("engine never connected")


def run_daemon(port, max_frames, grid=GridConfig(4, 4, 8)):
    """Daemon side: connect, wait for scene, run the main loop."""
    reader, writer = new_tcp_client(("127.0.0.1", port))
    frontend = Frontend(reader, writer, verbose=False)
    sim = Simulator(grid)
    while frontend.is_connected:
        f = frontend.read()
        if f is not None and f.particle_count > 0:
            sim.load_frame(f)
            break
        time.sleep(0.001)
    main_loop(frontend, sim, max_frames=max_frames)


def read_frames(reader, want, timeout=60.0):
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < want and time.monotonic() < deadline:
        f = reader.read()
        if f is None:
            time.sleep(0.002)
            continue
        got.append(f)
    return got


def test_daemon_ships_live_frames_over_tcp():
    server = new_tcp_server(("127.0.0.1", 0))
    t = threading.Thread(target=run_daemon, args=(server.addr[1], 6), daemon=True)
    t.start()
    reader, writer = accept_blocking(server)

    scene = scene_frame()
    assert writer.write(scene)

    frames = read_frames(reader, want=5)
    assert len(frames) == 5, f"got {len(frames)} frames"
    for f in frames:
        assert f.is_valid()
        assert f.particle_count == scene.particle_count  # no particles lost
        assert np.isfinite(f.particles["vx"]).all()
        assert np.isfinite(f.particles["vy"]).all()

    # the simulation actually advances: positions change across frames
    assert not np.array_equal(frames[0].particles["x"], frames[-1].particles["x"])
    t.join(timeout=30)
    server.close()


def test_daemon_metadata_only_update_applies_live():
    server = new_tcp_server(("127.0.0.1", 0))
    t = threading.Thread(target=run_daemon, args=(server.addr[1], 64), daemon=True)
    t.start()
    reader, writer = accept_blocking(server)

    scene = scene_frame()
    assert writer.write(scene)
    read_frames(reader, want=2)

    # live reconfigure: cursor moves, dt changes — no scene reset
    update = Frame.new()
    update.header["metadata"] = scene.metadata.copy()
    update.metadata.step_dt = 1e-15
    update.metadata.cursor_pos = (0.5, 0.5)
    assert update.particle_count == 0
    assert writer.write(update)

    # frames in flight when the edit lands keep their old stamp (they were
    # computed under it); the new dt appears a couple of frames later
    later = []
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        later += read_frames(reader, want=1, timeout=10.0)
        if later and abs(later[-1].metadata.step_dt - 1e-15) < 1e-20:
            break
    assert later, "engine died after metadata-only frame"
    # metadata round-trips on outbound frames
    assert any(abs(f.metadata.step_dt - 1e-15) < 1e-20 for f in later)
    # particles were NOT reset
    assert all(f.particle_count == scene.particle_count for f in later)
    t.join(timeout=30)
    server.close()


def test_daemon_scene_reset_replaces_particles():
    server = new_tcp_server(("127.0.0.1", 0))
    # generous budget: the ship worker + readback pipeline run the wire a few
    # frames behind the main loop, so the reset echo lands several frames
    # after our write — the budget must not expire first (same flake guard
    # as test_daemon_data_structure_switch_mid_run)
    t = threading.Thread(target=run_daemon, args=(server.addr[1], 64), daemon=True)
    t.start()
    reader, writer = accept_blocking(server)

    assert writer.write(scene_frame(n=8))
    read_frames(reader, want=2)

    bigger = scene_frame(n=10)
    assert writer.write(bigger)

    # soon the stream switches to the new particle count (the reset is echoed
    # back, reference cuda_simulator.cu:15-21)
    deadline = time.monotonic() + 60.0
    found = False
    while time.monotonic() < deadline and not found:
        for f in read_frames(reader, want=1, timeout=10.0):
            if f.particle_count == bigger.particle_count:
                found = True
    assert found, "scene reset never echoed on the wire"
    t.join(timeout=60)
    server.close()


def test_daemon_data_structure_switch_mid_run():
    """A scene reset can switch CompactArray <-> MatrixBuckets live
    (the layout travels in-band; reference cuda_simulator.cu:15-21)."""
    from particle_simulator_tpu.io.frame import DataStructure

    server = new_tcp_server(("127.0.0.1", 0))
    # generous frame budget: under suite load the daemon can ship many
    # frames between our write() and its next frontend poll, and it must
    # not hit max_frames before the reset arrives (observed flake)
    t = threading.Thread(target=run_daemon, args=(server.addr[1], 200), daemon=True)
    t.start()
    reader, writer = accept_blocking(server)

    scene = scene_frame()
    scene.metadata.data_structure = DataStructure.MATRIX_BUCKETS
    assert writer.write(scene)
    first = read_frames(reader, want=2)
    assert all(f.metadata.data_structure == DataStructure.MATRIX_BUCKETS for f in first)

    scene2 = scene_frame(n=6)
    scene2.metadata.data_structure = DataStructure.COMPACT_ARRAY
    assert writer.write(scene2)
    switched = []
    deadline = time.monotonic() + 60.0
    while not switched and time.monotonic() < deadline:
        switched = [
            f for f in read_frames(reader, want=4, timeout=10.0)
            if f.particle_count == scene2.particle_count
        ]
    assert switched, "scene reset never took effect"
    assert all(
        f.metadata.data_structure == DataStructure.COMPACT_ARRAY for f in switched
    )
    assert all(np.isfinite(f.particles["vx"]).all() for f in switched)
    t.join(timeout=30)
    server.close()


def test_daemon_sharded_over_mesh():
    """End-to-end: the engine shards the bucket grid over the virtual 8-device
    mesh and streams frames over TCP — the multi-chip production topology
    (editor on host 0, spatial domain decomposition across chips)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")

    from particle_simulator_tpu.parallel.domain import make_mesh

    def run_sharded(port, max_frames):
        reader, writer = new_tcp_client(("127.0.0.1", port))
        frontend = Frontend(reader, writer, verbose=False)
        sim = Simulator(GridConfig(4, 4, 8), mesh=make_mesh(n_devices=8))
        while frontend.is_connected:
            f = frontend.read()
            if f is not None and f.particle_count > 0:
                sim.load_frame(f)
                break
            time.sleep(0.001)
        main_loop(frontend, sim, max_frames=max_frames)

    server = new_tcp_server(("127.0.0.1", 0))
    t = threading.Thread(target=run_sharded, args=(server.addr[1], 5), daemon=True)
    t.start()
    reader, writer = accept_blocking(server)
    scene = scene_frame()
    assert writer.write(scene)

    frames = read_frames(reader, want=4)
    assert len(frames) == 4
    for f in frames:
        assert f.particle_count == scene.particle_count
        assert np.isfinite(f.particles["vx"]).all()
    assert not np.array_equal(frames[0].particles["x"], frames[-1].particles["x"])
    t.join(timeout=60)
    server.close()


def test_sharded_read_frame_dense_pack_bit_identical():
    """read_frame on a single-host sharded mesh state takes the dense-pack
    fast path (ops/readback.py) and its wire frame is byte-identical to the
    full-grid slow path — including over an odd mesh with tombstone pad rows.
    The sharded frame fn returns the unpadded global grid P("dy","dx",None),
    on which dense_readback's cumsum/gather algebra is mesh-agnostic (GSPMD
    inserts the collectives); the editor wire order (global bucket scan,
    ascending slots — frontend.hpp:50-56) is unchanged because pad rows are
    all-tombstone and contribute zero counts."""
    import jax

    from particle_simulator_tpu.parallel.domain import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")

    for n_dev in (8, 3):
        sim = Simulator(GridConfig(4, 4, 8), mesh=make_mesh(n_devices=n_dev))
        sim.load_frame(scene_frame())
        sim.frame_async()  # state becomes a sharded jit output
        slow = sim.read_frame()  # CPU platform: full-grid slow path
        sim.force_device_readback = True
        ticket = sim.start_readback()
        assert ticket.packed is not None, (
            f"dense-pack fast path did not engage on the {n_dev}-device mesh state"
        )
        fast = sim.read_frame(ticket)
        assert fast.particle_count == slow.particle_count
        assert fast.particles.tobytes() == slow.particles.tobytes()


def test_grid_selection_is_density_aware():
    """A dense scene must not silently drop most of its particles: the engine
    grows the grid (finer buckets, then deeper buckets past the physics
    floor) until the scene fits."""
    from particle_simulator_tpu.io.frame import MieParams

    frame = Frame.new()
    meta = frame.metadata
    r0 = MieParams.nitrogen().force0_r()
    # 100x100 lattice at 1.05 r0 spacing, box sized so the lattice covers
    # only ~36% of the box area: per-bucket occupancy at 64x64 would overflow
    n = 100
    span = n * r0 * 1.05
    meta.box_width = span / 0.6
    meta.box_height = span / 0.6
    lat = ParticleLattice((n, n), distance_factor=1.05, velocity=(0.0, 0.0))
    lat.hex_square(frame, (meta.box_width / 2, meta.box_height / 2), rng=np.random.default_rng(0))

    sim = Simulator()
    sim.load_frame(frame)
    assert sim.live_count == n * n, f"dropped {n*n - sim.live_count} particles"
    # and the bucket width stayed at/above the physics floor
    assert meta.box_width / sim.grid.bx >= 2.0 * r0 or sim.grid.cap > 16


def test_daemon_sharded_odd_mesh():
    """Sharded engine over a 3-device mesh (odd y axis -> padded rows)."""
    import jax

    if len(jax.devices()) < 3:
        pytest.skip("needs 3 virtual devices")

    from particle_simulator_tpu.parallel.domain import make_mesh

    def run_sharded(port, max_frames):
        reader, writer = new_tcp_client(("127.0.0.1", port))
        frontend = Frontend(reader, writer, verbose=False)
        sim = Simulator(GridConfig(4, 4, 8), mesh=make_mesh(n_devices=3))
        while frontend.is_connected:
            f = frontend.read()
            if f is not None and f.particle_count > 0:
                sim.load_frame(f)
                break
            time.sleep(0.001)
        main_loop(frontend, sim, max_frames=max_frames)

    server = new_tcp_server(("127.0.0.1", 0))
    t = threading.Thread(target=run_sharded, args=(server.addr[1], 4), daemon=True)
    t.start()
    reader, writer = accept_blocking(server)
    scene = scene_frame()
    assert writer.write(scene)
    frames = read_frames(reader, want=3)
    assert len(frames) == 3
    assert all(f.particle_count == scene.particle_count for f in frames)
    assert all(np.isfinite(f.particles["vx"]).all() for f in frames)
    t.join(timeout=60)
    server.close()


def test_daemon_record_tee(tmp_path):
    """--record tees outbound frames to a replayable file."""
    from particle_simulator_tpu.io.transport import Reader, Writer

    record_path = str(tmp_path / "record.bin")

    def run_recording(port, max_frames):
        reader, writer = new_tcp_client(("127.0.0.1", port))
        frontend = Frontend(reader, writer, verbose=False,
                            record=Writer.open_file(record_path))
        sim = Simulator(GridConfig(4, 4, 8))
        while frontend.is_connected:
            f = frontend.read()
            if f is not None and f.particle_count > 0:
                sim.load_frame(f)
                break
            time.sleep(0.001)
        main_loop(frontend, sim, max_frames=max_frames)
        frontend.record.close()

    server = new_tcp_server(("127.0.0.1", 0))
    t = threading.Thread(target=run_recording, args=(server.addr[1], 4), daemon=True)
    t.start()
    reader, writer = accept_blocking(server)
    assert writer.write(scene_frame())
    live = read_frames(reader, want=3)
    t.join(timeout=30)
    server.close()

    # the recording replays to the same frames the editor saw live
    rec = Reader.open_file(record_path)
    recorded = read_frames(rec, want=3)
    assert len(recorded) >= 3
    for a, b in zip(live, recorded):
        assert a.bytes == b.bytes


def test_scene_reset_echoes_loaded_scene_without_duplicates():
    """A scene reset echoes the loaded scene itself (positions identical to the
    incoming frame, reference cuda_simulator.cu:16-20), and the stream does not
    ship the same state twice in a row afterwards."""
    server = new_tcp_server(("127.0.0.1", 0))
    # generous frame budget: the daemon ships at full speed while the reset
    # frame is still in the socket, so under CPU load it can burn many
    # old-scene frames before its newest-wins poll sees the reset — a small
    # budget makes the test flake on delivery latency, not on semantics
    t = threading.Thread(target=run_daemon, args=(server.addr[1], 64), daemon=True)
    t.start()
    reader, writer = accept_blocking(server)

    assert writer.write(scene_frame(n=8))
    read_frames(reader, want=2)

    bigger = scene_frame(n=10)
    assert writer.write(bigger)
    # read until 3 post-reset frames arrive (bounded by the helper timeout
    # and by the daemon's 64-frame exit), however many old-scene frames were
    # already in flight
    reset_stream = []
    deadline = time.monotonic() + 60.0
    while len(reset_stream) < 3 and time.monotonic() < deadline:
        got = read_frames(reader, want=1, timeout=10.0)
        if not got:
            break
        reset_stream += [f for f in got if f.particle_count == bigger.particle_count]
    assert len(reset_stream) >= 3

    def pos_set(f):
        return set(zip(f.particles["x"].tolist(), f.particles["y"].tolist()))

    # the first post-reset frame is the scene echo (same positions, any order)
    assert pos_set(reset_stream[0]) == pos_set(bigger)
    # and subsequent frames each advance (no duplicate sends of one state)
    for a, b in zip(reset_stream, reset_stream[1:]):
        assert pos_set(a) != pos_set(b)
    t.join(timeout=30)
    server.close()


def test_metadata_only_frame_switches_data_structure_live():
    """A count==0 frame that changes data_structure re-layouts the RUNNING
    scene without a reset (reference write_metadata copies the full metadata
    and run_async dispatches on it, cuda_simulator.cu:12-14 + kernel.cuh):
    MatrixBuckets -> CompactArray -> back, zero particle loss."""
    from particle_simulator_tpu.io.frame import DataStructure

    scene = scene_frame(n=8, steps=2)
    scene.metadata.data_structure = DataStructure.MATRIX_BUCKETS
    sim = Simulator(GridConfig(4, 4, 8))
    sim.load_frame(scene)
    n = scene.particle_count
    for _ in range(2):
        sim.frame_async()
    assert sim.data_structure == DataStructure.MATRIX_BUCKETS

    def metadata_only(ds):
        f = Frame.new()
        f.header["metadata"] = scene.metadata.copy()
        f.metadata.data_structure = ds
        assert f.particle_count == 0
        return f

    sim.update_metadata(metadata_only(DataStructure.COMPACT_ARRAY))
    assert sim.data_structure == DataStructure.COMPACT_ARRAY
    assert sim.live_count == n
    for _ in range(2):
        sim.frame_async()
    assert sim.live_count == n

    sim.update_metadata(metadata_only(DataStructure.MATRIX_BUCKETS))
    assert sim.data_structure == DataStructure.MATRIX_BUCKETS
    assert sim.live_count == n
    for _ in range(2):
        sim.frame_async()
    assert sim.live_count == n
    out = sim.read_frame()
    assert np.isfinite(out.particles["vx"]).all()


def test_metadata_only_frame_switches_device_live():
    """A count==0 frame that changes the device re-layouts onto the new device
    mid-run; a launch-width edit alone is accepted and echoed, and re-lays
    out nothing (no frame program takes a launch width)."""
    from particle_simulator_tpu.io.frame import Device

    scene = scene_frame(n=6, steps=2)
    sim = Simulator(GridConfig(4, 4, 8))
    sim.load_frame(scene)
    n = scene.particle_count
    sim.frame_async()
    initial_device = sim.active_device

    f = Frame.new()
    f.header["metadata"] = scene.metadata.copy()
    f.metadata.device = Device.CPU_MAIN_THREAD
    sim.update_metadata(f)
    assert sim.active_device == Device.CPU_MAIN_THREAD
    assert sim.active_device != initial_device or initial_device == Device.CPU_MAIN_THREAD
    assert sim.live_count == n
    sim.frame_async()
    assert sim.live_count == n

    # a live launch-width edit alone is echoed and changes nothing else
    g = Frame.new()
    g.header["metadata"] = sim.read_frame().metadata.copy()
    g.metadata.gpu_threads_per_block_log2 = 9
    state = sim.state
    sim.update_metadata(g)
    assert int(sim.meta_record["gpu_threads_per_block_log2"]) == 9
    assert sim.state is state and sim.active_device == Device.CPU_MAIN_THREAD
    assert sim.read_frame().metadata.gpu_threads_per_block_log2 == 9


def test_grid_for_prefers_small_caps():
    """The density-aware grid picks the smallest capacity (>=8) that fits with
    drift headroom: the step kernel's pass count scales with cap, so cap-8
    grids run ~2x faster than cap-16 at equal slot count."""
    from particle_simulator_tpu.engine.simulator import _grid_for
    from particle_simulator_tpu.io.frame import MieParams, PARTICLE_DTYPE
    from particle_simulator_tpu.physics.bucket import REFERENCE_GRID

    r0 = MieParams.nitrogen().force0_r()
    rng = np.random.default_rng(5)
    # a dense uniform lattice (4.4 r0 buckets hold 4x4 particles at 1.1 r0):
    # exactly the regime where cap-8 over a finer grid halves the kernel work
    side = 256
    n = side * side
    parts = np.zeros(n, dtype=PARTICLE_DTYPE)
    box = side * 1.1 * r0
    ix, iy = np.meshgrid(np.arange(side), np.arange(side), indexing="xy")
    parts["x"] = ((ix.ravel() + 0.5) / side * 2**32).astype(np.uint64).astype(np.uint32)
    parts["y"] = ((iy.ravel() + 0.5) / side * 2**32).astype(np.uint64).astype(np.uint32)
    cfg = _grid_for(parts, REFERENCE_GRID, box, r0)
    assert cfg.cap <= 8
    assert cfg.capacity >= n
    # the 3x3 window still covers the force range: bucket side >= 2 r0
    assert box / cfg.bx >= 2.0 * r0
    # a pathologically clumped scene still escalates capacity instead
    clump = parts.copy()
    clump["x"] >>= np.uint32(8)  # squeeze everything into 1/256 of the box
    clump["y"] >>= np.uint32(8)
    cfg2 = _grid_for(clump, REFERENCE_GRID, box, r0)
    bx = (clump["x"] >> np.uint32(32 - cfg2.bx_log2)).astype(np.int64)
    by = (clump["y"] >> np.uint32(32 - cfg2.by_log2)).astype(np.int64)
    occ = np.bincount(by * cfg2.bx + bx, minlength=cfg2.buckets).max()
    assert occ <= cfg2.cap or cfg2.cap == 256


def test_metadata_only_frame_with_garbage_enums_is_ignored():
    """Out-of-range device/data_structure bytes in a metadata-only frame must
    not kill the engine: the running values are kept (pre-switch behavior)."""
    scene = scene_frame(n=6, steps=2)
    sim = Simulator(GridConfig(4, 4, 8))
    sim.load_frame(scene)
    n = scene.particle_count
    before_ds = sim.data_structure
    before_dev = sim.active_device

    f = Frame.new()
    f.header["metadata"] = scene.metadata.copy()
    f.header["metadata"]["device"] = 7  # not a Device
    f.header["metadata"]["data_structure"] = 9  # not a DataStructure
    f.header["metadata"]["steps_per_frame"] = 3
    sim.update_metadata(f)  # must not raise
    assert sim.data_structure == before_ds
    assert sim.active_device == before_dev
    assert int(sim.meta_record["steps_per_frame"]) == 3  # params still applied
    sim.frame_async()
    assert sim.live_count == n


def test_readback_pipeline_depths_ship_identical_streams():
    """The pipelined readback (depth N) must ship the exact same frame
    sequence as the reference's ship-while-computing cadence (depth 0) —
    only the wall-clock at which each frame leaves changes."""
    streams = {}
    for depth in (0, 2):
        server = new_tcp_server(("127.0.0.1", 0))

        def run(port, depth=depth):
            reader, writer = new_tcp_client(("127.0.0.1", port))
            frontend = Frontend(reader, writer, verbose=False)
            sim = Simulator(GridConfig(4, 4, 8))
            while frontend.is_connected:
                f = frontend.read()
                if f is not None and f.particle_count > 0:
                    sim.load_frame(f)
                    break
                time.sleep(0.001)
            main_loop(frontend, sim, max_frames=6, readback_depth=depth)

        t = threading.Thread(target=run, args=(server.addr[1],), daemon=True)
        t.start()
        reader, writer = accept_blocking(server)
        assert writer.write(scene_frame(n=6))
        frames = read_frames(reader, want=6)
        t.join(timeout=30)
        server.close()
        assert len(frames) >= 6
        streams[depth] = [f.bytes for f in frames[:6]]

    assert streams[0] == streams[2], "pipelining changed the shipped stream"


def _scripted_stream(ship_thread: bool, depth: int) -> list[bytes]:
    """Run main_loop over a deterministic scripted frontend and return the
    wire byte stream. The script injects the two reorder hazards mid-stream:
    a live metadata edit (poll 2) and a full scene reset (poll 4) — arrival
    is keyed to the poll count, which is iteration-deterministic, so every
    (ship_thread, depth) combination sees identical inputs."""

    class ScriptedFrontend:
        is_connected = True

        def __init__(self):
            self.polls = 0
            self.sent = []  # wire order (worker thread appends under the GIL)

        def read(self):
            self.polls += 1
            if self.polls == 2:
                edit = Frame.new()
                edit.metadata.steps_per_frame = 7
                assert edit.particle_count == 0
                return edit
            if self.polls == 4:
                return scene_frame(n=5, steps=3)
            return None

        def write(self, frame):
            self.sent.append(frame.bytes)

    frontend = ScriptedFrontend()
    sim = Simulator(GridConfig(4, 4, 8))
    sim.load_frame(scene_frame(n=6, steps=2))
    shipped = main_loop(frontend, sim, max_frames=8, readback_depth=depth,
                        ship_thread=ship_thread)
    assert shipped == 8
    assert len(frontend.sent) == 8
    return frontend.sent


def test_ship_worker_wire_stream_identical():
    """main_loop's docstring claims the ship worker leaves the wire byte
    stream IDENTICAL to inline shipping (engine/daemon.py: 'Single consumer,
    FIFO queue'). A/B ship_thread True vs False at depths 0 and 2, across a
    live metadata edit and a mid-stream scene reset — the two hazards where
    a reordering worker would diverge (the reference's overlap never
    reorders either, cuda_simulator.cu:7-26). VERDICT r4 item 4."""
    streams = {
        (ship, depth): _scripted_stream(ship, depth)
        for ship in (False, True)
        for depth in (0, 2)
    }
    for depth in (0, 2):
        assert streams[(True, depth)] == streams[(False, depth)], (
            f"ship worker changed the wire stream at depth {depth}")
    # and depth itself must not reorder (pending flushes before a reset)
    assert streams[(False, 0)] == streams[(False, 2)]


def test_ship_worker_exception_downgrades_to_disconnect():
    """A ship-worker crash (here: the TCP send raising) must mark the
    frontend disconnected and let main_loop drain and return — never
    deadlock on the bounded ship queue (engine/daemon.py:244-263)."""

    class ExplodingFrontend:
        is_connected = True

        def __init__(self):
            self.wrote = 0

        def read(self):
            return None

        def write(self, frame):
            self.wrote += 1
            if self.wrote >= 3:
                raise OSError("simulated broken pipe")

    frontend = ExplodingFrontend()
    sim = Simulator(GridConfig(4, 4, 8))
    sim.load_frame(scene_frame(n=6, steps=2))

    result = {}

    def run():
        result["shipped"] = main_loop(
            frontend, sim, max_frames=32, readback_depth=1, ship_thread=True)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "main_loop deadlocked after a ship-worker crash"
    assert frontend.is_connected is False
    # frames 1..2 hit the wire; the crashing 3rd (and later) never count
    assert result["shipped"] == 2


def test_compilation_cache_persists_executables(tmp_path):
    """The persistent jax compilation cache writes serialized executables so
    daemon restarts skip recompiles. Uses a subprocess so the cache config
    doesn't leak into other tests; JAX_COMPILATION_CACHE_DIR points it at a
    scratch directory (the variable always wins — see the next test)."""
    import subprocess
    import sys
    from pathlib import Path

    cache = tmp_path / "jax_cache"
    prog = (
        "from particle_simulator_tpu.utils.compile_cache import "
        "enable_compilation_cache\n"
        f"assert enable_compilation_cache() == {str(cache)!r}\n"
        "import jax, jax.numpy as jnp\n"
        "import numpy as np\n"
        "f = jax.jit(lambda x: jnp.sin(x) * 2.0 + jnp.cumsum(x))\n"
        "np.asarray(f(jnp.arange(128, dtype=jnp.float32)))\n"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COMPILATION_CACHE_DIR"] = str(cache)
    # jax's min_compile_time gate is 1 s; force caching of this tiny program
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    subprocess.run(
        [sys.executable, "-c", prog],
        env=env, cwd=str(Path(__file__).parent.parent), check=True,
        timeout=300,  # a cold jax import can take minutes under CI load
    )
    entries = list(cache.iterdir())
    assert entries, "no cache entries written"


def test_live_edit_never_restamps_inflight_frames():
    """A live metadata edit must only stamp frames DISPATCHED after it: the
    ticket queued for an in-flight frame carries the metadata snapshot taken
    at its dispatch, not whatever sim.meta_record says at enqueue time
    (r3 review finding: enqueue ran after update_metadata in the same
    iteration, restamping the old-params frame with the new record)."""

    class StubSim:
        """Tracks, per dispatched frame, the meta epoch it was computed
        under; read_frame logs what each shipped frame was stamped with."""

        def __init__(self):
            self.meta_record = {"steps_per_frame": 3}
            self.active_kernel = "bucket-gpu"
            self.dispatched_under = []  # frame id -> steps_per_frame at dispatch
            self.shipped_log = []  # (frame id | None, stamped steps | None)

        def frame_async(self):
            self.dispatched_under.append(self.meta_record["steps_per_frame"])

        def start_readback(self, state=None):
            # ticket = last dispatched id; None before any dispatch (the
            # prime echo ships the loaded scene, not a computed frame)
            if not self.dispatched_under:
                return None
            return len(self.dispatched_under) - 1

        def update_metadata(self, frame):
            self.meta_record = {"steps_per_frame": int(frame.metadata.steps_per_frame)}

        def read_frame(self, state=None, meta=None):
            self.shipped_log.append(
                (state, None if meta is None else meta["steps_per_frame"]))
            f = Frame.new()
            if meta is not None:
                f.metadata.steps_per_frame = meta["steps_per_frame"]
            return f

    class ScriptedFrontend:
        """read() returns None except one metadata-only edit on poll #2."""

        is_connected = True

        def __init__(self):
            self.polls = 0
            self.frames = []

        def read(self):
            self.polls += 1
            if self.polls == 2:
                edit = Frame.new()
                edit.metadata.steps_per_frame = 7
                assert edit.particle_count == 0
                return edit
            return None

        def write(self, frame):
            self.frames.append(frame)

    sim = StubSim()
    main_loop(ScriptedFrontend(), sim, max_frames=8, readback_depth=1)

    checked = 0
    for ticket, stamped in sim.shipped_log:
        if ticket is None:
            continue  # the prime echo carries the current record by design
        assert stamped == sim.dispatched_under[ticket], (
            f"frame {ticket} computed under {sim.dispatched_under[ticket]} "
            f"but stamped {stamped}")
        checked += 1
    assert checked >= 5
    # and the edit did take effect for later dispatches
    assert sim.dispatched_under[0] == 3 and sim.dispatched_under[-1] == 7


@pytest.mark.parametrize("log2", [5, 7, 10])
def test_launch_width_edit_echoes_without_recompile(log2):
    """gpu_threads_per_block_log2 is a field of the frozen wire format (the
    reference's launch width, kernel_bucket.cuh:118-121). The engine's frame
    programs take no launch width: a live edit is echoed in outbound
    metadata and the next frame reuses the compiled program."""
    from particle_simulator_tpu.engine import platform

    sim = Simulator(GridConfig(4, 4, 8))
    scene = scene_frame(n=6, steps=2)
    sim.load_frame(scene)
    sim.frame_async()
    sim.read_frame()
    compiled = platform._run_bucket._cache_size()

    edit = Frame.new()
    edit.header["metadata"] = scene.metadata.copy()
    edit.metadata.gpu_threads_per_block_log2 = log2
    sim.update_metadata(edit)
    sim.frame_async()
    out = sim.read_frame()
    assert out.metadata.gpu_threads_per_block_log2 == log2
    assert platform._run_bucket._cache_size() == compiled
    assert sim.active_kernel == "bucket-cpu"


def test_daemon_log_names_device_and_kernel(tmp_path):
    """serve() logs the device set and, at disconnect, the frame program
    that ran — what chip_smoke.py reads to check the GPU path ran."""
    import json
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = Path(__file__).parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    editor = subprocess.Popen(
        [sys.executable, "-m", "particle_simulator_tpu.editor.headless",
         "--addr", f"127.0.0.1:{port}", "--frames", "3", "--lattice", "6x6",
         "--steps-per-frame", "4"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    daemon = subprocess.run(
        [sys.executable, "-m", "particle_simulator_tpu.engine.daemon",
         "--addr", f"127.0.0.1:{port}", "--max-frames", "3", "--retry-s", "60"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    out, _ = editor.communicate(timeout=120)
    assert daemon.returncode == 0, daemon.stderr[-2000:]
    assert "engine: 8 cpu device(s), cpu" in daemon.stderr
    assert "disconnected after 3 frames (kernel bucket-cpu)" in daemon.stderr
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["frames_received"] == 3 and stats["first_frame_s"] > 0
