"""The simulator core: device state management + frame scheduling.

This replaces the reference's ``Kernel`` buffer manager and dispatch logic
(cuda_simulator/src/kernel.cuh):

- The reference hand-rolls 3 device buffers, a CUDA stream, pinned host memory,
  and ping-pong scheduling. Under JAX none of that is manual: ``jit`` reuses
  device buffers, and **async dispatch** gives the compute/readback overlap
  (compute of frame k+1 overlaps host readback of frame k, the reference's
  double-buffer trick at cuda_simulator.cu:7-26) for free: ``frame_async()``
  returns immediately after enqueueing the device work, and ``read_frame()``
  only blocks on the *previous* state's transfer.

- Scene frames are prepared into the kernel layout on the host
  (``kernel_prepare_frame`` analog, kernel.cuh:200-250): CompactArray frames are
  compacted and capacity-padded; MatrixBuckets frames are bucketized by
  coordinate top-bits.

- Device selection (``Device`` metadata field) is honored per frame at runtime:
  GPU -> the accelerator, CPU_* -> the JAX CPU backend running the *same*
  step functions — preserving the reference's one-kernel-all-devices property
  (doc/project.typ:673-708). If no accelerator is present, GPU falls back to
  CPU_THREAD_POOL exactly like the reference (kernel.cuh:203-205), and the
  outbound metadata echoes the device actually used. Which frame program a
  (platform, data structure, mesh) runs is decided in engine/platform.py.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import jax
import numpy as np

from particle_simulator_tpu.engine import platform
from particle_simulator_tpu.engine.state import (
    ParticleState,
    SimParams,
    state_from_numpy,
    state_to_numpy,
)
from particle_simulator_tpu.io.frame import (
    DataStructure,
    Device,
    Frame,
)
from particle_simulator_tpu.ops.readback import pow2_at_least
from particle_simulator_tpu.physics.bucket import (
    GridConfig,
    REFERENCE_GRID,
    bucketize_numpy,
)


class ReadbackTicket:
    """A started device->host readback (engine/daemon.py enqueues these).

    ``packed``/``scalars`` are the device-compacted outputs of
    ops/readback.dense_readback (None when the state was read the slow
    full-grid way); ``state`` is retained for the rare overflow retry."""

    __slots__ = ("state", "scalars", "packed", "k", "ncap")

    def __init__(self, state, scalars=None, packed=None, k=0, ncap=0):
        self.state = state
        self.scalars = scalars
        self.packed = packed
        self.k = k
        self.ncap = ncap


def _cpu_device():
    """The JAX CPU device, or None when JAX_PLATFORMS leaves the CPU out."""
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        return None


def _grid_for(
    live: np.ndarray,
    base: GridConfig,
    box_width: float,
    r0: float,
    box_height: float | None = None,
) -> GridConfig:
    """Density-aware grid selection.

    The reference compiles a fixed 64x64x16 grid and silently drops bucket
    overflow (kernel.cuh:14-20, kernel_bucket.cuh:30-31). Here the grid is
    chosen per scene: grow the bucket grid until the actual max per-bucket
    occupancy fits, but never shrink buckets below ~2 equilibrium distances
    (the 3x3 neighborhood must cover the interaction range — the reference's
    own bucket width is ~2 r0); past that floor, grow the bucket capacity
    instead. Pathologically overlapping scenes stop at cap 256 and drop, like
    the reference.
    """
    def max_occupancy(c: GridConfig) -> int:
        bx = (live["x"] >> np.uint32(32 - c.bx_log2)).astype(np.int64)
        by = (live["y"] >> np.uint32(32 - c.by_log2)).astype(np.int64)
        return int(np.bincount(by * c.bx + bx, minlength=c.buckets).max())

    cfg = base
    while cfg.capacity < len(live):
        cfg = GridConfig(cfg.bx_log2 + 1, cfg.by_log2 + 1, cfg.cap, cfg.move_every)
    if len(live) == 0:
        return cfg
    box_height = box_width if box_height is None else box_height
    while max_occupancy(cfg) > cfg.cap:
        # the smaller bucket side governs the 3x3 window's force coverage
        bucket_side = min(box_width / cfg.bx, box_height / cfg.by)
        if bucket_side / 2.0 >= 2.0 * r0:
            cfg = GridConfig(cfg.bx_log2 + 1, cfg.by_log2 + 1, cfg.cap, cfg.move_every)
        elif cfg.cap < 256:
            cfg = GridConfig(cfg.bx_log2, cfg.by_log2, cfg.cap * 2, cfg.move_every)
        else:
            break  # accept drops (reference semantics)

    # Capacity refinement: the step's pair work per slot scales with the
    # bucket capacity (each slot meets 9*cap candidates), so at equal slot
    # count a finer grid with half the cap does HALF the pair-enumeration
    # work. Halve cap while splitting the coarser axis, as long as the scene
    # still fits (the same occupancy <= cap criterion the coarse search
    # uses) and the 3x3 window keeps covering the force range (bucket side
    # >= 2 r0, like the reference's own ~2-sigma buckets).
    while cfg.cap > 8:
        if box_width / cfg.bx >= box_height / cfg.by:  # split the wider side
            finer = GridConfig(cfg.bx_log2 + 1, cfg.by_log2, cfg.cap // 2, cfg.move_every)
            side = box_width / finer.bx
        else:
            finer = GridConfig(cfg.bx_log2, cfg.by_log2 + 1, cfg.cap // 2, cfg.move_every)
            side = box_height / finer.by
        if side < 2.0 * r0 or max_occupancy(finer) > finer.cap:
            break
        cfg = finer

    # In-place capacity refinement: when the bucket side is already at the
    # 2 r0 floor (no axis may split) but occupancy has >= 2x headroom after
    # halving, halve the capacity without splitting — the step cost scales
    # with cap. The 2x headroom keeps live clustering from out-dropping the
    # reference's fixed cap 16 — note the default 50x50 editor lattice (max
    # occupancy 6) deliberately FAILS this gate and stays on the drop-safe
    # cap-16 grid.
    while cfg.cap > 8 and 2 * max_occupancy(cfg) <= cfg.cap // 2:
        cfg = GridConfig(cfg.bx_log2, cfg.by_log2, cfg.cap // 2, cfg.move_every)
    return cfg


class Simulator:
    """Holds the device-resident scene and advances it frame by frame.

    With a ``mesh`` (jax.sharding.Mesh), the MatrixBuckets path runs the
    spatial domain decomposition (parallel/domain.py): the bucket grid shards
    over the mesh, halos ride the device interconnect, and ``read_frame``
    gathers the global state to the host (the editor connection lives on
    host 0, SURVEY.md section 7). CompactArray stays single-device —
    all-pairs has no spatial locality to shard."""

    def __init__(self, grid: GridConfig = REFERENCE_GRID, mesh=None):
        self.base_grid = grid
        self.grid = grid
        self.mesh = mesh
        self.accel = platform.accelerator()
        self.cpu = _cpu_device()
        self.state: Optional[ParticleState] = None
        self.params: Optional[SimParams] = None
        self.meta_record: Optional[np.ndarray] = None
        self.data_structure = DataStructure.MATRIX_BUCKETS
        self.active_device = Device.GPU
        # platform of the device (or mesh) holding the current scene; None
        # for host-resident CpuMainThread states
        self.platform: str | None = None
        self._runners: dict = {}  # (platform, structure, grid, mesh) -> fn
        # Device-side readback compaction (ops/readback.py): kcap = the
        # occupied slot prefix the dense pack gathers from (sticky, power of
        # two; grows on overflow, shrinks on a long low streak); ncap = the
        # dense pack's output length (sticky, power of two >= the live
        # count, seeded at scene load — physics only ever DROPS particles,
        # so it can't overflow between loads; guarded anyway).
        # force_device_readback lets CPU tests drive the fast path (on a
        # real CPU backend the transfer it saves is free).
        self._readback_k = 8
        self._readback_ncap = 1
        self._readback_low_streak = 0
        # which frame program produced the last frame_async dispatch
        # (engine/platform.py kernel_name, or "host" for CpuMainThread) —
        # the daemon reports it so throughput is attributable
        self.active_kernel: str | None = None
        self.force_device_readback = False

    # -- scene / metadata ingest (kernel_prepare_frame analog) -----------------
    def _target_device(self, requested: Device):
        if requested == Device.GPU and self.accel is not None:
            return self.accel, Device.GPU
        # capability fallback: GPU requested but no accelerator (kernel.cuh:203-205)
        fallback = Device.CPU_THREAD_POOL if requested == Device.GPU else requested
        # CpuMainThread never touches an XLA client: the shared kernels run
        # eagerly via NumPy on the caller's thread (physics/host.py), so the
        # state stays host-resident — None device means "no device_put"
        if fallback == Device.CPU_MAIN_THREAD:
            return None, fallback
        if self.cpu is None:
            raise RuntimeError(
                f"{fallback.display_name} requested, but JAX has no CPU backend "
                "(JAX_PLATFORMS leaves it out)"
            )
        return self.cpu, fallback

    def load_frame(self, frame: Frame) -> None:
        """Full scene reset from a non-empty editor frame."""
        meta = frame.metadata
        self.meta_record = meta.copy()
        self.data_structure = meta.data_structure
        requested_device = meta.device
        if jax.process_count() > 1 and (
            self.data_structure != DataStructure.MATRIX_BUCKETS
            or requested_device != Device.GPU
        ):
            # Multi-process runs shard the bucket grid over the global mesh;
            # CompactArray and single-host CPU devices have no global layout
            # (device_put to jax.devices()[0] would crash every non-zero
            # process). Every process sees the same frame bytes
            # (DistributedFrontend), so this coercion is identical everywhere.
            print(
                "engine: multi-process run forces MatrixBuckets/accelerator "
                f"(requested {self.data_structure.name}/{requested_device.name})",
                file=sys.stderr,
            )
            self.data_structure = DataStructure.MATRIX_BUCKETS
            requested_device = Device.GPU
            self.meta_record["data_structure"] = int(self.data_structure)
        jdev, self.active_device = self._target_device(requested_device)
        # echo the actually-active device in subsequent outbound metadata
        self.meta_record["device"] = int(self.active_device)
        self.platform = None if jdev is None else jdev.platform

        parts = frame.particles
        live = parts[parts["ty"] >= 0]

        if self.data_structure == DataStructure.COMPACT_ARRAY:
            capacity = max(1024, 1 << int(np.ceil(np.log2(max(len(live), 1)))))
            layout = np.zeros(capacity, dtype=parts.dtype)
            layout["ty"] = -1
            layout[: len(live)] = live
            self.grid = self.base_grid
            state = state_from_numpy(layout, capacity)
            if jdev is None:  # CpuMainThread: host-resident NumPy state
                from particle_simulator_tpu.physics.host import to_host_state

                self.state = to_host_state(state)
            else:
                self.state = jax.device_put(state, jdev)
        else:
            self.grid = _grid_for(
                live, self.base_grid, meta.box_width,
                meta.species(0).force0_r(), box_height=meta.box_height,
            )
            if self.mesh is not None:
                # grow bx until it tiles the mesh's (power-of-two) x axis;
                # the y axis is handled by tombstone row padding below
                nx = self.mesh.devices.shape[1]
                while self.grid.bx % nx:
                    self.grid = GridConfig(
                        self.grid.bx_log2 + 1, self.grid.by_log2 + 1,
                        self.grid.cap, self.grid.move_every,
                    )
            # Readback seeds from bucket ids alone (np.bincount), without the
            # full bucketize: min(count, cap) equals the per-bucket placed
            # count (bucketize fills slots ascending and drops past cap).
            g = self.grid
            bxi = (live["x"] >> np.uint32(32 - g.bx_log2)).astype(np.int64)
            byi = (live["y"] >> np.uint32(32 - g.by_log2)).astype(np.int64)
            counts = np.bincount(bxi + byi * g.bx, minlength=g.by * g.bx)
            self._readback_k = pow2_at_least(int(min(counts.max(initial=0), g.cap)))
            self._readback_ncap = pow2_at_least(len(live))
            self._readback_low_streak = 0
            _t0 = time.perf_counter()
            layout = bucketize_numpy(live, self.grid)
            self.last_bucketize_s = time.perf_counter() - _t0
            state = state_from_numpy(layout, self.grid.capacity).reshape(self.grid.grid_shape)
            if self.mesh is not None:
                from particle_simulator_tpu.parallel.domain import (
                    pad_rows_for_mesh,
                    shard_state,
                )

                state, _ = pad_rows_for_mesh(state, self.mesh)
                self.state = shard_state(state, self.mesh)
                self.platform = self.mesh.devices.flat[0].platform
            elif jdev is None:  # CpuMainThread: host-resident NumPy state
                from particle_simulator_tpu.physics.host import to_host_state

                self.state = to_host_state(state)
            else:
                self.state = jax.device_put(state, jdev)
        self.params = SimParams.from_record(self.meta_record)

        desc = (
            f"grid {self.grid.bx}x{self.grid.by}x{self.grid.cap}"
            if self.data_structure == DataStructure.MATRIX_BUCKETS
            else f"compact capacity {self.state.ty.size}"
        )
        print(
            f"engine: scene loaded ({len(live)} live, {desc}, "
            f"{self.active_device.display_name}, bucketize "
            f"{getattr(self, 'last_bucketize_s', 0.0):.2f}s); first compile "
            "of a new shape may take a while",
            file=sys.stderr,
        )

    def update_metadata(self, frame: Frame) -> None:
        """Metadata-only frame (particle_count == 0): live reconfigure
        (cuda_simulator.cu:12-14, where write_metadata copies the FULL incoming
        metadata and run_async dispatches on it). Like the reference, a
        ``data_structure`` or ``device`` change takes effect live: the current
        particles are read back, re-laid-out into the new structure on the new
        device, and the run continues — no scene reset required. Pure parameter
        tweaks never touch particle state and never recompile. That includes
        the launch-width field ``gpu_threads_per_block_log2``: the frame
        programs take no launch width, so an edit is accepted and echoed in
        outbound metadata, and changes nothing else."""
        if self.meta_record is None:
            return
        new = frame.metadata.copy()
        # Out-of-range enum bytes (buggy client / wire corruption past the
        # signature check) must not kill the engine loop: ignore them and
        # keep the running values, like the pre-switch behavior.
        try:
            requested_dev = Device(int(new["device"]))
            requested_ds = DataStructure(int(new["data_structure"]))
        except ValueError:
            requested_dev = self.active_device
            requested_ds = self.data_structure
            new["device"] = int(self.meta_record["device"])
            new["data_structure"] = int(self.data_structure)
        if jax.process_count() > 1:
            # multi-process: only the sharded MatrixBuckets/accelerator layout
            # exists (see load_frame) — ignore live switch requests
            requested_dev = self.active_device
            requested_ds = self.data_structure
        _, effective_dev = self._target_device(requested_dev)
        if requested_ds != self.data_structure or effective_dev != self.active_device:
            # Live structure/device switch: re-layout the running scene.
            live = self._state_numpy(self.state)
            relayout = Frame.from_particles(new, live[live["ty"] >= 0])
            self.load_frame(relayout)
            return
        # keep active layout/device fields consistent with what's actually running
        new["data_structure"] = int(self.data_structure)
        new["device"] = int(self.meta_record["device"])
        self.meta_record = new
        self.params = SimParams.from_record(self.meta_record)

    # -- frame stepping ---------------------------------------------------------
    def _sharded(self) -> bool:
        return (self.mesh is not None
                and self.data_structure == DataStructure.MATRIX_BUCKETS)

    def _runner(self):
        """The cached frame program for the current (platform, structure,
        grid, mesh) — engine/platform.py decides which it is."""
        sharded = self._sharded()
        key = (self.platform, self.data_structure,
               self.grid if sharded else None, self.mesh if sharded else None)
        fn = self._runners.get(key)
        if fn is None:
            fn = self._runners[key] = platform.frame_runner(
                self.platform, self.data_structure, grid=self.grid,
                mesh=self.mesh if sharded else None,
            )
        return fn

    def frame_async(self) -> None:
        """Dispatch one frame (steps_per_frame physics steps) on device and
        return immediately (JAX async dispatch = the reference's run_async)."""
        if self.state is None:
            return
        if self.active_device == Device.CPU_MAIN_THREAD and not self._sharded():
            # genuinely single-threaded: the shared kernels execute eagerly
            # via NumPy on THIS thread (physics/host.py) — the analog of the
            # reference's sequential for-loop (kernel_bucket.cuh:133-141).
            # Synchronous by nature, like the reference's main-thread path.
            from particle_simulator_tpu.physics import host

            if self.data_structure == DataStructure.COMPACT_ARRAY:
                self.state = host.host_run_frame_compact(self.state, self.params)
            else:
                self.state = host.host_run_frame_bucket(
                    self.state, self.params, move_every=self.grid.move_every
                )
            self.active_kernel = "host"
            return
        self.state = self._runner()(self.state, self.params)
        self.active_kernel = platform.kernel_name(
            self.platform, self.data_structure, self._sharded()
        )

    def sync(self) -> None:
        if self.state is not None:
            jax.block_until_ready(self.state)

    # -- readback ----------------------------------------------------------------
    @staticmethod
    def _state_numpy(state: ParticleState) -> np.ndarray:
        """state_to_numpy that also handles multi-process global arrays:
        shards owned by other hosts are gathered (cross-host allgather)
        first — every process ends up with the full global state, and
        process 0 ships it to the editor (parallel/multihost.py)."""
        x = state.x
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            from particle_simulator_tpu.parallel.multihost import gather_global

            state = gather_global(state)
        return state_to_numpy(state)

    def _fast_readback_ok(self, state) -> bool:
        """Bucket-grid states on a platform whose plan packs on device
        (engine/platform.py) qualify for device-side compaction
        (ops/readback.py); everything else (CompactArray 1D layouts,
        host-resident CpuMainThread states, multi-HOST mesh states, CPU
        states where the transfer is free) reads the full grid.

        Single-host mesh states DO qualify: the sharded frame fn returns the
        unpadded global (BY, BX, CAP) grid sharded P("dy","dx",None), on
        which dense_readback's cumsum/gather algebra is mesh-agnostic — GSPMD
        inserts the collectives, and the host link then carries the
        ~20 B/particle pack instead of the full slot grid. Multi-host stays
        on the gather_global path: the pack output would not be fully
        addressable on process 0."""
        if not isinstance(state, ParticleState):
            return False
        x = state.x
        if not isinstance(x, jax.Array) or x.ndim != 3:
            return False
        if not x.is_fully_addressable:
            return False
        if self.force_device_readback:
            return True
        return platform.plan(next(iter(x.devices())).platform).dense_readback

    def start_readback(self, state: Optional[ParticleState] = None) -> ReadbackTicket:
        """Kick off the device->host readback of ``state`` (default current)
        and return a ticket ``read_frame`` consumes. On the accelerator bucket
        path this dispatches the dense-pack readback (ops/readback.py):
        every live particle gathered into exactly-sized output arrays, so
        the host link carries ~the wire frame's own bytes (the reference
        reads exactly ``len`` particles too, kernel.cuh:116-165). The host
        copies start at once (copy_to_host_async), so they overlap whatever
        the caller dispatches next."""
        state = self.state if state is None else state
        if not self._fast_readback_ok(state):
            for a in state:
                if hasattr(a, "copy_to_host_async") and a.is_fully_addressable:
                    a.copy_to_host_async()
            return ReadbackTicket(state)
        from particle_simulator_tpu.ops.readback import dense_readback

        k = min(self._readback_k, state.x.shape[-1])
        ncap = self._readback_ncap
        scalars, packed = dense_readback(state, k, ncap)
        for a in (scalars, *packed):
            a.copy_to_host_async()
        return ReadbackTicket(state, scalars, packed, k, ncap)

    def read_frame(self, state=None, meta: Optional[np.ndarray] = None) -> Frame:
        """Device -> host readback (default: current state), compacted and
        wrapped in a wire frame (frontend.write semantics: tombstones removed
        before shipping, frontend.hpp:50-56). Accepts a ``ReadbackTicket``
        from ``start_readback`` (the daemon's readback pipeline), a raw
        state, or None. ``meta`` overrides the metadata record stamped on the
        frame (captured at enqueue time so queued frames keep the params they
        were computed under)."""
        if not isinstance(state, ReadbackTicket):
            state = self.start_readback(state)
        rec = self.meta_record if meta is None else meta
        if state.packed is None:
            parts = self._state_numpy(state.state)
            # the boolean-mask gather is a fresh array — hand it over
            return Frame.from_particles(rec, parts[parts["ty"] >= 0], owned=True)

        from particle_simulator_tpu.ops.readback import (
            dense_readback,
            dense_to_particles,
        )

        scalars, packed, k, ncap = state.scalars, state.packed, state.k, state.ncap
        mx, total = (int(v) for v in np.asarray(jax.device_get(scalars)))
        if mx > k or total > ncap:
            # a bucket outgrew the occupied prefix (or — defensively; physics
            # only drops — the pack length): widen the sticky sizes and redo
            self._readback_k = k = min(pow2_at_least(mx), state.state.x.shape[-1])
            self._readback_ncap = ncap = max(ncap, pow2_at_least(total))
            self._readback_low_streak = 0
            scalars, packed = dense_readback(state.state, k, ncap)
            mx, total = (int(v) for v in np.asarray(jax.device_get(scalars)))
        elif mx <= k // 2 and k > 1:
            self._readback_low_streak += 1
            if self._readback_low_streak >= 256:
                self._readback_k = max(1, k // 2)
                self._readback_low_streak = 0
        else:
            self._readback_low_streak = 0
        fields = jax.device_get(tuple(packed))
        live = dense_to_particles(total, ParticleState(*fields))
        # dense_to_particles builds a fresh contiguous array — hand it over
        # instead of paying a second ~60 ms copy at 1M
        return Frame.from_particles(rec, live, owned=True)

    @property
    def live_count(self) -> int:
        if self.state is None:
            return 0
        return int(np.count_nonzero(self._state_numpy(self.state)["ty"] >= 0))
