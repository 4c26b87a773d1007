"""Byte-exact frame/state wire format.

This is the L1 layer of the stack: the self-describing packet the editor and the
engine exchange. The layout is byte-identical to the reference's
``particle_io::{Particle, MiePotentialParams, FrameMetadata, FrameHeader, Frame}``
(reference: particle_io/src/particle.rs:12-238) so the reference editor can talk to
this engine unchanged:

- packet = 96-byte header + ``particle_count`` x 20-byte particles
- header = start signature ``36 bc e9 bd`` | u32 particle_count | 80-byte metadata
  | end signature ``ac c4 12 ec`` | 4 bytes padding
- particle = u32 x | u32 y | f32 vx | f32 vy | i32 ty  (ty < 0 means null/tombstone)

Positions are **u32 fixed point** spanning the simulation box
(0..=u32::MAX <-> 0..box_width). This is load-bearing for the physics: it gives
uniform absolute precision everywhere in the box, makes displacement math wrap-free
(u32 subtraction), and makes bucket ids plain bit shifts of the coordinate
(reference: cuda_simulator/src/particle.cuh:33-47, kernel.cuh:224-226).

Configuration travels **in-band**: every frame carries the full physics/config
metadata, so the simulator is stateless across frames. ``particle_count == 0``
frames are live metadata-only updates; non-empty frames reset the whole scene
(reference: cuda_simulator/src/cuda_simulator.cu:11-22).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

# ---------------------------------------------------------------------------
# dtypes (little-endian, matching #[repr(C)] on x86/ARM)
# ---------------------------------------------------------------------------

MIE_PARAMS_DTYPE = np.dtype(
    [("sigma", "<f4"), ("epsilon", "<f4"), ("n", "<f4"), ("m", "<f4")]
)

METADATA_DTYPE = np.dtype(
    [
        ("particles", MIE_PARAMS_DTYPE, (2,)),
        ("cursor_pos", "<f4", (2,)),
        ("cursor_size", "<f4"),
        ("step_dt", "<f4"),
        ("steps_per_frame", "<u4"),
        ("box_width", "<f4"),
        ("box_height", "<f4"),
        ("data_structure", "<u4"),
        ("device", "<u4"),
        ("gpu_threads_per_block_log2", "<u4"),
        ("_padding", "<u4", (2,)),
    ]
)

HEADER_DTYPE = np.dtype(
    [
        ("signature_start", "u1", (4,)),
        ("particle_count", "<u4"),
        ("metadata", METADATA_DTYPE),
        ("signature_end", "u1", (4,)),
        ("_padding", "<u4"),
    ]
)

PARTICLE_DTYPE = np.dtype(
    [("x", "<u4"), ("y", "<u4"), ("vx", "<f4"), ("vy", "<f4"), ("ty", "<i4")]
)

METADATA_SIZE = METADATA_DTYPE.itemsize  # 80
HEADER_SIZE = HEADER_DTYPE.itemsize  # 96
PARTICLE_SIZE = PARTICLE_DTYPE.itemsize  # 20

assert METADATA_SIZE == 80, METADATA_SIZE
assert HEADER_SIZE == 96, HEADER_SIZE
assert PARTICLE_SIZE == 20, PARTICLE_SIZE

SIGNATURE_START = bytes([0x36, 0xBC, 0xE9, 0xBD])
SIGNATURE_END = bytes([0xAC, 0xC4, 0x12, 0xEC])

U32_MAX = 0xFFFFFFFF


def packet_size(particle_count: int) -> int:
    """Total packet bytes for a frame with ``particle_count`` particles."""
    return HEADER_SIZE + PARTICLE_SIZE * int(particle_count)


class DataStructure(enum.IntEnum):
    """Force-kernel selector (reference: particle_io/src/particle.rs:52-78)."""

    COMPACT_ARRAY = 0
    MATRIX_BUCKETS = 1

    @property
    def display_name(self) -> str:
        return ("Compact Array", "Matrix Buckets")[int(self)]


class Device(enum.IntEnum):
    """Backend selector (reference: particle_io/src/particle.rs:80-109).

    For this engine, ``GPU`` means "the accelerator" (an NVIDIA GPU); the two CPU
    variants select the JAX CPU backend, preserving the reference's property that
    the same kernel logic runs on every device.
    """

    GPU = 0  # the accelerator
    CPU_THREAD_POOL = 1
    CPU_MAIN_THREAD = 2

    @property
    def display_name(self) -> str:
        return ("GPU", "CPU Thread Pool", "CPU Main Thread")[int(self)]


BOLTZMANN = 1.380649e-23  # J/K


@dataclasses.dataclass(frozen=True)
class MieParams:
    """Mie potential parameters for one species.

    sigma: distance (m) at which the potential is zero; epsilon: dispersion
    energy (J); n/m: repulsive/attractive exponents.
    (reference: particle_io/src/particle.rs:34-50)
    """

    sigma: float
    epsilon: float
    n: float
    m: float

    def force0_r(self) -> float:
        """Equilibrium distance: the r where the Mie force is zero (f64 math)."""
        return float(self.sigma) * (float(self.n) / float(self.m)) ** (
            1.0 / (float(self.n) - float(self.m))
        )

    @staticmethod
    def nitrogen() -> "MieParams":
        return MieParams(sigma=3.609e-10, epsilon=105.79 * BOLTZMANN, n=14.08, m=6.0)

    @staticmethod
    def argon() -> "MieParams":
        return MieParams(sigma=3.404e-10, epsilon=117.84 * BOLTZMANN, n=12.085, m=6.0)


def default_metadata() -> np.ndarray:
    """Default in-band config, matching the reference's ``FrameMetadata::default``
    (particle_io/src/particle.rs:132-165): Nitrogen + Argon species, dt = 50 fs,
    100 steps/frame, 50x50 nm box, MatrixBuckets on the accelerator.

    Returns a 0-d structured numpy scalar of ``METADATA_DTYPE``.
    """
    meta = np.zeros((), dtype=METADATA_DTYPE)
    for i, p in enumerate((MieParams.nitrogen(), MieParams.argon())):
        meta["particles"][i] = (p.sigma, p.epsilon, p.n, p.m)
    meta["cursor_pos"] = (-1.0, -1.0)
    meta["cursor_size"] = 0.05
    meta["step_dt"] = 50e-15
    meta["steps_per_frame"] = 100
    meta["box_width"] = 50e-9
    meta["box_height"] = 50e-9
    meta["data_structure"] = DataStructure.MATRIX_BUCKETS
    meta["device"] = Device.GPU
    meta["gpu_threads_per_block_log2"] = 7
    return meta


class FrameMetadata:
    """Convenience view over a ``METADATA_DTYPE`` record.

    Thin wrapper: attribute access reads/writes the underlying record in place, so
    mutating a ``Frame.metadata`` view mutates the frame bytes (like the
    reference's ``Frame::metadata_mut``).
    """

    __slots__ = ("_rec",)

    def __init__(self, rec: np.ndarray):
        self._rec = rec

    # -- raw record ----------------------------------------------------------
    @property
    def record(self) -> np.ndarray:
        return self._rec

    def copy(self) -> np.ndarray:
        return self._rec.copy()

    # -- species params ------------------------------------------------------
    def species(self, i: int) -> MieParams:
        p = self._rec["particles"][i]
        return MieParams(float(p["sigma"]), float(p["epsilon"]), float(p["n"]), float(p["m"]))

    def set_species(self, i: int, p: MieParams) -> None:
        self._rec["particles"][i] = (p.sigma, p.epsilon, p.n, p.m)

    # -- scalar fields ---------------------------------------------------------
    def _get(self, name):
        return self._rec[name]

    @property
    def cursor_pos(self):
        return self._rec["cursor_pos"]

    @cursor_pos.setter
    def cursor_pos(self, v):
        self._rec["cursor_pos"] = v

    @property
    def cursor_size(self) -> float:
        return float(self._rec["cursor_size"])

    @cursor_size.setter
    def cursor_size(self, v: float):
        self._rec["cursor_size"] = v

    @property
    def step_dt(self) -> float:
        return float(self._rec["step_dt"])

    @step_dt.setter
    def step_dt(self, v: float):
        self._rec["step_dt"] = v

    @property
    def steps_per_frame(self) -> int:
        return int(self._rec["steps_per_frame"])

    @steps_per_frame.setter
    def steps_per_frame(self, v: int):
        self._rec["steps_per_frame"] = v

    @property
    def box_width(self) -> float:
        return float(self._rec["box_width"])

    @box_width.setter
    def box_width(self, v: float):
        self._rec["box_width"] = v

    @property
    def box_height(self) -> float:
        return float(self._rec["box_height"])

    @box_height.setter
    def box_height(self, v: float):
        self._rec["box_height"] = v

    @property
    def data_structure(self) -> DataStructure:
        try:
            return DataStructure(int(self._rec["data_structure"]))
        except ValueError:
            return DataStructure.MATRIX_BUCKETS

    @data_structure.setter
    def data_structure(self, v):
        self._rec["data_structure"] = int(v)

    @property
    def device(self) -> Device:
        try:
            return Device(int(self._rec["device"]))
        except ValueError:
            return Device.GPU

    @device.setter
    def device(self, v):
        self._rec["device"] = int(v)

    @property
    def gpu_threads_per_block_log2(self) -> int:
        return int(self._rec["gpu_threads_per_block_log2"])

    @gpu_threads_per_block_log2.setter
    def gpu_threads_per_block_log2(self, v: int):
        self._rec["gpu_threads_per_block_log2"] = v

    # -- derived ---------------------------------------------------------------
    def box_size(self) -> tuple[float, float]:
        return (self.box_width, self.box_height)

    def frame_dt(self) -> float:
        """Simulated time advanced by one frame (f32 product like the reference)."""
        return float(np.float32(self.step_dt) * np.float32(self.steps_per_frame))

    def new_particle(self, pos, vel, ty: int = 0) -> np.ndarray:
        """Convert meters -> u32 fixed point, f64 rounding like the reference
        (particle_io/src/particle.rs:168-178)."""
        p = np.zeros((), dtype=PARTICLE_DTYPE)
        p["x"] = np.uint64(round(U32_MAX * float(pos[0]) / self.box_width)) & U32_MAX
        p["y"] = np.uint64(round(U32_MAX * float(pos[1]) / self.box_height)) & U32_MAX
        p["vx"] = vel[0]
        p["vy"] = vel[1]
        p["ty"] = ty
        return p


def _new_header() -> np.ndarray:
    hdr = np.zeros((), dtype=HEADER_DTYPE)
    hdr["signature_start"] = np.frombuffer(SIGNATURE_START, dtype=np.uint8)
    hdr["signature_end"] = np.frombuffer(SIGNATURE_END, dtype=np.uint8)
    hdr["metadata"] = default_metadata()
    return hdr


class Frame:
    """A wire packet: header + particle array.

    Mirrors the reference's ``Frame`` (a typed view over ``Vec<u8>``,
    particle_io/src/particle.rs:189-401). Owned as a fixed header record plus a
    capacity-managed particle array; ``bytes`` serializes to the wire layout.
    Metadata/particle accessors are mutable views — edits land in the frame.
    """

    __slots__ = ("_header", "_parts", "_count")

    def __init__(self):
        self._header = _new_header()
        self._parts = np.zeros(0, dtype=PARTICLE_DTYPE)
        self._count = 0

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def new() -> "Frame":
        return Frame()

    @staticmethod
    def from_bytes(data: bytes | bytearray | memoryview) -> "Frame":
        data = bytes(data)
        if len(data) < HEADER_SIZE:
            raise ValueError(f"frame too short: {len(data)} < {HEADER_SIZE}")
        f = Frame()
        f._header = np.frombuffer(data[:HEADER_SIZE], dtype=HEADER_DTYPE).copy().reshape(())
        expected = packet_size(f.particle_count)
        if expected != len(data):
            raise ValueError(f"frame size mismatch: have {len(data)}, header says {expected}")
        f._parts = np.frombuffer(data, dtype=PARTICLE_DTYPE, offset=HEADER_SIZE).copy()
        f._count = len(f._parts)
        return f

    @staticmethod
    def from_buffer(data: bytearray) -> "Frame":
        """Like ``from_bytes`` but takes OWNERSHIP of ``data`` (a writable
        buffer the caller will not touch again): the particle array becomes a
        zero-copy view over it. This is the transport ingest fast path — at
        1M particles a wire frame is ~20 MB and ``from_bytes`` would copy it
        twice (bytes() + .copy())."""
        if len(data) < HEADER_SIZE:
            raise ValueError(f"frame too short: {len(data)} < {HEADER_SIZE}")
        f = Frame()
        f._header = (
            np.frombuffer(data[:HEADER_SIZE], dtype=HEADER_DTYPE).copy().reshape(())
        )
        expected = packet_size(f.particle_count)
        if expected != len(data):
            raise ValueError(f"frame size mismatch: have {len(data)}, header says {expected}")
        f._parts = np.frombuffer(data, dtype=PARTICLE_DTYPE, offset=HEADER_SIZE)
        f._count = len(f._parts)
        return f

    @staticmethod
    def from_metadata(metadata: np.ndarray, particle_count: int = 0) -> "Frame":
        f = Frame()
        f._header["metadata"] = metadata
        if particle_count:
            f._parts = np.zeros(particle_count, dtype=PARTICLE_DTYPE)
            f._count = particle_count
            f._header["particle_count"] = particle_count
        return f

    @staticmethod
    def from_particles(metadata: np.ndarray, particles: np.ndarray,
                       owned: bool = False) -> "Frame":
        """Build a frame from a ``PARTICLE_DTYPE`` array (copies the data).
        ``owned=True`` skips the copy when the caller hands over a freshly
        built contiguous array it will not touch again — the ship path's
        readback output is exactly that (a ~60 ms copy saved at 1M)."""
        f = Frame()
        f._header["metadata"] = metadata
        parts = np.ascontiguousarray(particles, dtype=PARTICLE_DTYPE)
        # copy only when we'd otherwise alias the caller's array: a dtype/
        # layout conversion above already produced a fresh buffer
        f._parts = parts.copy() if (not owned and parts is particles) else parts
        f._count = len(f._parts)
        f._header["particle_count"] = f._count
        return f

    # -- raw access --------------------------------------------------------------
    @property
    def bytes(self) -> bytes:
        self._header["particle_count"] = self._count
        return self._header.tobytes() + self._parts[: self._count].tobytes()

    def wire_views(self) -> tuple[bytes, memoryview]:
        """(header bytes, zero-copy particle-body memoryview) — the wire
        serialization without the full-packet concat that ``bytes`` pays.
        The view aliases live frame memory: consume before mutating."""
        self._header["particle_count"] = self._count
        live = self._parts[: self._count]
        if not live.flags.c_contiguous:
            live = np.ascontiguousarray(live)
        return self._header.tobytes(), memoryview(live).cast("B")

    @property
    def header(self) -> np.ndarray:
        return self._header

    @property
    def metadata(self) -> FrameMetadata:
        return FrameMetadata(self._header["metadata"])

    @property
    def particle_count(self) -> int:
        return int(self._header["particle_count"])

    @property
    def particles(self) -> np.ndarray:
        """Mutable structured view of the live particle array."""
        return self._parts[: self._count]

    def is_valid(self) -> bool:
        hdr = self._header
        return (
            hdr["signature_start"].tobytes() == SIGNATURE_START
            and hdr["signature_end"].tobytes() == SIGNATURE_END
        )

    def _set_count(self, n: int) -> None:
        self._count = n
        self._header["particle_count"] = n

    # -- mutation (reference: particle_io/src/particle.rs:349-400) ---------------
    def compact(self) -> None:
        """Drop null (ty < 0) particles in place, preserving order."""
        parts = self.particles
        live = parts["ty"] >= 0
        n = int(np.count_nonzero(live))
        if n == len(parts):
            return
        self._parts = parts[live]
        self._set_count(n)

    def compact_into(self, dst: "Frame") -> None:
        """Compact non-null particles into ``dst`` (metadata copied too)."""
        parts = self.particles
        dst._header["metadata"] = self._header["metadata"]
        dst._parts = parts[parts["ty"] >= 0].copy()
        dst._set_count(len(dst._parts))

    def clear(self) -> None:
        self._set_count(0)

    def reserve(self, additional: int) -> None:
        need = self._count + additional
        if need > len(self._parts):
            grown = np.zeros(max(need, 2 * len(self._parts)), dtype=PARTICLE_DTYPE)
            grown[: self._count] = self._parts[: self._count]
            self._parts = grown

    def push(self, particle: np.ndarray) -> None:
        self.reserve(1)
        self._parts[self._count] = particle
        self._set_count(self._count + 1)

    def extend(self, particles: np.ndarray) -> None:
        particles = np.asarray(particles, dtype=PARTICLE_DTYPE)
        self.reserve(len(particles))
        self._parts[self._count : self._count + len(particles)] = particles
        self._set_count(self._count + len(particles))

    def drop(self, n: int) -> None:
        """Remove the last ``n`` particles."""
        self._set_count(self._count - n)

    # -- misc -------------------------------------------------------------------
    def copy(self) -> "Frame":
        f = Frame()
        f._header = self._header.copy()
        f._parts = self.particles.copy()
        f._count = self._count
        return f

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Frame)
            and self._header == other._header
            and np.array_equal(self.particles, other.particles)
        )

    def __repr__(self) -> str:
        m = self.metadata
        return (
            f"Frame(n={self.particle_count}, dt={m.step_dt:.3g}, "
            f"spf={m.steps_per_frame}, box=({m.box_width:.3g},{m.box_height:.3g}), "
            f"ds={m.data_structure.name}, dev={m.device.name})"
        )

    def print(self) -> str:
        """Human-readable dump, analogous to the reference's ``frame_print``."""
        lines = ["--- Frame ---"]
        if not self.is_valid():
            lines.append("  signature error")
        m = self.metadata
        lines.append(f"  step dt = {m.step_dt}")
        lines.append(f"  steps per frame = {m.steps_per_frame}")
        lines.append(f"  box size = ({m.box_width}, {m.box_height})")
        parts = self.particles
        lines.append(f"  particles[{len(parts)}]")
        for i in range(min(5, len(parts))):
            p = parts[i]
            lines.append(
                f"    [{i}] = x={100.0 * p['x'] / U32_MAX:.2f}% y={100.0 * p['y'] / U32_MAX:.2f}% "
                f"vx={p['vx']} vy={p['vy']} ty={p['ty']}"
            )
        lines.append("-------------")
        return "\n".join(lines)
