"""particle_simulator_tpu — a JAX 2D molecular-dynamics particle simulation engine.

A from-scratch reimplementation of the capabilities of otcova/particle-simulator
(Mie/Lennard-Jones potential, leapfrog integration, interactive editor protocol),
written in JAX for an accelerator (an NVIDIA GPU) and the CPU alike:

- particle state lives as SoA JAX arrays (u32 fixed-point positions, f32 velocities),
- a whole editor frame (default 100 physics steps) is ONE jitted device dispatch
  (``lax.fori_loop`` over steps, no host round-trips),
- two force data structures, mirroring the reference's ``DataStructure`` enum:
  * ``CompactArray``  — all-pairs O(N^2) as one fused pair reduction,
  * ``MatrixBuckets`` — uniform bucket grid with 3x3-neighborhood interactions and
    lazy pull-based rebucketing (vectorized, static shapes),
- multi-chip scaling via spatial domain decomposition: ``shard_map`` over a device
  mesh with one-bucket halo exchange between devices (``lax.ppermute``),
- the editor wire protocol (signature-framed packets over TCP/files) is kept
  byte-identical so the reference's interactive editor connects unchanged.

Reference layout map (see SURVEY.md):
  io/        <- particle_io (Rust)          : frame codec, transport, presets
  physics/   <- particle.cuh, kernel_compact.cuh, kernel_bucket.cuh : forces, leapfrog, steps
  engine/    <- cuda_simulator.cu + kernel.cuh : buffers, step scheduling, daemon
  ops/       <- kernel.cuh readback            : device-side dense pack
  parallel/  <- (new) multi-chip domain decomposition
  editor/    <- particle_editor (Rust)      : headless timeline/tools/server
"""

__version__ = "0.1.0"

from particle_simulator_tpu.io.frame import (  # noqa: F401
    DataStructure,
    Device,
    Frame,
    FrameMetadata,
    MieParams,
    PARTICLE_DTYPE,
    default_metadata,
)
