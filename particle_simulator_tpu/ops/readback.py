"""Device-side readback compaction for the bucket grid.

The daemon ships a wire frame every compute frame (engine/daemon.py ship()),
and the wire only carries LIVE particles — but the grid state is mostly
tombstones (a 1M user scene lands on a 1024x1024x16 grid = 16.8M slots at 6%
occupancy), so a full-grid readback (``state_to_numpy``) moves 400 MB over
the host link (PCIe on a GPU host) per frame. The reference has no such
asymmetry: its CUDA kernel compacts into a dense device buffer and reads
exactly ``len`` particles back (cuda_simulator/src/kernel.cuh:116-165,
kernel_compact.cuh:44-76).

Device-side equivalent — **gather-based dense pack** (``dense_readback``):
every bucket keeps its live particles in ascending slots (bucketize_numpy
and all three rebucket passes share this invariant — CLAUDE.md), so bucket
b's live particles occupy global pack positions [offset_b, offset_b+count_b)
where offset = exclusive-cumsum(counts). Inverting that map per OUTPUT
position (the stream-compaction idiom: index algebra, then gathers):

    marks[offset_b] += 1 for every bucket      (one scatter-add, B indices)
    bucket_of[j] = cumsum(marks)[j] - 1        (vector cumsum)
    slot_of[j]   = j - offset[bucket_of[j]]    (one gather)
    out[j]       = state[bucket_of[j], slot_of[j]]   (5 monotone gathers)

so the host link carries exactly ``ncap`` slots per field (ncap = sticky
power-of-two >= the live count, seeded at scene load) plus a 2-scalar
(max-occupancy, total) header — ~20 B/particle, the same bytes the wire
frame itself needs, instead of every slot of the grid.

``kcap`` (sticky power-of-two >= the fullest bucket) bounds the gather's
SOURCE slice: packing from ``state[:, :, :kcap]`` instead of the full cap
keeps the index arithmetic in the occupied prefix, and a bucket outgrowing
it is detectable host-side (the scalars header carries the true max) for
the widen-and-retry path.

A rank-based butterfly compaction (move every live particle to its per-row
prefix with log2(L) lane-shift stages) was tried before this form and
dropped: it moves all six arrays through HBM once per stage, where this
form does one pass of index algebra.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from particle_simulator_tpu.engine.state import ParticleState
from particle_simulator_tpu.io.frame import PARTICLE_DTYPE


@functools.partial(jax.jit, static_argnames=("kcap", "ncap"))
def dense_readback(
    state: ParticleState, kcap: int, ncap: int
) -> tuple[jnp.ndarray, ParticleState]:
    """Jitted: pack every live particle into dense ``(ncap,)`` field arrays,
    in the global row-major (bucket-scan, ascending-slot) order — the frozen
    outbound wire order (frontend.hpp:50-56 compaction semantics).

    Returns ``(scalars, packed)`` with ``scalars = [max_occupancy, total]``
    (i32, exact for every bucket regardless of ``kcap``/``ncap``). The pack
    is only valid when ``max_occupancy <= kcap`` and ``total <= ncap``; the
    host wrapper (engine/simulator.py read_frame) checks the scalars, widens
    the sticky sizes, and retries otherwise — same contract as the
    reference's own fixed-capacity readback, but self-healing."""
    by, bx, cap = state.ty.shape
    counts = (state.ty >= 0).sum(-1, dtype=jnp.int32).reshape(-1)  # (B,) exact
    kcap = min(int(kcap), cap)
    total = counts.sum()
    mx = counts.max()
    offsets = jnp.cumsum(counts) - counts  # exclusive prefix sum

    # bucket_of[j]: scatter one mark at each bucket's start offset (empty
    # buckets stack marks on the next start; trailing empties land at
    # offset == total and drop when total == ncap — they contribute nothing),
    # then a running count of starts <= j names the owning bucket.
    marks = jnp.zeros((ncap,), jnp.int32).at[offsets].add(1, mode="drop")
    bucket_of = jnp.cumsum(marks) - 1  # (ncap,) in [0, B)
    j = jnp.arange(ncap, dtype=jnp.int32)
    slot_of = j - offsets[bucket_of]
    valid = j < total
    src_idx = jnp.where(valid, bucket_of * kcap + slot_of, 0)

    packed = []
    for name, a in zip(ParticleState._fields, state):
        src = a.reshape(by * bx, cap)[:, :kcap].reshape(-1)
        g = src[src_idx]
        if name == "ty":
            g = jnp.where(valid, g, jnp.int32(-1))  # tombstone the pad tail
        packed.append(g)
    return jnp.stack([mx, total]), ParticleState(*packed)


def dense_to_particles(total: int, packed: ParticleState) -> np.ndarray:
    """Host: wrap the first ``total`` entries of the dense pack as one live
    PARTICLE_DTYPE array (== what ``state_to_numpy(state)[mask]`` produces)."""
    out = np.empty(int(total), dtype=PARTICLE_DTYPE)
    for f in PARTICLE_DTYPE.names:
        out[f] = np.asarray(getattr(packed, f))[: int(total)]
    return out


def pow2_at_least(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor) — the kcap/ncap bucketing that
    bounds the number of distinct jit signatures per grid."""
    n = max(int(n), floor, 1)
    return 1 << (n - 1).bit_length()
