"""MatrixBuckets path: uniform-grid cell lists with 3x3-neighborhood forces.

The reference's O(N) data structure (cuda_simulator/src/kernel_bucket.cuh,
kernel.cuh:14-20): the box is a 2^k x 2^k grid of fixed-capacity buckets; a
particle's bucket id is the top k bits of each u32 coordinate, so bucketing is a
bit shift, and forces only consider the 3x3 neighboring buckets. Rebucketing is
*lazy* (every 16 steps) and *pull-based*: each bucket scans its 3x3 neighborhood
for particles that now belong to it, keeping the first ``CAP`` in scan order and
silently dropping overflow (kernel_bucket.cuh:5-39; drop at :30-31).

Formulation — everything static-shaped and vectorized:

- state lives as ``(BY, BX, CAP)`` SoA grids;
- the 3x3 gather is 9 shifted views stacked to ``(BY, BX, 9*CAP)`` (a halo pad
  of tombstones replaces the reference's edge-clamp branches);
- the force pass is one fused ``(BY, BX, CAP, 9*CAP)`` elementwise pair tile
  reduced over its last axis;
- the move pass places every candidate in the reference's pull scan order
  (y outer, x inner, slot innermost), reproducing its keep-first-CAP overflow
  semantics exactly: ``bucket_move`` by a stable argsort (the readable
  reference), ``bucket_move_direct`` by elementwise ranks and one scatter
  (the pass the frame runners use), ``bucket_move_sorted`` by one global key
  sort — all three bit-identical;
- pull-based movement only ever references the 3x3 neighborhood, which is what
  makes the multi-chip domain decomposition a pure halo-exchange problem
  (parallel/domain.py).

Grid size and capacity are compile-time config like the reference's #defines,
but configurable: the reference is fixed at 64x64x16 = 65,536 particles;
``LARGE_GRID`` (256x256x16) holds 1,048,576.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from particle_simulator_tpu.engine.state import ParticleState, SimParams, empty_state
from particle_simulator_tpu.io.frame import PARTICLE_DTYPE
from particle_simulator_tpu.physics.mie import leapfrog_apply, pair_force_accum
from particle_simulator_tpu.physics.step import external_forces


class GridConfig(NamedTuple):
    """Compile-time bucket grid config (analog of kernel.cuh:14-20 #defines)."""

    bx_log2: int = 6
    by_log2: int = 6
    cap: int = 16
    move_every: int = 16  # rebucket cadence in steps (kernel_bucket.cuh:184)

    @property
    def bx(self) -> int:
        return 1 << self.bx_log2

    @property
    def by(self) -> int:
        return 1 << self.by_log2

    @property
    def buckets(self) -> int:
        return self.bx * self.by

    @property
    def capacity(self) -> int:
        return self.buckets * self.cap

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return (self.by, self.bx, self.cap)


REFERENCE_GRID = GridConfig(6, 6, 16)  # 65,536 particles — the reference's max
LARGE_GRID = GridConfig(8, 8, 16)  # 1,048,576 particles — the 1M target


# ---------------------------------------------------------------------------
# host-side bucketize (scene prep; analog of kernel_prepare_frame,
# kernel.cuh:200-250)
# ---------------------------------------------------------------------------

def bucketize_numpy(parts: np.ndarray, cfg: GridConfig) -> np.ndarray:
    """Scatter a compact PARTICLE_DTYPE array into bucket layout: output has
    shape (buckets * cap,) where slot b*cap+i holds the i-th particle of bucket
    b (row-major bucket id = bx + by*BX), tombstone-filled.

    Overflow past ``cap`` per bucket is dropped. (The reference writes past the
    bucket end instead — an out-of-bounds bug, kernel.cuh:228-229; we keep the
    documented drop semantics of its steady-state move pass.)
    """
    out = np.zeros(cfg.capacity, dtype=PARTICLE_DTYPE)
    out["ty"] = -1

    live = parts[parts["ty"] >= 0]
    bx = live["x"] >> np.uint32(32 - cfg.bx_log2)
    by = live["y"] >> np.uint32(32 - cfg.by_log2)
    bucket = (bx + by * cfg.bx).astype(np.int64)

    order = np.argsort(bucket, kind="stable")
    bucket_sorted = bucket[order]
    # rank within bucket = position since bucket start
    starts = np.searchsorted(bucket_sorted, bucket_sorted)
    rank = np.arange(len(bucket_sorted)) - starts
    keep = rank < cfg.cap
    out[bucket_sorted[keep] * cfg.cap + rank[keep]] = live[order][keep]
    return out


def state_to_grid(state: ParticleState, cfg: GridConfig) -> ParticleState:
    return state.reshape(cfg.grid_shape)


def grid_to_flat(state: ParticleState) -> ParticleState:
    return state.reshape((-1,))


# ---------------------------------------------------------------------------
# 3x3 neighborhood gather
# ---------------------------------------------------------------------------

def _pad_grid(a: jnp.ndarray, fill) -> jnp.ndarray:
    """Pad the (BY, BX, ...) bucket grid with one halo ring of ``fill``."""
    pad = [(1, 1), (1, 1)] + [(0, 0)] * (a.ndim - 2)
    return jnp.pad(a, pad, constant_values=fill)


def pad_tombstone_halo(state: ParticleState) -> ParticleState:
    """Single-device halo: one ring of tombstone buckets around the grid,
    (BY, BX, CAP) -> (BY+2, BX+2, CAP). The multi-chip path replaces this with
    a ppermute halo exchange (parallel/domain.py) — everything downstream is
    shared between the two."""
    return ParticleState(
        x=_pad_grid(state.x, jnp.uint32(0)),
        y=_pad_grid(state.y, jnp.uint32(0)),
        vx=_pad_grid(state.vx, jnp.float32(0)),
        vy=_pad_grid(state.vy, jnp.float32(0)),
        ty=_pad_grid(state.ty, jnp.int32(-1)),
    )


def stack9(padded: ParticleState) -> ParticleState:
    """Stack the 3x3 bucket neighborhood of a halo-padded grid:
    (BY+2, BX+2, CAP) -> (BY, BX, 9*CAP).

    Block order matches the reference's scan order (y outer, x inner,
    slot innermost: kernel_bucket.cuh:18-22) so downstream keep-first-CAP
    logic reproduces its overflow behavior.
    """
    by, bx = padded.x.shape[0] - 2, padded.x.shape[1] - 2

    def stack(p):
        views = [
            p[dy : dy + by, dx : dx + bx]
            for dy in (0, 1, 2)
            for dx in (0, 1, 2)
        ]
        return jnp.concatenate(views, axis=-1)

    return ParticleState(*(stack(a) for a in padded))


def gather_neighborhood(state: ParticleState) -> ParticleState:
    """3x3 neighborhood stack with out-of-box neighbors as tombstones."""
    return stack9(pad_tombstone_halo(state))


def _self_pair_mask(cap: int) -> np.ndarray:
    """(CAP, 9*CAP) mask of i==j pairs: the center block (offset index 4) of the
    neighborhood stack is the bucket itself."""
    mask = np.zeros((cap, 9 * cap), dtype=bool)
    mask[:, 4 * cap : 5 * cap] = np.eye(cap, dtype=bool)
    return mask


# ---------------------------------------------------------------------------
# step + move
# ---------------------------------------------------------------------------

def bucket_step_nbr(state: ParticleState, nbr: ParticleState, p: SimParams) -> ParticleState:
    """One physics step given a prebuilt 3x3 neighborhood stack: cursor + wall +
    neighborhood Mie forces, then leapfrog (kernel_bucket.cuh:40-94)."""
    cap = state.x.shape[-1]
    fx, fy = external_forces(state, p)
    pfx, pfy = pair_force_accum(
        state.x, state.y, state.ty,
        nbr.x, nbr.y, nbr.ty,
        p, self_mask=jnp.asarray(_self_pair_mask(cap)),
    )
    fx = fx + pfx
    fy = fy + pfy

    nx, ny, nvx, nvy = leapfrog_apply(state.x, state.y, state.vx, state.vy, state.ty, fx, fy, p)
    return ParticleState(nx, ny, nvx, nvy, state.ty)


def bucket_step(state: ParticleState, p: SimParams) -> ParticleState:
    """One physics step over the full (BY, BX, CAP) grid (single device)."""
    return bucket_step_nbr(state, gather_neighborhood(state), p)


def bucket_move_nbr(
    state: ParticleState,
    nbr: ParticleState,
    bx_log2: int,
    by_log2: int,
    row_offset=0,
    col_offset=0,
) -> ParticleState:
    """Pull-based rebucketing given the neighborhood stack (kernel_bucket.cuh:5-39).

    ``bx_log2``/``by_log2`` describe the *global* grid (bucket id = coordinate
    top bits); ``row_offset``/``col_offset`` are this shard's global bucket
    offsets (0 on a single device).
    """
    by, bx, cap = state.x.shape

    # target bucket of each candidate, from its position bits
    tgt_bx = (nbr.x >> jnp.uint32(32 - bx_log2)).astype(jnp.int32)
    tgt_by = (nbr.y >> jnp.uint32(32 - by_log2)).astype(jnp.int32)

    here_bx = jax.lax.broadcasted_iota(jnp.int32, (by, bx, 9 * cap), 1) + col_offset
    here_by = jax.lax.broadcasted_iota(jnp.int32, (by, bx, 9 * cap), 0) + row_offset

    selected = (nbr.ty >= 0) & (tgt_bx == here_bx) & (tgt_by == here_by)

    # stable sort: selected first, preserving scan order == reference's
    # first-come-first-kept overflow semantics
    order = jnp.argsort(~selected, axis=-1, stable=True)
    take = order[..., :cap]
    n_selected = jnp.sum(selected, axis=-1, keepdims=True)
    slot_valid = jax.lax.broadcasted_iota(jnp.int32, (by, bx, cap), 2) < n_selected

    def gather(a, fill):
        g = jnp.take_along_axis(a, take, axis=-1)
        return jnp.where(slot_valid, g, fill)

    return ParticleState(
        x=gather(nbr.x, jnp.uint32(0)),
        y=gather(nbr.y, jnp.uint32(0)),
        vx=gather(nbr.vx, jnp.float32(0)),
        vy=gather(nbr.vy, jnp.float32(0)),
        ty=gather(nbr.ty, jnp.int32(-1)),
    )


def bucket_move(state: ParticleState) -> ParticleState:
    """Single-device rebucketing pass over the full (BY, BX, CAP) grid.

    Particles that drifted further than one bucket since the last move are lost
    (same as the reference). The halo pad bounds movement to the neighborhood,
    which keeps this pass local for multi-chip sharding.
    """
    by, bx, _ = state.x.shape
    return bucket_move_nbr(
        state,
        gather_neighborhood(state),
        bx_log2=int(np.log2(bx)),
        by_log2=int(np.log2(by)),
    )


def move_dest_direct(state: ParticleState):
    """Destination slot of every particle under the reference's pull order,
    computed directly — no global sort or scan.

    rank(p) within its target bucket = (number of particles in earlier scan
    blocks targeting the same bucket) + (number of earlier slots in p's own
    source bucket targeting the same bucket). The per-block counts are
    (BY, BX) maps connected by static spatial shifts — everything is
    elementwise + tiny cap-axis cumsums, fully fusable.

    Returns (dest, keep): flat slot index (target*CAP + rank) and the
    keep mask (pullable & rank < CAP & live). Semantics identical to
    bucket_move / bucket_move_sorted (overflow and >1-bucket drift drop).
    """
    by, bx, cap = state.x.shape
    bx_log2 = int(np.log2(bx))
    by_log2 = int(np.log2(by))

    tgt_bx = (state.x >> jnp.uint32(32 - bx_log2)).astype(jnp.int32)
    tgt_by = (state.y >> jnp.uint32(32 - by_log2)).astype(jnp.int32)
    cur_bx = jax.lax.broadcasted_iota(jnp.int32, (by, bx, cap), 1)
    cur_by = jax.lax.broadcasted_iota(jnp.int32, (by, bx, cap), 0)
    dy = cur_by - tgt_by
    dx = cur_bx - tgt_bx
    live = state.ty >= 0
    pullable = live & (jnp.abs(dy) <= 1) & (jnp.abs(dx) <= 1)

    def shift_pad(a, sy, sx):
        """a shifted by (+sy, +sx) with zero fill: result[y, x] = a[y-sy, x-sx]."""
        pad_y = (max(sy, 0), max(-sy, 0))
        pad_x = (max(sx, 0), max(-sx, 0))
        p = jnp.pad(a, (pad_y, pad_x))
        return p[pad_y[1] : pad_y[1] + by, pad_x[1] : pad_x[1] + bx]

    # The 9 per-block slot cumsums ride 2 bit-packed words instead of 9
    # separate 1M-element scans: each slot belongs to exactly ONE block k, so
    # packing the one-hot masks as `1 << (bits*k)` makes a single cumsum
    # produce all per-k prefix sums at once in disjoint bit fields (each
    # field's sum <= cap, which fits in `bits`). Integer-exact, so the ranks —
    # and hence the layout — stay bit-identical to the unpacked form.
    bits = int(cap).bit_length()  # holds values up to cap
    per_word = max(1, 31 // bits)  # keep the top field clear of the sign bit
    masks = []
    for k in range(9):
        dyk, dxk = k // 3 - 1, k % 3 - 1
        masks.append((pullable & (dy == dyk) & (dx == dxk)).astype(jnp.int32))
    cums = []
    for w in range(0, 9, per_word):
        packed = masks[w]
        shift = bits
        for k in range(w + 1, min(w + per_word, 9)):
            packed = packed + (masks[k] << shift)
            shift += bits
        cums.append(jnp.cumsum(packed, axis=-1))
    field_max = (1 << bits) - 1

    rank = jnp.zeros((by, bx, cap), jnp.int32)
    block_prefix = jnp.zeros((by, bx), jnp.int32)  # indexed by target bucket
    for k in range(9):
        dyk, dxk = k // 3 - 1, k % 3 - 1
        mk_i = masks[k]
        inc = (cums[k // per_word] >> (bits * (k % per_word))) & field_max
        # within-source-bucket exclusive cumsum along slots
        r_k = inc - mk_i
        # block_prefix is per-target; align to p's cell (C = T + (dyk, dxk))
        bs_at_c = shift_pad(block_prefix, dyk, dxk)
        rank = rank + mk_i * (bs_at_c[..., None] + r_k)
        # add this block's counts into the per-target prefix:
        # cnt_k[T] = the block's total = the cumsum's last slot
        cnt_k = shift_pad(inc[..., -1], -dyk, -dxk)
        block_prefix = block_prefix + cnt_k

    keep = pullable & (rank < cap)
    dest = (tgt_by * bx + tgt_bx) * cap + rank
    n = by * bx * cap
    dest = jnp.where(keep, dest, n)  # out-of-bounds = dropped
    return dest.reshape(-1), keep.reshape(-1)


def move_ranks_direct_halo(
    padded: ParticleState,
    bx_log2: int,
    by_log2: int,
    row_offset,
    col_offset,
):
    """``move_dest_direct`` generalized to a halo-padded shard
    (parallel/domain.py) — same bit-packed cumsum ranking, same reference
    pull order (kernel_bucket.cuh:5-39: blocks in (dy, dx) scan order, slots
    ascending).

    ``padded`` is the (ly+2, lx+2, cap) exchange_halo output: candidates are
    ALL padded slots (the halo ring holds the neighbors' edge buckets);
    targets are this shard's own (ly, lx) interior buckets. A local particle
    whose target lies off-shard is dropped here and pulled by the owner from
    ITS halo — pull-based migration needs no send protocol.
    ``row_offset``/``col_offset`` are the shard's global bucket offsets
    (traced ``axis_index`` values inside shard_map).

    Returns (tgt_y, tgt_x, rank, keep) over the padded grid: local target
    bucket coords in [0, ly) x [0, lx), pull rank within the target bucket,
    and the keep mask (live, <=1-bucket drift, on-shard target, rank < cap).
    """
    py, px, cap = padded.x.shape
    ly, lx = py - 2, px - 2

    # local target bucket from the GLOBAL coordinate top bits, shard-relative
    tgt_bx = (padded.x >> jnp.uint32(32 - bx_log2)).astype(jnp.int32) - col_offset
    tgt_by = (padded.y >> jnp.uint32(32 - by_log2)).astype(jnp.int32) - row_offset
    # candidate's own cell in local coords: halo ring = -1 / ly (lx)
    cur_bx = jax.lax.broadcasted_iota(jnp.int32, (py, px, cap), 1) - 1
    cur_by = jax.lax.broadcasted_iota(jnp.int32, (py, px, cap), 0) - 1
    dy = cur_by - tgt_by
    dx = cur_bx - tgt_bx
    live = padded.ty >= 0
    tgt_in = (tgt_by >= 0) & (tgt_by < ly) & (tgt_bx >= 0) & (tgt_bx < lx)
    pullable = live & tgt_in & (jnp.abs(dy) <= 1) & (jnp.abs(dx) <= 1)

    def shift_pad(a, sy, sx):
        """a shifted by (+sy, +sx) with zero fill: result[y, x] = a[y-sy, x-sx]."""
        pad_y = (max(sy, 0), max(-sy, 0))
        pad_x = (max(sx, 0), max(-sx, 0))
        p = jnp.pad(a, (pad_y, pad_x))
        return p[pad_y[1] : pad_y[1] + py, pad_x[1] : pad_x[1] + px]

    # same bit-packed per-block slot cumsums as move_dest_direct (see there)
    bits = int(cap).bit_length()
    per_word = max(1, 31 // bits)
    masks = []
    for k in range(9):
        dyk, dxk = k // 3 - 1, k % 3 - 1
        masks.append((pullable & (dy == dyk) & (dx == dxk)).astype(jnp.int32))
    cums = []
    for w in range(0, 9, per_word):
        packed = masks[w]
        shift = bits
        for k in range(w + 1, min(w + per_word, 9)):
            packed = packed + (masks[k] << shift)
            shift += bits
        cums.append(jnp.cumsum(packed, axis=-1))
    field_max = (1 << bits) - 1

    # block_prefix rides the PADDED shape, indexed by target cell in padded
    # coords; boundary (halo) targets are masked out by tgt_in so their
    # entries are never read by kept candidates
    rank = jnp.zeros((py, px, cap), jnp.int32)
    block_prefix = jnp.zeros((py, px), jnp.int32)
    for k in range(9):
        dyk, dxk = k // 3 - 1, k % 3 - 1
        mk_i = masks[k]
        inc = (cums[k // per_word] >> (bits * (k % per_word))) & field_max
        r_k = inc - mk_i  # within-source-bucket exclusive cumsum along slots
        bs_at_c = shift_pad(block_prefix, dyk, dxk)
        rank = rank + mk_i * (bs_at_c[..., None] + r_k)
        cnt_k = shift_pad(inc[..., -1], -dyk, -dxk)
        block_prefix = block_prefix + cnt_k

    keep = pullable & (rank < cap)
    return tgt_by, tgt_bx, rank, keep


def bucket_move_direct_halo(
    padded: ParticleState,
    bx_log2: int,
    by_log2: int,
    row_offset,
    col_offset,
) -> ParticleState:
    """Shard-local rebucketing/migration from a halo-padded grid via direct
    rank computation + one local scatter — bit-identical to
    ``bucket_move_nbr`` over the same halo, with the argsort over the 9*CAP
    neighborhood axis (and its take_along_axis gathers) replaced by
    elementwise ranking (reference: kernel_bucket.cuh:5-39)."""
    py, px, cap = padded.x.shape
    ly, lx = py - 2, px - 2
    tgt_by, tgt_bx, rank, keep = move_ranks_direct_halo(
        padded, bx_log2, by_log2, row_offset, col_offset
    )
    n = ly * lx * cap
    dest = jnp.where(keep, (tgt_by * lx + tgt_bx) * cap + rank, n).reshape(-1)
    flat = padded.reshape((-1,))
    out = empty_state((n,))
    mode = "drop"
    out = ParticleState(
        x=out.x.at[dest].set(flat.x, mode=mode),
        y=out.y.at[dest].set(flat.y, mode=mode),
        vx=out.vx.at[dest].set(flat.vx, mode=mode),
        vy=out.vy.at[dest].set(flat.vy, mode=mode),
        ty=out.ty.at[dest].set(flat.ty, mode=mode),
    )
    return out.reshape((ly, lx, cap))


def bucket_move_direct(state: ParticleState) -> ParticleState:
    """Rebucketing via direct destination computation + one scatter —
    bit-identical to bucket_move; avoids the global sort entirely."""
    by, bx, cap = state.x.shape
    dest, _ = move_dest_direct(state)
    flat = state.reshape((-1,))
    out = empty_state((by * bx * cap,))
    mode = "drop"
    out = ParticleState(
        x=out.x.at[dest].set(flat.x, mode=mode),
        y=out.y.at[dest].set(flat.y, mode=mode),
        vx=out.vx.at[dest].set(flat.vx, mode=mode),
        vy=out.vy.at[dest].set(flat.vy, mode=mode),
        ty=out.ty.at[dest].set(flat.ty, mode=mode),
    )
    return out.reshape((by, bx, cap))


def bucket_move_sorted(state: ParticleState) -> ParticleState:
    """Rebucketing by one global key sort — semantics-identical to
    ``bucket_move`` but O(N log N) over N particles instead of an argsort over
    the 9x-larger neighborhood stack (~10x less sort work; the fast path for
    single-chip runs — the pull-based pass remains the multi-chip one, since
    a global sort isn't shard-local).

    Key = (target_bucket, pull-scan rank), where the scan rank reproduces the
    reference's pull order exactly: neighborhood blocks in (dy, dx) order,
    slots ascending within a block (kernel_bucket.cuh:18-22). After the sort,
    the first CAP particles of each target-bucket segment land in its slots;
    overflow and >1-bucket drifters are dropped (kernel_bucket.cuh:30-31).
    """
    by, bx, cap = state.x.shape
    bx_log2 = int(np.log2(bx))
    by_log2 = int(np.log2(by))
    n = by * bx * cap
    # key = (tgt_bucket * 9 + block) * cap + slot with tgt_bucket < n/cap, so
    # max key < 9*n; keep one extra value free for the drop sentinel.
    if 9 * n >= 2**31 - 1:
        raise ValueError("grid too large for int32 sort keys")

    flat = state.reshape((-1,))
    idx = jnp.arange(n, dtype=jnp.int32)
    cur_by = idx // (bx * cap)
    cur_bx = (idx // cap) % bx
    slot = idx % cap

    tgt_bx = (flat.x >> jnp.uint32(32 - bx_log2)).astype(jnp.int32)
    tgt_by = (flat.y >> jnp.uint32(32 - by_log2)).astype(jnp.int32)

    dy = cur_by - tgt_by
    dx = cur_bx - tgt_bx
    live = flat.ty >= 0
    pullable = live & (jnp.abs(dy) <= 1) & (jnp.abs(dx) <= 1)

    block = (dy + 1) * 3 + (dx + 1)
    tgt = tgt_by * bx + tgt_bx
    key = (tgt * 9 + block) * cap + slot
    key = jnp.where(pullable, key, jnp.int32(2**31 - 1))  # dropped -> end

    # payloads ride the sort network directly instead of a (key, idx)-only
    # sort followed by five random-index gathers. tgt and pullable are
    # recovered from the sorted key instead of riding along (2 fewer operands
    # through the network).
    key_s, x_s, y_s, vx_s, vy_s, ty_s = jax.lax.sort(
        (key, flat.x, flat.y, flat.vx, flat.vy, flat.ty), num_keys=1
    )
    ok_s = (key_s != jnp.int32(2**31 - 1)).astype(jnp.int32)
    tgt_s = key_s // jnp.int32(9 * cap)

    # rank within each target-bucket segment of the sorted order
    pos = jnp.arange(n, dtype=jnp.int32)
    new_seg = jnp.concatenate([jnp.ones(1, bool), tgt_s[1:] != tgt_s[:-1]])
    seg_start = jax.lax.cummax(jnp.where(new_seg, pos, 0))
    rank = pos - seg_start

    keep = (ok_s == 1) & (rank < cap)
    dest = jnp.where(keep, tgt_s * cap + rank, n)  # n = out of bounds -> drop

    out = empty_state((n,))
    mode = "drop"
    out = ParticleState(
        x=out.x.at[dest].set(x_s, mode=mode),
        y=out.y.at[dest].set(y_s, mode=mode),
        vx=out.vx.at[dest].set(vx_s, mode=mode),
        vy=out.vy.at[dest].set(vy_s, mode=mode),
        ty=out.ty.at[dest].set(ty_s, mode=mode),
    )
    return out.reshape((by, bx, cap))


def chunked_frame_schedule(state, steps, move_every: int, step, move):
    """``steps`` physics steps with ``move`` before steps 1, 1+k, 1+2k, … —
    the exact op sequence of the reference's per-step schedule
    (kernel_bucket.cuh:181-206, `if i % k == 1: move`) without paying a
    branch per step: one chunk loop with a dynamic inner step loop, so
    ``step``/``move`` appear once in the jaxpr (small traces, fast compiles)
    and ``steps`` stays a traced value — live steps_per_frame edits never
    recompile. (Unrolling each chunk's steps ran the 1M dense grid 46%
    slower on an H100 and compiled 4x slower; PERF.md, Findings.)"""

    def chunk(c, s):
        # chunk 0 = the lone leading step; chunks 1.. = move + <= move_every
        # steps (moves land before steps 1, 1+k, 1+2k, ... exactly)
        s = jax.lax.cond(c > 0, move, lambda t: t, s)
        k = jnp.where(
            c == 0,
            jnp.minimum(steps, 1),
            jnp.minimum(move_every, steps - 1 - (c - 1) * move_every),
        )
        return jax.lax.fori_loop(0, k, lambda j, t: step(t), s)

    n_chunks = jnp.where(steps >= 1, (steps + move_every - 2) // move_every + 1, 0)
    return jax.lax.fori_loop(0, n_chunks, chunk, state)


def run_frame_bucket(state: ParticleState, p: SimParams,
                     move_every: int = 16) -> ParticleState:
    """One frame = steps_per_frame bucket steps with a rebucket pass every
    ``move_every`` steps, scheduled like bucket_kernel_run_async
    (kernel_bucket.cuh:181-206): first move lands before the 2nd step of the
    frame, then every ``move_every`` steps after. The rebucket is
    ``bucket_move_direct``."""
    return chunked_frame_schedule(
        state, p.steps_per_frame, move_every, lambda s: bucket_step(s, p),
        bucket_move_direct,
    )
