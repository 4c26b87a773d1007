"""Cross-checks of the device paths against references independent of them.

Each check runs one JAX path on JAX's default device (the GPU on a GPU
host, the CPU in the test suite) and compares it with code that shares
nothing with it:

- ``allpairs_vs_oracle``: one all-pairs step against the NumPy oracle
  (physics/oracle.py), over all particles or a seeded sample of rows;
- ``bucket_step_vs_oracle``: one bucket step against the oracle's f32 pair
  force summed over each sampled particle's 3x3 neighbour buckets, with the
  same wall and cursor terms;
- ``dense_readback_vs_host``: the device dense pack (ops/readback.py)
  against the host mask ``state_to_numpy(...)[ty >= 0]``, bit for bit.

Tolerances (``TOLERANCE``) are the CPU suite's (tests/test_physics.py):
species exact, positions within 4 fixed-point units, velocities within
``rtol=2e-5, atol=1e-4``. The pair math has no matrix product, so TF32 does
not apply; the checks still run under ``jax.default_matmul_precision
("highest")``. What may differ between the device and the oracle is the
f32 rounding of log/exp (the device uses the log-domain form, the oracle
powf) and the summation order. Each check returns the measured maxima
beside an ``ok`` verdict.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from particle_simulator_tpu.physics import oracle

# JAX is imported inside the device checks only: ``compare`` also serves
# processes that must not load it (chip_smoke.py's parent).


class Tolerance(NamedTuple):
    pos_units: int = 4
    v_rtol: float = 2e-5
    v_atol: float = 1e-4


TOLERANCE = Tolerance()


def compare(got: np.ndarray, want: np.ndarray, tol: Tolerance = TOLERANCE) -> dict:
    """Maxima of the differences between two PARTICLE_DTYPE arrays of the
    same particles, and whether they are within ``tol``. ``v_tol_ratio`` is
    max |dv| / (atol + rtol |v_want|): at most 1 passes."""
    ty_mismatches = int(np.count_nonzero(got["ty"] != want["ty"]))
    pos = max(
        int(np.abs(got[f].astype(np.int64) - want[f].astype(np.int64)).max(initial=0))
        for f in ("x", "y")
    )
    v_abs = 0.0
    ratio = 0.0
    for f in ("vx", "vy"):
        d = np.abs(got[f].astype(np.float64) - want[f].astype(np.float64))
        if d.size:
            v_abs = max(v_abs, float(d.max()))
            bound = tol.v_atol + tol.v_rtol * np.abs(want[f].astype(np.float64))
            ratio = max(ratio, float((d / bound).max()))
    finite = bool(np.isfinite(got["vx"]).all() and np.isfinite(got["vy"]).all())
    return {
        "compared": int(len(want)),
        "ty_mismatches": ty_mismatches,
        "pos_max_units": pos,
        "v_max_abs": v_abs,
        "v_tol_ratio": ratio,
        "finite": finite,
        "ok": bool(finite and ty_mismatches == 0 and pos <= tol.pos_units
                   and ratio <= 1.0),
    }


def _sample(n: int, sample: int | None, seed: int) -> np.ndarray:
    if sample is None or sample >= n:
        return np.arange(n)
    return np.sort(np.random.default_rng(seed).choice(n, sample, replace=False))


def allpairs_vs_oracle(parts: np.ndarray, meta: np.ndarray,
                       sample: int | None = None, seed: int = 0) -> dict:
    """One all-pairs step (physics/step.py ``allpairs_step``) of the live
    particles laid out like the engine's CompactArray path (power-of-two
    capacity, at least 1024, tombstone tail), against the oracle on all rows
    or on ``sample`` seeded rows."""
    import jax

    from particle_simulator_tpu.engine.state import (
        SimParams,
        state_from_numpy,
        state_to_numpy,
    )
    from particle_simulator_tpu.physics.step import allpairs_step

    live = parts[parts["ty"] >= 0]
    n = len(live)
    capacity = max(1024, 1 << int(np.ceil(np.log2(max(n, 1)))))
    state = jax.device_put(state_from_numpy(live, capacity), jax.devices()[0])
    with jax.default_matmul_precision("highest"):
        out = jax.jit(allpairs_step)(state, SimParams.from_record(meta))
    rows = _sample(n, sample, seed)
    got = state_to_numpy(out)[:n][rows]
    return compare(got, oracle.oracle_step_rows(live, meta, rows))


def neighbour_candidates(ty: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """(len(rows), 9*CAP) flat slot indices of the live slots in each row's
    3x3 neighbour buckets (-1 where the bucket is off the grid or the slot
    dead), in stack9's scan order — the candidate set of the bucket step.
    ``ty`` is the (BY, BX, CAP) species grid; ``rows`` flat slot indices."""
    by, bx, cap = ty.shape
    iy, rem = np.divmod(rows, bx * cap)
    ix = rem // cap
    cols = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ny, nx = iy + dy, ix + dx
            inside = (ny >= 0) & (ny < by) & (nx >= 0) & (nx < bx)
            base = (np.clip(ny, 0, by - 1) * bx + np.clip(nx, 0, bx - 1)) * cap
            for t in range(cap):
                idx = base + t
                cols.append(np.where(inside & (ty.reshape(-1)[idx] >= 0), idx, -1))
    return np.stack(cols, axis=1)


def bucket_step_vs_oracle(state, meta: np.ndarray,
                          sample: int | None = None, seed: int = 0) -> dict:
    """One bucket step (physics/bucket.py ``bucket_step``) of a (BY, BX, CAP)
    grid state, against the oracle on ``sample`` seeded live slots (all of
    them for None), each feeling only its 3x3 neighbour buckets' live
    particles — the cell-list semantics the step implements."""
    import jax

    from particle_simulator_tpu.engine.state import SimParams, state_to_numpy
    from particle_simulator_tpu.physics.bucket import bucket_step

    state = jax.device_put(state, jax.devices()[0])
    with jax.default_matmul_precision("highest"):
        out = jax.jit(bucket_step)(state, SimParams.from_record(meta))
    grid = state_to_numpy(state)
    live = np.nonzero(grid["ty"] >= 0)[0]
    rows = live[_sample(len(live), sample, seed)]
    cands = neighbour_candidates(np.asarray(state.ty), rows)
    got = state_to_numpy(out)[rows]
    return compare(got, oracle.oracle_step_rows(grid, meta, rows, cands))


def dense_readback_vs_host(state) -> dict:
    """The device dense pack against the host mask, bit for bit, with the
    engine's sizing (power-of-two prefix >= the fullest bucket, power-of-two
    length >= the live count)."""
    import jax

    from particle_simulator_tpu.engine.state import ParticleState, state_to_numpy
    from particle_simulator_tpu.ops.readback import (
        dense_readback,
        dense_to_particles,
        pow2_at_least,
    )

    state = jax.device_put(state, jax.devices()[0])
    host = state_to_numpy(state)
    want = host[host["ty"] >= 0]
    occupancy = (np.asarray(state.ty) >= 0).sum(-1)
    kcap = pow2_at_least(int(occupancy.max(initial=0)))
    ncap = pow2_at_least(len(want))
    scalars, packed = dense_readback(state, kcap, ncap)
    mx, total = (int(v) for v in np.asarray(scalars))
    got = dense_to_particles(total, ParticleState(*jax.device_get(tuple(packed))))
    exact = total == len(want) and got.tobytes() == want.tobytes()
    return {"compared": len(want), "max_occupancy": mx, "bit_exact": exact,
            "ok": exact}
