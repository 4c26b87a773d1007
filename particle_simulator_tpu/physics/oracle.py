"""NumPy f32 oracle: a direct, dependency-free transliteration of the reference
CUDA kernel math, used as the test reference ("the same kernel logic callable
from plain CPU loops" oracle the reference relies on, doc/project.typ:673-708).

This module intentionally mirrors cuda_simulator/src/particle.cuh and
kernel_compact.cuh operation-for-operation in float32. It is the ground truth
the JAX paths are tested against; it is NOT a performance path.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
U32_MAX_F = F32(4294967295.0)
MASS = F32(6.63352599e-26)
HALF_U32 = np.uint32(2147483647)


def _params(meta: np.ndarray):
    p = meta["particles"][0]
    sigma, eps, n, m = F32(p["sigma"]), F32(p["epsilon"]), F32(p["n"]), F32(p["m"])
    C = (n / (n - m)) * F32(np.power(n / m, m / (n - m)))
    return sigma, eps, n, m, C


def _f_force(r, sigma, eps, n, m, C):
    sr = sigma / r
    return C * eps * (m * np.power(sr, m) - n * np.power(sr, n)) / r


def _f_force_repulsive(r, sigma, eps, n, m, C):
    sr = sigma / r
    return C * eps * m * np.power(sr, m) / r


def _meta_scalars(meta: np.ndarray):
    return (F32(meta["box_width"]), F32(meta["box_height"]), F32(meta["step_dt"]),
            F32(meta["cursor_pos"][0]), F32(meta["cursor_pos"][1]),
            F32(meta["cursor_size"]))


def _external_force(x, y, meta):
    """Cursor + wall force on u32 positions (kernel_compact.cuh:10-22,
    particle.cuh:125-144)."""
    sigma, eps, n, m, C = _params(meta)
    bw, bh, _, cx, cy, csize = _meta_scalars(meta)
    dxc = cx - x.astype(F32) / U32_MAX_F
    dyc = cy - y.astype(F32) / U32_MAX_F
    sq = dxc * dxc + dyc * dyc
    inside = sq < csize * csize / F32(4.0)
    mag = F32(8e-12) / (sq + F32(1.0))
    fx = np.where(inside, np.where(dxc > 0, -mag, mag), F32(0.0))
    fy = np.where(inside, np.where(dyc > 0, -mag, mag), F32(0.0))

    in_left = x < HALF_U32
    dist_x = np.where(in_left, x.astype(F32) / U32_MAX_F * bw, (U32_MAX_F - x.astype(F32)) / U32_MAX_F * bw)
    fx = fx + np.where(in_left, 1.0, -1.0).astype(F32) * _f_force_repulsive(dist_x, sigma, eps, n, m, C)
    in_bottom = y < HALF_U32
    dist_y = np.where(in_bottom, y.astype(F32) / U32_MAX_F * bh, (U32_MAX_F - y.astype(F32)) / U32_MAX_F * bh)
    fy = fy + np.where(in_bottom, 1.0, -1.0).astype(F32) * _f_force_repulsive(dist_y, sigma, eps, n, m, C)
    return fx, fy


def _pair_force(xi, yi, xj, yj, skip, meta):
    """Summed Mie pair force on each i from its row of j's (kernel_compact.cuh:
    26-31, particle.cuh:41-47,97-103): xi/yi shaped (Ni, 1), xj/yj and the
    ``skip`` mask (pairs that contribute nothing: i itself, empty slots)
    shaped (Ni, Nj)."""
    sigma, eps, n, m, C = _params(meta)
    bw, bh = F32(meta["box_width"]), F32(meta["box_height"])
    ddx = np.where(xi < xj, (xj - xi).astype(F32), -((xi - xj).astype(F32))) / U32_MAX_F * bw
    ddy = np.where(yi < yj, (yj - yi).astype(F32), -((yi - yj).astype(F32))) / U32_MAX_F * bh
    r = np.where(skip, F32(1.0), np.hypot(ddx, ddy))
    f_over_r = np.where(skip, F32(0.0), _f_force(r, sigma, eps, n, m, C) / r)
    return (np.sum(f_over_r * ddx, axis=1, dtype=F32),
            np.sum(f_over_r * ddy, axis=1, dtype=F32))


def _leapfrog(parts, fx, fy, meta):
    """Kick-drift update (particle.cuh:105-123) of ``parts`` under force
    (fx, fy); returns the updated copy."""
    bw, bh, dt = F32(meta["box_width"]), F32(meta["box_height"]), F32(meta["step_dt"])
    nvx = parts["vx"].astype(F32) + (fx / MASS) * dt
    nvy = parts["vy"].astype(F32) + (fy / MASS) * dt
    ddx_fp = np.round((nvx * dt / bw) * U32_MAX_F)
    ddy_fp = np.round((nvy * dt / bh) * U32_MAX_F)
    out = parts.copy()
    out["x"] = parts["x"].astype(np.uint32) + ddx_fp.astype(np.int64).astype(np.uint32)
    out["y"] = parts["y"].astype(np.uint32) + ddy_fp.astype(np.int64).astype(np.uint32)
    out["vx"] = nvx
    out["vy"] = nvy
    return out


def oracle_step(parts: np.ndarray, meta: np.ndarray) -> np.ndarray:
    """One all-pairs physics step over a PARTICLE_DTYPE array (live particles
    only — callers pass compacted arrays, like the reference's CompactArray
    path). Returns the updated array. All math in f32."""
    return oracle_step_rows(parts, meta, np.arange(len(parts)))


def oracle_step_rows(parts: np.ndarray, meta: np.ndarray, rows: np.ndarray,
                     cands: np.ndarray | None = None) -> np.ndarray:
    """``oracle_step`` for ``parts[rows]`` alone: each row feels cursor, walls
    and the Mie force of every other particle of ``parts`` (``cands=None``,
    the all-pairs step), or only of ``parts[cands[k]]`` — a (len(rows), K)
    index array, -1 for no particle — which is how a cell-list step is
    checked: the candidates are the 3x3 neighbour buckets' live slots.
    Returns the updated ``parts[rows]``."""
    x = parts["x"].astype(np.uint32)
    y = parts["y"].astype(np.uint32)
    rows = np.asarray(rows)
    with np.errstate(all="ignore"):
        fx, fy = _external_force(x[rows], y[rows], meta)
        if cands is None:
            xj, yj = x[None, :], y[None, :]
            skip = rows[:, None] == np.arange(len(parts))[None, :]
        else:
            cands = np.asarray(cands)
            skip = (cands < 0) | (cands == rows[:, None])
            safe = np.where(cands < 0, 0, cands)
            xj, yj = x[safe], y[safe]
        pfx, pfy = _pair_force(x[rows][:, None], y[rows][:, None], xj, yj, skip, meta)
        return _leapfrog(parts[rows], fx + pfx, fy + pfy, meta)


def oracle_run(parts: np.ndarray, meta: np.ndarray, steps: int) -> np.ndarray:
    for _ in range(steps):
        parts = oracle_step(parts, meta)
    return parts


def total_energy(parts: np.ndarray, meta: np.ndarray) -> float:
    """Kinetic + Mie pair potential + wall potential proxy — in f64 for
    diagnostic stability. (Wall potential omitted: the reference's wall force is
    not conservative across the half-box branch; energy tests use interior
    scenes where walls contribute negligibly.)"""
    sigma, eps, n, m, C = _params(meta)
    bw, bh = float(meta["box_width"]), float(meta["box_height"])
    x = parts["x"].astype(np.float64) / 4294967295.0 * bw
    y = parts["y"].astype(np.float64) / 4294967295.0 * bh
    v2 = parts["vx"].astype(np.float64) ** 2 + parts["vy"].astype(np.float64) ** 2
    ke = 0.5 * float(MASS) * v2.sum()

    dx = x[:, None] - x[None, :]
    dy = y[:, None] - y[None, :]
    r = np.hypot(dx, dy)
    np.fill_diagonal(r, np.inf)
    sr = float(sigma) / r
    pe = 0.5 * float(C) * float(eps) * np.sum(sr ** float(n) - sr ** float(m))
    return ke + pe
