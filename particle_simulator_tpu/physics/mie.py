"""Mie-potential particle physics in f32, semantics matched to the reference.

Every formula here is a jnp transliteration of the reference's device functions
(cuda_simulator/src/particle.cuh, kernel_compact.cuh, kernel_bucket.cuh), kept in
f32 so trajectories agree to f32 tolerance (the hot pair path uses the
re-associated log-domain form — see ``mie_log_coeffs`` — which agrees with the
reference's op order within f32 rounding; the oracle keeps the exact order):

- Mie force        F(r)   = C * eps * (m*(s/r)^m - n*(s/r)^n) / r,
                   C      = (n/(n-m)) * (n/m)^(m/(n-m))           (particle.cuh:54,63-66)
- pair force       F2(r_) = F(|r_|)/|r_| * r_                     (particle.cuh:97-103)
- wall force       repulsive-only Mie from the 4 walls, branch on
                   which half of the box the particle is in        (particle.cuh:125-144)
- cursor force     8e-12/(d^2+1) componentwise-signed repulsion inside
                   the cursor radius, in normalized [0,1] coords   (kernel_bucket.cuh:54-67)
- leapfrog         v += (F/mass)*dt ; x += round(v*dt/box * u32max) as
                   wrap-around u32 addition                        (particle.cuh:105-123)

All functions take/return plain arrays and work under jit, vmap and the
NumPy shim of physics/host.py alike.
Positions are u32 fixed point spanning the box; distances are computed by
wrap-free u32 subtraction then scaled to meters in f32 (particle.cuh:41-47).
"""

from __future__ import annotations

import jax.numpy as jnp

from particle_simulator_tpu.engine.state import PARTICLE_MASS, SimParams, U32_MAX_F, HALF_U32

F32 = jnp.float32


def mie_constant(n, m):
    """C = (n/(n-m)) * (n/m)^(m/(n-m)), computed in f32 like ParticleParams' ctor."""
    n = jnp.asarray(n, F32)
    m = jnp.asarray(m, F32)
    return (n / (n - m)) * jnp.power(n / m, m / (n - m))


def mie_force(r, p: SimParams):
    """Scalar Mie force magnitude (positive = repulsive) at distance r (meters)."""
    C = mie_constant(p.n, p.m)
    sr = jnp.asarray(p.sigma, F32) / r
    return C * p.epsilon * (p.m * jnp.power(sr, p.m) - p.n * jnp.power(sr, p.n)) / r


def mie_force_repulsive(r, p: SimParams):
    """Repulsion-only term of the Mie force (used for walls)."""
    C = mie_constant(p.n, p.m)
    sr = jnp.asarray(p.sigma, F32) / r
    return C * p.epsilon * p.m * jnp.power(sr, p.m) / r


_F32_TINY = 1.1754944e-38  # smallest normal f32
_F32_HUGE = 3.4028235e38   # largest finite f32


def mie_log_coeffs_scalars(sigma, eps, n, m):
    """Log-domain pair-force constants from raw f32 scalars — the
    derivation behind ``mie_log_coeffs``; pure scalar math evaluated once
    per dispatch, so a hand-written pair kernel can call it on its own
    parameter vector.

    The pair kernel needs F(r)/r, and the Mie law factors into two pure
    exponentials of lu = log(r^2/sigma^2):

        F(r)/r = C*eps*(m*(s/r)^m - n*(s/r)^n)/r^2
               = exp(A1 - B1*lu) - exp(A2 - B2*lu),
        A1 = log(C*eps*m/sigma^2),  B1 = (m+2)/2   (A2/B2 with n)

    so the per-pair cost is one log + two exp + two FMAs + two sign
    multiplies: the direct form's rsqrt and five multiplies (sigma*inv_r,
    m*lsr, n*lsr, inv_r^2, Ce*...) hoist into the per-dispatch scalars.
    Same force law as the reference (particle.cuh:54-66, just
    re-associated); all A/B are O(10) so the f32 exponent range is safe for
    any r where the direct form was. The per-term signs s1/s2 keep garbage
    metadata (live-edited m > n, or negative eps/exponents — C*eps < 0)
    producing the same FINITE values as the direct form instead of
    log-of-negative NaNs that would permanently poison the scene. Agreement
    with the oracle's powf form is within f32 rounding (tests/test_physics).

    Degenerate-sigma handling (every param here is a live-editable slider):
    sigma == 0 would make Ce/s2 = inf and then inf - inf = NaN in the pair
    loop, where the direct form yields ZERO force (sr = 0, powf(0, m) = 0).
    s2 clamps to the smallest normal f32 so inv_s2 (hence lu) stays finite,
    |t| clamps to the largest finite f32 so garbage-huge eps can't reach
    log(inf), and A pins to -inf when sigma underflowed — exp(-inf - B*lu)
    is the direct form's EXACT zero at every d2 > 0 (at d2 == 0, coincident
    particles, both forms are already NaN/inf — reference parity). All
    clamps are identity for every physically representable sigma/eps.
    """
    # C = (n/(n-m)) * (n/m)^(m/(n-m))  (particle.cuh:54), in exp/log form
    C = (n / (n - m)) * jnp.exp((m / (n - m)) * jnp.log(n / m))
    s = jnp.asarray(sigma, F32)
    degenerate = s * s < F32(_F32_TINY)
    s2 = jnp.maximum(s * s, F32(_F32_TINY))
    ce_s2 = C * jnp.asarray(eps, F32) / s2
    t1 = ce_s2 * m
    t2 = ce_s2 * n
    neg_inf = F32(-jnp.inf)
    A1 = jnp.where(degenerate, neg_inf, jnp.log(jnp.minimum(jnp.abs(t1), F32(_F32_HUGE))))
    A2 = jnp.where(degenerate, neg_inf, jnp.log(jnp.minimum(jnp.abs(t2), F32(_F32_HUGE))))
    B1 = (m + F32(2.0)) * F32(0.5)
    B2 = (n + F32(2.0)) * F32(0.5)
    s1 = jnp.where(t1 < F32(0.0), F32(-1.0), F32(1.0))
    s2_ = jnp.where(t2 < F32(0.0), F32(-1.0), F32(1.0))
    return A1, B1, A2, B2, F32(1.0) / s2, s1, s2_


def mie_log_coeffs(p: SimParams):
    """Log-domain pair-force constants for the jnp pair path — see
    ``mie_log_coeffs_scalars`` for the math and the degenerate-metadata
    clamps."""
    return mie_log_coeffs_scalars(p.sigma, p.epsilon, p.n, p.m)


def mie_potential(r, p: SimParams):
    """Potential energy V(r) = C*eps*((s/r)^n - (s/r)^m) — used by the energy
    diagnostics/tests; the reference documents it (particle.cuh:12) but never
    evaluates it on device."""
    C = mie_constant(p.n, p.m)
    sr = jnp.asarray(p.sigma, F32) / r
    return C * p.epsilon * (jnp.power(sr, p.n) - jnp.power(sr, p.m))


def _u32_signed_dist(a_u32, b_u32, box_len):
    """Wrap-free displacement b-a in meters (f32), via u32 subtraction
    (particle.cuh:41-47): picks the direction that avoids u32 underflow."""
    fwd = (b_u32 - a_u32).astype(F32)  # valid when a <= b (wraps otherwise)
    bwd = (a_u32 - b_u32).astype(F32)
    d = jnp.where(a_u32 < b_u32, fwd, -bwd)
    return (d / U32_MAX_F) * box_len


def pair_force_accum(xi, yi, tyi, xj, yj, tyj, p: SimParams, self_mask=None):
    """Summed Mie pair force on each i-particle from a set of j-particles.

    xi/yi: u32 positions shaped (..., Ni); xj/yj shaped (..., Nj). Returns
    (fx, fy) shaped like xi. ``self_mask`` (optional, (..., Ni, Nj) bool) marks
    pairs to *exclude* in addition to null j-particles (use it for i==j).

    This is the innermost hot loop (kernel_bucket.cuh:79-91 /
    kernel_compact.cuh:26-31) in data-parallel form: a (Ni, Nj) pair tile of
    elementwise math. Null j's and excluded pairs are masked with a safe
    distance so no NaN leaks into masked lanes.
    """
    dx = _u32_signed_dist(xi[..., :, None], xj[..., None, :], p.box_width)
    dy = _u32_signed_dist(yi[..., :, None], yj[..., None, :], p.box_height)

    valid = tyj[..., None, :] >= jnp.int32(0)
    valid = jnp.logical_and(valid, tyi[..., :, None] >= jnp.int32(0))
    if self_mask is not None:
        valid = jnp.logical_and(valid, jnp.logical_not(self_mask))

    A1, B1, A2, B2, inv_s2, s1, s2 = mie_log_coeffs(p)
    d2 = dx * dx + dy * dy
    d2 = jnp.where(valid, d2, F32(1.0))
    lu = jnp.log(d2 * inv_s2)
    f_over_r = s1 * jnp.exp(A1 - B1 * lu) - s2 * jnp.exp(A2 - B2 * lu)
    f_over_r = jnp.where(valid, f_over_r, F32(0.0))

    fx = jnp.sum(f_over_r * dx, axis=-1)
    fy = jnp.sum(f_over_r * dy, axis=-1)
    return fx, fy


def wall_force(x_u32, y_u32, p: SimParams):
    """Repulsive-only Mie force from the four box walls (particle.cuh:125-144).
    Branches on which half of the box the particle is in and pushes inward."""
    xf = x_u32.astype(F32)
    yf = y_u32.astype(F32)

    left = (xf / U32_MAX_F) * p.box_width
    right = ((U32_MAX_F - xf) / U32_MAX_F) * p.box_width
    in_left = x_u32 < HALF_U32
    dist_x = jnp.where(in_left, left, right)
    fx = mie_force_repulsive(dist_x, p) * jnp.where(in_left, F32(1.0), F32(-1.0))

    bottom = (yf / U32_MAX_F) * p.box_height
    top = ((U32_MAX_F - yf) / U32_MAX_F) * p.box_height
    in_bottom = y_u32 < HALF_U32
    dist_y = jnp.where(in_bottom, bottom, top)
    fy = mie_force_repulsive(dist_y, p) * jnp.where(in_bottom, F32(1.0), F32(-1.0))

    return fx, fy


def cursor_force(x_u32, y_u32, p: SimParams):
    """Editor cursor repulsion: 8e-12/(d^2+1) with componentwise sign, in
    normalized [0,1] coordinates, active inside radius cursor_size/2
    (kernel_bucket.cuh:54-67). cursor_pos = (-1,-1) means "no cursor" and falls
    outside every particle's radius naturally."""
    dx = p.cursor_x - x_u32.astype(F32) / U32_MAX_F
    dy = p.cursor_y - y_u32.astype(F32) / U32_MAX_F
    sq = dx * dx + dy * dy
    inside = sq < p.cursor_size * p.cursor_size / F32(4.0)

    mag = F32(8e-12) / (sq + F32(1.0))
    fx = jnp.where(dx > F32(0.0), -mag, mag)
    fy = jnp.where(dy > F32(0.0), -mag, mag)
    zero = F32(0.0)
    return jnp.where(inside, fx, zero), jnp.where(inside, fy, zero)


def euler_apply(x, y, vx, vy, ty, fx, fy, p: SimParams):
    """Explicit (forward) Euler: drift with the CURRENT velocity, then kick.

    Not on any production path. Exists to replicate the reference report's
    integrator stability analysis (doc/project.typ:208-209: explicit Euler
    explodes within ~100 ps of sim-time at dt = 1 fs, while the symplectic
    leapfrog below holds >10 ns at dt = 10 fs) — tests/test_physics.py
    asserts both halves of that claim. Fixed-point conversion is identical
    to leapfrog_apply; the ONLY difference is which velocity drifts x.
    """
    ddx = jnp.round((vx * p.step_dt / p.box_width) * U32_MAX_F)
    ddy = jnp.round((vy * p.step_dt / p.box_height) * U32_MAX_F)
    nx = x + ddx.astype(jnp.int32).astype(jnp.uint32)
    ny = y + ddy.astype(jnp.int32).astype(jnp.uint32)

    nvx = vx + (fx / PARTICLE_MASS) * p.step_dt
    nvy = vy + (fy / PARTICLE_MASS) * p.step_dt

    live = ty >= jnp.int32(0)
    return (
        jnp.where(live, nx, x),
        jnp.where(live, ny, y),
        jnp.where(live, nvx, vx),
        jnp.where(live, nvy, vy),
    )


def leapfrog_apply(x, y, vx, vy, ty, fx, fy, p: SimParams):
    """Kick-drift leapfrog update in u32 fixed point (particle.cuh:105-123):

        v(t+dt/2) = v(t-dt/2) + F/m * dt
        x(t+dt)   = x(t) + round(v*dt / box * u32_max)   (u32 wrap-around add)

    Null particles pass through unchanged (the bucket kernel's early-out,
    kernel_bucket.cuh:49-50).
    """
    # same op order as the reference: a = F/m, then v += a*dt
    nvx = vx + (fx / PARTICLE_MASS) * p.step_dt
    nvy = vy + (fy / PARTICLE_MASS) * p.step_dt

    # f32 round, then modular conversion to u32 (matches (uint32_t)(int64_t)roundf)
    ddx = jnp.round((nvx * p.step_dt / p.box_width) * U32_MAX_F)
    ddy = jnp.round((nvy * p.step_dt / p.box_height) * U32_MAX_F)
    nx = x + ddx.astype(jnp.int32).astype(jnp.uint32)
    ny = y + ddy.astype(jnp.int32).astype(jnp.uint32)

    live = ty >= jnp.int32(0)
    return (
        jnp.where(live, nx, x),
        jnp.where(live, ny, y),
        jnp.where(live, nvx, vx),
        jnp.where(live, nvy, vy),
    )
