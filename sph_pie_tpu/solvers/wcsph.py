"""Weakly-compressible SPH (Mueller-03 style) — the fused hot step.

Mirrors the role of the reference's single hot write path (everything
funnels through one function — sphereisaiahmin-dev/sph-pie
`server/storage/sqlProvider.js:162-228` has the same shape for entry
writes): one jit-compiled ``step`` that every driver, bench, and service
layer calls. Two neighbor folds per step (density, then forces), symplectic
Euler integration, optional XSPH advection smoothing and Akinci-style
cohesion. Entirely static-shape: rollable under ``lax.fori_loop`` /
``lax.scan`` and shardable with ``shard_map``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from sph_pie_tpu.core.params import FluidParams
from sph_pie_tpu.core.state import ParticleState
from sph_pie_tpu.kernels import eos, smoothing
from sph_pie_tpu.neighbors import grid as nbr
from sph_pie_tpu.utils.struct import replace


def compute_density(
    params: FluidParams, gspec: nbr.GridSpec, cl: nbr.CellList, state: ParticleState
):
    """SPH density summation rho_i = sum_j m_j W_poly6(|x_ij|)."""
    pos, mass = state.pos, state.mass
    h2 = params.h * params.h

    def pair(rho, j, valid):
        d = pos[:, None, :] - pos[j]                       # [N, cap, dim]
        r2 = jnp.sum(d * d, axis=-1)                       # [N, cap]
        w = smoothing.poly6(params.dim, params.h, r2)      # includes self term
        contrib = jnp.where(valid & (r2 < h2), mass[j] * w, 0.0)
        return rho + jnp.sum(contrib, axis=-1)

    rho = nbr.neighbor_fold(gspec, cl, pair, jnp.zeros_like(mass))
    # Floor well away from zero so 1/rho is safe for isolated particles.
    return jnp.maximum(rho, 1e-6 * params.rest_density)


def _pair_accel(params: FluidParams, state: ParticleState):
    """Returns (pair_fn, init) computing pressure+viscosity+cohesion accel
    and the XSPH velocity-correction sum in a single neighbor fold."""
    pos, vel = state.pos, state.vel
    mass, rho, prs = state.mass, state.density, state.pressure
    dim, h = params.dim, params.h
    h2 = h * h
    tiny = jnp.asarray(1e-12, pos.dtype)

    def pair(carry, j, valid):
        acc, xsph = carry
        d = pos[:, None, :] - pos[j]                       # x_ij  [N, cap, dim]
        r2 = jnp.sum(d * d, axis=-1)
        live = valid & (r2 < h2) & (r2 > tiny)             # exclude self
        r = jnp.sqrt(jnp.maximum(r2, tiny))
        rhat = d / r[..., None]
        m_j = jnp.where(live, mass[j], 0.0)
        rho_j = rho[j]
        inv_rho_j = 1.0 / rho_j

        # Symmetric pressure gradient (Mueller 03 / standard SPH):
        #   a_i = -sum_j m_j (p_i/rho_i^2 + p_j/rho_j^2) grad_i W_spiky
        gw = smoothing.spiky_grad_mag(dim, h, r)           # < 0 inside support
        p_term = prs[:, None] / (rho[:, None] ** 2) + prs[j] * inv_rho_j**2
        acc = acc - jnp.sum((m_j * p_term * gw)[..., None] * rhat, axis=1)

        # Mueller viscosity: a_i += (mu/rho_i) sum_j m_j (v_j - v_i)/rho_j lapW
        dv = vel[j] - vel[:, None, :]
        lap = smoothing.visc_lap(dim, h, r)
        visc_w = m_j * inv_rho_j * lap
        acc = acc + (params.viscosity / rho[:, None]) * jnp.sum(
            visc_w[..., None] * dv, axis=1
        )

        # Akinci-style cohesion (surface tension), attractive along -rhat.
        coh = smoothing.cohesion(dim, h, r)
        acc = acc - params.surface_tension * jnp.sum(
            (m_j * coh)[..., None] * rhat, axis=1
        )

        # XSPH sum (uses pre-step velocities; applied to advection below).
        # Monaghan-style with the common m_j/rho_j weighting — divide-free
        # in the pair loop (the rho_bar form costs a per-pair divide).
        w = smoothing.poly6(dim, h, r2)
        xw = jnp.where(live, mass[j] * inv_rho_j * w, 0.0)
        xsph = xsph + jnp.sum(xw[..., None] * dv, axis=1)

        return (acc, xsph)

    zero = jnp.zeros_like(pos)
    return pair, (zero, zero)


def boundary_accel(params: FluidParams, pos, vel, wall_axes=None):
    """Penalty spring-damper against the domain AABB walls.

    The damping ramps in linearly over the first 0.1h of penetration: a
    step-function damper (full -c*v the instant pen > 0) makes the force
    field discontinuous in state, which lets O(ulp) implementation noise
    flip a finite force at grazing contact — measured to seed a 2e-4
    trajectory jump between bit-equivalent engines. A continuous ramp keeps
    cross-implementation parity at rounding level (and is better contact
    physics).

    ``wall_axes``: optional per-SPATIAL-axis bool mask; False disables the
    wall on that axis (periodic axes have no walls).
    """
    pen_lo = jnp.maximum(params.bound_min - pos, 0.0)
    pen_hi = jnp.maximum(pos - params.bound_max, 0.0)
    if wall_axes is not None and not all(wall_axes):
        m = jnp.asarray(wall_axes, pos.dtype)[None, :]
        pen_lo = pen_lo * m
        pen_hi = pen_hi * m
    pen = jnp.max(pen_lo + pen_hi, axis=-1, keepdims=True)
    ramp = jnp.minimum(pen / (0.1 * params.h), 1.0)
    acc = params.boundary_stiffness * (pen_lo - pen_hi)
    acc = acc - params.boundary_damping * ramp * vel
    return acc


def clamp_speed(params: FluidParams, vel):
    """CFL guard: rescale any velocity above ``max_speed`` onto the cap.

    Inactive in healthy flows (Mach << 1); identical in the oracle, the
    naive engine, and the binned engine, so it does not break trajectory
    parity. It is what makes the binned engine's Verlet-skin rebin bound
    (displacement <= max_speed * dt per step) a hard guarantee.
    """
    speed2 = jnp.sum(vel * vel, axis=-1, keepdims=True)
    cap2 = params.max_speed * params.max_speed
    scale = jnp.where(speed2 > cap2, params.max_speed * jax.lax.rsqrt(speed2), 1.0)
    return vel * scale


@partial(jax.jit, static_argnames=("gspec",))
def step(
    params: FluidParams,
    gspec: nbr.GridSpec,
    state: ParticleState,
    obstacles=None,
    t=0.0,
) -> ParticleState:
    """One WCSPH step: build cells -> density -> EOS -> forces -> integrate."""
    cl = nbr.build(gspec, state.pos, state.active)

    rho = compute_density(params, gspec, cl, state)
    prs = eos.tait_pressure(params, rho)
    state = replace(state, density=rho, pressure=prs)

    pair, init = _pair_accel(params, state)
    acc, xsph = nbr.neighbor_fold(gspec, cl, pair, init)

    acc = acc + params.gravity
    acc = acc + boundary_accel(params, state.pos, state.vel)
    if obstacles is not None:
        from sph_pie_tpu.scenes import obstacles as obs_lib

        acc = acc + obs_lib.accel(obstacles, state.pos, state.vel, t)

    active = state.active[:, None]
    vel = jnp.where(active, state.vel + params.dt * acc, state.vel)
    vel = clamp_speed(params, vel)
    vel_adv = vel + params.xsph_eps * xsph
    pos = jnp.where(active, state.pos + params.dt * vel_adv, state.pos)

    return replace(state, pos=pos, vel=vel)


@partial(jax.jit, static_argnames=("gspec",))
def simulate(params, gspec, state, n_steps, obstacles=None) -> ParticleState:
    """Roll ``n_steps`` fused steps on-device (no host round trips).

    ``n_steps`` is a dynamic scalar: any horizon reuses one compilation."""
    return lax.fori_loop(
        0,
        jnp.asarray(n_steps, jnp.int32),
        lambda i, s: step(params, gspec, s, obstacles, t=i * params.dt),
        state,
    )


@partial(jax.jit, static_argnames=("gspec", "n_steps", "record_every"))
def simulate_trajectory(params, gspec, state, n_steps: int, record_every: int = 1):
    """Roll the sim, recording positions every ``record_every`` steps.

    Returns (final_state, traj) with traj.shape == [n_steps//record_every, N, dim].
    """

    def outer(s, _):
        s = lax.fori_loop(0, record_every, lambda _, x: step(params, gspec, x), s)
        return s, s.pos

    return lax.scan(outer, state, None, length=n_steps // record_every)
