"""WCSPH on the binned dense layout — the production hot path.

Same physics, constants, and update order as ``solvers/wcsph.py`` (and the
CPU oracle), re-expressed over the gather-free slot layout of
``neighbors/binned.py``:

  * neighbor candidates come from static-slice slab windows — zero gathers;
  * empty slots have ``mass == 0`` and a floored density, so they
    contribute exactly 0 to every pair sum — no mask tensors in the loop;
  * re-binning (the only sort) runs under ``lax.cond`` only when the
    accumulated per-particle displacement bound exceeds skin/2.

The per-step displacement bound is ``dt * min(max_speed, max|v_adv|)``
(the CFL clamp in ``clamp_speed`` makes it hard), which preserves the
cell-list exactness guarantee: any pair within support radius h is always
inside the 3^d stale-cell window.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from sph_pie_tpu.core.params import FluidParams
from sph_pie_tpu.kernels import eos, smoothing
from sph_pie_tpu.neighbors import binned as nb
from sph_pie_tpu.solvers.wcsph import boundary_accel, clamp_speed
from sph_pie_tpu.utils.struct import replace


def _planar(name: str, x: jax.Array) -> dict[str, jax.Array]:
    """Split an [S, dim] array into per-component [S] fields.

    Layout note: the pair tensors are [blk, cap, 3cap]; keeping vector
    components as separate planes keeps the wide 3cap axis minor. A
    trailing [.., dim] axis would make the minor axis 2-3 elements wide,
    which was ~10x slower on the previous machine.
    """
    return {f"{name}{k}": x[:, k] for k in range(x.shape[1])}


def _r2(dim, home, w):
    """Squared pair distance + per-component deltas, planar layout."""
    d = [
        home[f"p{k}"][:, :, None] - w[f"p{k}"][:, None, :] for k in range(dim)
    ]
    r2 = d[0] * d[0]
    for k in range(1, dim):
        r2 = r2 + d[k] * d[k]
    return d, r2


def _density(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b,
    halo=None,
    local_cells: int | None = None,
):
    """rho over home slots via slab windows (self term included).

    ``b`` needs .pos/.mass flat arrays; with halo/local_cells the fold runs
    on a device-local slab (parallel/halo.py)."""
    dim, h = params.dim, params.h
    if halo is None and local_cells is None and grid.symmetric_fold:
        return _density_sym(params, grid, b)

    def pair(rho, home, w):
        _, r2 = _r2(dim, home, w)                           # [blk, cap, 3cap]
        wk = smoothing.poly6(dim, h, r2)
        return rho + jnp.sum(w["mass"][:, None, :] * wk, axis=2)

    init = jnp.zeros_like(b.mass)
    fields = {**_planar("p", b.pos), "mass": b.mass}
    rho = nb.slab_fold(grid, fields, pair, init, halo=halo, local_cells=local_cells)
    return jnp.maximum(rho, 1e-6 * params.rest_density)


def _density_sym(params: FluidParams, grid: nb.BinnedGrid, b):
    """Symmetric density: each pair once, rho_i += m_j W and rho_j += m_i W;
    the diagonal self term m_i W(0) is a separate elementwise pass."""
    dim, h = params.dim, params.h

    def pair(home, w, mask):
        _, r2 = _r2(dim, home, w)
        wk = smoothing.poly6(dim, h, r2)
        if mask is not None:
            wk = jnp.where(mask, wk, 0.0)
        h_delta = jnp.sum(w["mass"][:, None, :] * wk, axis=2)
        w_delta = jnp.sum(home["mass"][:, :, None] * wk, axis=1)
        return {"rho": h_delta}, {"rho": w_delta}

    fields = {**_planar("p", b.pos), "mass": b.mass}
    out = nb.slab_fold_sym(grid, fields, pair, {"rho": jnp.zeros_like(b.mass)})
    w0 = smoothing.poly6_coeff(dim, h) * h**6  # W(0)
    rho = out["rho"] + b.mass * w0
    # Empty slots sit at pos 0; window-side accumulation can deposit
    # garbage on them (harmless downstream — every use is weighted by
    # mass==0 or gated by valid — but keep the floor semantics clean).
    rho = jnp.where(b.valid, rho, 0.0)
    return jnp.maximum(rho, 1e-6 * params.rest_density)


def _forces_sym(params: FluidParams, grid: nb.BinnedGrid, b):
    """Symmetric pressure + viscosity + cohesion + XSPH (pairs once).

    Per-pair antisymmetric core A_k = -s d_k + mu/(rho_i rho_j) lap dv_k
    with s = ((p_i/rho_i^2 + p_j/rho_j^2) gw + st coh) / r:
      acc_i += m_j A,    acc_j -= m_i A
      xsph_i += (m/rho)_j X,  xsph_j -= (m/rho)_i X   with X = W dv
    — exactly the one-sided math of ``_forces`` applied to both sides.
    """
    dim, h = params.dim, params.h
    h2 = h * h
    tiny = jnp.asarray(1e-12, b.pos.dtype)

    inv_rho = 1.0 / b.density
    pr2 = b.pressure * inv_rho * inv_rho
    m_rho = b.mass * inv_rho

    def pair(hm, w, mask):
        d, r2 = _r2(dim, hm, w)
        inv_r = jax.lax.rsqrt(jnp.maximum(r2, tiny))
        r = r2 * inv_r

        gw = smoothing.spiky_grad_mag(dim, h, r)
        if mask is not None:
            gw = jnp.where(mask, gw, 0.0)
        p_term = hm["pr2"][:, :, None] + w["pr2"][:, None, :]
        s = p_term * gw
        if params.use_cohesion:
            coh = smoothing.cohesion(dim, h, r)
            if mask is not None:
                coh = jnp.where(mask, coh, 0.0)
            s = s + params.surface_tension * coh
        s = s * inv_r

        lap = smoothing.visc_lap(dim, h, r)
        if mask is not None:
            lap = jnp.where(mask, lap, 0.0)
        g = params.viscosity * (
            hm["inv_rho"][:, :, None] * w["inv_rho"][:, None, :]
        ) * lap

        if params.use_xsph:
            wk = smoothing.poly6(dim, h, r2)
            if mask is not None:
                wk = jnp.where(mask, wk, 0.0)

        m_h = hm["mass"][:, :, None]
        m_w = w["mass"][:, None, :]
        hd, wd = {}, {}
        for k in range(dim):
            dv = w[f"v{k}"][:, None, :] - hm[f"v{k}"][:, :, None]
            A = g * dv - s * d[k]
            hd[f"a{k}"] = jnp.sum(m_w * A, axis=2)
            wd[f"a{k}"] = -jnp.sum(m_h * A, axis=1)
            if params.use_xsph:
                X = wk * dv
                hd[f"x{k}"] = jnp.sum(w["m_rho"][:, None, :] * X, axis=2)
                wd[f"x{k}"] = -jnp.sum(hm["m_rho"][:, :, None] * X, axis=1)
        return hd, wd

    fields = {
        **_planar("p", b.pos),
        **_planar("v", b.vel),
        "mass": b.mass,
        "pr2": pr2,
        "m_rho": m_rho,
        "inv_rho": inv_rho,
    }
    zero = jnp.zeros_like(b.mass)
    init = {f"a{k}": zero for k in range(dim)}
    if params.use_xsph:
        init.update({f"x{k}": zero for k in range(dim)})
    out = nb.slab_fold_sym(grid, fields, pair, init)
    acc = jnp.stack([out[f"a{k}"] for k in range(dim)], axis=-1)
    if params.use_xsph:
        xsph = jnp.stack([out[f"x{k}"] for k in range(dim)], axis=-1)
    else:
        xsph = jnp.zeros_like(acc)
    return acc, xsph


def _forces(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b,
    halo=None,
    local_cells: int | None = None,
):
    """Pressure + viscosity + cohesion accel and XSPH sum over home slots."""
    if halo is None and local_cells is None and grid.symmetric_fold:
        return _forces_sym(params, grid, b)
    dim, h = params.dim, params.h
    h2 = h * h
    tiny = jnp.asarray(1e-12, b.pos.dtype)

    # Per-particle quantities hoisted out of the pair loop: no divides
    # remain in the O(pairs) inner math (divides are multi-cycle).
    inv_rho = 1.0 / b.density
    pr2 = b.pressure * inv_rho * inv_rho          # p / rho^2
    m_rho = b.mass * inv_rho                      # m / rho

    def pair(carry, hm, w):
        """Mask-free pair math (every term vanishes naturally):

        * empty slots carry mass == 0 and m_rho == 0 -> zero weight;
        * the self pair has d == 0, so radial*d and dv terms are exactly 0
          (cohesion's own r>0 guard covers its constant near-field branch);
        * every kernel is clamped to 0 beyond the support radius.

        The explicit ``live`` mask round 1 carried cost 3 selects + 2
        compares per pair for nothing.
        """
        acc, xsph = carry                                   # tuples of [blk, cap]
        d, r2 = _r2(dim, hm, w)                             # [blk, cap, 3cap]
        inv_r = jax.lax.rsqrt(jnp.maximum(r2, tiny))
        r = r2 * inv_r                                      # = sqrt(r2), one mul
        m_j = w["mass"][:, None, :]

        # Scalar pair weights (all [blk, cap, 3cap], minor axis = 3cap):
        gw = smoothing.spiky_grad_mag(dim, h, r)
        p_term = hm["pr2"][:, :, None] + w["pr2"][:, None, :]
        # radial coefficient: acc_k -= radial * d_k (pressure [+ cohesion])
        radial = m_j * p_term * gw
        if params.use_cohesion:
            coh = smoothing.cohesion(dim, h, r)
            radial = radial + params.surface_tension * m_j * coh
        radial = radial * inv_r

        lap = smoothing.visc_lap(dim, h, r)
        visc_w = w["m_rho"][:, None, :] * lap

        if params.use_xsph:
            # m_j/rho_j weighting (= the m_rho field): divide-free and one
            # fewer window stream than the rho_bar form.
            wk = smoothing.poly6(dim, h, r2)
            xw = w["m_rho"][:, None, :] * wk

        mu_over_rho_i = params.viscosity * hm["inv_rho"]
        new_acc, new_xsph = [], []
        for k in range(dim):
            dv_k = w[f"v{k}"][:, None, :] - hm[f"v{k}"][:, :, None]
            a_k = (
                acc[k]
                - jnp.sum(radial * d[k], axis=2)
                + mu_over_rho_i * jnp.sum(visc_w * dv_k, axis=2)
            )
            new_acc.append(a_k)
            if params.use_xsph:
                new_xsph.append(xsph[k] + jnp.sum(xw * dv_k, axis=2))
            else:
                new_xsph.append(xsph[k])
        return (tuple(new_acc), tuple(new_xsph))

    fields = {
        **_planar("p", b.pos),
        **_planar("v", b.vel),
        "mass": b.mass,
        "pr2": pr2,
        "m_rho": m_rho,
        "inv_rho": inv_rho,
    }
    zero_flat = jnp.zeros_like(b.mass)
    init = (
        tuple(zero_flat for _ in range(dim)),
        tuple(zero_flat for _ in range(dim)),
    )
    acc, xsph = nb.slab_fold(
        grid, fields, pair, init, halo=halo, local_cells=local_cells
    )
    return jnp.stack(acc, axis=-1), jnp.stack(xsph, axis=-1)


def maybe_rebin(
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    light: bool = False,
    carry_density: bool = False,
) -> nb.BinnedState:
    """Two-stage lazy rebin trigger.

    ``travel`` (sum of per-step max displacement bounds) is cheap but very
    conservative in oscillatory flow. When it trips, measure the TRUE max
    displacement against the bin-time anchor (``bin_pos``, one O(S) pass):
    rebin only if a particle actually drifted past
    skin/2, otherwise tighten ``travel`` to the measured bound. The
    cell-list exactness guarantee needs (drift at fold time) <= skin/2;
    WCSPH folds once right after this check. PBF keeps moving particles
    between folds within one step, so it instead calls this before EVERY
    fold and hard-caps each constraint projection at skin/2 (solvers/
    pbf.py) — the check threshold stays skin/2 there too.
    """
    thr = 0.5 * grid.skin

    def check(x):
        d2 = jnp.sum((x.pos - x.bin_pos) ** 2, axis=-1)
        d = jnp.sqrt(jnp.max(d2))
        return lax.cond(
            d > thr,
            lambda y: nb.rebin(grid, y, light=light, carry_density=carry_density),
            lambda y: replace(y, travel=d),
            x,
        )

    return lax.cond(b.travel > thr, check, lambda x: x, b)


@partial(jax.jit, static_argnames=("grid",))
def step(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    obstacles=None,
) -> nb.BinnedState:
    """One WCSPH step in binned space, with conditional amortised rebin."""
    b = maybe_rebin(grid, b)
    if any(grid.periodic):
        b = nb.wrap_ghosts(grid, b)

    rho = _density(params, grid, b)
    prs = eos.tait_pressure(params, rho)
    b = replace(b, density=rho, pressure=prs)

    acc, xsph = _forces(params, grid, b)
    acc = acc + params.gravity
    if any(grid.periodic):
        order = grid.axis_order or tuple(range(grid.dim))
        wall_axes = tuple(
            not grid.periodic[order.index(sa)] for sa in range(grid.dim)
        )
    else:
        wall_axes = None
    acc = acc + boundary_accel(params, b.pos, b.vel, wall_axes)
    if obstacles is not None:
        from sph_pie_tpu.scenes import obstacles as obs_lib

        acc = acc + obs_lib.accel(obstacles, b.pos, b.vel, b.sim_time)

    move = (b.valid & ~nb.frozen_mask(grid, b))[:, None]
    vel = jnp.where(move, b.vel + params.dt * acc, 0.0)
    vel = clamp_speed(params, vel)
    vel_adv = vel + params.xsph_eps * xsph
    vel_adv = jnp.where(move, vel_adv, 0.0)
    pos = jnp.where(move, b.pos + params.dt * vel_adv, b.pos)

    # Hard per-step displacement bound for the Verlet-skin guarantee.
    step_disp = params.dt * jnp.sqrt(
        jnp.maximum(jnp.max(jnp.sum(vel_adv * vel_adv, axis=-1)), 0.0)
    )
    return replace(
        b,
        pos=pos,
        vel=vel,
        travel=b.travel + step_disp,
        sim_time=b.sim_time + params.dt,
    )


@partial(jax.jit, static_argnames=("grid",))
def simulate(params, grid, b, n_steps, obstacles=None) -> nb.BinnedState:
    """Roll ``n_steps`` steps on-device. ``n_steps`` is a dynamic scalar so
    different horizons share one compilation."""
    return lax.fori_loop(
        0,
        jnp.asarray(n_steps, jnp.int32),
        lambda _, s: step(params, grid, s, obstacles),
        b,
    )
