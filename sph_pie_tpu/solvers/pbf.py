"""Position-Based Fluids (Macklin & Mueller 2013) on the binned layout.

BASELINE config #4: incompressible PBF solver. The constraint loop runs a
fixed number of Jacobi iterations (static — jit/fori friendly):

  predict x* from external forces
  repeat iters times:
      rho_i, sum-of-gradients  ->  lambda_i = -C_i / (sum|grad|^2 + eps)
      dx_i = (1/rho0) sum_j (lambda_i + lambda_j + s_corr) gradW_ij
  v = (x* - x)/dt ; optional XSPH smoothing ; x = x*

Uses the same gather-free slab-window machinery as WCSPH
(``neighbors/binned.py``). An artificial-pressure term (s_corr, the
"tensile instability" fix from the paper) provides surface cohesion.

The CPU mirror for testing lives in ``tests/test_pbf.py``'s PbfOracle.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from sph_pie_tpu.core.params import FluidParams
from sph_pie_tpu.kernels import smoothing
from sph_pie_tpu.neighbors import binned as nb
from sph_pie_tpu.solvers.wcsph import boundary_accel, clamp_speed
from sph_pie_tpu.solvers.wcsph_binned import _planar, _r2, maybe_rebin
from sph_pie_tpu.utils.struct import pytree_dataclass, replace


@pytree_dataclass
class _DensView:
    """Duck-typed view for wcsph_binned._density (pos/mass/valid only)."""

    pos: jax.Array
    mass: jax.Array
    valid: jax.Array


@pytree_dataclass(
    meta_fields=("iters", "use_vorticity", "s_corr_n", "epilogue")
)
class PbfParams:
    """PBF solver knobs; FluidParams supplies h/dt/rho0/bounds/gravity."""

    iters: int                  # constraint iterations (static)
    epilogue: str               # how step-start positions + previous-step
                                # density reach the final fold (static;
                                # identical physics, different data
                                # movement):
                                # "gather" = compact owner-indexed stashes
                                #   + light mid-step rebins; recovery is
                                #   4 [S]<-[K] owner gathers (S ~ 8.4x K
                                #   at the 1M flagship).
                                # "ride" = step-start positions ride the
                                #   (otherwise dead) vel payload and the
                                #   density column rides rebins
                                #   (carry_density): zero owner gathers,
                                #   mid-step rebins carry 4 extra sort
                                #   operands + scatters.
    use_vorticity: bool         # static: False compiles the two extra
                                # vorticity folds away entirely
    relax_eps: jax.Array        # CFM epsilon in lambda denominator
    s_corr_k: jax.Array         # artificial pressure strength
    s_corr_n: int               # artificial pressure exponent (4 typical).
                                # STATIC int: lax.integer_pow in the dx
                                # fold instead of a per-pair pow()
                                # transcendental (a traced exponent cost
                                # ~25% of the fold)
    s_corr_dq: jax.Array        # reference distance as a fraction of h
    vort_eps: jax.Array         # vorticity-confinement strength epsilon
    sor: jax.Array              # under-relaxation of the Jacobi projection
                                # (1.0 = raw; ~0.5 kills the overshoot
                                # jitter of simultaneous corrections)
    proj_cap_h: jax.Array       # per-iteration projection cap as a
                                # fraction of the smoothing length h — a
                                # PHYSICAL knob, deliberately decoupled
                                # from the grid skin so quality
                                # calibrations survive grid-geometry
                                # sweeps (the applied cap is
                                # min(proj_cap_h*h, skin/2); the skin/2
                                # clamp preserves the bin-epoch
                                # bookkeeping). Correctness never depends
                                # on it (maybe_rebin fires lazily on TRUE
                                # drift either way); it controls the
                                # rebin FIRE RATE. 1M dam break at skin
                                # 0.25h: 0.125 -> 4.0 rebins/step,
                                #          rho_p99 1.127 rho0
                                # 0.0625 -> 1.6/step, p99 1.080
                                # 1/24 -> 1.0/step, p99 1.067
                                # Tighter caps IMPROVE density error
                                # (huge Jacobi projections overshoot)
                                # but SLOW violent transients. Sweep of
                                # the 2D column-collapse spread at 500
                                # steps vs the 1.5h quality bar
                                # (tests/test_pbf
                                # test_pbf_column_collapses), iters=3:
                                # 0.125 -> 1.58h, 0.094 -> 2.49h,
                                # 0.075 -> 1.55h, 0.0625 -> 1.33h FAIL,
                                # 1/24 -> 1.38h FAIL. Default 0.075 = the
                                # tightest sweep point passing the bar;
                                # at the flagship (iters=2, sor=0.9)
                                # 0.0625 passes every bar (see
                                # flagship_params).


def make_pbf_params(
    iters: int = 4,
    relax_eps: float = 100.0,
    s_corr_k: float = 0.1,
    s_corr_n: int = 4,
    s_corr_dq: float = 0.3,
    vort_eps: float = 0.0,
    sor: float = 0.8,
    proj_cap_h: float = 0.075,
    epilogue: str = "gather",
    dtype=jnp.float32,
) -> PbfParams:
    """``s_corr_k`` is h-relative: the effective artificial-pressure
    coefficient is s_corr_k * h^2 (lambda carries length^2 units, so the
    anti-clustering term must scale with h^2 to stay resolution-neutral).

    ``vort_eps`` > 0 enables vorticity confinement (Macklin & Mueller 2013
    section 5): f = eps * (N x omega), N the normalised gradient of
    |omega| — re-injects the rotational energy the Jacobi projection damps
    (visible as livelier swirls)."""
    f = lambda v: jnp.asarray(v, dtype)
    return PbfParams(
        iters=int(iters),
        use_vorticity=bool(vort_eps > 0.0),
        relax_eps=f(relax_eps),
        s_corr_k=f(s_corr_k),
        s_corr_n=int(s_corr_n),
        s_corr_dq=f(s_corr_dq),
        vort_eps=f(vort_eps),
        sor=f(sor),
        proj_cap_h=f(proj_cap_h),
        epilogue=str(epilogue),
    )


def flagship_params(**overrides) -> PbfParams:
    """The benchmark/flagship PBF configuration (BASELINE config #4) —
    ONE definition shared by bench.py, chip_smoke.py, and the quality
    tests that gate it (tests/test_pbf.py).

    Calibration: two Jacobi iterations at sor 0.9 pass every calibrated
    physics bar (2D collapse spread > 1.5h, vmax < 10, rho_q90 < 1.15 —
    in fact the earlier iters=3/sor=0.8 FAILED the vmax bar at 11.9 while
    this config reads 8.2), with one fewer lambda+dx fold pair and ~0.4
    fewer rebins/step. Cap sweep at iters=2 (proj_cap_h in h units, at
    skin 0.25h): 0.0625 beats 0.075 on rebins (1.0 vs 1.4 per step) and
    quality (1M rho_max 1.19 vs 1.31; 2D bars all green, rho_q90 1.025 vs
    1.046); 0.05 fails the 2D vmax bar. NOTE: at iters=3 cap 0.0625 had
    FAILED the spread bar — cap quality is coupled to (iters, sor), so
    re-run the sweep when touching any of the three.

    epilogue="ride" was chosen on the previous machine, where the 4
    [S]<-[K] owner gathers (S ~ 8.4x K) cost more than the extra rebin
    sort operands; the GPU A/B is not measured yet. Physics-equal to 1e-6
    incl. periodic seams
    (tests/test_pbf.py::test_pbf_epilogue_ride_matches_gather)."""
    cfg = dict(iters=2, sor=0.9, proj_cap_h=0.0625, epilogue="ride")
    cfg.update(overrides)
    return make_pbf_params(**cfg)


def _lambda_fold(params: FluidParams, pbf: PbfParams, grid, fields):
    """Per-particle lambda from one slab fold over predicted positions.

    Pair-math diet (round 3 — mirrors the WCSPH fold's discipline): no
    per-pair divide (rsqrt + multiply replaces /r), no masks (the kernel
    cutoffs zero far pairs, d == 0 zeroes the self pair, empty slots
    carry mass 0), and the 1/rho0 scaling is applied once in the O(S)
    epilogue instead of per pair — the CPU oracle uses the identical
    epilogue placement (oracle.py PbfOracle._lambda/_dx)."""
    dim, h = params.dim, params.h
    tiny = jnp.asarray(1e-12, params.h.dtype)
    rho0 = params.rest_density

    def pair(carry, hm, w):
        rho, grad_sq, grad_sum = carry
        d, r2 = _r2(dim, hm, w)
        inv_r = jax.lax.rsqrt(jnp.maximum(r2, tiny))
        r = r2 * inv_r
        m_j = w["mass"][:, None, :]
        wk = smoothing.poly6(dim, h, r2)
        rho = rho + jnp.sum(m_j * wk, axis=2)  # incl. self
        gw = smoothing.spiky_grad_mag(dim, h, r) * inv_r
        coef = m_j * gw                       # grad_i W_ij * m_j (x rho0 later)
        gs = []
        for k in range(dim):
            g_k = coef * d[k]                 # [blk, cap, 3cap]
            grad_sq = grad_sq + jnp.sum(g_k * g_k, axis=2)
            gs.append(jnp.sum(g_k, axis=2))
        grad_sum = tuple(a + g for a, g in zip(grad_sum, gs))
        return (rho, grad_sq, grad_sum)

    S = grid.num_slots
    dt = fields["mass"].dtype
    zero = jnp.zeros((S,), dt)
    init = (zero, zero, tuple(zero for _ in range(dim)))
    rho, grad_sq, grad_sum = nb.slab_fold(grid, fields, pair, init)
    # |sum grad|^2 + sum |grad|^2  (the standard CFM denominator), with
    # the deferred 1/rho0^2 applied here
    inv_rho0 = 1.0 / rho0
    denom = grad_sq
    for k in range(dim):
        denom = denom + grad_sum[k] * grad_sum[k]
    denom = denom * (inv_rho0 * inv_rho0)
    # Unclamped constraint (Macklin & Mueller eq. 1): stretched regions
    # attract. Clamping C at 0 breaks the balance against the artificial
    # pressure and the fluid slowly inflates (observed).
    c = rho * inv_rho0 - 1.0
    lam = -c / (denom + pbf.relax_eps)
    return lam, rho


def _dx_fold(params: FluidParams, pbf: PbfParams, grid, fields):
    """Position corrections from lambdas.

    Same pair-math diet as ``_lambda_fold``; additionally the artificial
    pressure's ``(wk/w_dq)**n`` is a reciprocal-multiply plus a STATIC
    ``lax.integer_pow`` (s_corr_n is a static int meta field) — a traced
    exponent lowers to a per-pair pow() transcendental, the single most
    expensive op the dx fold had."""
    dim, h = params.dim, params.h
    tiny = jnp.asarray(1e-12, params.h.dtype)
    rho0 = params.rest_density
    w_dq = smoothing.poly6(dim, h, (pbf.s_corr_dq * h) ** 2)
    inv_wdq = 1.0 / w_dq
    neg_k_h2 = -(pbf.s_corr_k * h * h)

    def pair(carry, hm, w):
        d, r2 = _r2(dim, hm, w)
        inv_r = jax.lax.rsqrt(jnp.maximum(r2, tiny))
        r = r2 * inv_r
        # dx_i = sum_j (m_j/rho0) (lam_i + lam_j + s_corr) grad_i W_ij —
        # the mass factor is REQUIRED with physical masses (the unit-mass
        # paper form blows corrections up by 1/m; observed 3D explosion).
        m_j = w["mass"][:, None, :]
        wk = smoothing.poly6(dim, h, r2)
        s_corr = neg_k_h2 * (wk * inv_wdq) ** pbf.s_corr_n
        lam_sum = hm["lam"][:, :, None] + w["lam"][:, None, :] + s_corr
        gw = smoothing.spiky_grad_mag(dim, h, r) * inv_r
        coef = (m_j * lam_sum) * gw
        return tuple(
            c_k + jnp.sum(coef * d[k], axis=2) for c_k, k in zip(carry, range(dim))
        )

    S = grid.num_slots
    zero = jnp.zeros((S,), fields["mass"].dtype)
    dxs = nb.slab_fold(grid, fields, pair, tuple(zero for _ in range(dim)))
    return jnp.stack(dxs, axis=-1) * (1.0 / rho0)


def _density_xsph_fold(params: FluidParams, grid, pos, vel, mass, m_rho):
    """Fused final fold: density AND the XSPH smoothing sum in one pass.

    ``m_rho`` is the per-slot Monaghan weight m_j/rho_j with rho_j taken
    from the PREVIOUS step's final density (positions do not move between
    a step's final fold and the next step's start, so that density is
    exact at step-start positions; on a smoothing term that is itself
    O(xsph_eps) the one-substep staleness is negligible — while the
    round-3 first cut's rho_j -> rho0 substitution measurably weakened
    free-surface smoothing: 2D column-collapse spread 1.33h vs the 1.5h
    quality bar). Being a per-particle plane, the weight keeps every
    accumulator a pure window-j sum, so the XSPH pass fuses into the
    density fold instead of costing its own (one ~76 ms fold at 1M vs
    41 + 76 separate). Moment form: sum_j w_j W (v_j - v_i) =
    S1 - v_i * S0 with S0 = sum w_j W (the self term cancels exactly),
    applied in the O(S) epilogue. The CPU oracle mirrors this form and
    the staleness (oracle.py PbfOracle._rho_prev).

    Returns (rho_raw, dv) where dv is the unscaled smoothing delta."""
    dim, h = params.dim, params.h

    def pair(carry, hm, w):
        rho, s0, s1 = carry
        _, r2 = _r2(dim, hm, w)
        wk = smoothing.poly6(dim, h, r2)
        mw = w["mass"][:, None, :] * wk
        ww = w["m_rho"][:, None, :] * wk
        rho = rho + jnp.sum(mw, axis=2)
        s0 = s0 + jnp.sum(ww, axis=2)
        s1 = tuple(
            s + jnp.sum(ww * w[f"v{k}"][:, None, :], axis=2)
            for s, k in zip(s1, range(dim))
        )
        return rho, s0, s1

    fields = {
        **_planar("p", pos),
        **_planar("v", vel),
        "mass": mass,
        "m_rho": m_rho,
    }
    zero = jnp.zeros((grid.num_slots,), pos.dtype)
    rho, s0, s1 = nb.slab_fold(
        grid, fields, pair, (zero, zero, tuple(zero for _ in range(dim)))
    )
    dv = jnp.stack(s1, axis=-1) - vel * s0[:, None]
    return rho, dv


def _vorticity_fold(params: FluidParams, grid, pos, vel, mass, rho):
    """omega_i = sum_j (m/rho)_j (v_j - v_i) x grad_i W_ij.

    3D: full 3-vector curl; 2D: the scalar z-curl. grad_i W uses the spiky
    kernel like the force gradients (standard PBF choice)."""
    dim, h = params.dim, params.h
    tiny = jnp.asarray(1e-12, params.h.dtype)
    m_rho = mass / jnp.maximum(rho, 1e-6 * params.rest_density)
    n_out = 3 if dim == 3 else 1

    def pair(carry, hm, w):
        d, r2 = _r2(dim, hm, w)
        inv_r = jax.lax.rsqrt(jnp.maximum(r2, tiny))
        r = r2 * inv_r
        gw = smoothing.spiky_grad_mag(dim, h, r) * inv_r
        coef = w["m_rho"][:, None, :] * gw          # [blk, cap, 3cap]
        dv = [
            w[f"v{k}"][:, None, :] - hm[f"v{k}"][:, :, None]
            for k in range(dim)
        ]
        g = [coef * d[k] for k in range(dim)]       # grad_i W components
        if dim == 3:
            terms = (
                dv[1] * g[2] - dv[2] * g[1],
                dv[2] * g[0] - dv[0] * g[2],
                dv[0] * g[1] - dv[1] * g[0],
            )
        else:
            terms = (dv[0] * g[1] - dv[1] * g[0],)
        return tuple(c + jnp.sum(t, axis=2) for c, t in zip(carry, terms))

    fields = {
        **_planar("p", pos),
        **_planar("v", vel),
        "mass": mass,
        "m_rho": m_rho,
    }
    zero = jnp.zeros((grid.num_slots,), pos.dtype)
    out = nb.slab_fold(grid, fields, pair, tuple(zero for _ in range(n_out)))
    return jnp.stack(out, axis=-1)                  # [S, 3] or [S, 1]


def _vorticity_force(params: FluidParams, grid, pos, mass, rho, omega):
    """f = eps * (N x omega), N = normalised grad|omega| (eta).

    eta_i = sum_j (m/rho)_j |omega_j| grad_i W_ij — points toward higher
    vorticity, so the confinement force spins existing vortices up rather
    than creating rotation from nothing."""
    dim, h = params.dim, params.h
    tiny = jnp.asarray(1e-12, params.h.dtype)
    m_rho = mass / jnp.maximum(rho, 1e-6 * params.rest_density)
    wmag = jnp.sqrt(jnp.maximum(jnp.sum(omega * omega, axis=-1), 0.0))

    def pair(carry, hm, w):
        d, r2 = _r2(dim, hm, w)
        inv_r = jax.lax.rsqrt(jnp.maximum(r2, tiny))
        r = r2 * inv_r
        gw = smoothing.spiky_grad_mag(dim, h, r) * inv_r
        coef = w["m_rho"][:, None, :] * w["wmag"][:, None, :] * gw
        return tuple(
            c + jnp.sum(coef * d[k], axis=2) for c, k in zip(carry, range(dim))
        )

    fields = {
        **_planar("p", pos),
        "mass": mass,
        "m_rho": m_rho,
        "wmag": wmag,
    }
    zero = jnp.zeros((grid.num_slots,), pos.dtype)
    eta = jnp.stack(
        nb.slab_fold(grid, fields, pair, tuple(zero for _ in range(dim))),
        axis=-1,
    )
    n_hat = eta * jax.lax.rsqrt(
        jnp.maximum(jnp.sum(eta * eta, axis=-1, keepdims=True), tiny)
    )
    if dim == 3:
        f = jnp.cross(n_hat, omega)
    else:
        # omega is the scalar z-curl: (N x w zhat) = (N_y w, -N_x w)
        w_z = omega[:, 0]
        f = jnp.stack([n_hat[:, 1] * w_z, -n_hat[:, 0] * w_z], axis=-1)
    return f


@partial(jax.jit, static_argnames=("grid",))
def step(
    params: FluidParams,
    grid: nb.BinnedGrid,
    pbf: PbfParams,
    b: nb.BinnedState,
    obstacles=None,
) -> nb.BinnedState:
    """One PBF step in binned space.

    Cell-list exactness: PBF moves particles BETWEEN folds (the predict
    step and every constraint projection), so unlike WCSPH one rebin check
    per step is not enough — the round-1 implementation left projections
    unclamped and the measured true drift reached 6x the skin/2 guarantee,
    silently dropping deep-support pairs (and the apparent "collapse" was
    a projection blow-up saturating the speed clamp). This version:

      * runs ``maybe_rebin`` before EVERY fold, including between
        constraint iterations. Mid-step rebins are ``light=True`` (no
        velocity payload — the iterations read only pos/mass); step-start
        positions, needed for the final velocity update after slots
        permute, live in a compact owner-indexed stash instead.
      * under-relaxes the Jacobi projection (``pbf.sor``) — simultaneous
        neighbor corrections overshoot at full step, which is the jitter
        that round 1's dynamics hid by clamping at max_speed.
      * hard-caps a single projection at min(proj_cap_h * h, skin/2):
        besides being a safety net for the skin bookkeeping (the skin/2
        clamp), the cap size sets how many projections fit one bin epoch
        and thus the rebin FIRE RATE of the checks below (see
        PbfParams.proj_cap_h).
    """
    ride = pbf.epilogue == "ride"
    S = grid.num_slots
    if not ride:
        # Compact owner-indexed stashes, taken BEFORE the entry rebin:
        # compact gathers are invariant under rebinning (slots permute,
        # owners don't), but a fired rebin rebuilds slots with density=0,
        # so the previous step's final density must be captured first.
        safe_slot = jnp.clip(b.slot_of, 0, S - 1)
        pos0c = b.pos[safe_slot]  # [K, dim] step-start positions
        # Previous-step final density — the Monaghan XSPH weight for the
        # final fused fold (see _density_xsph_fold). Virgin particles
        # (first step, fresh emitter rows) carry density 0 ->
        # rest-density fallback.
        rho_prev_c = b.density[safe_slot]

    b = maybe_rebin(grid, b, carry_density=ride)
    periodic = any(grid.periodic)
    if periodic:
        b = nb.wrap_ghosts(grid, b)
        order = grid.axis_order or tuple(range(grid.dim))
        wall_axes = tuple(
            not grid.periodic[order.index(sa)] for sa in range(grid.dim)
        )
        wall_mask = jnp.asarray(wall_axes, b.pos.dtype)[None, :]
    else:
        wall_axes = None

    def clip_box(x):
        """Project into the AABB on WALL axes only (periodic axes drift
        freely; the bin-time fold wraps them)."""
        c = jnp.clip(x, params.bound_min, params.bound_max)
        if periodic:
            return jnp.where(wall_mask > 0, c, x)
        return c

    def fmask(bb):
        return (bb.valid & ~nb.frozen_mask(grid, bb))[:, None]

    valid = fmask(b)

    # Predict
    acc = jnp.zeros_like(b.pos) + params.gravity
    acc = acc + boundary_accel(params, b.pos, b.vel, wall_axes)
    if obstacles is not None:
        from sph_pie_tpu.scenes import obstacles as obs_lib

        acc = acc + obs_lib.accel(obstacles, b.pos, b.vel, b.sim_time)
    vel = jnp.where(valid, b.vel + params.dt * acc, 0.0)
    vel = clamp_speed(params, vel)
    x_star = jnp.where(valid, b.pos + params.dt * vel, b.pos)

    def max_norm(v):
        return jnp.sqrt(jnp.maximum(jnp.max(jnp.sum(v * v, -1)), 0.0))

    # epilogue="gather": pos0c/rho_prev_c stashed at the top of step;
    # mid-step rebins run light=True (no velocity payload to sort or
    # scatter). epilogue="ride": the otherwise-dead vel slots carry the
    # step-start positions through full, density-carrying rebins, so the
    # final fold needs no owner gathers at all.
    b = replace(
        b,
        pos=x_star,
        vel=b.pos if ride else b.vel,
        travel=b.travel + max_norm(x_star - b.pos),
    )

    proj_cap = jnp.minimum(pbf.proj_cap_h * params.h, 0.5 * grid.skin)

    def iter_body(_, bb):
        bb = maybe_rebin(grid, bb, light=not ride, carry_density=ride)
        if periodic:
            bb = nb.wrap_ghosts(grid, bb)
        v = fmask(bb)
        fields = {**_planar("p", bb.pos), "mass": bb.mass}
        lam, _ = _lambda_fold(params, pbf, grid, fields)
        fields_l = {**fields, "lam": lam}
        dx = pbf.sor * _dx_fold(params, pbf, grid, fields_l)
        n2 = jnp.sum(dx * dx, axis=-1, keepdims=True)
        n = jnp.sqrt(jnp.maximum(n2, 1e-30))
        dx = jnp.where(v, dx * jnp.minimum(1.0, proj_cap / n), 0.0)
        x = clip_box(bb.pos + dx)
        return replace(
            bb,
            pos=jnp.where(v, x, bb.pos),
            travel=bb.travel + max_norm(dx),
        )

    b = lax.fori_loop(0, pbf.iters, iter_body, b)
    b = maybe_rebin(grid, b, light=not ride, carry_density=ride)
    if periodic:
        b = nb.wrap_ghosts(grid, b)
    valid = fmask(b)
    x_star = b.pos
    if ride:
        # Step-start positions rode the vel payload; previous-step density
        # rode the density column (carry_density rebins + wrap_ghosts).
        # Ghost payloads are UNOFFSET source origins — their raw disp is
        # off by +-L, exactly what the min-image fold below corrects.
        pos0 = b.vel
        rho_prev = b.density
    else:
        # Recover per slot from the compact stashes. Ghost slots
        # (periodic) gather the UNOFFSET source origin likewise.
        K = pos0c.shape[0]
        pos0 = pos0c[jnp.clip(b.owner, 0, K - 1)]
        rho_prev = rho_prev_c[jnp.clip(b.owner, 0, K - 1)]

    # Monaghan XSPH weight plane from the previous step's density (rest
    # density for virgin rows); ghost slots inherit their source's weight.
    m_rho = b.mass / jnp.where(
        rho_prev > 0, rho_prev, params.rest_density
    )

    disp = x_star - pos0
    if periodic:
        # Minimum-image the displacement: mid-step rebins fold seam-crossing
        # x_star into the primary box (+-L) while the stashed pos0 payload
        # stays continuous, so a wrapped particle's raw displacement is off
        # by ~L — divided by dt that is a huge wrong-way velocity (clamped
        # to max_speed but still wrong). Folding d by the domain period on
        # periodic axes recovers the true physical displacement.
        order = grid.axis_order or tuple(range(grid.dim))
        lengths = [
            grid.dims[order.index(sa)] * grid.cell_size
            if grid.periodic[order.index(sa)]
            else 0.0
            for sa in range(grid.dim)
        ]
        L = jnp.asarray(lengths, disp.dtype)[None, :]
        safe_L = jnp.where(L > 0, L, 1.0)
        disp = jnp.where(L > 0, disp - L * jnp.round(disp / safe_L), disp)
    new_vel = jnp.where(valid, disp / params.dt, 0.0)
    new_vel = clamp_speed(params, new_vel)

    # Final fold (diagnostics/rendering density + XSPH weights). The
    # XSPH pass is fused in (_density_xsph_fold) so the common
    # xsph-no-vorticity config pays ONE fold for both.
    if params.use_xsph and not pbf.use_vorticity:
        rho, dv = _density_xsph_fold(
            params, grid, x_star, new_vel, b.mass, m_rho
        )
        rho = jnp.maximum(
            jnp.where(b.valid, rho, 0.0), 1e-6 * params.rest_density
        )
        new_vel = new_vel + params.xsph_eps * jnp.where(valid, dv, 0.0)
        new_vel = jnp.where(valid, clamp_speed(params, new_vel), 0.0)
    else:
        from sph_pie_tpu.solvers import wcsph_binned as _wb

        rho = _wb._density(params, grid, _DensView(x_star, b.mass, b.valid))
        rho = jnp.maximum(rho, 1e-6 * params.rest_density)

        if pbf.use_vorticity:
            # Vorticity confinement (Macklin & Mueller 2013 section 5) —
            # computed on the projected positions/velocities, applied as
            # an acceleration before XSPH so the smoothing also
            # regularises it.
            omega = _vorticity_fold(
                params, grid, x_star, new_vel, b.mass, rho
            )
            f_vort = _vorticity_force(
                params, grid, x_star, b.mass, rho, omega
            )
            new_vel = new_vel + (pbf.vort_eps * params.dt) * jnp.where(
                valid, f_vort, 0.0
            )
            new_vel = jnp.where(valid, clamp_speed(params, new_vel), 0.0)

        if params.use_xsph:
            # Post-vorticity smoothing: same fused fold, rho recomputed
            # for free inside it (the vorticity folds needed rho first,
            # so there is no single-fold schedule here).
            _, dv = _density_xsph_fold(
                params, grid, x_star, new_vel, b.mass, m_rho
            )
            new_vel = new_vel + params.xsph_eps * jnp.where(valid, dv, 0.0)
            new_vel = jnp.where(valid, clamp_speed(params, new_vel), 0.0)

    return replace(
        b, vel=new_vel, density=rho, sim_time=b.sim_time + params.dt
    )


@partial(jax.jit, static_argnames=("grid",))
def simulate(params, grid, pbf, b, n_steps, obstacles=None) -> nb.BinnedState:
    return lax.fori_loop(
        0,
        jnp.asarray(n_steps, jnp.int32),
        lambda _, s: step(params, grid, pbf, s, obstacles),
        b,
    )


@partial(jax.jit, static_argnames=("grid",))
def simulate_rendered(params, grid, pbf, b, n_steps):
    """``simulate`` with the on-device splat render inside the loop, every
    step (BASELINE config #4: "PBF/PCISPH 1M w/ on-device splat render"):
    a 256x256 uint8 frame viewed along y.

    Returns (state, last frame [uint8], checksum over every frame's
    pixels); the checksum consumes each step's frame so the render cannot
    be compiled away."""
    from sph_pie_tpu.render import splat as splat_lib

    def render(bb):
        return splat_lib.render_binned_u8(grid, bb, (256, 256), axis=1, gain=50.0)

    def body(_, carry):
        bb, _, checksum = carry
        bb = step(params, grid, pbf, bb)
        frame = render(bb)
        return bb, frame, checksum + jnp.sum(frame.astype(jnp.uint32))

    frame0 = jnp.zeros(jax.eval_shape(render, b).shape, jnp.uint8)
    return lax.fori_loop(
        0,
        jnp.asarray(n_steps, jnp.int32),
        body,
        (b, frame0, jnp.zeros((), jnp.uint32)),
    )
