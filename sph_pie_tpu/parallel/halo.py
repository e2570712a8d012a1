"""Explicit shard_map + ppermute halo exchange.

The GSPMD path (parallel/sharding.py) lets XLA infer the collectives; this
module spells them out, which is the BASELINE-named mechanism ("spatially
shards the domain with halo exchange via jax.lax.ppermute") and
gives the compiler no freedom to choose worse ones:

  * slot arrays are split into contiguous slabs of cells per device
    (1-D spatial decomposition along the grid's leading axis);
  * each step, every device ppermutes its edge rows (halo_cells * cap
    slots per side) to its lattice neighbors — boundary shards receive
    zeros, which is exactly the zero-padding the single-device fold uses;
  * density/force folds run on the local slab with the received halos;
  * integration is local; the Verlet-travel bound is a pmax.

The amortised rebin stays outside shard_map (it is a global counting sort
— run under the partitioner as in sharding.py); between rebins no particle
changes cells, so the decomposition is static and only halos move between
devices (collectives that XLA hands to NCCL on GPUs).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from sph_pie_tpu.kernels import eos
from sph_pie_tpu.neighbors import binned as nb
from sph_pie_tpu.solvers import wcsph_binned
from sph_pie_tpu.solvers.wcsph import boundary_accel, clamp_speed
from sph_pie_tpu.utils.struct import replace


@dataclasses.dataclass
class _LocalView:
    """Duck-typed stand-in for BinnedState inside the shard: the folds only
    touch these fields."""

    pos: jax.Array
    vel: jax.Array
    mass: jax.Array
    density: jax.Array = None
    pressure: jax.Array = None


def _exchange(axis: str, n: int, rows: int, x: jax.Array):
    """(halo_lo, halo_hi) for a [S_local, ...] array: lo comes from the left
    neighbor's last rows, hi from the right neighbor's first rows; lattice
    edges receive zeros (ppermute zero-fills unmatched destinations)."""
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    lo = lax.ppermute(x[-rows:], axis, fwd)
    hi = lax.ppermute(x[:rows], axis, bwd)
    return lo, hi


def _exchange_fields(axis, n, rows, fields: dict):
    lo, hi = {}, {}
    for k, v in fields.items():
        lo[k], hi[k] = _exchange(axis, n, rows, v)
    return lo, hi


def make_halo_step(mesh: Mesh, params, grid: nb.BinnedGrid, obstacles=None):
    """jit-compiled WCSPH step whose neighbor halos ride explicit ppermutes.

    Requires grid.num_cells divisible by the mesh size (contiguous equal
    slabs of cells per device).
    """
    axis = mesh.axis_names[0]
    n = mesh.devices.size
    C = grid.num_cells
    if C % n:
        raise ValueError(f"num_cells {C} not divisible by {n} devices")
    c_loc = C // n
    halo_rows = nb.halo_cells(grid) * grid.cap
    if halo_rows > c_loc * grid.cap:
        raise ValueError("shard thinner than its halo; use fewer devices")
    from sph_pie_tpu.scenes import obstacles as obs_lib

    # Periodic axes (VERDICT r02 #7): the ghost-border planes are filled
    # by the same global ``wrap_ghosts`` as the single-device engine,
    # called OUTSIDE shard_map — under jit+GSPMD the leading-axis plane
    # copy lowers to exactly the wrap-around collective permute the ring
    # needs (device 0's low ghost plane comes from the high interior edge
    # living on device n-1, positions offset by -L), while non-leading
    # axes stay local slices. The ppermute edge halos keep zero-filling
    # past the lattice ends, which only ghost-plane home cells read —
    # identical semantics to the single-device fold's zero padding. Wall
    # forces are masked off periodic axes like the single-device step.
    periodic = any(grid.periodic)
    if periodic:
        order = grid.axis_order or tuple(range(grid.dim))
        wall_axes = tuple(
            not grid.periodic[order.index(sa)] for sa in range(grid.dim)
        )
    else:
        wall_axes = None

    def local(pos, vel, mass, valid, travel, sim_time):
        dim = pos.shape[1]
        v = _LocalView(pos=pos, vel=vel, mass=mass)

        # density
        dens_fields = {
            **wcsph_binned._planar("p", pos), "mass": mass,
        }
        halo = _exchange_fields(axis, n, halo_rows, dens_fields)
        rho = wcsph_binned._density(params, grid, v, halo=halo, local_cells=c_loc)
        prs = eos.tait_pressure(params, rho)
        v = _LocalView(pos=pos, vel=vel, mass=mass, density=rho, pressure=prs)

        # forces (exchange the derived per-slot fields too)
        inv_rho = 1.0 / rho
        force_fields = {
            **wcsph_binned._planar("p", pos),
            **wcsph_binned._planar("v", vel),
            "mass": mass,
            "pr2": prs * inv_rho * inv_rho,
            "m_rho": mass * inv_rho,
            "inv_rho": inv_rho,
        }
        halo = _exchange_fields(axis, n, halo_rows, force_fields)
        acc, xsph = wcsph_binned._forces(
            params, grid, v, halo=halo, local_cells=c_loc
        )

        acc = acc + params.gravity + boundary_accel(params, pos, vel, wall_axes)
        if obstacles is not None:
            acc = acc + obs_lib.accel(obstacles, pos, vel, sim_time)

        vmask = valid[:, None]
        new_vel = jnp.where(vmask, vel + params.dt * acc, 0.0)
        new_vel = clamp_speed(params, new_vel)
        vel_adv = new_vel + params.xsph_eps * xsph
        new_pos = jnp.where(vmask, pos + params.dt * vel_adv, pos)

        disp2 = jnp.max(jnp.sum(vel_adv * vel_adv, axis=-1))
        disp = params.dt * jnp.sqrt(jnp.maximum(disp2, 0.0))
        disp = lax.pmax(disp, axis)
        return new_pos, new_vel, rho, prs, travel + disp

    sharded_local = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P()),
    )

    def step(b: nb.BinnedState) -> nb.BinnedState:
        b = lax.cond(
            b.travel > 0.5 * grid.skin,
            lambda x: nb.rebin(grid, x),
            lambda x: x,
            b,
        )
        if periodic:
            b = nb.wrap_ghosts(grid, b)
        pos, vel, rho, prs, travel = sharded_local(
            b.pos, b.vel, b.mass, b.valid, b.travel, b.sim_time
        )
        return replace(
            b,
            pos=pos,
            vel=vel,
            density=rho,
            pressure=prs,
            travel=travel,
            sim_time=b.sim_time + params.dt,
        )

    slot = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def spec_like(b):
        return jax.tree.map(
            lambda x: slot if x.ndim >= 1 and x.shape[0] == grid.num_slots else rep,
            b,
        )

    def run(b, n_steps):
        fn = jax.jit(
            lambda bb, k: lax.fori_loop(
                0, jnp.asarray(k, jnp.int32), lambda _, s: step(s), bb
            ),
            in_shardings=(spec_like(b), rep),
            out_shardings=spec_like(b),
        )
        return fn(b, n_steps)

    return step, run
