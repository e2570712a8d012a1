"""Load-balanced spatial decomposition (BASELINE config #5: "ppermute halo
exchange + load-balanced resort").

The equal-cells split of parallel/halo.py starves devices on non-uniform
scenes: with the gravity axis leading, settled fluid is a contiguous
prefix of cell ids, so the first shard holds nearly every particle. Here
the split points are chosen from the actual per-cell particle counts:

  * device d owns the contiguous cell range [starts[d], starts[d]+counts[d])
    chosen greedily to even out PARTICLES, subject to a per-device cell
    budget ``c_cap`` (without the budget, the empty region would all land
    on one device and local arrays would have to be nearly global-sized;
    with c_cap = 2*C/n the empty cells spread over several devices and a
    settled dam break balances to ~1.0x — see tests/test_balance.py);
  * every device stores a fixed [(c_cap + halo_cells)*cap] padded slot
    slab (static shapes; padding rows have mass 0 so the fold's
    empty-block skip makes them nearly free);
  * halos ride explicit jax.lax.ppermute: the hi halo is the right
    neighbor's first rows, written right after this device's last valid
    row; the lo halo is the LAST VALID rows of the left neighbor — both
    at dynamic offsets from the device's own count (shard_map gives each
    device its scalar metadata);
  * ``rebalance_splits`` re-derives split points from current counts — the
    "resort" — whenever max/mean device load drifts past a threshold
    (piggybacks on the global rebin cadence, where particles move anyway).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from sph_pie_tpu.kernels import eos
from sph_pie_tpu.neighbors import binned as nb
from sph_pie_tpu.solvers import wcsph_binned
from sph_pie_tpu.solvers.wcsph import boundary_accel, clamp_speed
from sph_pie_tpu.utils.struct import replace


def cell_counts(grid: nb.BinnedGrid, b: nb.BinnedState) -> jax.Array:
    """Particles per cell, [num_cells] int32."""
    return jnp.sum(
        b.valid.reshape(grid.num_cells, grid.cap).astype(jnp.int32), axis=1
    )


def balanced_splits(counts: np.ndarray, n_dev: int, c_cap: int) -> np.ndarray:
    """Minimax particle-balanced contiguous splits under a cell budget.

    Binary-searches the smallest max-per-device particle load L such that
    the cells can be covered by <= n_dev contiguous segments, each holding
    <= L particles and <= c_cap cells (the classic painters-partition
    problem with an extra width constraint). Returns ``starts`` [n_dev+1];
    device d owns cells [starts[d], starts[d+1]).

    Note the contiguity + c_cap tradeoff: with extreme skew (all particles
    in a small prefix) only the first k = n_dev - ceil(empty/c_cap) devices
    can hold fluid, bounding the balance factor at n_dev/k. Larger c_cap
    buys balance with per-device memory.
    """
    counts = np.asarray(counts, np.int64)
    C = counts.shape[0]
    if n_dev * c_cap < C:
        raise ValueError(f"c_cap {c_cap} too small: {n_dev} devices cannot cover {C} cells")
    prefix = np.concatenate([[0], np.cumsum(counts)])

    def segments_for(L):
        """Greedy maximal segments; returns cut list or None if > n_dev."""
        cuts = [0]
        while cuts[-1] < C:
            if len(cuts) > n_dev:
                return None
            s = cuts[-1]
            # furthest end with load <= L ...
            e_load = int(np.searchsorted(prefix, prefix[s] + L, side="right")) - 1
            # ... and width <= c_cap, and leave the tail coverable
            e = min(max(e_load, s + 1), s + c_cap, C)
            remaining_devs = n_dev - len(cuts)
            e = max(e, C - remaining_devs * c_cap)
            if e > s + c_cap or (e_load < e and prefix[e] - prefix[s] > L):
                return None  # tail-coverage forces an overweight/overwide segment
            cuts.append(e)
        return cuts

    lo, hi = int(counts.max(initial=0)), int(prefix[-1])
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        seg = segments_for(mid)
        if seg is not None:
            best = seg
            hi = mid - 1
        else:
            lo = mid + 1
    if best is None:
        best = segments_for(int(prefix[-1]))
    # pad with empty trailing devices if fewer segments were needed
    while len(best) < n_dev + 1:
        best.append(C)
    return np.asarray(best, np.int64)


def balance_factor(counts: np.ndarray, starts: np.ndarray) -> float:
    """max device particles / mean device particles (1.0 = perfect)."""
    loads = [
        counts[starts[d] : starts[d + 1]].sum() for d in range(len(starts) - 1)
    ]
    mean = max(np.mean(loads), 1e-9)
    return float(np.max(loads) / mean)


def rebalance_splits(
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    n_dev: int,
    c_cap: int,
    current: np.ndarray | None = None,
    threshold: float = 1.25,
):
    """The resort decision: new splits when imbalance exceeds threshold."""
    counts = np.asarray(jax.device_get(cell_counts(grid, b)))
    if current is not None and balance_factor(counts, current) <= threshold:
        return current, balance_factor(counts, current), False
    fresh = balanced_splits(counts, n_dev, c_cap)
    return fresh, balance_factor(counts, fresh), True


# ---------------------------------------------------------------------------
# distribution to / collection from padded per-device slabs
# ---------------------------------------------------------------------------


def distribute(grid: nb.BinnedGrid, x: jax.Array, starts, c_cap: int) -> jax.Array:
    """Global flat [S, ...] -> stacked padded [n_dev, c_cap*cap, ...]."""
    cap = grid.cap
    n_dev = len(starts) - 1
    S = grid.num_slots
    pad = jnp.zeros((c_cap * cap,) + x.shape[1:], x.dtype)
    xp = jnp.concatenate([x, pad])  # so the tail slice is always in range

    def one(d):
        s = int(starts[d])
        return lax.dynamic_slice_in_dim(xp, s * cap, c_cap * cap, axis=0)

    out = jnp.stack([one(d) for d in range(n_dev)])
    # zero the padding rows past each device's count (avoid duplicated data)
    rows = jnp.arange(c_cap * cap)
    n_rows = (
        jnp.asarray([int(starts[d + 1] - starts[d]) for d in range(n_dev)])[:, None]
        * cap
    )
    mask = rows[None, :] < n_rows
    return jnp.where(mask.reshape(mask.shape + (1,) * (x.ndim - 1)), out, 0)


def collect(grid: nb.BinnedGrid, stacked: jax.Array, starts) -> jax.Array:
    """Inverse of distribute: stacked padded slabs -> global flat [S, ...]."""
    cap = grid.cap
    n_dev = stacked.shape[0]
    S = grid.num_slots
    out = jnp.zeros((S + stacked.shape[1],) + stacked.shape[2:], stacked.dtype)
    for d in range(n_dev):
        n_rows = int(starts[d + 1] - starts[d]) * cap
        out = lax.dynamic_update_slice_in_dim(
            out,
            stacked[d, :n_rows] if n_rows else stacked[d, :0],
            int(starts[d]) * cap,
            axis=0,
        )
    return out[:S]


# ---------------------------------------------------------------------------
# the balanced halo step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BalancedState:
    """Per-device padded slabs + split metadata for one decomposition."""

    fields: dict  # name -> [n_dev, slab_cells*cap, ...]
    starts: np.ndarray
    travel: jax.Array
    sim_time: jax.Array = 0.0  # drives moving obstacles


def make_balanced_step(mesh: Mesh, params, grid: nb.BinnedGrid, c_cap: int, obstacles=None):
    """WCSPH step over particle-balanced shards with ppermute halos.

    Returns (init_fn, step_fn, finish_fn):
      init_fn(b, starts)   -> BalancedState
      step_fn(bs)          -> BalancedState (one step, jit-compiled)
      finish_fn(bs, b)     -> BinnedState with updated pos/vel/density/...
    """
    axis = mesh.axis_names[0]
    n = mesh.devices.size
    cap = grid.cap
    halo_rows = nb.halo_cells(grid) * cap
    # Local slabs hold up to c_cap owned cells plus room for the right
    # neighbor's first halo cells, which are placed right after the owned
    # ones (see ``place_hi``).
    slab_cells = c_cap + nb.halo_cells(grid)
    grid_local = dataclasses.replace(
        grid, symmetric_fold=False  # window write-back can't cross shards
    )
    from sph_pie_tpu.scenes import obstacles as obs_lib

    FIELD_NAMES = ("pos", "vel", "mass", "valid")

    # Periodic axes compose with the balanced split (the r05 dryrun leg):
    # walls are masked off periodic axes exactly like the single-device
    # engine (solvers/wcsph_binned.py step), and the ghost-border planes
    # are refreshed per step on the COLLECTED global layout before
    # redistribution (step_fn below). On real chips that wrap is a ring
    # ppermute of edge planes between the first and last shards; the
    # dry-run composition reuses the reference wrap so parity against the
    # single-device periodic engine is exact by construction.
    periodic = any(grid.periodic)
    if periodic:
        order = grid.axis_order or tuple(range(grid.dim))
        wall_axes = tuple(
            not grid.periodic[order.index(sa)] for sa in range(grid.dim)
        )
    else:
        wall_axes = None

    def init_fn(b: nb.BinnedState, starts) -> BalancedState:
        # A halo comes from ONE neighbor, so every segment before the
        # last non-empty one must be at least a halo wide.
        widths = np.diff(np.asarray(starts))
        last = int(np.nonzero(widths)[0].max(initial=0))
        if (widths[:last] < nb.halo_cells(grid)).any():
            raise ValueError(
                f"segment widths {widths.tolist()} thinner than the "
                f"{nb.halo_cells(grid)}-cell halo; use fewer devices"
            )
        fields = {
            k: distribute(grid, getattr(b, k), starts, slab_cells)
            for k in FIELD_NAMES
        }
        return BalancedState(
            fields=fields,
            starts=np.asarray(starts),
            travel=b.travel,
            sim_time=b.sim_time,
        )

    def local(pos, vel, mass, valid, n_rows, travel, sim_time):
        pos, vel, mass, valid = pos[0], vel[0], mass[0], valid[0]
        n_rows = n_rows[0]
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i + 1, i) for i in range(n - 1)]

        def place_hi(arrays: dict) -> dict:
            """Write the right neighbor's first halo rows right after my
            LAST VALID row: my last cells' neighbor windows reach there.
            (The fold's own hi halo sits past the whole slab, which only
            an exactly full slab would reach.)"""
            out = {}
            for k, x in arrays.items():
                hi = lax.ppermute(x[:halo_rows], axis, bwd)
                out[k] = lax.dynamic_update_slice_in_dim(x, hi, n_rows, axis=0)
            return out

        def lo_halo(fields: dict):
            """(lo, zero hi) halos for the fold: lo for my right neighbor
            is my LAST VALID rows."""
            lo = {}
            for k, x in fields.items():
                edge_hi = lax.dynamic_slice_in_dim(
                    x, jnp.maximum(n_rows - halo_rows, 0), halo_rows, axis=0
                )
                lo[k] = lax.ppermute(edge_hi, axis, fwd)
            return lo, jax.tree.map(jnp.zeros_like, lo)

        a = place_hi({"pos": pos, "mass": mass})
        dens_fields = {**wcsph_binned._planar("p", a["pos"]), "mass": a["mass"]}
        rho = wcsph_binned._density(
            params,
            grid_local,
            wcsph_binned_local_view(a["pos"], vel, a["mass"]),
            halo=lo_halo(dens_fields),
            local_cells=slab_cells,
        )
        prs = eos.tait_pressure(params, rho)

        a = place_hi(
            {"pos": pos, "vel": vel, "mass": mass, "rho": rho, "prs": prs}
        )
        inv_rho = 1.0 / a["rho"]
        force_fields = {
            **wcsph_binned._planar("p", a["pos"]),
            **wcsph_binned._planar("v", a["vel"]),
            "mass": a["mass"],
            "pr2": a["prs"] * inv_rho * inv_rho,
            "m_rho": a["mass"] * inv_rho,
            "inv_rho": inv_rho,
        }
        acc, xsph = wcsph_binned._forces(
            params,
            grid_local,
            wcsph_binned_local_view(
                a["pos"], a["vel"], a["mass"], a["rho"], a["prs"]
            ),
            halo=lo_halo(force_fields),
            local_cells=slab_cells,
        )

        acc = acc + params.gravity + boundary_accel(params, pos, vel, wall_axes)
        if obstacles is not None:
            acc = acc + obs_lib.accel(obstacles, pos, vel, sim_time)

        vmask = valid[:, None]
        new_vel = jnp.where(vmask, vel + params.dt * acc, 0.0)
        new_vel = clamp_speed(params, new_vel)
        vel_adv = jnp.where(vmask, new_vel + params.xsph_eps * xsph, 0.0)
        new_pos = jnp.where(vmask, pos + params.dt * vel_adv, pos)

        disp2 = jnp.max(jnp.sum(vel_adv * vel_adv, axis=-1))
        disp = params.dt * jnp.sqrt(jnp.maximum(disp2, 0.0))
        disp = lax.pmax(disp, axis)
        return new_pos[None], new_vel[None], rho[None], prs[None], travel + disp

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P()),
    )
    sharded = jax.jit(sharded)

    def step_fn(bs: BalancedState) -> BalancedState:
        n_rows = jnp.asarray(
            [int(bs.starts[d + 1] - bs.starts[d]) * cap for d in range(n)],
            jnp.int32,
        )
        in_fields = bs.fields
        if periodic:
            glob = {
                k: collect(grid, in_fields[k], bs.starts)
                for k in FIELD_NAMES
            }
            glob = nb.wrap_ghost_fields(grid, glob, offset_fields=("pos",))
            in_fields = dict(
                in_fields,
                **{
                    k: distribute(grid, v, bs.starts, slab_cells)
                    for k, v in glob.items()
                },
            )
        pos, vel, rho, prs, travel = sharded(
            in_fields["pos"],
            in_fields["vel"],
            in_fields["mass"],
            in_fields["valid"],
            n_rows,
            bs.travel,
            bs.sim_time,
        )
        fields = dict(bs.fields, pos=pos, vel=vel, density=rho, pressure=prs)
        return BalancedState(
            fields=fields,
            starts=bs.starts,
            travel=travel,
            sim_time=bs.sim_time + params.dt,
        )

    def finish_fn(bs: BalancedState, b: nb.BinnedState) -> nb.BinnedState:
        out = {}
        for k in ("pos", "vel", "density", "pressure"):
            if k in bs.fields:
                out[k] = collect(grid, bs.fields[k], bs.starts)
        return replace(b, travel=bs.travel, sim_time=bs.sim_time, **out)

    return init_fn, step_fn, finish_fn


def wcsph_binned_local_view(pos, vel, mass, density=None, pressure=None):
    from sph_pie_tpu.parallel.halo import _LocalView

    return _LocalView(pos=pos, vel=vel, mass=mass, density=density, pressure=pressure)
