"""Multi-chip spatial domain decomposition.

The reference has no distributed layer at all (SURVEY.md §5 — its only
"fan-out" is a browser BroadcastChannel, `public/app.js:1884-2006`); the
BASELINE contract supplies the real requirement: spatially-sharded multi-
device runs with halo exchange (XLA lowers the collectives to NCCL over
NVLink on GPUs).

Design: the binned slot arrays (``neighbors/binned.py``) are
sharded along the leading cell axis of the grid — contiguous slabs of
cells per device, i.e. a 1-D spatial domain decomposition. Because the
whole step is expressed as static slices and dense arithmetic over that
axis, ``jit`` + GSPMD lowers the slab-window halos into exact
collective-permutes automatically — the idiomatic JAX way (annotate
shardings, let XLA insert the collectives). The amortised rebin (argsort) becomes a
distributed sort under the same partitioner.

``shard_map``-level manual ppermute halo exchange is a later optimisation;
correctness and the sharding contract live here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sph_pie_tpu.core.params import FluidParams
from sph_pie_tpu.neighbors import binned as nb
from sph_pie_tpu.solvers import wcsph_binned

SPATIAL_AXIS = "x"


def make_mesh(n_devices: int | None = None, axis: str = SPATIAL_AXIS) -> Mesh:
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, only {len(devs)} available")
    return Mesh(devs[:n], (axis,))


def slot_sharding(mesh: Mesh, axis: str = SPATIAL_AXIS) -> NamedSharding:
    """Sharding for flat [S, ...] slot arrays: split the slot axis.

    Slots are cell-major, so equal slot chunks are contiguous slabs of
    cells — a spatial decomposition along the grid's leading axis.
    """
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_binned(
    mesh: Mesh, grid: nb.BinnedGrid, b: nb.BinnedState, axis: str = SPATIAL_AXIS
) -> nb.BinnedState:
    """Place a BinnedState onto the mesh (slot arrays split, scalars replicated)."""
    slot = slot_sharding(mesh, axis)
    rep = replicated(mesh)

    def place(x):
        sh = slot if x.ndim >= 1 and x.shape[0] == grid.num_slots else rep
        return jax.device_put(x, sh)

    return jax.tree.map(place, b)


def sharded_step(mesh: Mesh, params: FluidParams, grid: nb.BinnedGrid, axis: str = SPATIAL_AXIS):
    """jit-compiled WCSPH step with spatial in/out shardings pinned."""
    import dataclasses

    # The symmetric fold's window write-back (scan-carried
    # dynamic_update_slice across shard boundaries) does not partition
    # well under GSPMD; sharded paths keep the one-sided fold.
    grid = dataclasses.replace(grid, symmetric_fold=False)
    slot = slot_sharding(mesh, axis)
    rep = replicated(mesh)

    def spec_like(b: nb.BinnedState):
        return jax.tree.map(
            lambda x: slot if x.ndim >= 1 and x.shape[0] == grid.num_slots else rep,
            b,
        )

    def run(b: nb.BinnedState) -> nb.BinnedState:
        return wcsph_binned.step(params, grid, b)

    def wrapped(b: nb.BinnedState) -> nb.BinnedState:
        sharded = jax.jit(
            run, in_shardings=(spec_like(b),), out_shardings=spec_like(b)
        )
        return sharded(b)

    return wrapped


def sharded_simulate(mesh: Mesh, params, grid, axis: str = SPATIAL_AXIS):
    """n-step roll with pinned shardings (fori_loop keeps layout stable)."""
    import dataclasses

    grid = dataclasses.replace(grid, symmetric_fold=False)
    slot = slot_sharding(mesh, axis)
    rep = replicated(mesh)

    def wrapped(b: nb.BinnedState, n_steps):
        spec = jax.tree.map(
            lambda x: slot if x.ndim >= 1 and x.shape[0] == grid.num_slots else rep,
            b,
        )
        fn = jax.jit(
            lambda bb, n: wcsph_binned.simulate(params, grid, bb, n),
            in_shardings=(spec, rep),
            out_shardings=spec,
        )
        return fn(b, jnp.asarray(n_steps, jnp.int32))

    return wrapped


def sharded_pbf_simulate(mesh: Mesh, params, grid, pbf_params, axis: str = SPATIAL_AXIS):
    """PBF n-step roll under the same spatial GSPMD decomposition.

    Same contract as ``sharded_simulate``: slot arrays split along the
    leading cell axis, scalars replicated; GSPMD partitions the
    constraint-iteration slab folds exactly like the WCSPH ones (static
    slices over the sharded axis lower to collective-permutes). The
    compact owner-indexed stashes in ``pbf.step`` (K-row gathers that
    cross shard boundaries) partition as gather collectives — correct by
    construction; their cost is one collective per step.
    """
    import dataclasses

    from sph_pie_tpu.solvers import pbf as pbf_lib

    grid = dataclasses.replace(grid, symmetric_fold=False)
    slot = slot_sharding(mesh, axis)
    rep = replicated(mesh)

    def wrapped(b: nb.BinnedState, n_steps):
        spec = jax.tree.map(
            lambda x: slot if x.ndim >= 1 and x.shape[0] == grid.num_slots else rep,
            b,
        )
        fn = jax.jit(
            lambda bb, n: pbf_lib.simulate(params, grid, pbf_params, bb, n),
            in_shardings=(spec, rep),
            out_shardings=spec,
        )
        return fn(b, jnp.asarray(n_steps, jnp.int32))

    return wrapped
