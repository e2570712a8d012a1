"""Uniform-grid cell-list neighbor search, fully static-shape.

Static-shape design (BASELINE.json "counting-sort cell lists with fixed-capacity
neighbor gathers"):

  1. Hash every particle to a grid cell (cell edge == support radius h).
  2. ``argsort`` particles by cell id — XLA's sort runs on-device and keeps
     the whole pipeline static-shape (no host round trip, no dynamic sizes).
  3. Per-cell contiguous ranges recovered with vectorised ``searchsorted``.
  4. Neighbor candidates for particle i = for each of the 3^d adjacent cells,
     the first ``cap`` particles of that cell's sorted range. The scan over
     the 3^d offsets keeps the materialised intermediate at [N, cap, ...]
     instead of [N, 3^d * cap, ...], bounding memory pressure at large N.

Inactive particles sort to a sentinel cell id past every real cell, so they
never appear in any candidate range.

Everything here is shape-static given (GridSpec, capacity), so the caller can
roll the entire simulation step under ``jit`` + ``lax.fori_loop``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, TypeVar

import jax
import jax.numpy as jnp
from jax import lax

from sph_pie_tpu.utils.struct import pytree_dataclass

Carry = TypeVar("Carry")


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of the uniform neighbor grid.

    All fields are compile-time constants (part of the jit cache key):
    changing the domain extent or cell size is a recompile; changing
    particle positions obviously is not.
    """

    dims: tuple[int, ...]      # number of cells per axis
    origin: tuple[float, ...]  # world coordinate of cell (0,...,0) corner
    cell_size: float           # cell edge length (>= support radius h)
    cap: int                   # max particles gathered per cell

    @property
    def dim(self) -> int:
        return len(self.dims)

    @property
    def num_cells(self) -> int:
        return math.prod(self.dims)

    @property
    def strides(self) -> tuple[int, ...]:
        s = [1] * self.dim
        for a in range(self.dim - 2, -1, -1):
            s[a] = s[a + 1] * self.dims[a + 1]
        return tuple(s)


def grid_from_bounds(bound_min, bound_max, cell_size: float, cap: int) -> GridSpec:
    """GridSpec covering an AABB. Bounds must be concrete Python floats."""
    bmin = tuple(float(v) for v in bound_min)
    bmax = tuple(float(v) for v in bound_max)
    dims = tuple(
        max(1, int(math.ceil((hi - lo) / cell_size)))
        for lo, hi in zip(bmin, bmax)
    )
    return GridSpec(dims=dims, origin=bmin, cell_size=float(cell_size), cap=int(cap))


@pytree_dataclass
class CellList:
    """Result of one counting-sort build over the particle set."""

    order: jax.Array   # [N]  particle indices sorted by cell id
    starts: jax.Array  # [C]  first index in ``order`` for each cell
    ends: jax.Array    # [C]  one-past-last index in ``order`` for each cell
    coords: jax.Array  # [N, dim] integer cell coordinates per particle


def cell_coords(grid: GridSpec, pos):
    """Integer cell coordinates, clipped into the grid."""
    origin = jnp.asarray(grid.origin, pos.dtype)
    rel = (pos - origin) / grid.cell_size
    coords = jnp.floor(rel).astype(jnp.int32)
    dims = jnp.asarray(grid.dims, jnp.int32)
    return jnp.clip(coords, 0, dims - 1)


def build(grid: GridSpec, pos, active) -> CellList:
    """Counting-sort cell list. O(N log N) on-device sort, static shapes."""
    coords = cell_coords(grid, pos)
    strides = jnp.asarray(grid.strides, jnp.int32)
    cid = jnp.sum(coords * strides, axis=-1)
    # Inactive slots go to a sentinel cell past the last real cell, so the
    # per-cell [start, end) ranges below never cover them.
    cid = jnp.where(active, cid, jnp.int32(grid.num_cells))
    order = jnp.argsort(cid).astype(jnp.int32)
    sorted_cid = cid[order]
    all_cells = jnp.arange(grid.num_cells, dtype=jnp.int32)
    starts = jnp.searchsorted(sorted_cid, all_cells, side="left").astype(jnp.int32)
    ends = jnp.searchsorted(sorted_cid, all_cells, side="right").astype(jnp.int32)
    return CellList(order=order, starts=starts, ends=ends, coords=coords)


def _neighbor_offsets(dim: int) -> jnp.ndarray:
    """[3^dim, dim] int32 array of {-1,0,1}^dim cell offsets."""
    grids = jnp.meshgrid(*([jnp.arange(-1, 2, dtype=jnp.int32)] * dim), indexing="ij")
    return jnp.stack([g.reshape(-1) for g in grids], axis=-1)


def neighbor_fold(
    grid: GridSpec,
    cl: CellList,
    pair_fn: Callable[[Carry, jax.Array, jax.Array], Carry],
    init: Carry,
) -> Carry:
    """Fold ``pair_fn`` over all neighbor candidates of every particle.

    ``pair_fn(carry, j, valid)`` receives, per scan step over one of the 3^d
    adjacent-cell offsets:
      j     [N, cap] int32 — candidate neighbor indices (original numbering)
      valid [N, cap] bool  — candidate exists (in-range slot of a real cell)
    and must return an updated carry of identical structure. The candidate
    set includes the particle itself (callers mask r > 0 for pair forces and
    keep the self term for density).
    """
    n = cl.order.shape[0]
    dims = jnp.asarray(grid.dims, jnp.int32)
    strides = jnp.asarray(grid.strides, jnp.int32)
    slot = jnp.arange(grid.cap, dtype=jnp.int32)  # [cap]
    offsets = _neighbor_offsets(grid.dim)         # [3^d, dim]

    def body(carry, off):
        nb = cl.coords + off                                     # [N, dim]
        in_grid = jnp.all((nb >= 0) & (nb < dims), axis=-1)      # [N]
        nb_cid = jnp.sum(jnp.clip(nb, 0, dims - 1) * strides, axis=-1)
        s = cl.starts[nb_cid]                                    # [N]
        e = cl.ends[nb_cid]                                      # [N]
        idx = s[:, None] + slot[None, :]                         # [N, cap]
        valid = (idx < e[:, None]) & in_grid[:, None]
        j = cl.order[jnp.clip(idx, 0, n - 1)]                    # [N, cap]
        return pair_fn(carry, j, valid), None

    carry, _ = lax.scan(body, init, offsets)
    return carry


def max_cell_occupancy(grid: GridSpec, cl: CellList) -> jax.Array:
    """Diagnostic: the fullest cell's population (to validate ``cap``)."""
    return jnp.max(cl.ends - cl.starts)
