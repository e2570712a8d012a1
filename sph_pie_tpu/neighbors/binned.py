"""Binned dense cell layout — the gather-free slot hot path.

The layout makes the neighbor structure *dense and static*. It was chosen
for the previous accelerator, where per-particle random gathers
were orders of magnitude slower than dense elementwise math; on the GPU a
gather-based cell list (``neighbors/grid.py``) is the usual design, and
which of the two wins there is an open measurement (ROADMAP S3).

  * Every grid cell owns ``cap`` particle slots in one flat slot-major array
    (slot = cell_id * cap + rank). A one-cell ghost border keeps every
    neighbor window in-bounds, so interior windows never wrap.
  * Cells are raveled row-major with the LAST spatial axis contiguous, so
    the three x-adjacent cells of any cell are contiguous slots. The 3^d
    neighbor stencil collapses to 3^(d-1) "slabs": for each combination of
    offsets along the leading axes, the neighbor block is a single
    **static slice** of the flat array (shifted by a compile-time constant)
    — zero gathers, pure dense streaming.
  * A Verlet-style skin (cell_size = h + skin) lets the expensive re-binning
    (counting sort) run only when accumulated displacement can have exceeded
    skin/2, instead of every step.

The layout trades FLOPs on empty slots for the elimination of gathers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, TypeVar

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sph_pie_tpu.core.state import ParticleState, allocate
from sph_pie_tpu.utils.struct import pytree_dataclass, replace

Carry = TypeVar("Carry")


@dataclasses.dataclass(frozen=True)
class BinnedGrid:
    """Static slot-grid description (part of the jit cache key)."""

    dims: tuple[int, ...]      # interior cells per GRID axis
    origin: tuple[float, ...]  # world coord of interior cell (0,..,0), grid order
    cell_size: float           # >= support radius h + skin
    cap: int                   # particle slots per cell
    skin: float                # Verlet skin absorbed into cell_size
    block_cells: int = 0       # cells per fold block (0 = whole grid at once)
    max_particles: int = 0     # compact particle capacity (for O(N) rebin)
    axis_order: tuple[int, ...] = ()  # grid axis g -> spatial axis. Putting
                               # the gravity axis first makes settled fluid a
                               # contiguous prefix of cell ids, so trailing
                               # blocks are empty and the fold skips them.
    skip_empty_blocks: bool = True
    symmetric_fold: bool = False  # Newton's-3rd-law fold (slab_fold_sym).
                               # Off: it measured slower than the
                               # one-sided fold on the previous machine
                               # (the dual home+window reductions and the
                               # carry write-back outweighed the ~1.8x
                               # pair-work saving). Not yet measured on
                               # the GPU; covered by an equivalence test.
    n_boundary: int = 0        # trailing rows of the compact arrays that
                               # are frozen boundary (ghost) particles:
                               # they participate in every pair sum but
                               # never integrate. max_particles includes
                               # them; fluid rows are [0, max_particles -
                               # n_boundary).
    home_tier: int = 0         # if 0 < t < cap: home rows [t, cap) are
                               # processed only for blocks that actually
                               # contain a cell with occupancy > t. Lets
                               # cap carry overflow headroom (rare crowded
                               # cells) at little cost: window columns
                               # cover the full cap either way, only home
                               # rows pay.
    periodic: tuple[bool, ...] = ()  # per GRID axis (axis_order space):
                               # True = wrap. Periodic axes fill their
                               # ghost-border cells each step with images
                               # of the opposite interior edge (positions
                               # offset by the domain length) — the slab
                               # windows then see exact periodic
                               # neighbors with zero changes to the fold.
                               # Incompatible with margin_cells on the
                               # same axis (walls vs wrap).
    window_mode: str = "concat"  # Window shape handed to pair_fn per
                               # block:
                               # "concat" = one [blk, cap, 3cap] call
                               #   per slab, window materialised as a
                               #   3-slice concatenate;
                               # "split" = 3 calls of [blk, cap, cap]
                               #   per slab, unmaterialised slices
                               #   (slower on the previous machine, kept
                               #   for A/B);
                               # "mega" = ONE [blk, cap, 3^dim*cap]
                               #   call per block (~10x fewer window ops
                               #   and pair dispatches).
    adaptive_rows: int = 0     # if 0 < a and a | cap: per-block DYNAMIC
                               # home-row bound. Each block runs a
                               # while_loop over a-row segments up to
                               # ceil(max_cell_occupancy_in_block / a)
                               # segments, so home-side pair work scales
                               # with actual occupancy instead of cap.
                               # Counting-sort rank order guarantees rank
                               # r is occupied iff cell occupancy > r, so
                               # segments past the block max are exactly
                               # the all-empty rows. Subsumes home_tier.
                               # Matches the static fold to fp tiling
                               # noise (~1e-7 rel): segments partition
                               # rows, only XLA's reduction tiling
                               # differs between shapes.
    scan_unroll: int = 1       # unroll factor for the fold's block scan
                               # (lax.scan unroll=k): k block bodies per
                               # while iteration. Dispatch gaps and
                               # while overhead scale with the ~350
                               # iterations/phase at 1M; unrolling trades
                               # them for code size. A/B knob.

    @property
    def dim(self) -> int:
        return len(self.dims)

    @property
    def padded_dims(self) -> tuple[int, ...]:
        return tuple(d + 2 for d in self.dims)  # one ghost cell per side

    @property
    def num_cells(self) -> int:
        return math.prod(self.padded_dims)

    @property
    def num_slots(self) -> int:
        return self.num_cells * self.cap

    @property
    def strides(self) -> tuple[int, ...]:
        pd = self.padded_dims
        s = [1] * self.dim
        for a in range(self.dim - 2, -1, -1):
            s[a] = s[a + 1] * pd[a + 1]
        return tuple(s)

    def slab_shifts(self) -> list[int]:
        """Flat cell shifts for each {-1,0,1}^(dim-1) leading-axes offset."""
        shifts = [0]
        for a in range(self.dim - 1):
            stride = self.strides[a]
            shifts = [s + o * stride for s in shifts for o in (-1, 0, 1)]
        return shifts


def binned_grid_from_bounds(
    bound_min,
    bound_max,
    h: float,
    cap: int,
    skin_frac: float = 0.5,
    block_cells: int | None = None,
    max_particles: int = 0,
    axis_order: tuple[int, ...] | None = None,
    home_tier: int = 0,
    margin_cells: int = 0,
    periodic: tuple[bool, ...] | None = None,
) -> BinnedGrid:
    """Grid whose cells are h*(1+skin_frac) wide; rebin is needed only when
    a particle may have moved more than skin/2 since the last binning.

    ``block_cells`` bounds the pair-interaction temporaries to
    [block_cells, cap, 3cap] (the fold scans over blocks); auto-sized so a
    block's pair tensor stays ~8M elements (~32 MB f32) unless given.

    ``margin_cells`` extends the interior past the domain AABB on every
    side. Without it, particles that penetrate a penalty wall are CLIPPED
    into the edge cell ring by ``_cell_ids`` — a deep pile-up then crowds
    phantom occupancy into those cells until they overflow (measured: a 1M
    dam break saturating any cap late in the run). Margin cells hold
    penetrators at their true density; they are empty otherwise and the
    fold's empty-block skip makes them nearly free.
    """
    skin = float(skin_frac) * float(h)
    cell = float(h) + skin
    bmin = tuple(float(v) for v in bound_min)
    bmax = tuple(float(v) for v in bound_max)
    dim = len(bmin)
    if axis_order is None:
        axis_order = tuple(range(dim))
    m = int(margin_cells)
    per_g = (
        tuple(bool(periodic[a]) for a in axis_order) if periodic else ()
    )
    if any(per_g) and m:
        raise ValueError(
            "margin_cells and periodic are mutually exclusive (margins "
            "hold wall penetrators; periodic axes have no walls)"
        )
    dims = tuple(
        max(1, int(math.ceil((bmax[a] - bmin[a]) / cell)) + 2 * m)
        for a in axis_order
    )
    grid = BinnedGrid(
        dims=dims,
        origin=tuple(bmin[a] - m * cell for a in axis_order),
        cell_size=cell,
        cap=int(cap),
        skin=skin,
        max_particles=int(max_particles),
        axis_order=tuple(axis_order),
        home_tier=int(home_tier) if 0 < home_tier < cap else 0,
        periodic=per_g,
    )
    if block_cells is None:
        # Small blocks win twice in 3D: finer empty-block skip granularity
        # and smaller temporaries. 256 cells/block in 3D and 1024 in 2D
        # (small, lightly skippable grids, where dispatch overhead rules)
        # were tuned on the previous machine; the GPU sweep is ROADMAP S7.
        budget = 8 * 1024 * 1024  # pair-tensor element cap per block
        sweet = 1024 if len(dims) == 2 else 256
        block_cells = max(8, min(sweet, budget // (grid.cap * 3 * grid.cap)))
        if block_cells >= grid.num_cells:
            block_cells = 0  # single block — no scan needed
    return dataclasses.replace(grid, block_cells=int(block_cells))


@pytree_dataclass
class BinnedState:
    """Dense slot-major particle state. Leading dim = grid.num_slots."""

    pos: jax.Array       # [S, dim]
    vel: jax.Array       # [S, dim]
    mass: jax.Array      # [S]
    density: jax.Array   # [S]
    pressure: jax.Array  # [S]
    valid: jax.Array     # [S] bool
    owner: jax.Array     # [S] int32 — original particle index, -1 if empty
    slot_of: jax.Array   # [K] int32 — particle k's slot; num_slots if absent.
                         # Keeps rebin/unbin O(K): compact-gather K rows, sort
                         # K keys, scatter K rows (never O(S) scatters).
    bin_pos: jax.Array   # [S, dim] positions AT BIN TIME: the anchor for the
                         # true-displacement rebin trigger (the accumulated
                         # sum-of-max-speeds bound alone over-triggers ~2-4x
                         # in oscillatory late-stage flow)
    travel: jax.Array    # [] upper bound on per-particle displacement since bin
    overflow: jax.Array  # [] int32 — particles dropped because a cell overflowed
    n_rebins: jax.Array  # [] int32 — re-sorts since bin_state (perf counter)
    sim_time: jax.Array  # [] simulated seconds since bin_state — drives
                         # time-dependent boundaries (moving obstacles)


def _cell_ids(grid: BinnedGrid, pos, valid):
    """Padded-grid flat cell id per row; invalid rows -> sentinel past end.

    Non-periodic axes CLIP penetrators into the edge ring (see
    margin_cells); periodic axes WRAP them modulo the interior width, so a
    particle leaving one side re-bins on the other."""
    order = grid.axis_order or tuple(range(grid.dim))
    pos_g = pos[:, list(order)]  # spatial columns permuted into grid order
    origin = jnp.asarray(grid.origin, pos.dtype)
    rel = (pos_g - origin) / grid.cell_size
    coords = jnp.floor(rel).astype(jnp.int32)      # interior-relative
    pd = jnp.asarray(grid.padded_dims, jnp.int32)
    dims = jnp.asarray(grid.dims, jnp.int32)
    wrapped = jnp.mod(coords, dims) + 1
    clipped = jnp.clip(coords + 1, 1, pd - 2)
    if any(grid.periodic):
        per = jnp.asarray(grid.periodic, jnp.bool_)
        coords = jnp.where(per[None, :], wrapped, clipped)
    else:
        coords = clipped
    cid = jnp.sum(coords * jnp.asarray(grid.strides, jnp.int32), axis=-1)
    return jnp.where(valid, cid, jnp.int32(grid.num_cells))


def _bin_rows(
    grid: BinnedGrid, pos, vel, mass, owner, valid, n_rebins=None,
    sim_time=None, density=None,
) -> BinnedState:
    """Counting-sort K compact rows into the dense slot layout. O(K log K).

    ``owner`` must be the particle index of each row (rows are the compact
    particle arrays), so K == grid.max_particles.

    Design: a single multi-operand ``lax.sort`` carries every payload
    column with the key (no argsort + per-field gathers), and the rank
    within a cell is a cummax scan over change-points (no
    ``searchsorted``). The remaining cost is the dense scatters.
    """
    n = pos.shape[0]
    dim = grid.dim
    if any(grid.periodic):
        # Fold positions into the primary box on periodic axes AT BIN TIME
        # only: between rebins they may drift <= skin/2 past the seam,
        # which the wrapped cell ids and ghost images still cover, and
        # keeping them continuous preserves the lazy-rebin drift check.
        order = grid.axis_order or tuple(range(grid.dim))
        cols = []
        for s_axis in range(dim):
            g_axis = order.index(s_axis)
            if grid.periodic[g_axis]:
                o = grid.origin[g_axis]
                L = grid.dims[g_axis] * grid.cell_size
                cols.append(o + jnp.mod(pos[:, s_axis] - o, L))
            else:
                cols.append(pos[:, s_axis])
        pos = jnp.stack(cols, axis=-1)
    cid = _cell_ids(grid, pos, valid)

    # One sort, all payloads riding with the key (vel/density only when
    # carried — see rebin(light=..., carry_density=...)).
    nv = dim if vel is not None else 0
    nd = 1 if density is not None else 0
    ops = (
        (cid,)
        + tuple(pos[:, k] for k in range(dim))
        + tuple(vel[:, k] for k in range(nv))
        + ((density,) if nd else ())
        + (mass, owner)
    )
    sorted_ops = jax.lax.sort(ops, num_keys=1)
    scid = sorted_ops[0]
    spos = sorted_ops[1 : 1 + dim]
    svel = sorted_ops[1 + dim : 1 + dim + nv]
    sdens = sorted_ops[1 + dim + nv] if nd else None
    smass = sorted_ops[1 + dim + nv + nd]
    sowner = sorted_ops[2 + dim + nv + nd]

    # rank within cell = i - (index of this cell's first row), where the
    # first-row index is the running max over change-point markers.
    iota = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), scid[1:] != scid[:-1]]
    )
    first = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_start, iota, 0)
    )
    rank = iota - first
    fits = (rank < grid.cap) & (scid < grid.num_cells)
    # NOTE: scatter mode="drop" WRAPS negative indices (verified on this
    # jax version), so the drop sentinel must be past-the-end, not -1.
    slot = jnp.where(fits, scid * grid.cap + rank, grid.num_slots)

    S = grid.num_slots
    dt = pos.dtype

    # Per-COLUMN scalar scatters into flat [S] targets (a packed
    # [K, 2dim+1] row scatter into [S, 7] measured worse on the previous
    # machine, whose tiled layout padded the trailing axis).
    def scat(rows):
        return jnp.zeros((S,), rows.dtype).at[slot].set(rows, mode="drop")

    pos_d = jnp.stack([scat(c) for c in spos], axis=-1)
    vel_d = (
        jnp.stack([scat(c) for c in svel], axis=-1)
        if nv
        else jnp.zeros((S, dim), dt)
    )
    mass_d = scat(smass)
    valid_d = mass_d > 0
    owner_d = jnp.full((S,), -1, jnp.int32).at[slot].set(sowner, mode="drop")
    dens_d = scat(sdens) if nd else jnp.zeros((S,), dt)

    out = BinnedState(
        pos=pos_d,
        vel=vel_d,
        mass=mass_d,
        density=dens_d,
        pressure=jnp.zeros((S,), dt),
        # Real particles have strictly positive mass (lattice_mass > 0),
        # empty slots hold 0 — validity is derivable, no bool scatter.
        valid=valid_d,
        owner=owner_d,
        slot_of=jnp.full((n,), S, jnp.int32).at[sowner].set(slot, mode="drop"),
        bin_pos=pos_d,
        travel=jnp.zeros((), dt),
        overflow=jnp.sum(
            (cid < grid.num_cells).astype(jnp.int32)
        ) - jnp.sum(fits.astype(jnp.int32)),
        n_rebins=(
            jnp.zeros((), jnp.int32) if n_rebins is None else n_rebins
        ),
        sim_time=(
            jnp.zeros((), dt) if sim_time is None else sim_time
        ),
    )
    return out


def bin_state(
    grid: BinnedGrid, state: ParticleState, boundary=None, sim_time=None
) -> BinnedState:
    """ParticleState (flat, original order) -> dense binned layout.

    ``boundary`` is an optional (pos [M, dim], mass [M]) pair of frozen
    ghost particles appended after the fluid rows (M must equal
    grid.n_boundary). They ride every rebin like fluid rows — their
    positions simply never change — and solvers freeze them via
    ``frozen_mask``.

    ``state.density`` is carried into the slots (zero for boundary rows):
    WCSPH recomputes it immediately, while PBF's Monaghan XSPH weight
    reads the previous step's density, which must survive the epoch
    loop's unbin/bin round-trip. ``sim_time`` seeds the state clock —
    the epoch loop passes its running time so moving obstacles keep
    their phase across epoch boundaries instead of snapping back to t=0.
    """
    n_fluid = (grid.max_particles or state.capacity) - grid.n_boundary
    if grid.max_particles and state.capacity != n_fluid:
        raise ValueError(
            f"state capacity {state.capacity} != fluid rows {n_fluid} "
            f"(grid.max_particles {grid.max_particles}, "
            f"n_boundary {grid.n_boundary})"
        )
    pos, vel, mass, valid = state.pos, state.vel, state.mass, state.active
    if grid.n_boundary:
        if boundary is None:
            raise ValueError(f"grid expects {grid.n_boundary} boundary rows")
        bpos, bmass = boundary
        if bpos.shape[0] != grid.n_boundary:
            raise ValueError(
                f"boundary rows {bpos.shape[0]} != grid.n_boundary {grid.n_boundary}"
            )
        pos = jnp.concatenate([pos, jnp.asarray(bpos, pos.dtype)])
        vel = jnp.concatenate([vel, jnp.zeros_like(jnp.asarray(bpos, pos.dtype))])
        mass = jnp.concatenate([mass, jnp.asarray(bmass, mass.dtype)])
        valid = jnp.concatenate(
            [valid, jnp.ones((grid.n_boundary,), jnp.bool_)]
        )
    dens = state.density
    if grid.n_boundary:
        dens = jnp.concatenate(
            [dens, jnp.zeros((grid.n_boundary,), dens.dtype)]
        )
    owner = jnp.arange(pos.shape[0], dtype=jnp.int32)
    return _bin_rows(
        grid, pos, vel, mass, owner, valid,
        sim_time=(
            None if sim_time is None else jnp.asarray(sim_time, pos.dtype)
        ),
        density=dens,
    )


def _wrap_axis(grid: BinnedGrid, x: jax.Array, axis: int, offset) -> jax.Array:
    """x: flat [S, ...]; copy interior edge planes into ghost planes
    along grid ``axis``; ``offset`` is added (spatial vector) or None."""
    pd = grid.padded_dims
    lead = int(np.prod(pd[:axis])) if axis else 1
    width = pd[axis]
    tail_cells = int(np.prod(pd[axis + 1 :])) * grid.cap
    x5 = x.reshape((lead, width, tail_cells) + x.shape[1:])
    lo_img = x5[:, -2:-1]  # interior high edge -> low ghost
    hi_img = x5[:, 1:2]    # interior low edge  -> high ghost
    if offset is not None:
        lo_img = lo_img - offset
        hi_img = hi_img + offset
    x5 = jnp.concatenate([lo_img, x5[:, 1:-1], hi_img], axis=1)
    return x5.reshape(x.shape)


def wrap_ghost_fields(
    grid: BinnedGrid,
    fields: dict[str, jax.Array],
    offset_fields: tuple[str, ...] = ("pos", "bin_pos"),
) -> dict[str, jax.Array]:
    """Field-level ghost wrap: name -> flat [S, ...] arrays, returned
    wrapped. Fields named in ``offset_fields`` get the +-L spatial image
    offset; the rest are copied verbatim. Shared by ``wrap_ghosts`` and
    the balanced decomposition (parallel/balance.py), which wraps on the
    collected global layout between sharded steps."""
    if not any(grid.periodic):
        return dict(fields)
    order = grid.axis_order or tuple(range(grid.dim))
    out = dict(fields)
    for g_axis, per in enumerate(grid.periodic):
        if not per:
            continue
        s_axis = order[g_axis]
        length = grid.dims[g_axis] * grid.cell_size
        for k, x in out.items():
            off = (
                jnp.zeros((grid.dim,), x.dtype).at[s_axis].set(length)
                if k in offset_fields
                else None
            )
            out[k] = _wrap_axis(grid, x, g_axis, off)
    return out


def wrap_ghosts(grid: BinnedGrid, b: BinnedState) -> BinnedState:
    """Refresh ghost-border cells of periodic axes with images of the
    opposite interior edge (positions offset by the domain length).

    Axis-at-a-time sequential wrapping composes corners/edges for free:
    after axis k is wrapped, axis k+1 copies rows that already contain
    axis-k images. All copies are static slices via per-axis reshapes —
    zero gathers, cost O(border slots). Called once per step BEFORE the
    pair folds; image positions therefore track their sources exactly
    (sources obey the Verlet-skin bound, so images do too).

    bin_pos mirrors the image offset too, else the lazy-rebin true-drift
    check sees a phantom |pos - 0| = domain-length drift on every
    populated ghost slot and rebins every step.  density rides as a live
    payload in PBF's epilogue="ride" scheme (Monaghan weight); for WCSPH
    it is recomputed per step and the ghost copy is simply overwritten —
    harmless either way."""
    if not any(grid.periodic):
        return b
    wrapped = wrap_ghost_fields(
        grid,
        {
            "pos": b.pos,
            "bin_pos": b.bin_pos,
            "vel": b.vel,
            "mass": b.mass,
            "valid": b.valid,
            "owner": b.owner,
            "density": b.density,
        },
    )
    return replace(b, **wrapped)


def frozen_mask(grid: BinnedGrid, b: BinnedState) -> jax.Array:
    """[S] bool: slot holds a frozen boundary particle (owner in the
    trailing n_boundary compact rows)."""
    if not grid.n_boundary:
        return jnp.zeros_like(b.valid)
    n_fluid = grid.max_particles - grid.n_boundary
    return b.owner >= n_fluid


def _compact(grid: BinnedGrid, b: BinnedState):
    """Gather the K compact particle rows out of the dense layout. O(K)."""
    S = grid.num_slots
    safe = jnp.clip(b.slot_of, 0, S - 1)
    alive = b.slot_of < S
    return (
        b.pos[safe],
        b.vel[safe],
        b.mass[safe],
        alive,
    )


def rebin(
    grid: BinnedGrid,
    b: BinnedState,
    light: bool = False,
    carry_density: bool = False,
) -> BinnedState:
    """Re-sort after drift: compact-gather K rows, then re-bin. O(K log K).

    (The obvious alternative — re-binning the S dense slots directly — costs
    O(S) scatters over mostly-empty slots, nearly 100x slower at 3D 100k on
    the previous machine.)

    ``light=True`` skips the velocity payload entirely (3 fewer sort
    operands + 3 fewer dense scatters; the rebinned state carries zero
    vel). PBF's mid-step rebins use this: its constraint iterations read
    only pos/mass, and the step-start positions needed for the final
    velocity ride a compact owner-indexed stash instead of the vel slots
    (solvers/pbf.py, epilogue="gather").

    ``carry_density=True`` sorts/scatters the density column alongside
    (one extra sort operand + scatter) instead of zeroing it — the
    epilogue="ride" PBF scheme keeps the previous step's final density as
    a live payload so the Monaghan XSPH weight never needs an owner
    gather.
    """
    S = grid.num_slots
    safe = jnp.clip(b.slot_of, 0, S - 1)
    if light:
        pos, mass, alive = b.pos[safe], b.mass[safe], b.slot_of < S
        vel = None
    else:
        pos, vel, mass, alive = _compact(grid, b)
    dens = b.density[safe] if carry_density else None
    owner = jnp.arange(pos.shape[0], dtype=jnp.int32)
    return _bin_rows(
        grid, pos, vel, mass, owner, alive, b.n_rebins + 1, b.sim_time,
        density=dens,
    )


def unbin(grid: BinnedGrid, b: BinnedState, capacity: int) -> ParticleState:
    """Dense layout -> flat original-order ParticleState (fluid rows only;
    trailing boundary rows are grid-static and not part of the state)."""
    if b.slot_of.shape[0] != capacity + grid.n_boundary:
        raise ValueError(
            f"capacity {capacity} + boundary {grid.n_boundary} != "
            f"particle rows {b.slot_of.shape[0]}"
        )
    S = grid.num_slots
    slot_of = b.slot_of[:capacity]
    safe = jnp.clip(slot_of, 0, S - 1)
    alive = slot_of < S
    st = allocate(capacity, grid.dim, b.pos.dtype)
    zero2 = jnp.zeros((capacity, grid.dim), b.pos.dtype)
    m = alive[:, None]
    return replace(
        st,
        pos=jnp.where(m, b.pos[safe], zero2),
        vel=jnp.where(m, b.vel[safe], zero2),
        mass=jnp.where(alive, b.mass[safe], 0.0),
        density=jnp.where(alive, b.density[safe], 0.0),
        pressure=jnp.where(alive, b.pressure[safe], 0.0),
        active=alive,
    )


def slab_windows(grid: BinnedGrid, x: jax.Array) -> list[jax.Array]:
    """For each of the 3^(dim-1) slabs, the [S, 3*cap, ...] neighbor window.

    ``x`` is a flat slot-major array [S, ...]. The window for slab ``s`` at
    cell c covers cells (c + shift_s - 1, c + shift_s, c + shift_s + 1) —
    contiguous because the last spatial axis has stride 1. Implemented as
    three compile-time-constant slices of a zero-padded copy; reshaped to
    [num_cells, 3*cap, ...].

    Returns a list (static length) of [num_cells, 3*cap, ...] arrays.
    """
    cap = grid.cap
    S = grid.num_slots
    shifts = grid.slab_shifts()
    pad = (max(abs(s) for s in shifts) + 1) * cap
    pad_width = [(pad, pad)] + [(0, 0)] * (x.ndim - 1)
    xp = jnp.pad(x, pad_width)
    tail = x.shape[1:]
    out = []
    for sh in shifts:
        base = pad + sh * cap
        parts = [
            xp[base - cap : base - cap + S],
            xp[base : base + S],
            xp[base + cap : base + cap + S],
        ]
        blocks = [p.reshape((grid.num_cells, cap) + tail) for p in parts]
        out.append(jnp.concatenate(blocks, axis=1))
    return out


def slab_fold(
    grid: BinnedGrid,
    fields: dict[str, jax.Array],
    pair_fn: Callable[[Carry, dict[str, jax.Array], dict[str, jax.Array]], Carry],
    init: Carry,
    halo: tuple[dict, dict] | None = None,
    local_cells: int | None = None,
) -> Carry:
    """Fold ``pair_fn`` over all neighbor slabs, blocked over cells.

    ``fields`` maps name -> flat [S, ...] array. ``init`` is a pytree of
    flat per-slot accumulators [S, ...]. For every block of
    ``grid.block_cells`` cells and every one of the 3^(dim-1) slabs,
    ``pair_fn(carry, home, win)`` receives:

      carry  pytree of [blk, cap, ...] accumulators for the home block
      home   dict of [blk, cap, ...] home-slot field blocks
      win    dict of [blk, 3*cap, ...] neighbor-window field blocks

    and returns the updated carry. Returns accumulators reassembled to the
    flat [S, ...] layout.

    Design notes: each block reads ONE contiguous haloed window per
    field (``lax.dynamic_slice`` — no gathers; the halo is the leading-axes
    stride so every slab of the block lies inside the window). Blocking
    bounds the pair temporaries to [blk, cap, 3cap] regardless of grid
    size, which is what keeps 3D grids inside HBM (unblocked, XLA
    materialises [num_cells, cap, 3cap] temps and OOMs at ~50k cells).
    The slab loop is a static Python loop; the block loop is a
    ``lax.scan`` so compiled code size stays O(1) in grid size.

    Multi-chip: with ``halo=(lo_fields, hi_fields)`` and ``local_cells``,
    the fold operates on a device-local contiguous slab of cells whose
    out-of-shard neighbor rows were exchanged explicitly (ppermute —
    parallel/halo.py) instead of zero-padded; each halo dict holds
    [padc*cap, ...] rows (padc = halo_cells(grid)).
    """
    cap = grid.cap
    C = local_cells if local_cells is not None else grid.num_cells
    shifts = grid.slab_shifts()
    blk = grid.block_cells if grid.block_cells else C
    blk = min(blk, C)
    nblk = -(-C // blk)
    padc = max(abs(s) for s in shifts) + 1  # halo cells on each side
    win_cells = blk + 2 * padc

    def pad_rows(k, x):
        tail_rows = (padc + nblk * blk - C) * cap
        if halo is None:
            front = jnp.zeros((padc * cap,) + x.shape[1:], x.dtype)
            back = jnp.zeros((tail_rows,) + x.shape[1:], x.dtype)
        else:
            front = halo[0][k]
            back = jnp.concatenate(
                [
                    halo[1][k],
                    jnp.zeros(
                        ((tail_rows - padc * cap),) + x.shape[1:], x.dtype
                    ),
                ]
            ) if tail_rows > padc * cap else halo[1][k][: tail_rows]
        return jnp.concatenate([front, x, back])

    padded = {k: pad_rows(k, v) for k, v in fields.items()}

    def tail(x):
        return x.shape[1:]

    # Per-block occupancy, computed once and vectorized (one O(S) pass)
    # BEFORE the scan. Empty home blocks (no particles -> all masses 0)
    # produce no output; with the gravity axis leading, the fluid-free part
    # of the domain is a contiguous run of such blocks. The cond below
    # executes only the taken branch, AND the window dynamic_slices live
    # inside it — a skipped block costs neither compute nor the HBM reads
    # of its field windows (round 1 sliced before the cond, so every
    # skipped block still streamed ~win_cells*cap rows of every field).
    use_skip = grid.skip_empty_blocks and nblk > 1 and "mass" in fields
    adaptive = (
        grid.adaptive_rows
        if 0 < grid.adaptive_rows and cap % grid.adaptive_rows == 0
        and "mass" in fields
        else 0
    )
    tier = (
        grid.home_tier
        if 0 < grid.home_tier < cap and "mass" in fields and halo is None
        and not adaptive
        else 0
    )
    if use_skip or tier or adaptive:
        m = fields["mass"]
        tail_rows = nblk * blk * cap - C * cap
        mflat = jnp.concatenate([m, jnp.zeros((tail_rows,), m.dtype)]) if tail_rows else m
        occ3 = (mflat > 0).reshape(nblk, blk, cap)
        if use_skip:
            blk_occ = jnp.any(occ3, axis=(1, 2))
        if adaptive:
            # segments this block needs = ceil(max cell occupancy / seg)
            blk_max = jnp.max(
                jnp.sum(occ3.astype(jnp.int32), axis=2), axis=1
            )
            blk_nseg = -(-blk_max // adaptive)
        if tier:
            # rank `tier` occupied anywhere in the block <=> some cell
            # holds more than `tier` particles (counting-sort rank order)
            blk_hi = jnp.any(occ3[:, :, tier:], axis=(1, 2))

    # Scalar zero carrying the fold data's shard_map varying axes (vma):
    # under a manual mesh (parallel/halo.py) lax.cond requires branch
    # outputs to agree on varying axes, but a skipped-block branch's fresh
    # zeros are unvaried while compute's output varies with the shard —
    # and accumulator components pair_fn never touches stay unvaried even
    # in compute. ``vcast`` promotes every leaf with a data-derived 0 at
    # each join; outside shard_map it is a zero add XLA fuses away.
    _vsrc = jnp.ravel(next(iter(padded.values())))[0]
    vz0 = _vsrc * jnp.zeros((), _vsrc.dtype)

    def vcast(t):
        return jax.tree.map(
            lambda c: c | (vz0 != 0)
            if c.dtype == jnp.bool_
            else c + vz0.astype(c.dtype),
            t,
        )

    def body(_, b):
        zero = jax.tree.map(
            lambda a: jnp.zeros((blk, cap) + tail(a), a.dtype), init
        )

        def compute(_):
            start = b * (blk * cap)
            win = {
                k: lax.dynamic_slice_in_dim(v, start, win_cells * cap, axis=0)
                for k, v in padded.items()
            }
            home = {
                k: w[padc * cap : (padc + blk) * cap].reshape(
                    (blk, cap) + tail(w)
                )
                for k, w in win.items()
            }

            def slab_windows():
                """Per-slab window dicts for pair_fn (see window_mode)."""
                mode = grid.window_mode
                if mode == "mega":
                    # One [blk, 3^dim * cap] window: every cell-column of
                    # every slab concatenated on the last axis, so pair_fn
                    # dispatches once per block instead of 3^(dim-1)
                    # times.
                    views = []
                    for sh in shifts:
                        base0 = (padc + sh - 1) * cap
                        for t in range(3):
                            base = base0 + t * cap
                            views.append(
                                {
                                    k: w[base : base + blk * cap].reshape(
                                        (blk, cap) + tail(w)
                                    )
                                    for k, w in win.items()
                                }
                            )
                    yield {
                        k: jnp.concatenate([v[k] for v in views], axis=1)
                        for k in win
                    }
                    return
                for sh in shifts:
                    base0 = (padc + sh - 1) * cap
                    if mode == "split":
                        for t in range(3):
                            base = base0 + t * cap
                            yield {
                                k: w[base : base + blk * cap].reshape(
                                    (blk, cap) + tail(w)
                                )
                                for k, w in win.items()
                            }
                    else:
                        yield {
                            k: _window_view(
                                w[base0 : base0 + (blk + 2) * cap], blk, cap
                            )
                            for k, w in win.items()
                        }

            def run_rows(r0, r1):
                hm = {k: h[:, r0:r1] for k, h in home.items()}
                carry = jax.tree.map(
                    lambda a: jnp.zeros((blk, r1 - r0) + tail(a), a.dtype),
                    init,
                )
                for slab in slab_windows():
                    carry = pair_fn(carry, hm, slab)
                return carry

            if adaptive:
                # while_loop over `adaptive`-row segments: home-side pair
                # work per block is ceil(block_max_occ/seg) segments, not
                # cap rows. Rows past the block max are rank-empty by the
                # counting-sort invariant, so skipping them is exact.
                def seg_body(state):
                    s, carry = state
                    r0 = s * adaptive
                    hm = {
                        k: lax.dynamic_slice_in_dim(h, r0, adaptive, axis=1)
                        for k, h in home.items()
                    }
                    cc = jax.tree.map(
                        lambda a: jnp.zeros(
                            (blk, adaptive) + tail(a), a.dtype
                        ),
                        init,
                    )
                    for slab in slab_windows():
                        cc = pair_fn(cc, hm, slab)
                    carry = jax.tree.map(
                        lambda c, d: lax.dynamic_update_slice_in_dim(
                            c, d, r0, axis=1
                        ),
                        carry,
                        cc,
                    )
                    return s + 1, carry

                _, carry = lax.while_loop(
                    lambda st: st[0] < blk_nseg[b],
                    seg_body,
                    (jnp.int32(0), vcast(zero)),
                )
                return carry

            t = tier or cap
            carry = run_rows(0, t)
            if tier:
                hi = lax.cond(
                    blk_hi[b],
                    lambda _: vcast(run_rows(tier, cap)),
                    lambda _: vcast(
                        jax.tree.map(
                            lambda a: jnp.zeros(
                                (blk, cap - tier) + tail(a), a.dtype
                            ),
                            init,
                        )
                    ),
                    None,
                )
                carry = jax.tree.map(
                    lambda a, c: jnp.concatenate([a, c], axis=1), carry, hi
                )
            return carry

        if use_skip:
            carry = lax.cond(
                blk_occ[b],
                lambda _: vcast(compute(None)),
                lambda _: vcast(zero),
                None,
            )
        else:
            carry = compute(None)
        return None, carry

    _, stacked = lax.scan(
        body,
        None,
        jnp.arange(nblk, dtype=jnp.int32),
        unroll=max(1, int(grid.scan_unroll)),
    )
    # [nblk, blk, cap, ...] -> flat [C*cap, ...]
    return jax.tree.map(
        lambda a: a.reshape((nblk * blk * cap,) + a.shape[3:])[: C * cap], stacked
    )


def halo_cells(grid: BinnedGrid) -> int:
    """Cells of halo each side a local fold needs (= max slab reach + 1)."""
    return max(abs(s) for s in grid.slab_shifts()) + 1


def slab_fold_sym(
    grid: BinnedGrid,
    fields: dict[str, jax.Array],
    pair_fn,
    init: Carry,
) -> Carry:
    """Newton's-third-law fold: every pair is computed ONCE and accumulated
    to both sides.

    Slab selection: of the 3^(dim-1) leading-offset slabs, only those with
    flat shift > 0 are visited with the full 3-cell window (the reverse
    pair is exactly the one their home/window swap would produce), plus a
    "self" slab with a 2-cell window (cells c, c+1) where the within-cell-c
    pairs carry an upper-triangle mask. 3D: 4 full + 1 half slabs instead
    of 9 (2D: 1 + 1 instead of 3) — ~1.8x less pair work for one extra
    window-side accumulation.

    ``pair_fn(home, win, mask)`` receives [blk, cap] home blocks and
    [blk, W*cap] window blocks (W = 3 for shifted slabs, 2 for the self
    slab; ``mask`` is None or a [1, cap, W*cap] pair mask) and returns
    (h_delta, w_delta): pytrees of [blk, cap] home contributions and
    [blk, W*cap] window contributions. Window contributions are folded
    into the carry with static shifted adds; blocks overlap through the
    halo rows, which is sound because lax.scan runs blocks sequentially.

    Self-interaction (i == i) is excluded by the triangle mask — callers
    that need a self term (density) add it as an O(S) elementwise pass.

    NOTE single-device only: window contributions crossing shard
    boundaries would need a reverse halo exchange; the multi-chip paths
    keep using ``slab_fold``.
    """
    cap = grid.cap
    C = grid.num_cells
    shifts = grid.slab_shifts()
    pos_shifts = [s for s in shifts if s > 0]
    blk = grid.block_cells if grid.block_cells else C
    blk = min(blk, C)
    nblk = -(-C // blk)
    padc = max(abs(s) for s in shifts) + 1
    win_cells = blk + 2 * padc
    pad_rows_total = (padc + nblk * blk + padc) * cap

    def pad_rows(x):
        front = jnp.zeros((padc * cap,) + x.shape[1:], x.dtype)
        back = jnp.zeros(
            ((padc + nblk * blk - C) * cap,) + x.shape[1:], x.dtype
        )
        return jnp.concatenate([front, x, back])

    padded = {k: pad_rows(v) for k, v in fields.items()}

    # static upper-triangle mask for the self slab: columns [0, cap) are the
    # home cell itself (pair once: rank_j > rank_i), columns [cap, 2cap)
    # the +1 neighbor (all pairs)
    tri = jnp.concatenate(
        [
            jnp.triu(jnp.ones((cap, cap), bool), k=1),
            jnp.ones((cap, cap), bool),
        ],
        axis=1,
    )[None]

    use_skip = grid.skip_empty_blocks and nblk > 1 and "mass" in fields
    tier = grid.home_tier if 0 < grid.home_tier < cap and "mass" in fields else 0
    if use_skip or tier:
        m = fields["mass"]
        tail_rows = nblk * blk * cap - C * cap
        mflat = (
            jnp.concatenate([m, jnp.zeros((tail_rows,), m.dtype)])
            if tail_rows
            else m
        )
        occ3 = (mflat > 0).reshape(nblk, blk, cap)
        if use_skip:
            blk_occ = jnp.any(occ3, axis=(1, 2))
        if tier:
            # counting sort fills ranks in order, so "any cell with
            # occupancy > tier" == "any slot of rank >= tier occupied"
            blk_hi = jnp.any(occ3[:, :, tier:], axis=(1, 2))

    carry0 = jax.tree.map(lambda a: pad_rows(a), init)

    def tail(x):
        return x.shape[1:]

    def win2_view(w):
        # [blk, 2cap]: cells (c, c+1) — the self slab's window
        n = blk * cap
        a = w[padc * cap : padc * cap + n]
        bpart = w[(padc + 1) * cap : (padc + 1) * cap + n]
        return jnp.concatenate(
            [a.reshape((blk, cap) + tail(w)), bpart.reshape((blk, cap) + tail(w))],
            axis=1,
        )

    def body(carry, b):
        start = b * (blk * cap)

        def compute(carry):
            win = {
                k: lax.dynamic_slice_in_dim(v, start, win_cells * cap, axis=0)
                for k, v in padded.items()
            }
            home = {
                k: w[padc * cap : (padc + blk) * cap].reshape(
                    (blk, cap) + tail(w)
                )
                for k, w in win.items()
            }
            # local window-side accumulator spanning the haloed window
            w_buf = jax.tree.map(
                lambda a: jnp.zeros((win_cells * cap,) + tail(a), a.dtype),
                init,
            )

            def add_w(w_buf, wd, sh, ncells):
                # wd [blk, ncells*cap] -> rows (c + sh - 1 + t) for t<ncells
                # (for the self slab sh==0 windows start at offset 0, i.e.
                # cells c + t)
                out = w_buf
                base = padc + (sh - 1 if ncells == 3 else 0)
                for t in range(ncells):
                    chunk = wd[:, t * cap : (t + 1) * cap].reshape(
                        (blk * cap,) + wd.shape[2:]
                    )
                    lo = (base + t) * cap
                    out = out.at[lo : lo + blk * cap].add(chunk)
                return out

            def fold_rows(r0, r1, w_buf):
                """All slabs for home rows [r0, r1) of every cell."""
                hm = {k: h[:, r0:r1] for k, h in home.items()}
                h_acc = jax.tree.map(
                    lambda a: jnp.zeros((blk, r1 - r0) + tail(a), a.dtype),
                    init,
                )
                for sh in pos_shifts:
                    base = (padc + sh - 1) * cap
                    slab = {
                        k: _window_view(w[base : base + (blk + 2) * cap], blk, cap)
                        for k, w in win.items()
                    }
                    hd, wd = pair_fn(hm, slab, None)
                    h_acc = jax.tree.map(jnp.add, h_acc, hd)
                    w_buf = jax.tree.map(
                        lambda wb, w_: add_w(wb, w_, sh, 3), w_buf, wd
                    )
                slab0 = {k: win2_view(w) for k, w in win.items()}
                hd, wd = pair_fn(hm, slab0, tri[:, r0:r1])
                h_acc = jax.tree.map(jnp.add, h_acc, hd)
                w_buf = jax.tree.map(
                    lambda wb, w_: add_w(wb, w_, 0, 2), w_buf, wd
                )
                return h_acc, w_buf

            t = tier or cap
            h_acc, w_buf = fold_rows(0, t, w_buf)
            if tier:
                # crowded home rows [tier, cap): only for blocks that
                # actually contain a cell deeper than the tier boundary
                def hi_rows(wb):
                    return fold_rows(tier, cap, wb)

                def no_hi(wb):
                    zero_hi = jax.tree.map(
                        lambda a: jnp.zeros(
                            (blk, cap - tier) + tail(a), a.dtype
                        ),
                        init,
                    )
                    return zero_hi, wb

                h_hi, w_buf = lax.cond(blk_hi[b], hi_rows, no_hi, w_buf)
                h_acc = jax.tree.map(
                    lambda a, c: jnp.concatenate([a, c], axis=1), h_acc, h_hi
                )

            # fold home contributions into the window buffer's center rows
            w_buf = jax.tree.map(
                lambda wb, ha: wb.at[padc * cap : (padc + blk) * cap].add(
                    ha.reshape((blk * cap,) + ha.shape[2:])
                ),
                w_buf,
                h_acc,
            )
            # read-modify-write the carry's window span (sequential scan ->
            # overlapping halo rows accumulate correctly)
            def merge(c, wb):
                cur = lax.dynamic_slice_in_dim(c, start, win_cells * cap, axis=0)
                return lax.dynamic_update_slice_in_dim(
                    c, cur + wb, start, axis=0
                )

            return jax.tree.map(merge, carry, w_buf)

        if use_skip:
            carry = lax.cond(blk_occ[b], compute, lambda c: c, carry)
        else:
            carry = compute(carry)
        return carry, None

    carry, _ = lax.scan(
        body,
        carry0,
        jnp.arange(nblk, dtype=jnp.int32),
        unroll=max(1, int(grid.scan_unroll)),
    )
    return jax.tree.map(
        lambda a: a[padc * cap : padc * cap + C * cap], carry
    )


def _window_view(w: jax.Array, blk: int, cap: int) -> jax.Array:
    """[blk*cap + 2*cap, ...] contiguous rows -> [blk, 3*cap, ...] windows.

    Window of cell c covers cells (c-1, c, c+1): three overlapping reshapes
    of the same contiguous slab, concatenated — pure slices, no gather.
    """
    tail = w.shape[1:]
    n = blk * cap
    parts = [w[0:n], w[cap : cap + n], w[2 * cap : 2 * cap + n]]
    blocks = [p.reshape((blk, cap) + tail) for p in parts]
    return jnp.concatenate(blocks, axis=1)


def cell_view(grid: BinnedGrid, x: jax.Array) -> jax.Array:
    """Flat [S, ...] -> per-cell [num_cells, cap, ...] view of home slots."""
    return x.reshape((grid.num_cells, grid.cap) + x.shape[1:])


def flat_view(grid: BinnedGrid, x: jax.Array) -> jax.Array:
    """Inverse of cell_view."""
    return x.reshape((grid.num_slots,) + x.shape[2:])
