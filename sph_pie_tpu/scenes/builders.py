"""Scene builders: canonical particle layouts + tuned parameters.

The reference drives everything from JSON config + seeded defaults
(sphereisaiahmin-dev/sph-pie `server/configStore.js:9-42`,
`config/disciplines.json`); the analogue here is a set of scene builders
that produce (FluidParams, GridSpec, ParticleState) triples and are also
reachable from JSON scene files (sph_pie_tpu/scenes/config.py).

BASELINE.json config coverage:
  #1 2D dam break ~4k (``dam_break_2d``)
  #2 2D emitter + obstacle (``emitter_2d`` — scenes/emitter.py)
  #3 3D dam break 100k (``dam_break_3d``)
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import jax.numpy as jnp
import numpy as np

from sph_pie_tpu.core import state as state_lib
from sph_pie_tpu.core.params import FluidParams, make_params
from sph_pie_tpu.core.state import ParticleState
from sph_pie_tpu.kernels import smoothing
from sph_pie_tpu.neighbors import binned as nb
from sph_pie_tpu.neighbors.grid import GridSpec, grid_from_bounds


@dataclasses.dataclass(frozen=True)
class Scene:
    name: str
    params: FluidParams
    gspec: GridSpec        # naive per-particle cell grid (reference engine)
    bgrid: nb.BinnedGrid   # dense slot grid (production engine)
    state: ParticleState
    obstacles: object | None = None   # scenes.obstacles.Obstacles
    emitter: object | None = None     # scenes.emitter.EmitterSchedule
    boundary: tuple | None = None     # (pos [M, dim], mass [M]) frozen ghosts

    def binned_state(self) -> nb.BinnedState:
        return nb.bin_state(self.bgrid, self.state, self.boundary)


def lattice_block(lo, hi, dx: float) -> np.ndarray:
    """Particle positions on a regular lattice filling an AABB, spacing dx.

    First particle sits at lo + dx/2 (cell-centered), so blocks touch
    boundaries with a half-spacing gap — consistent on both the binned engine
    and the CPU oracle.
    """
    axes = [np.arange(l + 0.5 * dx, h, dx) for l, h in zip(lo, hi)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=-1)


def lattice_mass(dim: int, h: float, dx: float, rest_density: float) -> float:
    """Mass that makes the discrete poly6 density of an infinite lattice
    exactly rest_density: m = rho0 / sum_lattice W(|offset|).

    Removes the usual SPH rest-density bias at startup so the EOS starts
    from p ~ 0 instead of a pressure shock.
    """
    reach = int(math.ceil(h / dx))
    coeff = smoothing.poly6_coeff(dim, h)  # pure python float
    w_sum = 0.0
    for off in itertools.product(range(-reach, reach + 1), repeat=dim):
        r2 = sum((o * dx) ** 2 for o in off)
        if r2 < h * h:
            w_sum += coeff * (h * h - r2) ** 3  # host-side: no device ops
    return rest_density / w_sum


def wall_lattice(lo, hi, dx: float, layers: int, open_top: bool = True) -> np.ndarray:
    """Frozen boundary (ghost) particle positions: ``layers`` staggered
    lattice shells just OUTSIDE each face of the AABB (the no-slip dummy-
    particle treatment; the open top is skipped for tank scenes). Ghost
    pressure comes from the same EOS as fluid, so a wall-adjacent fluid
    particle sees full support and cannot over-compress against the wall.
    """
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    dim = lo.shape[0]
    shells = []
    for axis in range(dim):
        for side in (0, 1):
            if open_top and axis == dim - 1 and side == 1:
                continue  # open top face
            # expand the tangential extent so wall shells meet at corners
            t_lo = lo - layers * dx
            t_hi = hi + layers * dx
            for l in range(layers):
                off = (l + 0.5) * dx
                plane = lo[axis] - off if side == 0 else hi[axis] + off
                axes = []
                for a in range(dim):
                    if a == axis:
                        axes.append(np.array([plane]))
                    else:
                        axes.append(np.arange(t_lo[a] + 0.5 * dx, t_hi[a], dx))
                mesh = np.meshgrid(*axes, indexing="ij")
                shells.append(np.stack([m.reshape(-1) for m in mesh], axis=-1))
    if not shells:
        return np.zeros((0, dim))
    pts = np.concatenate(shells, axis=0)
    # de-dup corner overlaps (quantize to the lattice)
    key = np.round(pts / (0.5 * dx)).astype(np.int64)
    _, idx = np.unique(key, axis=0, return_index=True)
    return pts[np.sort(idx)]


def _gravity_first_order(dim: int) -> tuple[int, ...]:
    """Grid axis order with the gravity (height = last spatial) axis
    leading: settled fluid then occupies a contiguous prefix of cell ids,
    so the fold's empty-block skip pays off (neighbors/binned.py)."""
    g = dim - 1
    return (g,) + tuple(a for a in range(dim) if a != g)


def _default_cap(dim: int, h: float, dx: float) -> int:
    """Per-cell gather capacity: rest occupancy (h/dx)^dim with ~2x headroom,
    rounded up to a multiple of 8."""
    rest = (h / dx) ** dim
    cap = int(math.ceil(2.0 * rest))
    return max(8, (cap + 7) // 8 * 8)


def block_scene(
    *,
    name: str,
    dim: int,
    domain,
    fluid_lo,
    fluid_hi,
    dx: float,
    h_over_dx: float = 2.0,
    sound_speed: float = 40.0,
    viscosity: float = 0.05,
    xsph_eps: float = 0.0,
    surface_tension: float = 0.0,
    cfl: float = 0.25,
    capacity: int | None = None,
    cap: int | None = None,
    bcap: int | None = None,
    skin_frac: float = 0.25,
    wall_layers: int = 0,
    build_state: bool = True,
    dtype=jnp.float32,
    **param_overrides,
) -> Scene:
    """Generic block-of-fluid scene in an AABB domain.

    ``wall_layers`` > 0 adds that many shells of frozen ghost particles
    outside every face except the top — the no-slip boundary treatment
    (VERDICT round-1 physics-depth item). The penalty walls stay on as a
    safety net; ghost pressure dominates contact."""
    lo, hi = domain
    h = h_over_dx * dx
    rest_density = float(param_overrides.pop("rest_density", 1000.0))
    mass = lattice_mass(dim, h, dx, rest_density)
    dt = cfl * h / sound_speed
    params = make_params(
        dim=dim,
        h=h,
        dt=dt,
        rest_density=rest_density,
        sound_speed=sound_speed,
        viscosity=viscosity,
        xsph_eps=xsph_eps,
        surface_tension=surface_tension,
        bound_min=list(lo),
        bound_max=list(hi),
        dtype=dtype,
        **param_overrides,
    )
    cap = cap if cap is not None else _default_cap(dim, h, dx)
    gspec = grid_from_bounds(lo, hi, cell_size=h, cap=cap)
    cell = h * (1.0 + skin_frac)
    rest_occ = (cell / dx) ** dim
    # Headroom over rest occupancy: dam-break impact compresses cells well
    # past rest (3x was still observed to overflow at 4k/2D on real
    # hardware - wall-corner pile-ups under penalty boundaries; the cost of
    # extra 2D slots is negligible). In 3D, the apparent >32 occupancy that
    # round 1 chased was wall penetrators CLIPPED into edge cells; with
    # margin_cells the true p100 over a full 1M run is 27, so 2.0x
    # headroom (cap 32) suffices and the home_tier at 1.5x makes the top
    # quarter of rows cost only what crowded blocks actually use.
    headroom = 4.5 if dim == 2 else 2.0
    if bcap is None:
        bcap = max(8, (int(math.ceil(headroom * rest_occ)) + 7) // 8 * 8)
    else:
        # Explicit override (skin sweeps): 8-granular rounding only —
        # the caller owns the headroom/overflow tradeoff; overflow is
        # detected at runtime (BinnedState.overflow).
        bcap = max(8, (int(bcap) + 7) // 8 * 8)
    tier = 0 if dim == 2 else max(8, (int(math.ceil(1.5 * rest_occ)) + 7) // 8 * 8)
    # With a tight explicit bcap, 1.5x rest occupancy can reach the cap,
    # which would silently DISABLE the tier split (binned_grid_from_bounds
    # requires 0 < tier < cap). Clamp to cap-8: uncrowded blocks still
    # skip the top row group instead of always paying the full cap.
    if tier >= bcap:
        tier = bcap - 8
    if build_state:
        pos = lattice_block(fluid_lo, fluid_hi, dx)
        st = state_lib.from_positions(
            pos, capacity=capacity, mass=mass, dtype=dtype
        )
    else:
        # Shape-only mode (memory budgeting at 16M+): static grid math
        # without materialising the particle lattice. The capacity math
        # must match the built path, so count lattice sites analytically.
        import numpy as np_

        # mirror lattice_block: sites at lo + dx/2, lo + 3dx/2, ... < hi
        counts = [
            len(np_.arange(lo_ + 0.5 * dx, hi_, dx))
            for lo_, hi_ in zip(fluid_lo, fluid_hi)
        ]
        n_sites = int(np_.prod(counts))
        st = state_lib.allocate(capacity or n_sites, dim, dtype)
    boundary = None
    n_boundary = 0
    if wall_layers > 0:
        bpos = wall_lattice(lo, hi, dx, wall_layers)
        boundary = (
            jnp.asarray(bpos, dtype),
            jnp.full((len(bpos),), mass, dtype),
        )
        n_boundary = len(bpos)
    # ghosts sit outside the AABB: the margin must cover them
    margin = max(2, int(math.ceil(wall_layers * dx / (h * (1 + skin_frac)))) + 1)
    bgrid = nb.binned_grid_from_bounds(
        lo,
        hi,
        h=h,
        cap=bcap,
        skin_frac=skin_frac,
        max_particles=st.capacity + n_boundary,
        axis_order=_gravity_first_order(dim),
        home_tier=tier,
        margin_cells=margin,  # holds wall penetrators + ghost shells
    )
    bgrid = dataclasses.replace(bgrid, n_boundary=n_boundary)
    return Scene(
        name=name, params=params, gspec=gspec, bgrid=bgrid, state=st,
        boundary=boundary,
    )


def dam_break_2d(n_target: int = 4096, dtype=jnp.float32, **overrides) -> Scene:
    """BASELINE config #1: 2D dam break, ~4k particles, WCSPH.

    Fluid column 0.4 x 0.6 in a unit box; dx solved from the target count.
    """
    area = 0.4 * 0.6
    dx = math.sqrt(area / n_target)
    return block_scene(
        name="dam_break_2d",
        dim=2,
        domain=([0.0, 0.0], [1.0, 1.0]),
        fluid_lo=[0.0, 0.0],
        fluid_hi=[0.4, 0.6],
        dx=dx,
        dtype=dtype,
        **overrides,
    )


def emitter_2d(
    n_target: int = 4096,
    emit_speed: float = 1.5,
    dtype=jnp.float32,
    **overrides,
) -> Scene:
    """BASELINE config #2: 2D faucet fill — emitter stream onto a circular
    obstacle, XSPH viscosity, boundary penalty walls."""
    from sph_pie_tpu.scenes import emitter as em_lib
    from sph_pie_tpu.scenes import obstacles as obs_lib

    fill_area = 0.3  # m^2 the stream will eventually fill
    dx = math.sqrt(fill_area / n_target)
    h = 2.0 * dx
    overrides.setdefault("xsph_eps", 0.1)
    overrides.setdefault("viscosity", 0.05)
    rest_density = float(overrides.pop("rest_density", 1000.0))
    mass = lattice_mass(2, h, dx, rest_density)
    sound_speed = float(overrides.pop("sound_speed", 40.0))
    dt = 0.25 * h / sound_speed
    params = make_params(
        dim=2,
        h=h,
        dt=dt,
        rest_density=rest_density,
        sound_speed=sound_speed,
        bound_min=[0.0, 0.0],
        bound_max=[1.0, 1.0],
        dtype=dtype,
        **overrides,
    )
    skin_frac = 0.25
    bcap = max(8, (int(math.ceil(3.0 * ((h * (1 + skin_frac)) / dx) ** 2)) + 7) // 8 * 8)
    gspec = grid_from_bounds([0, 0], [1, 1], cell_size=h, cap=_default_cap(2, h, dx))
    st = state_lib.allocate(n_target, 2, dtype)
    bgrid = nb.binned_grid_from_bounds(
        [0, 0],
        [1, 1],
        h=h,
        cap=bcap,
        skin_frac=skin_frac,
        max_particles=n_target,
        axis_order=_gravity_first_order(2),
        margin_cells=2,
    )
    emitter = em_lib.plan_stream(
        start_index=0,
        capacity=n_target,
        dim=2,
        nozzle_lo=[0.45, 0.92],
        nozzle_hi=[0.55, 0.92 + 0.5 * dx],
        direction=[0.0, -1.0],
        speed=emit_speed,
        dx=dx,
        mass=mass,
        dt=float(dt),
        dtype=dtype,
    )
    obstacles = obs_lib.make(
        2, spheres=[([0.5, 0.5], 0.12)], dtype=dtype
    )
    return Scene(
        name="emitter_2d",
        params=params,
        gspec=gspec,
        bgrid=bgrid,
        state=st,
        obstacles=obstacles,
        emitter=emitter,
    )


def dam_break_3d(n_target: int = 100_000, dtype=jnp.float32, **overrides) -> Scene:
    """BASELINE config #3: 3D dam break with surface tension, ~100k.

    Standard shallow-tank geometry (column at one end of a long tank, free
    surface well below the lid) — the classic experimental configuration,
    and it keeps the cell grid tight around fluid the flow can actually
    reach instead of an empty cube above it.
    """
    vol = 0.3 * 0.4 * 0.6
    dx = (vol / n_target) ** (1.0 / 3.0)
    overrides.setdefault("surface_tension", 0.25)
    overrides.setdefault("xsph_eps", 0.05)
    # skin 0.40 / cap 40: the optimum of a 1M skin sweep on the previous
    # machine, chosen there to fill its 128-wide vector tiles (3*cap = 120)
    # and to halve PBF rebins (1.0 -> 0.5 per step); the GPU sweep is
    # ROADMAP S7. Occupancy is resolution-invariant for this geometry
    # ((cell/dx)^3 fixed by h_over_dx and skin): full-run p100 was 27 at
    # skin 0.25 -> x(1.40/1.25)^3 ~ 38 < 40; overflow is counted at
    # runtime (BinnedState.overflow) and reported by bench.
    if "skin_frac" not in overrides:
        overrides["skin_frac"] = 0.40
        # cap tied to the defaulted skin only: explicit skin sweeps own
        # their cap (auto headroom at 0.40 would pick 48).
        overrides.setdefault("bcap", 40)
    return block_scene(
        name="dam_break_3d",
        dim=3,
        domain=([0.0, 0.0, 0.0], [1.0, 0.4, 0.75]),
        fluid_lo=[0.0, 0.0, 0.0],
        fluid_hi=[0.3, 0.4, 0.6],
        dx=dx,
        dtype=dtype,
        **overrides,
    )


def dam_break_3d_periodic(n_target: int = 50_000, dtype=jnp.float32) -> Scene:
    """3D dam break in a channel periodic along y (the cross-flow axis).

    The r05 multi-chip dryrun leg (config #5 mechanisms x periodic axis):
    the fluid block spans the FULL y extent so the periodic seam carries
    real pair interactions from step one. The y domain length is snapped
    to an exact multiple of the cell size (a periodic axis must tile
    cells — neighbors/binned.py wrap_ghosts images offset by dims*cell).
    Gravity stays on z (make_params default), collapse runs along x;
    walls on x/z remain penalty walls, y walls are masked by the engine.
    """
    vol = 0.3 * 0.4 * 0.6
    dx = (vol / n_target) ** (1.0 / 3.0)
    h = 2.0 * dx
    skin_frac = 0.40
    cell = h * (1.0 + skin_frac)
    ny = max(3, int(round(0.4 / cell)))
    ly = ny * cell * (1.0 - 1e-7)  # epsilon under: ceil(ly/cell) == ny
    lo, hi = [0.0, 0.0, 0.0], [1.0, ly, 0.75]
    rest_density = 1000.0
    sound_speed = 40.0
    params = make_params(
        dim=3,
        h=h,
        dt=0.25 * h / sound_speed,
        rest_density=rest_density,
        sound_speed=sound_speed,
        viscosity=0.05,
        xsph_eps=0.05,
        surface_tension=0.25,
        bound_min=lo,
        bound_max=hi,
        dtype=dtype,
    )
    pos = lattice_block([0.0, 0.0, 0.0], [0.3, ly, 0.6], dx)
    state = state_lib.from_positions(
        pos,
        capacity=pos.shape[0],
        mass=lattice_mass(3, h, dx, rest_density),
        dtype=dtype,
    )
    bgrid = nb.binned_grid_from_bounds(
        lo,
        hi,
        h=h,
        cap=40,
        skin_frac=skin_frac,
        max_particles=state.capacity,
        periodic=(False, True, False),
    )
    assert bgrid.dims[1] == ny, (bgrid.dims, ny)
    return Scene(
        name="dam_break_3d_periodic",
        params=params,
        gspec=grid_from_bounds(lo, hi, cell_size=h, cap=_default_cap(3, h, dx)),
        bgrid=bgrid,
        state=state,
    )
