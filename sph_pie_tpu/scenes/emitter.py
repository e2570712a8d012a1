"""Emitters: pre-scheduled particle spawning with static shapes.

Static-shape emission: the scene is allocated at its final particle count and
every future particle has a precomputed (spawn_step, pos, vel, mass). Until
its step arrives a particle is simply inactive (never binned, zero cost).
Activation happens at epoch boundaries of the run loop
(``solvers/run.py``) on the compact flat state — no dynamic shapes ever.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sph_pie_tpu.core.state import ParticleState
from sph_pie_tpu.utils.struct import pytree_dataclass, replace


@pytree_dataclass
class EmitterSchedule:
    """Per-particle spawn plan. spawn_step < 0 means "never" (slot unused
    by the emitter; e.g. particles active from t=0)."""

    spawn_step: jax.Array  # [K] int32
    spawn_pos: jax.Array   # [K, dim]
    spawn_vel: jax.Array   # [K, dim]
    spawn_mass: jax.Array  # [K]


def no_emitter(capacity: int, dim: int, dtype=jnp.float32) -> EmitterSchedule:
    return EmitterSchedule(
        spawn_step=jnp.full((capacity,), -1, jnp.int32),
        spawn_pos=jnp.zeros((capacity, dim), dtype),
        spawn_vel=jnp.zeros((capacity, dim), dtype),
        spawn_mass=jnp.zeros((capacity,), dtype),
    )


def emit_due(
    state: ParticleState, em: EmitterSchedule, step_count
) -> ParticleState:
    """Activate every not-yet-active particle whose spawn step has arrived."""
    due = (em.spawn_step >= 0) & (em.spawn_step <= step_count) & (~state.active)
    d2 = due[:, None]
    return replace(
        state,
        pos=jnp.where(d2, em.spawn_pos, state.pos),
        vel=jnp.where(d2, em.spawn_vel, state.vel),
        mass=jnp.where(due, em.spawn_mass, state.mass),
        active=state.active | due,
    )


def merge_schedules(schedules: list[EmitterSchedule]) -> EmitterSchedule:
    """Combine emitters occupying DISJOINT slot ranges into one schedule
    (unused slots have spawn_step == -1, so an elementwise latest-wins
    select is exact for disjoint plans)."""
    out = schedules[0]
    for s in schedules[1:]:
        use = s.spawn_step >= 0
        out = EmitterSchedule(
            spawn_step=jnp.where(use, s.spawn_step, out.spawn_step),
            spawn_pos=jnp.where(use[:, None], s.spawn_pos, out.spawn_pos),
            spawn_vel=jnp.where(use[:, None], s.spawn_vel, out.spawn_vel),
            spawn_mass=jnp.where(use, s.spawn_mass, out.spawn_mass),
        )
    return out


def plan_stream(
    *,
    start_index: int,
    capacity: int,
    dim: int,
    nozzle_lo,
    nozzle_hi,
    direction,
    speed: float,
    dx: float,
    mass: float,
    dt: float,
    t_start: float = 0.0,
    t_end: float = np.inf,
    n_slots: int | None = None,
    dtype=jnp.float32,
) -> EmitterSchedule:
    """Continuous stream: rows of particles across the nozzle cross-section,
    one row every dx/speed seconds, moving along ``direction`` at ``speed``.

    Fills schedule slots [start_index, capacity); the stream stops when slots
    run out or t_end is reached.
    """
    nozzle_lo = np.asarray(nozzle_lo, float)
    nozzle_hi = np.asarray(nozzle_hi, float)
    direction = np.asarray(direction, float)
    direction = direction / np.linalg.norm(direction)

    # Cross-section lattice across the nozzle (the nozzle AABB is thin along
    # the flow direction; we lattice its full extent).
    axes = [
        np.arange(lo + 0.5 * dx, hi, dx) if hi - lo > dx else np.array([(lo + hi) / 2])
        for lo, hi in zip(nozzle_lo, nozzle_hi)
    ]
    mesh = np.meshgrid(*axes, indexing="ij")
    row = np.stack([m.reshape(-1) for m in mesh], axis=-1)  # [R, dim]
    per_row = row.shape[0]
    row_interval = max(1, int(round(dx / speed / dt)))

    budget = capacity - start_index
    n_slots = budget if n_slots is None else min(int(n_slots), budget)
    n_rows = n_slots // per_row
    steps = []
    pos = []
    first_step = int(round(t_start / dt))
    last_step = int(t_end / dt) if np.isfinite(t_end) else None
    for r in range(n_rows):
        s = first_step + r * row_interval
        if last_step is not None and s > last_step:
            break
        steps.append(np.full(per_row, s, np.int32))
        pos.append(row)
    if not steps:
        return no_emitter(capacity, dim, dtype)
    steps = np.concatenate(steps)
    pos = np.concatenate(pos)
    n = len(steps)

    spawn_step = np.full(capacity, -1, np.int32)
    spawn_pos = np.zeros((capacity, dim))
    spawn_vel = np.zeros((capacity, dim))
    spawn_mass = np.zeros(capacity)
    end = start_index + n
    spawn_step[start_index:end] = steps
    spawn_pos[start_index:end] = pos
    spawn_vel[start_index:end] = direction * speed
    spawn_mass[start_index:end] = mass
    return EmitterSchedule(
        spawn_step=jnp.asarray(spawn_step),
        spawn_pos=jnp.asarray(spawn_pos, dtype),
        spawn_vel=jnp.asarray(spawn_vel, dtype),
        spawn_mass=jnp.asarray(spawn_mass, dtype),
    )
