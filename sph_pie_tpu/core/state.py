"""Struct-of-arrays particle state.

The reference keeps its hot mutable state in a single central object
(`public/app.js:116-180` in sphereisaiahmin-dev/sph-pie); the JAX
analogue is a struct-of-arrays pytree living in device memory: every field
is a ``[capacity, ...]`` ``jax.Array`` with a static capacity and an
``active`` mask, so every step of the simulation is static-shape (a hard
requirement for ``jit`` + ``lax.fori_loop`` rolling).

Inactive slots (``active == False``) are used by emitters: a scene is
allocated at its maximum particle count and emitters flip slots on over
time without any reshape/recompile.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sph_pie_tpu.utils.struct import pytree_dataclass, replace


@pytree_dataclass
class ParticleState:
    """SoA particle state. All arrays share leading dim = capacity."""

    pos: jax.Array       # [N, dim] position
    vel: jax.Array       # [N, dim] velocity
    mass: jax.Array      # [N]      per-particle mass
    density: jax.Array   # [N]      most recent SPH density estimate
    pressure: jax.Array  # [N]      most recent EOS pressure
    active: jax.Array    # [N]      bool, slot carries a live particle

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]

    @property
    def dtype(self):
        return self.pos.dtype

    def n_active(self) -> jax.Array:
        return jnp.sum(self.active.astype(jnp.int32))


def allocate(capacity: int, dim: int, dtype=jnp.float32) -> ParticleState:
    """All-inactive state with static capacity."""
    return ParticleState(
        pos=jnp.zeros((capacity, dim), dtype),
        vel=jnp.zeros((capacity, dim), dtype),
        mass=jnp.zeros((capacity,), dtype),
        density=jnp.zeros((capacity,), dtype),
        pressure=jnp.zeros((capacity,), dtype),
        active=jnp.zeros((capacity,), jnp.bool_),
    )


def from_positions(
    pos,
    *,
    capacity: int | None = None,
    vel=None,
    mass: float | jax.Array = 1.0,
    dtype=jnp.float32,
) -> ParticleState:
    """Build a state from an [n, dim] position array, padding to capacity."""
    pos = jnp.asarray(pos, dtype)
    n, dim = pos.shape
    cap = int(capacity) if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < particle count {n}")
    st = allocate(cap, dim, dtype)
    vel = jnp.zeros_like(pos) if vel is None else jnp.asarray(vel, dtype)
    mass_arr = jnp.broadcast_to(jnp.asarray(mass, dtype), (n,))
    st = replace(
        st,
        pos=st.pos.at[:n].set(pos),
        vel=st.vel.at[:n].set(vel),
        mass=st.mass.at[:n].set(mass_arr),
        active=st.active.at[:n].set(True),
    )
    return st


def astype(state: ParticleState, dtype) -> ParticleState:
    """Cast all float fields to ``dtype`` (active mask stays bool)."""
    cast = lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x
    return jax.tree.map(cast, state)
