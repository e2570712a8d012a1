"""WCSPH engine vs the CPU oracle (SURVEY.md §7.3 oracle-integration archetype).

The float64 test checks the JAX engine's math is *identical* to the
documented oracle (only summation-order noise); the float32 test checks the
production dtype tracks the f64 oracle within the BASELINE-style tolerance
on a shorter horizon. The full 4k/1k-step contract run lives in
scripts/verify_trajectory.py (marked slow here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sph_pie_tpu.oracle import oracle_from_scene
from sph_pie_tpu.scenes import builders
from sph_pie_tpu.solvers import wcsph


def _small_scene(dtype=jnp.float32, **over):
    over.setdefault("viscosity", 0.05)
    return builders.dam_break_2d(n_target=400, dtype=dtype, **over)


def test_engine_matches_oracle_f64():
    with jax.enable_x64():
        scene = _small_scene(dtype=jnp.float64)
        st = scene.state
        for _ in range(100):
            st = wcsph.step(scene.params, scene.gspec, st)
        got = np.asarray(st.pos)[np.asarray(st.active)]
        oracle = oracle_from_scene(scene, dtype=np.float64)
        want = oracle.run(100)
        err = np.abs(got - want).max()
        assert err < 1e-6, f"max |dx| = {err}"


def test_engine_f32_tracks_oracle():
    scene = _small_scene(dtype=jnp.float32)
    st = scene.state
    steps = 100
    for _ in range(steps):
        st = wcsph.step(scene.params, scene.gspec, st)
    got = np.asarray(st.pos)[np.asarray(st.active)]
    oracle = oracle_from_scene(scene, dtype=np.float64)
    want = oracle.run(steps)
    err = np.abs(got - want).max()
    assert err < 1e-3, f"f32 drift vs f64 oracle: max |dx| = {err}"


def test_simulate_rolls_and_stays_finite():
    scene = _small_scene()
    st = wcsph.simulate(scene.params, scene.gspec, scene.state, 300)
    pos = np.asarray(st.pos)[np.asarray(st.active)]
    assert np.isfinite(pos).all()
    # Particles stay within (slightly padded) domain walls.
    pad = 5 * float(scene.params.h)
    assert (pos > np.asarray(scene.params.bound_min) - pad).all()
    assert (pos < np.asarray(scene.params.bound_max) + pad).all()


def test_trajectory_recording_shape():
    scene = _small_scene()
    st, traj = wcsph.simulate_trajectory(
        scene.params, scene.gspec, scene.state, n_steps=20, record_every=5
    )
    assert traj.shape == (4, scene.state.capacity, 2)
    np.testing.assert_allclose(np.asarray(traj[-1]), np.asarray(st.pos))


def test_density_near_rest_at_start():
    """lattice_mass calibration: initial density ~ rest density in the bulk."""
    scene = _small_scene()
    from sph_pie_tpu.neighbors import grid as nbr

    cl = nbr.build(scene.gspec, scene.state.pos, scene.state.active)
    rho = np.asarray(
        wcsph.compute_density(scene.params, scene.gspec, cl, scene.state)
    )[np.asarray(scene.state.active)]
    rho0 = float(scene.params.rest_density)
    # median particle (bulk) within 2% of rest density; surface particles lower
    assert abs(np.median(rho) / rho0 - 1.0) < 0.02


@pytest.mark.slow
def test_full_contract_4k_1000_steps():
    """BASELINE contract: 2D dam break ~4k, 1k steps, 1e-3 vs CPU oracle.

    Uses the production binned engine and the native C++ oracle when built
    (tests/test_native_oracle.py proves native == NumPy to 1e-9)."""
    from sph_pie_tpu import native
    from sph_pie_tpu.neighbors import binned as nb
    from sph_pie_tpu.solvers import wcsph_binned

    with jax.enable_x64():
        scene = builders.dam_break_2d(n_target=4096, dtype=jnp.float64)
        b = wcsph_binned.simulate(
            scene.params, scene.bgrid, scene.binned_state(), 1000
        )
        assert int(b.overflow) == 0
        st = nb.unbin(scene.bgrid, b, scene.state.capacity)
        got = np.asarray(st.pos)[np.asarray(st.active)]
        oracle = oracle_from_scene(scene, dtype=np.float64)
        if native.available():
            want, _ = native.oracle_run(
                scene.params, oracle.pos, oracle.vel, oracle.mass, 1000
            )
        else:
            want = oracle.run(1000)
        err = np.abs(got - want).max()
        assert err < 1e-3, f"contract violated: max |dx| = {err}"
