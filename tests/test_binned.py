"""Binned dense engine: layout round-trips + trajectory parity vs oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sph_pie_tpu.neighbors import binned as nb
from sph_pie_tpu.oracle import oracle_from_scene
from sph_pie_tpu.scenes import builders
from sph_pie_tpu.solvers import wcsph, wcsph_binned


def _small_scene(dtype=jnp.float32, **over):
    over.setdefault("viscosity", 0.05)
    return builders.dam_break_2d(n_target=400, dtype=dtype, **over)


def test_bin_unbin_roundtrip():
    scene = _small_scene()
    b = scene.binned_state()
    assert int(b.overflow) == 0
    st2 = nb.unbin(scene.bgrid, b, scene.state.capacity)
    np.testing.assert_array_equal(np.asarray(st2.active), np.asarray(scene.state.active))
    np.testing.assert_allclose(np.asarray(st2.pos), np.asarray(scene.state.pos))
    np.testing.assert_allclose(np.asarray(st2.mass), np.asarray(scene.state.mass))


def test_empty_slots_are_massless():
    scene = _small_scene()
    b = scene.binned_state()
    mass = np.asarray(b.mass)
    valid = np.asarray(b.valid)
    assert (mass[~valid] == 0.0).all()
    assert (np.asarray(b.owner)[~valid] == -1).all()
    assert valid.sum() == int(scene.state.n_active())


def test_rebin_preserves_particles():
    scene = _small_scene()
    b = scene.binned_state()
    b2 = nb.rebin(scene.bgrid, b)
    assert int(b2.overflow) == 0
    st = nb.unbin(scene.bgrid, b, scene.state.capacity)
    st2 = nb.unbin(scene.bgrid, b2, scene.state.capacity)
    np.testing.assert_allclose(np.asarray(st.pos), np.asarray(st2.pos))
    assert float(b2.travel) == 0.0


@pytest.mark.heavy  # compile-heavy f64 gate (~34 s on the 1-CPU mesh);
# the default tier keeps test_binned_matches_naive_engine_f32 on the same
# engine path
def test_binned_matches_oracle_f64():
    with jax.enable_x64():
        scene = _small_scene(dtype=jnp.float64)
        b = scene.binned_state()
        for _ in range(100):
            b = wcsph_binned.step(scene.params, scene.bgrid, b)
        assert int(b.overflow) == 0
        st = nb.unbin(scene.bgrid, b, scene.state.capacity)
        got = np.asarray(st.pos)[np.asarray(st.active)]
        want = oracle_from_scene(scene, dtype=np.float64).run(100)
        err = np.abs(got - want).max()
        assert err < 1e-6, f"binned engine drift vs oracle: {err}"


def test_binned_matches_naive_engine_f32():
    scene = _small_scene(dtype=jnp.float32)
    b = scene.binned_state()
    st_naive = scene.state
    for _ in range(50):
        b = wcsph_binned.step(scene.params, scene.bgrid, b)
        st_naive = wcsph.step(scene.params, scene.gspec, st_naive)
    st = nb.unbin(scene.bgrid, b, scene.state.capacity)
    act = np.asarray(st.active)
    err = np.abs(np.asarray(st.pos)[act] - np.asarray(st_naive.pos)[act]).max()
    # identical math, different summation order -> f32 noise only
    assert err < 1e-4, f"binned vs naive engines diverge: {err}"


def test_simulate_binned_rolls_on_device():
    scene = _small_scene()
    b = wcsph_binned.simulate(scene.params, scene.bgrid, scene.binned_state(), 300)
    assert int(b.overflow) == 0
    st = nb.unbin(scene.bgrid, b, scene.state.capacity)
    pos = np.asarray(st.pos)[np.asarray(st.active)]
    assert np.isfinite(pos).all()
    pad = 5 * float(scene.params.h)
    assert (pos > np.asarray(scene.params.bound_min) - pad).all()
    assert (pos < np.asarray(scene.params.bound_max) + pad).all()


def test_slab_windows_cover_neighbor_cells():
    """Every particle pair within h must share a (home cell, window) slab."""
    rng = np.random.default_rng(3)
    n, h = 200, 0.11
    pos = jnp.asarray(rng.uniform(0, 1, (n, 2)), jnp.float32)
    grid = nb.binned_grid_from_bounds([0, 0], [1, 1], h=h, cap=64, skin_frac=0.5)
    from sph_pie_tpu.core import state as state_lib

    st = state_lib.from_positions(pos, mass=1.0)
    b = nb.bin_state(grid, st)
    assert int(b.overflow) == 0

    # Count, per home particle, candidate appearances of each owner.
    owners_home = nb.cell_view(grid, b.owner)        # [C, cap]
    found = np.zeros((n, n), bool)
    for w in nb.slab_windows(grid, b.owner):
        oh = np.asarray(owners_home)                  # [C, cap]
        ow = np.asarray(w)                            # [C, 3cap]
        for c in range(oh.shape[0]):
            hs = oh[c][oh[c] >= 0]
            ws = ow[c][ow[c] >= 0]
            for i in hs:
                found[i, ws] = True
    d = np.asarray(pos)[:, None] - np.asarray(pos)[None, :]
    true_pairs = (d**2).sum(-1) < h * h
    assert not (true_pairs & ~found).any()


@pytest.mark.heavy
def test_symmetric_fold_matches_one_sided():
    """Newton's-3rd-law fold == one-sided fold (both passes, fp tolerance)."""
    import dataclasses

    from sph_pie_tpu.kernels import eos
    from sph_pie_tpu.scenes import dam_break_2d, dam_break_3d
    from sph_pie_tpu.solvers import wcsph_binned
    from sph_pie_tpu.utils.struct import replace as srep

    for scene in (dam_break_2d(n_target=900), dam_break_3d(n_target=2000)):
        g_sym = dataclasses.replace(scene.bgrid, symmetric_fold=True)
        g_one = dataclasses.replace(scene.bgrid, symmetric_fold=False)
        b = scene.binned_state()
        # run a few steps first so velocities/pressures are nontrivial
        b = wcsph_binned.simulate(scene.params, g_one, b, 20)

        valid = np.asarray(b.valid)
        rho_s = np.asarray(wcsph_binned._density(scene.params, g_sym, b))
        rho_o = np.asarray(wcsph_binned._density(scene.params, g_one, b))
        np.testing.assert_allclose(rho_s[valid], rho_o[valid], rtol=2e-5)

        rho = wcsph_binned._density(scene.params, g_one, b)
        b2 = srep(b, density=rho, pressure=eos.tait_pressure(scene.params, rho))
        acc_s, xs_s = wcsph_binned._forces(scene.params, g_sym, b2)
        acc_o, xs_o = wcsph_binned._forces(scene.params, g_one, b2)
        # compare valid slots only: empty slots accumulate (ignored)
        # garbage that differs between the two pairing orders
        da = np.abs(np.asarray(acc_s) - np.asarray(acc_o))[valid]
        scale = float(np.abs(np.asarray(acc_o)[valid]).max()) or 1.0
        assert da.max() / scale < 3e-5
        dx = np.abs(np.asarray(xs_s) - np.asarray(xs_o))[valid]
        xscale = float(np.abs(np.asarray(xs_o)[valid]).max())
        assert dx.max() / max(xscale, 1e-12) < 3e-5


@pytest.mark.heavy
def test_adaptive_rows_fold_matches_static():
    """Per-block dynamic home-row fold == static fold (fp-tiling tolerance)."""
    import dataclasses

    from sph_pie_tpu.kernels import eos
    from sph_pie_tpu.scenes import dam_break_2d, dam_break_3d
    from sph_pie_tpu.solvers import wcsph_binned
    from sph_pie_tpu.utils.struct import replace as srep

    for scene in (dam_break_2d(n_target=900), dam_break_3d(n_target=2000)):
        g_ad = dataclasses.replace(scene.bgrid, adaptive_rows=8)
        g_st = dataclasses.replace(
            scene.bgrid, adaptive_rows=0, home_tier=0
        )
        b = scene.binned_state()
        b = wcsph_binned.simulate(scene.params, g_st, b, 20)

        valid = np.asarray(b.valid)
        rho_a = np.asarray(wcsph_binned._density(scene.params, g_ad, b))
        rho_s = np.asarray(wcsph_binned._density(scene.params, g_st, b))
        # segments partition home rows; only XLA's reduction tiling
        # differs between the [blk,seg,*] and [blk,cap,*] shapes
        np.testing.assert_allclose(rho_a[valid], rho_s[valid], rtol=1e-6)

        rho = wcsph_binned._density(scene.params, g_st, b)
        b2 = srep(
            b, density=rho, pressure=eos.tait_pressure(scene.params, rho)
        )
        acc_a, xs_a = wcsph_binned._forces(scene.params, g_ad, b2)
        acc_s, xs_s = wcsph_binned._forces(scene.params, g_st, b2)
        scale = float(np.abs(np.asarray(acc_s)[valid]).max()) or 1.0
        assert (
            np.abs(np.asarray(acc_a) - np.asarray(acc_s))[valid].max() / scale
            < 1e-6
        )
        xscale = max(float(np.abs(np.asarray(xs_s)[valid]).max()), 1e-12)
        assert (
            np.abs(np.asarray(xs_a) - np.asarray(xs_s))[valid].max() / xscale
            < 1e-6
        )


@pytest.mark.heavy
def test_window_modes_match_concat():
    """window_mode split/mega == concat (same pairs, different window
    shapes handed to pair_fn)."""
    import dataclasses

    from sph_pie_tpu.kernels import eos
    from sph_pie_tpu.scenes import dam_break_2d, dam_break_3d
    from sph_pie_tpu.solvers import wcsph_binned
    from sph_pie_tpu.utils.struct import replace as srep

    for scene in (dam_break_2d(n_target=900), dam_break_3d(n_target=2000)):
        grids = {
            m: dataclasses.replace(
                scene.bgrid, window_mode=m
            )
            for m in ("concat", "split", "mega")
        }
        b = scene.binned_state()
        b = wcsph_binned.simulate(scene.params, grids["concat"], b, 20)
        valid = np.asarray(b.valid)

        rho = {
            m: np.asarray(wcsph_binned._density(scene.params, g, b))
            for m, g in grids.items()
        }
        b2 = srep(
            b,
            density=jnp.asarray(rho["concat"]),
            pressure=eos.tait_pressure(scene.params, jnp.asarray(rho["concat"])),
        )
        acc = {
            m: np.asarray(wcsph_binned._forces(scene.params, g, b2)[0])
            for m, g in grids.items()
        }
        scale = float(np.abs(acc["concat"][valid]).max()) or 1.0
        for m in ("split", "mega"):
            np.testing.assert_allclose(
                rho[m][valid], rho["concat"][valid], rtol=1e-6
            )
            assert (
                np.abs(acc[m] - acc["concat"])[valid].max() / scale < 1e-6
            ), m


@pytest.mark.heavy
def test_skin_invariance_density_forces():
    """Cell size (h + skin) must not change the physics: the fold visits
    every pair within h regardless of how particles land in cells, so
    density/forces on the SAME configuration under skin 0.25 (cap 32) and
    skin 0.40 (bcap 40 — the default 3D geometry) may differ only by summation order (fp reassoc)."""
    from sph_pie_tpu.kernels import eos
    from sph_pie_tpu.scenes import dam_break_3d
    from sph_pie_tpu.utils.struct import replace as srep

    scene = dam_break_3d(n_target=2000)
    # settle a few steps in the incumbent grid so the configuration is
    # irregular (lattice states hide pair-ordering differences)
    b = scene.binned_state()
    b = wcsph_binned.simulate(scene.params, scene.bgrid, b, 15)
    st = nb.unbin(scene.bgrid, b, scene.state.capacity)

    out = {}
    for label, kw in (
        ("s25", dict(skin_frac=0.25)),
        ("s40", dict(skin_frac=0.40, bcap=40)),
    ):
        sc = dam_break_3d(n_target=2000, **kw)
        assert sc.bgrid.cap == (32 if label == "s25" else 40)
        bb = nb.bin_state(sc.bgrid, st, sc.boundary)
        assert int(bb.overflow) == 0, label
        rho = wcsph_binned._density(sc.params, sc.bgrid, bb)
        bb = srep(
            bb,
            density=rho,
            pressure=eos.tait_pressure(sc.params, rho),
        )
        acc = wcsph_binned._forces(sc.params, sc.bgrid, bb)[0]
        s2 = nb.unbin(sc.bgrid, bb, st.capacity)
        act = np.asarray(s2.active)
        # per-owner order via unbin for rho; acc needs the slot gather
        safe = np.clip(np.asarray(bb.slot_of)[: st.capacity], 0, sc.bgrid.num_slots - 1)
        out[label] = (
            np.asarray(s2.density)[act],
            np.asarray(acc)[safe][act],
        )

    rho25, acc25 = out["s25"]
    rho40, acc40 = out["s40"]
    np.testing.assert_allclose(rho40, rho25, rtol=1e-5)
    # Forces see catastrophic cancellation of near-singular pair terms, so
    # reassociation noise is larger than density's (measured 3.6e-4 of the
    # max accel); a genuinely dropped pair shows at >= 1e-1 of scale.
    scale = float(np.abs(acc25).max()) or 1.0
    assert np.abs(acc40 - acc25).max() / scale < 1e-3


@pytest.mark.heavy
def test_scan_unroll_matches_default():
    """scan_unroll only changes how many block bodies share a while
    iteration — summation order is identical, so density/forces must
    match EXACTLY (not just to fp noise)."""
    import dataclasses

    from sph_pie_tpu.scenes import dam_break_3d

    scene = dam_break_3d(n_target=3000)
    b = scene.binned_state()
    g1 = scene.bgrid
    rho1 = np.asarray(wcsph_binned._density(scene.params, g1, b))
    for k in (2, 4):
        gk = dataclasses.replace(scene.bgrid, scan_unroll=k)
        rhok = np.asarray(wcsph_binned._density(scene.params, gk, b))
        np.testing.assert_array_equal(rhok, rho1)
