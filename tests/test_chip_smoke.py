"""chip_smoke.py on the CPU: it must refuse to run, and its state check
must pass healthy runs and reject broken ones."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from sph_pie_tpu.scenes import dam_break_2d, dam_break_3d
from sph_pie_tpu.solvers import pbf, wcsph_binned
from sph_pie_tpu.utils.struct import replace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_run_exits_nonzero_without_result():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "'cpu'" in proc.stderr


def _tiny_run(solver: str, dim: int):
    """A short CPU run long enough to cross at least one rebin."""
    if dim == 2:
        scene, wsteps = dam_break_2d(n_target=300), 200
    else:
        scene, wsteps = dam_break_3d(n_target=500), 100
    b = scene.binned_state()
    if solver == "wcsph":
        b = wcsph_binned.simulate(scene.params, scene.bgrid, b, wsteps)
    else:
        b = pbf.simulate(scene.params, scene.bgrid, pbf.flagship_params(), b, 10)
    return scene, b


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("solver", ["wcsph", "pbf"])
def test_state_check_passes_tiny_run(solver, dim):
    scene, b = _tiny_run(solver, dim)
    n0, mass0 = chip_smoke.initial_inventory(scene)
    got = chip_smoke.check_state(scene, b, n0, mass0)
    assert got["overflow"] == 0
    assert got["n_active"] == n0
    assert got["rebins"] >= 1


def _break(kind: str, scene, b):
    """Corrupt one particle (the one in compact row 0) of a healthy state."""
    slot = int(b.slot_of[0])
    h = float(scene.params.h)
    if kind == "nan":
        return replace(b, pos=b.pos.at[slot, 0].set(jnp.nan))
    if kind == "out_of_box":
        far = float(np.asarray(scene.params.bound_max)[0]) + 10 * h
        return replace(b, pos=b.pos.at[slot, 0].set(far))
    if kind == "overflow":
        return replace(b, overflow=jnp.ones_like(b.overflow))
    assert kind == "lost"
    return replace(b, slot_of=b.slot_of.at[0].set(scene.bgrid.num_slots))


@pytest.mark.parametrize(
    "kind, match",
    [
        ("nan", "non-finite"),
        ("out_of_box", "outside the domain"),
        ("overflow", "overflow"),
        ("lost", "particle count changed"),
    ],
)
def test_state_check_rejects_broken_state(kind, match):
    scene, b = _tiny_run("pbf", 2)
    n0, mass0 = chip_smoke.initial_inventory(scene)
    chip_smoke.check_state(scene, b, n0, mass0)  # healthy first
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.check_state(scene, _break(kind, scene, b), n0, mass0)
