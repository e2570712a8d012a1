"""BASELINE trajectory contract, full scale: 2D dam break ~4k particles,
1000 steps, engine (binned, f64) vs the native CPU oracle, tolerance 1e-3.

Run: python -u scripts/verify_trajectory.py   (or: python -m sph_pie_tpu verify)
Exits non-zero on contract violation (the reference's harness discipline:
self-asserting scripts — SURVEY.md §4).
"""

import os as _os, sys as _sys  # bare-runnable: repo root on sys.path
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from sph_pie_tpu import native
from sph_pie_tpu.neighbors import binned as nb
from sph_pie_tpu.oracle import oracle_from_scene
from sph_pie_tpu.scenes import builders
from sph_pie_tpu.solvers import wcsph_binned

STEPS = 1000
TOL = 1e-3


def main() -> int:
    with jax.enable_x64():
        scene = builders.dam_break_2d(n_target=4096, dtype=jnp.float64)
        n = int(scene.state.n_active())
        print(f"engine: {n} particles, {STEPS} steps (f64)...", flush=True)
        t0 = time.time()
        b = wcsph_binned.simulate(
            scene.params, scene.bgrid, scene.binned_state(), STEPS
        )
        overflow = int(b.overflow)
        print(f"engine done in {time.time()-t0:.0f}s overflow={overflow}", flush=True)
        st = nb.unbin(scene.bgrid, b, scene.state.capacity)
        got = np.asarray(st.pos)[np.asarray(st.active)]

        py = oracle_from_scene(scene, dtype=np.float64)
        t0 = time.time()
        if native.available():
            print("oracle: native C++ ...", flush=True)
            want, _ = native.oracle_run(scene.params, py.pos, py.vel, py.mass, STEPS)
        else:
            print("oracle: NumPy fallback (slow) ...", flush=True)
            want = py.run(STEPS)
        print(f"oracle done in {time.time()-t0:.0f}s", flush=True)

    err = float(np.abs(got - want).max())
    rms = float(np.sqrt(((got - want) ** 2).mean()))
    ok = err < TOL and overflow == 0
    print(f"max |dx| = {err:.3e}  rms = {rms:.3e}  tol = {TOL}  -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
