"""Quick WCSPH timing: 2D 4k, 3D 100k and 3D 1M dam breaks, one line each.

Run: python scripts/bench_quick.py   (on the GPU; bench.py is the full
benchmark). Each line names the device it ran on.
"""

import os as _os, sys as _sys  # bare-runnable: repo root on sys.path
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import time

import jax

from sph_pie_tpu.scenes import dam_break_2d, dam_break_3d
from sph_pie_tpu.solvers import wcsph_binned
from sph_pie_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
dev = jax.devices()[0]
for scene, steps in ((dam_break_2d(4096), 2000), (dam_break_3d(100_000), 200), (dam_break_3d(1_000_000), 20)):
    g = scene.bgrid
    b = jax.block_until_ready(wcsph_binned.simulate(scene.params, g, scene.binned_state(), 2))
    t0 = time.time()
    b = jax.block_until_ready(wcsph_binned.simulate(scene.params, g, b, steps))
    w = time.time() - t0
    n = int(scene.state.n_active())
    print(f"[{dev.platform} {dev.device_kind}] {scene.name} N={n} cells={g.num_cells} cap={g.cap}: "
          f"{w/steps*1e3:.2f} ms/step -> {n*steps/w:.3g} particle-steps/s overflow={int(b.overflow)}", flush=True)
