"""The engine has no matrix product, so no float32 product can run in
TF32 on the GPU: only the order of sums differs between devices."""

import jax
import pytest

from sph_pie_tpu.scenes import dam_break_3d
from sph_pie_tpu.solvers import pbf, wcsph_binned


@pytest.mark.parametrize("solver", ["wcsph", "pbf"])
def test_step_has_no_dot(solver):
    scene = dam_break_3d(n_target=500)
    b = scene.binned_state()
    if solver == "wcsph":
        jaxpr = jax.make_jaxpr(
            lambda bb: wcsph_binned.step(scene.params, scene.bgrid, bb)
        )(b)
    else:
        pp = pbf.flagship_params()
        jaxpr = jax.make_jaxpr(
            lambda bb: pbf.step(scene.params, scene.bgrid, pp, bb)
        )(b)
    text = str(jaxpr)
    assert "dot_general" not in text and "conv_general" not in text
