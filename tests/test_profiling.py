"""Trace summary of utils/profiling.py: interval union and a real trace."""

import jax
import jax.numpy as jnp
import pytest

from sph_pie_tpu.utils import profiling


@pytest.mark.parametrize(
    "intervals, want",
    [
        ([], 0),
        ([(0, 10), (20, 25)], 15),  # disjoint
        ([(0, 10), (5, 12), (30, 31)], 13),  # overlapping
        ([(10, 20), (0, 100), (40, 50)], 100),  # nested, unsorted
    ],
)
def test_busy_ns_is_interval_union(intervals, want):
    assert profiling.busy_ns(intervals) == want


def test_trace_steps_summarizes_a_cpu_trace(tmp_path):
    """The CPU backend has no device plane, so the summary reads the
    host plane; on a GPU the default prefix selects the CUDA streams."""
    f = jax.jit(lambda x: jnp.cumsum(jnp.sin(x)) * 2.0)
    x = jnp.ones((4096,))
    f(x).block_until_ready()

    res = profiling.trace_steps(
        lambda: f(x), 2, str(tmp_path), plane_prefix="/host:CPU"
    )
    assert res["steps"] == 2
    assert res["untraced_ms_per_step"] > 0
    lines = res["lines"]
    assert lines and all(ln["plane"] == "/host:CPU" for ln in lines)
    for ln in lines:
        assert ln["events"] >= 1
        assert ln["events_per_step"] == ln["events"] / 2
        assert 0.0 <= ln["idle_share"] <= 1.0
        assert ln["busy_ms"] <= ln["window_ms"] + 1e-9
        assert ln["top"] and ln["top"][0]["ms_per_step"] >= ln["top"][-1]["ms_per_step"]
    # no device plane on the CPU backend
    assert profiling.summarize_trace(str(tmp_path), 2) == []


def test_summarize_trace_without_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path), 1)
