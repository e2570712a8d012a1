"""Device-memory budget accounting for BASELINE config #5 (16M)."""

import pytest

from sph_pie_tpu.utils import membudget
from sph_pie_tpu.utils.membudget import budget, dam_break_budget

GIB = 1 << 30


class _FakeDevice:
    platform = "gpu"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_capacity_read_from_memory_stats():
    dev = _FakeDevice({"bytes_limit": 60 * GIB, "peak_bytes_in_use": 1})
    assert membudget.device_capacity_bytes(dev) == 60 * GIB


@pytest.mark.parametrize("stats", [None, {"peak_bytes_in_use": 1}])
def test_no_known_capacity_is_an_error(stats):
    with pytest.raises(ValueError, match="no memory capacity"):
        membudget.device_capacity_bytes(_FakeDevice(stats))
    if stats is None:  # the CPU backend reports none: budget() must say so
        with pytest.raises(ValueError, match="no memory capacity"):
            dam_break_budget(100_000)


def test_16m_fits_one_80gib_card_but_not_one_16gib_card():
    b80 = dam_break_budget(16_000_000, n_devices=1, hbm_bytes=80 * GIB)
    assert b80.fits, b80.row()
    # sanity: the dominant term is the dense slot state
    assert b80.dense_state_bytes >= b80.num_slots * 40
    b16 = dam_break_budget(16_000_000, n_devices=1, hbm_bytes=16 * GIB)
    assert not b16.fits, b16.row()
    # and it shards: 8 devices of 16 GiB hold it
    assert dam_break_budget(16_000_000, n_devices=8, hbm_bytes=16 * GIB).fits


def test_budget_matches_shape_math_at_small_n():
    """The analytical budget uses the SAME static grid the engine builds."""
    from sph_pie_tpu.scenes import dam_break_3d

    scene = dam_break_3d(n_target=50_000)
    b = budget(scene.bgrid, 50_000, hbm_bytes=80 * GIB)
    assert b.num_slots == scene.bgrid.num_slots
    assert b.fits


def test_shape_only_scene_matches_built_capacity():
    from sph_pie_tpu.scenes import dam_break_3d

    a = dam_break_3d(n_target=30_000)
    b = dam_break_3d(n_target=30_000, build_state=False)
    assert a.state.capacity == b.state.capacity
    assert a.bgrid == b.bgrid
