"""Device-memory budget accounting for binned scenes (BASELINE config #5).

Answers "does N particles fit on D devices" ANALYTICALLY from the static
grid geometry — the quantities XLA allocates are all shape-determined:

  * the dense slot arrays (the dominant term: S = num_cells * cap slots),
  * the compact per-particle arrays (K rows),
  * the multi-operand rebin sort workspace (~2x the compact columns),
  * the blocked fold's pair temporaries (bounded by block_cells — this is
    the invariant that makes big grids possible at all),
  * double-buffering headroom for the functional update of the state.

The capacity side comes from the device itself
(``memory_stats()["bytes_limit"]``); a caller with no device to ask (a CPU
dry run) passes the capacity it assumes explicitly.

Reference scale note: the reference platform has no large-array compute;
this sizing discipline is the analogue of its capacity planning
(5-runs-per-date cap, retention windows) applied to device memory.
"""

from __future__ import annotations

import dataclasses
import math

from sph_pie_tpu.neighbors.binned import BinnedGrid


@dataclasses.dataclass(frozen=True)
class MemBudget:
    n_particles: int
    n_devices: int
    num_cells: int
    num_slots: int
    slots_per_device: int
    dense_state_bytes: int      # per device
    compact_bytes: int          # per device
    sort_workspace_bytes: int   # per device
    fold_temp_bytes: int        # per device
    total_bytes: int            # per device, with 2x state double-buffer
    hbm_bytes: int              # per device capacity
    fits: bool

    def row(self) -> dict:
        gb = 1 << 30
        return {
            "n": self.n_particles,
            "devices": self.n_devices,
            "slots_per_device": self.slots_per_device,
            "dense_gb": round(self.dense_state_bytes / gb, 3),
            "compact_gb": round(self.compact_bytes / gb, 3),
            "sort_gb": round(self.sort_workspace_bytes / gb, 3),
            "fold_gb": round(self.fold_temp_bytes / gb, 3),
            "total_gb": round(self.total_bytes / gb, 3),
            "hbm_gb": round(self.hbm_bytes / gb, 1),
            "fits": self.fits,
        }


def device_capacity_bytes(device=None) -> int:
    """Bytes a process may allocate on ``device`` (default: the first JAX
    device), as the runtime reports it in ``memory_stats()["bytes_limit"]``.

    Raises ValueError when the device reports no capacity (the CPU
    backend reports none): the caller then has to state the capacity it
    assumes."""
    if device is None:
        import jax

        device = jax.devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise ValueError(
            f"{device.platform} device reports no memory capacity; "
            "pass hbm_bytes explicitly"
        )
    return int(stats["bytes_limit"])


def budget(
    grid: BinnedGrid,
    n_particles: int,
    n_devices: int = 1,
    hbm_bytes: int | None = None,
    dtype_bytes: int = 4,
) -> MemBudget:
    """Per-device memory budget for a binned scene sharded over the cell
    axis. ``hbm_bytes`` is the per-device capacity; None reads it from the
    device (``device_capacity_bytes``)."""
    if hbm_bytes is None:
        hbm_bytes = device_capacity_bytes()
    dim = grid.dim
    S = grid.num_slots
    K = grid.max_particles or n_particles
    s_dev = -(-S // n_devices)
    k_dev = -(-K // n_devices)

    # BinnedState dense columns: pos/vel/bin_pos [S, dim] f32, mass/density/
    # pressure [S] f32, valid bool, owner i32
    dense = s_dev * ((3 * dim + 3) * dtype_bytes + 1 + 4)
    # slot_of [K] i32 + compact gather outputs (pos/vel [K,dim], mass, alive)
    compact = k_dev * (4 + (2 * dim + 1) * dtype_bytes + 1)
    # multi-operand lax.sort: key + 2*dim+2 payload columns, in+out copies
    sort_ws = 2 * k_dev * ((2 * dim + 2) * dtype_bytes + 4)
    # blocked fold: [blk, cap, 3cap] pair tensors; a handful live at once
    blk = grid.block_cells or grid.num_cells
    fold = 8 * blk * grid.cap * 3 * grid.cap * dtype_bytes

    total = 2 * dense + compact + sort_ws + fold  # 2x: functional update
    return MemBudget(
        n_particles=n_particles,
        n_devices=n_devices,
        num_cells=grid.num_cells,
        num_slots=S,
        slots_per_device=s_dev,
        dense_state_bytes=dense,
        compact_bytes=compact,
        sort_workspace_bytes=sort_ws,
        fold_temp_bytes=fold,
        total_bytes=total,
        hbm_bytes=hbm_bytes,
        fits=total < hbm_bytes * 0.9,  # 10% headroom for XLA scratch
    )


def dam_break_budget(
    n_target: int, n_devices: int = 1, hbm_bytes: int | None = None
) -> MemBudget:
    """Budget for the standard 3D dam-break scene at n_target particles.

    Builds only the STATIC grid (pure shape math — no arrays), so this is
    instant even at 16M+."""
    from sph_pie_tpu.scenes import dam_break_3d

    scene = dam_break_3d(n_target=n_target, build_state=False)
    return budget(scene.bgrid, n_target, n_devices, hbm_bytes)
