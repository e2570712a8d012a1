"""On-device particle splatting to a framebuffer.

BASELINE.json: "rendering becomes on-device particle splatting to a
framebuffer streamed to the canvas front end". This renders entirely on
the accelerator (bilinear scatter-add), returning either a float intensity
field or a tone-mapped uint8 image — only the final small image ever
crosses to the host (the service layer streams it as PNG/PGM;
sph_pie_tpu/service/frames.py).

3D scenes are projected orthographically along a chosen axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("resolution", "axis"))
def splat(
    pos: jax.Array,        # [N, dim]
    weight: jax.Array,     # [N] per-particle weight (e.g. mass, 1.0, speed)
    active: jax.Array,     # [N] bool
    extent,                # ((xmin, xmax), (ymin, ymax)) world window
    resolution: tuple[int, int] = (256, 256),
    axis: int = 2,         # projection axis for 3D inputs
) -> jax.Array:
    """Bilinear scatter-add of particle weights onto an [H, W] grid.

    Returns float32 [H, W]; row 0 is the TOP of the window (image order).
    """
    h_px, w_px = resolution
    dim = pos.shape[1]
    if dim == 2:
        xy = pos
    else:
        keep = [a for a in range(dim) if a != axis][:2]
        xy = pos[:, keep]
    (x0, x1), (y0, y1) = extent
    fx = (xy[:, 0] - x0) / (x1 - x0) * (w_px - 1)
    fy = (y1 - xy[:, 1]) / (y1 - y0) * (h_px - 1)  # flip: world +y = up

    ix = jnp.floor(fx)
    iy = jnp.floor(fy)
    tx = fx - ix
    ty = fy - iy
    ix = ix.astype(jnp.int32)
    iy = iy.astype(jnp.int32)

    w = jnp.where(active, weight, 0.0)
    img = jnp.zeros((h_px, w_px), jnp.float32)
    oob = jnp.int32(h_px * w_px)  # flat sentinel, dropped by mode="drop"
    flat = img.reshape(-1)
    for dy, wy in ((0, 1.0 - ty), (1, ty)):
        for dx, wx in ((0, 1.0 - tx), (1, tx)):
            gx = ix + dx
            gy = iy + dy
            ok = (gx >= 0) & (gx < w_px) & (gy >= 0) & (gy < h_px)
            idx = jnp.where(ok, gy * w_px + gx, oob)
            flat = flat.at[idx].add(
                (w * wx * wy).astype(jnp.float32), mode="drop"
            )
    return flat.reshape(h_px, w_px)


@partial(jax.jit, static_argnames=("resolution", "axis"))
def render_u8(
    pos, weight, active, extent, resolution=(256, 256), axis: int = 2, gain=1.0
) -> jax.Array:
    """Tone-mapped uint8 frame: 255 * (1 - exp(-gain * intensity))."""
    img = splat(pos, weight, active, extent, resolution, axis)
    tone = 1.0 - jnp.exp(-gain * img)
    return jnp.clip(tone * 255.0, 0, 255).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("grid", "resolution", "axis"))
def splat_binned(grid, b, resolution=(256, 256), axis: int = 2) -> jax.Array:
    """Framebuffer straight from the dense binned layout — scatter-free.

    A particle-indexed scatter-add at 1M+ particles was slow on the
    previous machine (XLA scatter ran ~serially per update there); the
    binned layout already IS a spatial histogram, so projection = one O(S) per-cell mass reduction +
    a sum over the projection grid axis + a bilinear resize. Sub-cell
    positions are quantized to the cell grid (~2.6 px at 256^2 over a unit
    domain) — the right trade for in-loop streaming at 1M+ (use ``splat``
    for publication-quality stills).

    ``axis`` is the SPATIAL projection axis (3D only).
    """
    C, cap = grid.num_cells, grid.cap
    m_cell = jnp.sum(b.mass.reshape(C, cap), axis=1)
    vol = m_cell.reshape(grid.padded_dims)
    # drop ghost cells
    vol = vol[tuple(slice(1, -1) for _ in grid.dims)]
    order = grid.axis_order or tuple(range(grid.dim))
    if grid.dim == 3:
        gaxis = order.index(axis)          # grid axis holding spatial `axis`
        vol = jnp.sum(vol, axis=gaxis)
        keep = [a for a in order if a != axis]  # spatial axes left, grid order
    else:
        keep = list(order)
    # image rows = screen y (world 'up' = the LAST remaining spatial axis,
    # by the scenes' convention), columns = the other axis; row 0 = top.
    up = max(keep)
    if keep.index(up) == 1:
        vol = vol.T
    vol = vol[::-1]  # ascending world-up -> image top row first
    img = jax.image.resize(vol, resolution, method="bilinear")
    return img


@partial(jax.jit, static_argnames=("grid", "resolution", "axis"))
def render_binned_u8(grid, b, resolution=(256, 256), axis: int = 2, gain=1.0):
    img = splat_binned(grid, b, resolution, axis)
    tone = 1.0 - jnp.exp(-gain * img)
    return jnp.clip(tone * 255.0, 0, 255).astype(jnp.uint8)


def frame_from_state(state, params, resolution=(256, 256), axis: int = 2, gain=None):
    """Render a ParticleState using the scene AABB as the window."""
    extent = (
        (float(params.bound_min[0]), float(params.bound_max[0])),
        (float(params.bound_min[1]), float(params.bound_max[1])),
    )
    if gain is None:
        gain = 1.0 / max(float(jnp.max(state.mass)), 1e-12)
    return render_u8(
        state.pos, state.mass, state.active, extent, resolution, axis, gain
    )
