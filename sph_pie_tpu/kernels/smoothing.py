"""SPH smoothing kernels (Mueller et al. 2003 family), 2D and 3D.

All kernels take the support radius ``h`` (W(r) = 0 for r >= h) and are
written as branch-free jit-safe functions of ``r**2`` or ``r`` so XLA can
fuse them straight into the neighbor reduction.

Normalisation constants (d = spatial dimension):

  poly6    W(r)  = C_p (h^2 - r^2)^3          C_p: 2D 4/(pi h^8),  3D 315/(64 pi h^9)
  spiky   dW(r)  = C_s (h - r)^2 rhat         C_s: 2D -30/(pi h^5), 3D -45/(pi h^6)
  visc  lap W(r) = C_v (h - r)                C_v: 2D 40/(pi h^5),  3D 45/(pi h^6)

The 2D viscosity-Laplacian constant follows the convention used across 2D
Mueller-style implementations; the CPU oracle in ``tests/oracle.py`` uses the
exact same constants, so the trajectory-match contract (BASELINE.md) is
self-consistent. poly6 normalisation (integral of W over R^d == 1) is
verified numerically in ``tests/test_kernels.py``.
"""

from __future__ import annotations

import math

import jax.numpy as jnp


def poly6_coeff(dim: int, h):
    if dim == 2:
        return 4.0 / (math.pi * h**8)
    if dim == 3:
        return 315.0 / (64.0 * math.pi * h**9)
    raise ValueError(f"dim must be 2 or 3, got {dim}")


def spiky_grad_coeff(dim: int, h):
    if dim == 2:
        return -30.0 / (math.pi * h**5)
    if dim == 3:
        return -45.0 / (math.pi * h**6)
    raise ValueError(f"dim must be 2 or 3, got {dim}")


def visc_lap_coeff(dim: int, h):
    if dim == 2:
        return 40.0 / (math.pi * h**5)
    if dim == 3:
        return 45.0 / (math.pi * h**6)
    raise ValueError(f"dim must be 2 or 3, got {dim}")


def poly6(dim: int, h, r2):
    """W_poly6(r) from squared distance. Zero outside support."""
    q = jnp.maximum(h * h - r2, 0.0)
    return poly6_coeff(dim, h) * q * q * q


def spiky_grad_mag(dim: int, h, r):
    """|dW_spiky/dr|-signed magnitude: C_s (h-r)^2 (negative: attraction of
    the gradient toward decreasing r). Multiply by rhat = x_ij / r."""
    q = jnp.maximum(h - r, 0.0)
    return spiky_grad_coeff(dim, h) * q * q


def visc_lap(dim: int, h, r):
    """Laplacian of the Mueller viscosity kernel: C_v (h - r), >= 0."""
    return visc_lap_coeff(dim, h) * jnp.maximum(h - r, 0.0)


def cohesion(dim: int, h, r):
    """Akinci-2013-style cohesion spline (normalised to 3D constants).

    C(r) = K * (h-r)^3 r^3                 for h/2 < r <= h
         = K * (2 (h-r)^3 r^3 - h^6/64)    for 0 < r <= h/2
    with K = 32/(pi h^9) (3D). For 2D we reuse the same shape with
    K = 32/(pi h^8) so the term stays dimensionally sane; the coefficient is
    a user-tuned strength anyway (FluidParams.surface_tension).
    """
    k = 32.0 / (math.pi * h ** (9 if dim == 3 else 8))
    hr3 = jnp.maximum(h - r, 0.0) ** 3
    r3 = r**3
    near = 2.0 * hr3 * r3 - h**6 / 64.0
    far = hr3 * r3
    c = jnp.where(r <= 0.5 * h, near, far)
    return jnp.where((r > 0.0) & (r < h), k * c, 0.0)
