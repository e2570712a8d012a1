"""sph_pie_tpu — a smoothed-particle-hydrodynamics framework in JAX.

Brand-new JAX/XLA implementation scoped by SURVEY.md (the structural
map of the reference platform sphereisaiahmin-dev/sph-pie) and BASELINE.json
(the performance contract: fused jit WCSPH/PBF steps over SoA particle
arrays, counting-sort cell lists, on-device splat rendering, ppermute halo
exchange for multi-device domain decomposition).
"""

__version__ = "0.1.0"
