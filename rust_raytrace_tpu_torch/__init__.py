"""rust_raytrace_tpu_torch — the renderer on PyTorch and CUDA (NVIDIA H100).

The port of `rust_raytrace_tpu` (JAX/XLA with Pallas TPU kernels), which
stays in the repository as the reference the port is tested against.  The
port imports torch and never jax; it reuses the JAX package's jax-free host
modules (scene, geometry, materials, camera, models, ops.pages, oracle,
utils.png) instead of copying them.

Layout (each module names its JAX counterpart):
  engine        Engine: the main render path and its host helpers
  render        RenderResult
  ops/state     row layout of the ray state and of the trace winner rows
  ops/shade     the shade + scatter hash (plain torch; B0b)
  ops/cull      B1: packet cull of ray chunks against page AABBs
  ops/intersect B0a hit predicate, pinhole fold, B2: wave-0 union trace+shade
  ops/intersect_perlane  per-lane tables, B4: bounce trace+shade
  utils/rng     jax.random-equal threefry keys
  utils/native  nvcc build + ctypes binding + launch counts of csrc/*.cu
  csrc/         the CUDA kernels (sm_90a)

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain torch version for CPU tensors.
"""
