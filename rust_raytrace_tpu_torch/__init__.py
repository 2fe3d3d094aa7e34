"""rust_raytrace_tpu_torch — the renderer on PyTorch and CUDA (NVIDIA H100).

The port of `rust_raytrace_tpu` (JAX/XLA with Pallas TPU kernels), which
stays in the repository as the reference the port is tested against.  The
port imports torch, never jax and nothing of the JAX package: the numpy host
modules it needs are copies under the same relative names.

Layout (each module names its JAX counterpart):
  engine        Engine: the compacted and legacy wave loops (spp >= 1,
                debug buffers, walk_one_ray, render_banded,
                render_sharded) and their host helpers
  cli           the command line: render, diff, tune (--device cuda|cpu)
  render        WavefrontRenderer (the portable renderer: backends
                "kernel" = B11, "portable" = the page scan), RenderResult,
                RayCaster
  scene, geometry, materials, camera, math3d, obj_parser, models,
  ops/pages, utils/png, oracle, octree, utils/raydebug,
  utils/term_display, utils/tracelog
                numpy host modules (copies)
  ops/state     row layout of the ray state and of the trace winner rows
  ops/shade     the shade + scatter hash, fma and XLA-CPU's rsqrt (B0b)
  ops/cull      B1: packet cull of ray chunks against page AABBs, B13: the
                same with the page sort in the kernel; the interval culls
                of the XLA path
  ops/intersect B0a hit predicate, pinhole fold, B2: wave-0 union trace+shade,
                B6: union trace to rows, B11: dense nearest hit
  ops/intersect_xla  the portable page scan (JAX's nearest_hit_xla)
  ops/compact   B3: compaction, B5: expansion, B14: the bucketed pair
  ops/intersect_perlane  per-lane tables, B4: bounce trace+shade
  ops/intersect_streamed  streamed tables, B9: bank-worklist trace+shade,
                B10: bank-worklist trace to rows, B12: the bank-major sweep
  utils/rng     jax.random-equal threefry keys
  utils/xla_rsqrt  the host CPU's rsqrtps table
  utils/native  nvcc build + ctypes binding + launch counts of csrc/*.cu
  utils/host_native  g++ build + ctypes binding of native/scene_pipeline.cc
                (the JAX package's C++ scene pipeline, copied byte for byte)
  parallel/sharding  render_sharded's image-tile data parallelism
  utils/progress  progress / run statistics (copy)
  csrc/         the CUDA kernels (sm_90a) and the rsqrt table capture (C)

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain torch version for CPU tensors.
"""
