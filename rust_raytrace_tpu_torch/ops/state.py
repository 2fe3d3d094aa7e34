"""Row layout of the per-ray state and of the trace winner rows.

Counterparts: the `ROW_*`/`TRACE_ROWS` constants of
`rust_raytrace_tpu/ops/intersect_pallas.py` and the `ROW_W`/`ROW_ALIVE`/
`ROW_ACC`/`ROW_DEAD`/`STATE_ROWS` constants of
`rust_raytrace_tpu/ops/compact.py`.  Both JAX modules import jax, so the port
carries its own copy; `tests/test_torch_imports.py` holds the two equal.

A render's state is one `[STATE_ROWS, R]` float32 tensor, one column per ray:
origin rows 0..2, direction rows 3..5, weight, alive flag, accumulated color
rows 8..10 and the retired flag.  The trace kernels' winner rows use the same
`[16, R]` shape with the `ROW_T..ROW_SCAT` meaning.  The CUDA sources repeat
these numbers in `csrc/common.cuh`.
"""

#: trace winner rows
ROW_T = 0        # best hit time (+inf miss; -inf on invalid lanes)
ROW_ID = 1       # winning triangle id (0 miss)
ROW_NORM = 2     # 2..4: winner plane normal
ROW_ENC = 5      # kind + 4*edge + 8*back of the winner
ROW_COLOR = 6    # 6..8: winner material color
ROW_ALPHA = 9
ROW_SCAT = 10
TRACE_ROWS = 16

#: ray state rows
ROW_O = 0
ROW_D = 3
ROW_W = 6
ROW_ALIVE = 7
ROW_ACC = 8
ROW_DEAD = 11
STATE_ROWS = 16
