"""Device ms a frame of the kernels launched inside the span
`engine.dispatch` (`Engine._dispatch`) whose name the port's kernel
library does not hold: the wave loop's torch glue (`compact_meta`,
`page_lists`, `alive.sum`, the box filter, the quantize), on rank 0.  None
where the program records no such span or the launches cannot be paired
with the card's kernels (`rtbench.spans`)."""

from rtbench.spans import DISPATCH, device_ms


def read(run):
    if run.trace is None:
        return None
    return device_ms(run, (DISPATCH,), keep=lambda name: not (
        name.lower().startswith("nccl") or run.trace.port_kernel(name)))
