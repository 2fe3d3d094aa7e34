"""Host ms a frame in `Engine.render`'s spans `engine.prep` (the camera
rays, the spp jitter, the pinhole fold, the live mask) and
`engine.dispatch` (the wave loop, the box filter, the quantize): the host
enqueueing the frame's torch ops and kernel launches, on rank 0.  None
where the program records no such span."""

from rtbench.spans import DISPATCH, PREP, host_ms


def read(run):
    return host_ms(run, (PREP, DISPATCH))
