"""Device ms a frame of the kernels launched inside `Engine.render`'s span
`engine.prep`: the camera's glue (`camera_rays_tiled`, the spp jitter's
threefry draws and its float64 fma, the pinhole fold, the live mask), on
rank 0.  None where the program records no such span or the launches
cannot be paired with the card's kernels (`rtbench.spans`)."""

from rtbench.spans import PREP, device_ms


def read(run):
    return device_ms(run, (PREP,))
