"""Device ms a frame of the kernels launched inside the span
`engine.shadow`: a lit wave's shadow pass (the shadow rays and their
threefry jitter, then the resident regime's cull, sort and B6, or the
streamed regime's any-hit B10, with self-exclusion) in the resident
regime's wave 0 and each wave of the streamed regime, on rank 0.  None
where the program records no such span (unlit, or a program without it)
or the launches cannot be paired with the card's kernels
(`rtbench.spans`)."""

from rtbench.spans import device_ms

SHADOW = "engine.shadow"


def read(run):
    return device_ms(run, (SHADOW,))
