"""Device ms a frame of the kernels launched inside the span `engine.shade`:
B8 and its scatter draws after a wave's trace to winner rows, in the
resident regime's lit wave 0 and each lit wave of the streamed regime, on
rank 0.  None where the program records no such span (unlit, or a program
without it) or the launches cannot be paired with the card's kernels
(`rtbench.spans`)."""

from rtbench.spans import device_ms

SHADE = "engine.shade"


def read(run):
    return device_ms(run, (SHADE,))
