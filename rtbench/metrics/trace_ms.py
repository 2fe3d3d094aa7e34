"""Device ms a frame of the kernels launched inside the span `engine.trace`
of a wave split into trace, shadow pass and shade: the resident regime's
lit wave 0 (B6 to winner rows, `Engine._union_wave`) and each wave of the
streamed regime (`Engine._streamed_wave`: B10 to winner rows, lit; B9 or
B12 with its shade, unlit), on rank 0.  None where the program records no
such span (an unlit resident render, or a program without it) or the
launches cannot be paired with the card's kernels (`rtbench.spans`)."""

from rtbench.spans import device_ms

TRACE = "engine.trace"


def read(run):
    return device_ms(run, (TRACE,))
