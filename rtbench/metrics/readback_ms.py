"""Host ms a frame in `Engine.render`'s span `engine.readback`: the wait
for the card to finish the frame, then the copies of the image and the
wave counts to the host, on rank 0.  None where the program records no
such span."""

from rtbench.spans import READBACK, host_ms


def read(run):
    return host_ms(run, (READBACK,))
