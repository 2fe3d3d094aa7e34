"""Host ms a frame in `Engine.render`'s span `engine.unpermute`: the launch
of `ops/untile.untile_u8`, which un-tiles the quantized image on the card
(a float image: the host's un-permute `_assemble_host_image`), on rank 0.
None where the program records no such span."""

from rtbench.spans import UNPERMUTE, host_ms


def read(run):
    return host_ms(run, (UNPERMUTE,))
