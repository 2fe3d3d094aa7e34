"""Host ms a frame in `Engine.render`'s span `engine.unpermute`: the tile
order's permutation and the numpy un-permute (`_assemble_host_image`), on
rank 0.  None where the program records no such span."""

from rtbench.spans import UNPERMUTE, host_ms


def read(run):
    return host_ms(run, (UNPERMUTE,))
