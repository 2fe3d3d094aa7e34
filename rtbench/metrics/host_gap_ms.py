"""The mean over the traced frames of the time within a frame's span in
which the card runs no kernel and no copy, in ms: the host's share of a
frame (`Engine.render`'s ray set-up and launches, the copy to the host; in
the render across processes rank 0's path)."""

from rtbench.profile import covered


def read(run):
    if run.trace is None:
        return None
    r = run.trace.ranks[0]
    busy = [(s, e) for _, s, e, _ in r.device]
    gaps = [(b - a) - covered(busy, a, b) for a, b in r.frames]
    return 1e3 * sum(gaps) / len(gaps)
