"""The share of the traced window, in %, in which no kernel and no copy
runs on the card; the mean over the cards of a run across processes."""

from rtbench.profile import busy_s


def read(run):
    if run.trace is None:
        return None
    shares = []
    for r in run.trace.ranks:
        lo, hi = r.window
        shares.append(100.0 * (1.0 - busy_s(r) / (hi - lo)))
    return sum(shares) / len(shares)
