"""The engine's spans in a traced window, and the card's work tied to the
span whose host code launched it.

Under a running profiler `Engine.render` records four spans a frame, in
this order (`engine.prep`, `engine.dispatch`, `engine.unpermute`,
`engine.readback`; a float image: `engine.unpermute` after
`engine.readback`; `rust_raytrace_tpu_torch/utils/profiling.annotate`),
so `profile.reduce` keeps them among the rendering thread's host events,
on the one clock of the card's kernels and copies.  The runtime calls that
launch a kernel or a copy (`cudaLaunchKernel`, `cudaMemcpyAsync`, ...) are
host events of that thread too.  The port runs its work on one stream, which runs it in
the order the host launched it, so the k-th kernel on the card is the one
the k-th kernel launch enqueued, and likewise for copies: `launched_at`
pairs them so, where the counts agree.  A program without the spans (or
a window with nothing on the card) gives the readers nothing to read.
"""

import bisect

PREP, DISPATCH, READBACK, UNPERMUTE = (
    "engine.prep", "engine.dispatch", "engine.readback", "engine.unpermute")

#: runtime and driver calls that launch one activity of each kind
LAUNCHES = {
    "kernel": ("cudaLaunchKernel", "cuLaunchKernel",
               "cudaLaunchCooperativeKernel", "cuLaunchCooperativeKernel"),
    "copy": ("cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset"),
}


def launched_at(rank, kind: str = "kernel"):
    """A list parallel to `rank.device`: the start (s) of the host call
    that launched each activity of `kind`, None for the other kinds; None
    where the window's launch calls and activities of that kind differ in
    number (then no pairing can be trusted)."""
    calls = sorted(s for name, s, _ in rank.host
                   if name.startswith(LAUNCHES[kind]))
    idx = [i for i, d in enumerate(rank.device) if d[3] == kind]
    if len(calls) != len(idx):
        return None
    out = [None] * len(rank.device)
    for i, s in zip(idx, calls):
        out[i] = s
    return out


def spans(rank, names) -> list:
    """(start, end) of the rendering thread's host spans named in `names`,
    sorted."""
    return sorted((s, e) for name, s, e in rank.host if name in names)


def host_ms(run, names):
    """Host ms a frame in the named spans, rank 0; None without them."""
    if run.trace is None:
        return None
    r = run.trace.ranks[0]
    found = spans(r, names)
    if not found:
        return None
    return 1e3 * sum(e - s for s, e in found) / len(r.frames)


def device_s_by_span(rank, names, kind: str = "kernel", keep=None):
    """Device seconds of the activities of `kind` whose launch falls inside
    one of the named host spans; keep(name) selects among them.  None
    where the window holds no such span, nothing of `kind` on the card, or
    no pairing of launches (`launched_at`)."""
    found = spans(rank, names)
    at = launched_at(rank, kind)
    if not found or at is None or not any(a is not None for a in at):
        return None
    starts = [s for s, _ in found]
    total = 0.0
    for (name, s, e, _), t in zip(rank.device, at):
        if t is None or (keep is not None and not keep(name)):
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= found[i][1]:
            total += e - s
    return total


def device_ms(run, names, keep=None):
    """Device ms a frame of the kernels launched inside the named spans
    (those whose name keep(name) selects), rank 0; None where
    `device_s_by_span` is."""
    if run.trace is None:
        return None
    r = run.trace.ranks[0]
    sec = device_s_by_span(r, names, "kernel", keep)
    return None if sec is None else 1e3 * sec / len(r.frames)
