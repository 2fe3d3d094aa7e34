"""Device ms a frame of NCCL's kernels on rank 0: the all-reduce of the wave
counts and the gather of the image, with the wait for the slowest rank.
None in a run without them."""


def read(run):
    if run.trace is None:
        return None
    r = run.trace.ranks[0]
    nccl = [e - s for name, s, e, kind in r.device
            if kind == "kernel" and name.lower().startswith("nccl")]
    if not nccl:
        return None
    return 1e3 * sum(nccl) / len(r.frames)
