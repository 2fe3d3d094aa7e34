"""Device ms a frame of kernels that are not in the port's kernel library
and not NCCL's: the wave loop's torch glue (threefry draws, the float64
fma, sorts, compaction metadata), on rank 0."""


def read(run):
    if run.trace is None:
        return None
    r = run.trace.ranks[0]
    ms = sum(e - s for name, s, e, kind in r.device
             if kind == "kernel" and not name.lower().startswith("nccl")
             and not run.trace.port_kernel(name))
    return 1e3 * ms / len(r.frames)
