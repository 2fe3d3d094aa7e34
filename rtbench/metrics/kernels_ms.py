"""Device ms a frame of the port's own kernels (a kernel whose name the
port's kernel library holds), on rank 0."""


def read(run):
    if run.trace is None:
        return None
    r = run.trace.ranks[0]
    ms = sum(e - s for name, s, e, kind in r.device
             if kind == "kernel" and run.trace.port_kernel(name))
    return 1e3 * ms / len(r.frames)
