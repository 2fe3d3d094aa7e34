"""Seconds from the process's start to the first timed frame: imports, the
kernel and host libraries loaded (or built), the scene and Engine built,
the warm-up frames."""


def read(run):
    return run.setup_s
