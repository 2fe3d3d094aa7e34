"""Millions of rays traced a second over the window: the sum of every
completed frame's `rays_traced` (the live rays of each wave, shadow rays
not counted) over the wall time from the first frame's start to the last
frame's end."""


def read(run):
    if not run.frames:
        return None
    rays = sum(f[2] for f in run.frames)
    return rays / (run.frames[-1][1] - run.frames[0][0]) / 1e6
