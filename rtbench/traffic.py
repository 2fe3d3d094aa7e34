"""The traffic: frame keys from the seed, and the closed loop of one client
that asks for the next frame when the last has come back.

A cell's traffic file (`workloads/<cell>.json`) gives `spp`, `lit` and
`ranks` (processes, one card each).  Every seed asks for the same work:
the same camera, scene and sizes, other keys.
"""

import sys
import time
import traceback

import numpy as np

from .reference.arith import fold_in

_M32 = 0xFFFFFFFF

#: frames rendered in set-up (the first is a one-card Engine's planning frame)
WARMUP_FRAMES = 2
#: the checked frame is drawn from the seed among the window's first so many
CHECK_WITHIN = 16
#: the most frames a traced run profiles
TRACE_FRAMES = 24


def frame_key(seed: int, i: int) -> np.ndarray:
    """Frame i's key: the seed's two 32-bit words as a key, folded with i
    (jax.random.fold_in's threefry), so every bit of the seed counts."""
    base = np.asarray([(int(seed) >> 32) & _M32, int(seed) & _M32],
                      dtype=np.uint32)
    return fold_in(base, i)


def check_index(seed: int) -> int:
    """The window frame whose image is checked, drawn from the seed."""
    return int(np.random.default_rng(int(seed)).integers(CHECK_WITHIN))


def closed_loop(render, seconds: float, keep: int, max_frames: int = 0,
                agree=None, needs_image: bool = True):
    """Frames rendered back to back: render(i) -> RenderResult, starting a
    new frame until `seconds` have passed since the first one started (or
    max_frames were started).  agree(go) -> go, where several processes
    must stop together (rank 0's decision).  Returns (frames [(start, end,
    rays)], attempted, failed, kept) with kept = (image, wave_rays) of frame
    `keep` or None.  A frame that raises or returns no image counts as
    failed; under `agree` a raise ends the run (the ranks would part).
    needs_image=False: a rank that holds no image of its own."""
    frames, kept = [], None
    attempted = failed = 0
    t_first = None
    while True:
        go = t_first is None or time.perf_counter() - t_first < seconds
        go = go and not (max_frames and attempted >= max_frames)
        if agree is not None:
            go = agree(go)
        if not go:
            break
        i = attempted
        attempted += 1
        t0 = time.perf_counter()
        if t_first is None:
            t_first = t0
        try:
            res = render(i)
        except Exception:
            if agree is not None:
                raise
            failed += 1
            traceback.print_exc(file=sys.stderr)
            continue
        t1 = time.perf_counter()
        if needs_image and res.image is None:
            failed += 1
            continue
        frames.append((t0, t1, int(res.rays_traced)))
        if i == keep:
            kept = (res.image, np.asarray(res.wave_rays))
    return frames, attempted, failed, kept
