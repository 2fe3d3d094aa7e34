"""Whether the window's frames are right: the plain reference renders the
checked frame again from its key and the configuration's own parameters,
and every byte of the image and every wave's live-ray count must agree.

The configuration states that each frame is the port's exact bits (its
float rules, ROADMAP C1-C11), so both numbers have the limit 0.  A
one-card cell also checks its planning frame, the first warm-up frame,
which the program renders under the default compaction schedule and from
whose wave counts it plans the schedule of every later frame: the
reference plans from its own counts.  Both frames take the checked
frame's key, so where the plan is the default one reference render serves
both.  The render across processes never plans: its ranks keep the
default schedule, and the reference renders the same shards.
"""

import contextlib

import numpy as np

from . import bench
from .reference import arith
from .reference.render import plan_boundaries, render, scene_tables
from .traffic import frame_key

LIMITS = {"bytes_differing": 0, "wave_rays_differing": 0}


def default_schedule(maxdepth: int) -> tuple:
    """The program's schedule before it plans: compact after waves 0, 1."""
    return tuple(b < 2 for b in range(maxdepth - 1))


def differ(ref, got) -> dict:
    img, counts = ref
    if got is None:
        return {"bytes_differing": int(img.size),
                "wave_rays_differing": int(len(counts))}
    image, waves = got
    image = np.asarray(image)
    if image.shape != img.shape or image.dtype != img.dtype:
        n_bytes = int(img.size)
    else:
        n_bytes = int((image != img).sum())
    waves = np.asarray(waves).reshape(-1)
    n_waves = (len(counts) if waves.shape != counts.shape
               else int((waves != counts).sum()))
    return {"bytes_differing": n_bytes, "wave_rays_differing": n_waves}


def reference_frames(cell, seed: int, j: int, device, lowered: bool = False):
    """The reference's (planning frame, checked frame) of the cell under
    key(seed, j), each (image, wave counts); the planning frame is None for
    a cell across processes.  lowered: the control's arithmetic."""
    cfg, tr = cell.config, cell.traffic
    recipe = bench.recipe(cfg["recipe"], reference=True)
    tris, light, view = recipe.build(cfg, int(tr["spp"]))
    tabs = scene_tables(tris, light if tr["lit"] else None, device)
    key = frame_key(seed, j)
    default = default_schedule(view.maxdepth)
    ranks = int(tr["ranks"])
    with arith.lowered() if lowered else contextlib.nullcontext():
        if ranks > 1:
            return None, render(tabs, view, key, default, shards=ranks)
        planning = render(tabs, view, key, default)
        plan = plan_boundaries(planning[1].tolist())
        checked = planning if plan == default else render(tabs, view, key,
                                                          plan)
    return planning, checked


def compare(cell, seed: int, j: int, planning, checked, device) -> dict:
    """The numbers compared, each the worst over the checked frames:
    planning and checked are the program's (image, wave_rays), or None
    where the program gave none (a failed frame)."""
    ref_plan, ref_checked = reference_frames(cell, seed, j, device)
    got = [differ(ref_checked, checked)]
    if ref_plan is not None:
        got.append(differ(ref_plan, planning))
    return {k: max(g[k] for g in got) for k in LIMITS}


def correct(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
