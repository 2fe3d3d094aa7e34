"""The inputs of tests/test_torch_streamed_walk.py (against the JAX package
on the CPU) and of tests/test_torch_cuda.py's streamed-walk cases (B9 and
B12a against their plain versions on the card): a scene and a ray state
built with the port alone, so that the card's tests need no jax."""

import numpy as np
import torch

from rust_raytrace_tpu_torch import math3d as m3
from rust_raytrace_tpu_torch.geometry import make_sphere, make_triangles
from rust_raytrace_tpu_torch.materials import matte, reflective
from rust_raytrace_tpu_torch.ops.intersect_streamed import (
    upload_streamed_tables)
from rust_raytrace_tpu_torch.ops.pages import build_pages
from rust_raytrace_tpu_torch.scene import assemble

F32 = np.float32
P = 8
RB = 1024
NC = 3
#: chunk 1 holds no live ray, and its words -0 and NaNs; chunk 0 holds
#: camera rays from the origin, chunk 2 rays from inside the sphere
DEAD_CHUNK = 1
CAMERA_CHUNK = 0
INSIDE_CHUNK = 2
#: sphere triangles copied, with larger ids, into the last page
COPIES = 8
#: zeroed (zero-normal) slots mid-page: (page, slot)
ZERO_SLOTS = ((200, 3), (200, 4), (390, 5))
CENTER = np.asarray([0.0, 0.0, 6.0], F32)


def scene():
    """tests/test_streamed.py's sphere (radius 2.5 at z = 6, 40x40 cells,
    3,120 triangles) in generation order, so that its banks are latitude
    bands whose boxes overlap inside the sphere, then COPIES of the sphere
    triangles nearest the camera (equal t, larger ids) in a page of their
    own in the last bank: 3,128 triangles, 391 pages of 8 in 4 banks (the
    last holding 7 pages and 121 padding pages); then ZERO_SLOTS zeroed.
    Returns (pages, the copied triangles' ids, their incenters [COPIES,
    3])."""
    surf = matte(m3.make_color((252, 119, 0)), 0.2)
    sphere = make_sphere(tuple(CENTER), 2.5, (40, 40), surf, 0.0)
    src = np.argsort(sphere.incenter[:, 2], kind="stable")[:COPIES]
    copies = make_triangles(sphere.corners[src],
                            reflective(m3.make_color((90, 90, 200)), 0.7,
                                       0.02), 0.0)
    sc = assemble([sphere, copies])
    n = len(sc.tris) - 1
    assert n == 3128
    pages = build_pages(sc.tris, page_size=P,
                        order=np.arange(1, n + 1, dtype=np.int64))
    assert pages.num_pages == 391
    for page, slot in ZERO_SLOTS:
        pages.PK[page, slot] = 0.0
    return pages, src + 1, sphere.incenter[src]


def tables(pages, device="cpu"):
    return upload_streamed_tables(pages, device)


def state(targets, seed=3):
    """A [16, NC * RB] state: chunk 0 camera rays from the origin over the
    sphere and its rim (a column with d.x exactly 0), 64 of them aimed at
    the copied triangles' incenters (ties between a triangle and its copy
    in another bank); chunk DEAD_CHUNK no live ray, its accumulated color
    words -0 and NaNs of two payloads; chunk 2 rays from points inside the
    sphere (inside several bank boxes) in scattered directions, a fifth of
    its lanes dead (their alive words -0 or +0).  Weights and accumulated
    colors random."""
    rng = np.random.default_rng(seed)
    R = NC * RB
    st = np.zeros((16, R), F32)
    o = np.zeros((3, R), F32)
    w = 32
    u, v = np.meshgrid(np.linspace(-0.6, 0.6, w), np.linspace(-0.6, 0.6, w))
    d = np.zeros((3, R), F32)
    d[:, :RB] = np.stack([u.ravel(), v.ravel(), np.ones(RB)])
    d[0, :RB:w] = 0.0                                    # d.x exactly 0
    d[:, :64] = targets.T[:, np.arange(64) % len(targets)]
    inside = slice(2 * RB, 3 * RB)
    r = rng.uniform(0.0, 2.3, RB) * rng.choice([-1.0, 1.0], RB)
    dirs = rng.normal(size=(3, RB))
    o[:, inside] = CENTER[:, None] + r * dirs / np.linalg.norm(dirs, axis=0)
    d[:, inside] = rng.normal(size=(3, RB))
    d[:, RB:2 * RB] = rng.normal(size=(3, RB))
    d = d / np.linalg.norm(d, axis=0)
    st[0:3], st[3:6] = o, d
    st[6] = rng.uniform(0.2, 1.0, R)
    st[7] = 1.0
    st[7, RB:2 * RB] = 0.0
    dead = 2 * RB + np.nonzero(rng.uniform(size=RB) < 0.2)[0]
    st[7, dead] = 0.0
    st[8:11] = rng.uniform(0, 0.5, (3, R))
    words = st.view(np.uint32)
    words[7, dead[::2]] = 0x80000000                     # alive -0
    lanes = slice(RB, RB + 128)
    words[8, lanes] = 0x80000000                         # -0
    words[9, lanes] = 0x7FC00001                         # quiet NaN
    words[10, lanes] = 0xFFC0BEEF                        # negative NaN
    return st


def chunk_live(st):
    """[NC] int32: 1 where a chunk holds a live ray."""
    return (st[7] != 0).reshape(NC, RB).any(axis=1).astype(np.int32)


def torch_case(device="cpu"):
    """(tables, state, chunk_live) as tensors on `device`."""
    pages, _, targets = scene()
    st = state(targets)
    return (tables(pages, device), torch.from_numpy(st).to(device),
            torch.from_numpy(chunk_live(st)).to(device))
