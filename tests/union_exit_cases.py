"""The inputs of tests/test_torch_union_exit.py (against the JAX package
on the CPU) and of tests/test_torch_cuda.py's union-exit case (kernels
against plain versions on the card): a scene and rays built with the port
alone, so that the card's tests need no jax."""

import numpy as np
import torch

from rust_raytrace_tpu_torch import math3d as m3
from rust_raytrace_tpu_torch.engine import page_lists
from rust_raytrace_tpu_torch.geometry import make_triangles
from rust_raytrace_tpu_torch.materials import matte, reflective
from rust_raytrace_tpu_torch.ops.cull import cull_mask_exact
from rust_raytrace_tpu_torch.ops.intersect import (fold_pages_origin,
                                                   trace_chunks_plain)
from rust_raytrace_tpu_torch.ops.pages import build_pages
from rust_raytrace_tpu_torch.scene import assemble

F32 = np.float32
P = 8
NP = 37
NC = 5
#: chunk 1 holds only invalid rays (d = 0); chunk 2's count is set to 0;
#: chunk 4 looks at a part of the near wall without holes, so it exits
#: before its last page
DEAD_CHUNK, EMPTY_CHUNK, SOLID_CHUNK = 1, 2, 4
ORIGIN = np.asarray([0.1, -0.05, 0.0], F32)


def scene():
    """A near wall of 133 cells (two triangles each, 11 cells at x < 1 left
    out as holes) at z 5..5.6, a far wall at z = 9, 7 loose triangles
    between, and 8 copies of near-wall triangles (equal t, larger ids) in a
    page of their own: 289 triangles in 37 pages of 8, the last holding one (7
    padding slots); then two slots of an early page zeroed (zero-normal
    slots mid-page).  Returns (pages, PK)."""
    rng = np.random.default_rng(11)
    cells = [(i, j) for i in range(8) for j in range(12)]
    holes = set(map(tuple, rng.permutation(cells)[:11].tolist()))
    near = []
    # cells in 2x2 blocks, so that a page of 8 triangles is a tight box
    for bi in range(6):
        for bj in range(6):
            for i, j in ((2 * bi, 2 * bj), (2 * bi + 1, 2 * bj),
                         (2 * bi, 2 * bj + 1), (2 * bi + 1, 2 * bj + 1)):
                if (i, j) in holes:
                    continue
                x0, y0 = -3 + 0.5 * i, -3 + 0.5 * j
                x1, y1 = x0 + 0.5, y0 + 0.5
                z = lambda x, y: 5 + 0.05 * x + 0.03 * y   # noqa: E731
                a, b = (x0, y0, z(x0, y0)), (x1, y0, z(x1, y0))
                c, d = (x1, y1, z(x1, y1)), (x0, y1, z(x0, y1))
                near += [[a, b, c], [a, c, d]]
    near = np.asarray(near, F32)
    far = np.asarray([[[-8, -8, 9], [8, -8, 9], [8, 8, 9]],
                      [[-8, -8, 9], [8, 8, 9], [-8, 8, 9]],
                      [[-8, -8, 9.5], [0, -8, 9.5], [0, 8, 9.5]],
                      [[0, -8, 9.5], [8, -8, 9.5], [8, 8, 9.5]],
                      [[-8, 8, 9.2], [8, 8, 9.2], [0, 9, 9.2]],
                      [[-8, -8, 9.2], [8, -8, 9.2], [0, -9, 9.2]],
                      [[-9, -8, 9.3], [-9, 8, 9.3], [-8.5, 0, 9.3]],
                      [[9, -8, 9.3], [9, 8, 9.3], [8.5, 0, 9.3]]], F32)
    loose = (rng.uniform(-1, 1, (7, 3, 3)) * [0.8, 0.8, 0.3]
             + np.stack([rng.uniform(-2, 2, 7), rng.uniform(-2, 2, 7),
                         rng.uniform(6, 8, 7)], -1)[:, None]).astype(F32)
    dups = near[rng.choice(len(near), 8, replace=False)]
    surf = matte(m3.make_color((200, 80, 60)), 0.3)
    scene = assemble([make_triangles(near, surf, 0.05),
                      make_triangles(far, reflective(
                          m3.make_color((90, 90, 200)), 0.7, 0.02), 0.0),
                      make_triangles(loose, surf, 0.1),
                      make_triangles(dups, surf, 0.05)])
    n = len(scene.tris) - 1
    assert n == 289
    pages = build_pages(scene.tris, page_size=P,
                        order=np.arange(1, n + 1, dtype=np.int64))
    assert pages.num_pages == NP
    PK = pages.PK.copy()
    PK[3, 2] = 0.0
    PK[3, 5] = 0.0
    return pages, PK


def rays(rc, zero_origin, seed=5):
    """NC chunks of rc rays: camera rays from ORIGIN (zero_origin) through
    a window of the near wall a chunk, or rays from scattered origins in
    front of it (near one point in SOLID_CHUNK; elsewhere aimed with some
    noise, and some looking away); chunk DEAD_CHUNK has d = 0 throughout,
    a few other rays too, and a column of rays has d.x exactly 0.  Returns
    (o, d) [3, R]."""
    rng = np.random.default_rng(seed + rc)
    R = NC * rc
    w = 32
    h = rc // w
    u, v = np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h))
    windows = [(-1.2, 0.8, 1.3), (0, 0, 1.3), (1.5, -1.0, 1.3),
               (0.6, 1.7, 1.3), (2.0, 0.0, 0.6)]
    tgt = np.concatenate([
        np.stack([cx + r * u.ravel(), cy + r * v.ravel(), np.full(rc, 5.0)])
        for cx, cy, r in windows], axis=1)
    if zero_origin:
        o = np.repeat(ORIGIN[:, None], R, axis=1)
        tgt[0, ::w] = ORIGIN[0]                    # d.x exactly 0
    else:
        o = np.stack([rng.uniform(-2, 2, R), rng.uniform(-2, 2, R),
                      rng.uniform(0, 3, R)])
        rest = np.arange(R) < SOLID_CHUNK * rc
        o[:, ~rest] = (np.asarray([[2.0], [0.0], [0.5]])
                       + rng.uniform(-0.1, 0.1, (3, int((~rest).sum()))))
        tgt[:, rest] += rng.normal(0, 0.3, (3, int(rest.sum())))
        tgt[2, rest & (rng.uniform(size=R) < 0.1)] = -5.0   # look away
    d = tgt - o
    d = d / np.linalg.norm(d, axis=0)
    d[:, DEAD_CHUNK * rc:(DEAD_CHUNK + 1) * rc] = 0.0
    d[:, rng.uniform(size=R) < 0.03] = 0.0
    return o.astype(F32), d.astype(F32)


def case(rc, zero_origin, with_excl=False):
    """Rays, folded or plain pages, and the page lists of the port's cull
    (chunk EMPTY_CHUNK's count then set to 0); excl: the nearest triangle
    of 70% of the rays."""
    pages, PK = scene()
    o, d = rays(rc, zero_origin)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    valid = (dt != 0).any(dim=0)
    mask, tmin = cull_mask_exact(ot, dt, valid,
                                 torch.from_numpy(pages.aabb_lo),
                                 torch.from_numpy(pages.aabb_hi), rc)
    counts, plist, ptmin = page_lists(mask, tmin)
    counts[EMPTY_CHUNK] = 0
    pk = torch.from_numpy(PK)
    if zero_origin:
        pk = fold_pages_origin(pk, ORIGIN)
    excl = None
    if with_excl:
        first = trace_chunks_plain(ot, dt, pk, counts, plist, ptmin, rc,
                                   zero_origin)[1]
        drop = torch.from_numpy(np.random.default_rng(3).uniform(
            size=ot.shape[1]) < 0.7)
        excl = torch.where(drop, first, 0.0)
    return dict(o=o, d=d, ot=ot, dt=dt, pk=pk, counts=counts, plist=plist,
                ptmin=ptmin, excl=excl, pages=pages, PK=PK)
