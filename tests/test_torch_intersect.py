"""B2 and B6: the port's wave-0 union trace + shade and its union trace
alone (with the shadow rays' self-exclusion) against
trace_chunks_pallas / trace_shade_chunks_pallas in interpret mode.

Bitwise: the port fuses multiply-adds where XLA on the CPU fuses them
(ROADMAP C2) and computes XLA-CPU's rsqrt (C1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.geometry import make_sphere, make_triangles
from rust_raytrace_tpu.materials import matte, reflective, solid
from rust_raytrace_tpu.ops.intersect_pallas import (trace_chunks_pallas,
                                                    trace_shade_chunks_pallas)
from rust_raytrace_tpu.ops.pages import build_pages_kd
from rust_raytrace_tpu.scene import assemble
from rust_raytrace_tpu_torch.engine import page_lists
from rust_raytrace_tpu_torch.ops.cull import cull_mask_exact
from rust_raytrace_tpu_torch.ops.intersect import (fold_pages_origin,
                                                   trace_chunks,
                                                   trace_chunks_plain,
                                                   trace_shade_chunks)
from rust_raytrace_tpu_torch.utils import native

F32 = np.float32
P = 16
RB = 128
R = 4 * RB
ORIGIN = np.asarray([0.3, -0.2, -1.0], F32)


@pytest.fixture(scope="module")
def pages():
    """A sphere soup plus a floor: matte, reflective and solid surfaces."""
    rng = np.random.default_rng(4)
    parts = [make_sphere(tuple(rng.uniform([-2, -1, 5], [2, 1, 8])),
                         float(rng.uniform(0.6, 1.4)), (8, 12), surf, -1.0)
             for surf in (matte(m3.make_color((200, 60, 60)), 0.3),
                          reflective(m3.make_color((230, 230, 230)), 0.7,
                                     0.01),
                          solid(m3.make_color((60, 120, 220))))]
    parts.append(make_triangles(
        np.asarray([[[-20, -3, -10], [20, -3, -10], [0, -3, 40]]], dtype=F32),
        reflective(m3.make_color((120, 120, 120)), 0.8, 0.1), 0.0))
    return build_pages_kd(assemble(parts).tris, page_size=P)


def _state(zero_origin: bool):
    """Wave-0 style state: shared-origin camera rays (zero_origin) or
    scattered origins; dead lanes have d = 0 like the padding lanes."""
    rng = np.random.default_rng(9)
    st = np.zeros((16, R), F32)
    if zero_origin:
        st[0:3] = ORIGIN[:, None]
        d = np.stack([rng.uniform(-0.5, 0.5, R), rng.uniform(-0.4, 0.3, R),
                      np.ones(R)])
    else:
        st[0:3] = rng.uniform([-3, -2, 3], [3, 2, 9], (R, 3)).T
        d = rng.normal(size=(3, R))
    alive = (rng.uniform(size=R) > 0.15).astype(F32)
    st[3:6] = d / np.linalg.norm(d, axis=0) * alive
    st[6] = rng.uniform(0.1, 1.0, R)
    st[7] = alive
    st[8:11] = rng.uniform(0, 0.5, (3, R))
    return st


def _inputs(pages, zero_origin):
    st = _state(zero_origin)
    t = torch.from_numpy(st)
    mask, tmin = cull_mask_exact(t[0:3], t[3:6], t[7] != 0,
                                 torch.from_numpy(pages.aabb_lo),
                                 torch.from_numpy(pages.aabb_hi), RB)
    lists = page_lists(mask, tmin)
    pk = torch.from_numpy(pages.PK)
    if zero_origin:
        pk = fold_pages_origin(pk, ORIGIN)
    return st, pk, lists


@pytest.mark.parametrize("zero_origin", [False, True])
def test_trace_rows_match_pallas(pages, zero_origin):
    st, pk, (counts, plist, ptmin) = _inputs(pages, zero_origin)
    mine = trace_chunks_plain(torch.from_numpy(st[0:3]),
                              torch.from_numpy(st[3:6]), pk, counts, plist,
                              ptmin, RB, zero_origin).numpy()
    ref = np.asarray(trace_chunks_pallas(
        jnp.asarray(st[0:3]), jnp.asarray(st[3:6]), jnp.asarray(pk.numpy()),
        jnp.asarray(counts.numpy()), jnp.asarray(plist.numpy()),
        jnp.asarray(ptmin.numpy()), P, RB, interpret=True,
        zero_origin=zero_origin))
    hit = ref[1] != 0
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_array_equal(mine[[1, 5]], ref[[1, 5]])
    np.testing.assert_array_equal(mine[:11], ref[:11])


@pytest.mark.parametrize("zero_origin", [False, True])
@pytest.mark.parametrize("fixed_rng", [True, False])
def test_trace_shade_matches_pallas(pages, zero_origin, fixed_rng):
    st, pk, (counts, plist, ptmin) = _inputs(pages, zero_origin)
    seed = np.asarray([9, 77], np.uint32)
    native.reset_launch_counts()
    mine = trace_shade_chunks(torch.from_numpy(st), pk, counts, plist, ptmin,
                              seed, P, RB, fixed_rng, 1 / 512,
                              zero_origin=zero_origin).numpy()
    assert native.TRACE_SHADE_UNION.launches == 0   # CPU: plain version
    ref = np.asarray(trace_shade_chunks_pallas(
        jnp.asarray(st), jnp.asarray(pk.numpy()), jnp.asarray(counts.numpy()),
        jnp.asarray(plist.numpy()), jnp.asarray(ptmin.numpy()),
        jnp.asarray(seed), P, RB, fixed_rng=fixed_rng, weight_cutoff=1 / 512,
        interpret=True, zero_origin=zero_origin))
    np.testing.assert_array_equal(mine[[7, 11]], ref[[7, 11]])
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("zero_origin", [False, True])
@pytest.mark.parametrize("with_excl", [False, True])
def test_trace_chunks_matches_pallas(pages, zero_origin, with_excl):
    """B6 through its wrapper, every winner row bitwise.  excl: most rays
    may not hit their own nearest triangle (as a shadow ray may not hit the
    triangle it leaves), so their winner moves to the next triangle."""
    st, pk, (counts, plist, ptmin) = _inputs(pages, zero_origin)
    ot, dt = torch.from_numpy(st[0:3]), torch.from_numpy(st[3:6])
    excl = None
    if with_excl:
        first = trace_chunks_plain(ot, dt, pk, counts, plist, ptmin, RB,
                                   zero_origin)[1]
        drop = torch.from_numpy(np.random.default_rng(3).uniform(size=R)
                                < 0.7)
        excl = torch.where(drop, first, 0.0)
    native.reset_launch_counts()
    mine = trace_chunks(ot, dt, pk, counts, plist, ptmin, P, RB, zero_origin,
                        excl).numpy()
    assert native.TRACE_UNION_ROWS.launches == 0     # CPU: plain version
    ref = np.asarray(trace_chunks_pallas(
        jnp.asarray(st[0:3]), jnp.asarray(st[3:6]), jnp.asarray(pk.numpy()),
        jnp.asarray(counts.numpy()), jnp.asarray(plist.numpy()),
        jnp.asarray(ptmin.numpy()), P, RB, interpret=True,
        zero_origin=zero_origin,
        excl=None if excl is None else jnp.asarray(excl.numpy()[None])))
    if with_excl:
        # the exclusion changed winners, and some rays lost their only hit
        assert (ref[1][excl.numpy() != 0] != excl.numpy()[excl.numpy() != 0]
                ).all()
        assert ((ref[1] == 0) & (excl.numpy() != 0)).any()
    np.testing.assert_array_equal(mine[[0, 1]], ref[[0, 1]])
    np.testing.assert_array_equal(mine.view(np.uint32), ref.view(np.uint32))
