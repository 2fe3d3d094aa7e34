"""B4: the port's per-lane bounce trace + shade against
trace_perlane_pallas / trace_shade_perlane_pallas in interpret mode, on one
bank of pages and on two.

Bitwise: the port fuses multiply-adds where XLA on the CPU fuses them
(ROADMAP C2) and computes XLA-CPU's rsqrt (C1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.geometry import make_sphere, make_triangles
from rust_raytrace_tpu.materials import matte, reflective
from rust_raytrace_tpu.ops.intersect_perlane import (
    trace_perlane_pallas, trace_shade_perlane_pallas)
from rust_raytrace_tpu.ops.pages import build_pages_kd
from rust_raytrace_tpu.scene import assemble
from rust_raytrace_tpu_torch.ops.intersect_perlane import (
    trace_perlane_plain, trace_shade_perlane, upload_perlane_tables)
from rust_raytrace_tpu_torch.utils import native

F32 = np.float32
RB = 256          # >= 2 groups of 128: the TPU kernel's in-chunk sort runs
R = 2 * RB

#: (sphere lat/lon, page size) -> 1 bank of 13 pages; 2 banks of 174 pages
BANKS = {1: ((8, 12), 16), 2: ((24, 30), 8)}


def _tables(banks):
    lat_lon, page = BANKS[banks]
    s = make_sphere((0.0, 0.0, 6.0), 2.0, lat_lon,
                    matte(m3.make_color((200, 60, 60)), 0.3), -1.0)
    floor = make_triangles(
        np.asarray([[[-20, -3, -10], [20, -3, -10], [0, -3, 40]]], dtype=F32),
        reflective(m3.make_color((120, 120, 120)), 0.8, 0.1), 0.0)
    pages = build_pages_kd(assemble([s, floor]).tris, page_size=page)
    tabs = upload_perlane_tables(pages, "cpu")
    assert tabs[2].shape[0] == 128 * banks
    return page, tabs


def _state():
    """Bounce-like state: origins near the geometry, scattered directions,
    retired lanes, and a chunk with no live ray."""
    rng = np.random.default_rng(5)
    st = np.zeros((16, R), F32)
    st[0:3] = rng.uniform([-3, -3, 3], [3, 3, 9], (R, 3)).T
    d = rng.normal(size=(3, R))
    st[3:6] = d / np.linalg.norm(d, axis=0)
    alive = (rng.uniform(size=R) > 0.15).astype(F32)
    alive[RB:RB + RB // 2] = 0.0
    st[6] = rng.uniform(0.1, 1.0, R)
    st[7] = alive
    st[8:11] = rng.uniform(0, 0.5, (3, R))
    st[11] = 1.0 - alive
    return st


@pytest.mark.parametrize("banks", [1, 2])
def test_trace_rows_match_pallas(banks):
    page, (plt_i, plt_s, ab) = _tables(banks)
    st = _state()
    mine = trace_perlane_plain(torch.from_numpy(st[0:3]),
                               torch.from_numpy(st[3:6]),
                               torch.from_numpy(st[7]), plt_i, plt_s, ab,
                               page).numpy()
    ref = np.asarray(trace_perlane_pallas(
        jnp.asarray(st[0:3]), jnp.asarray(st[3:6]), jnp.asarray(st[7] != 0),
        jnp.asarray(plt_i.numpy()), jnp.asarray(plt_s.numpy()),
        jnp.asarray(ab.numpy()), page, RB, interpret=True))
    live = st[7] != 0
    assert 0.2 < (ref[1, live] != 0).mean() < 0.95
    np.testing.assert_array_equal(mine[1][live], ref[1][live])
    np.testing.assert_array_equal(mine[5][live], ref[5][live])
    np.testing.assert_array_equal(mine[:11, live], ref[:11, live])


@pytest.mark.parametrize("banks", [1, 2])
@pytest.mark.parametrize("fixed_rng", [True, False])
def test_trace_shade_matches_pallas(banks, fixed_rng):
    page, (plt_i, plt_s, ab) = _tables(banks)
    st = _state()
    seed = np.asarray([123, 456], np.uint32)
    chunk_live = torch.from_numpy(st[7].reshape(-1, RB).any(axis=1)
                                  .astype(np.int32))
    native.reset_launch_counts()
    mine = trace_shade_perlane(torch.from_numpy(st), plt_i, plt_s, ab, seed,
                               page, RB, fixed_rng, 1 / 512,
                               chunk_live).numpy()
    assert native.TRACE_SHADE_PERLANE.launches == 0   # CPU: plain version
    ref = np.asarray(trace_shade_perlane_pallas(
        jnp.asarray(st), jnp.asarray(plt_i.numpy()), jnp.asarray(plt_s.numpy()),
        jnp.asarray(ab.numpy()), jnp.asarray(seed), page, RB,
        fixed_rng=fixed_rng, weight_cutoff=1 / 512,
        chunk_live=jnp.asarray(chunk_live.numpy()), interpret=True))
    np.testing.assert_array_equal(mine[[7, 11]], ref[[7, 11]])
    np.testing.assert_array_equal(mine, ref)
