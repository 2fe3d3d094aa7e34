"""B7 on tests/streamed_walk_cases.py's scene built as resident tables (391
pages of 8 in 4 banks, the last of them 7 pages and 121 padding; a
triangle and its copy, equal t and a larger id, in two banks and two
pages; zero-normal slots mid-page) and state (camera rays from the
origin, some aimed at the copied triangles, a chunk with no live ray,
rays from inside the sphere inside several banks' pages, dead lanes):
the port's `trace_perlane` (its plain version on the CPU) against the JAX
package's `trace_perlane_pallas` in interpret mode, nearest (all rows
bitwise on the valid lanes), with each ray's own nearest triangle
excluded, with a live chunk flagged dead, and any-hit with exclusion (the
occlusion bit, ROADMAP C5); and the group boxes that the kernel's walk
reads, `perlane_tables(...).gab`, equal to `group_boxes(pab)` and holding
their pages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu.ops.intersect_perlane import trace_perlane_pallas
from rust_raytrace_tpu_torch.ops.intersect_perlane import (
    GROUP, PAGES_A_BOX, build_perlane_tables, group_boxes, perlane_tables,
    trace_perlane, trace_perlane_plain)
from rust_raytrace_tpu_torch.utils import native
from streamed_walk_cases import INSIDE_CHUNK, NC, P, RB, scene, state


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    pages, _, targets = scene()
    tabs = perlane_tables(*(torch.from_numpy(x)
                            for x in build_perlane_tables(pages)))
    st = torch.from_numpy(state(targets))
    return tabs, st


def _jax(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("mode", ["nearest", "excl", "dead_chunk",
                                  "any_hit"])
def test_trace_perlane_walk_case_equals_jax(case, mode):
    tabs, st = case
    assert tabs.ab.shape[0] == 4 * GROUP
    o, d, alive = st[0:3], st[3:6], st[7]
    excl = chunk_live = None
    if mode in ("excl", "any_hit"):
        excl = trace_perlane_plain(o, d, alive, *tabs[:3], P)[1]
    if mode == "dead_chunk":
        chunk_live = torch.ones(NC, dtype=torch.int32)
        chunk_live[INSIDE_CHUNK] = 0
    native.reset_launch_counts()
    mine = trace_perlane(o, d, alive, tabs, P, RB, chunk_live=chunk_live,
                         excl=excl, any_hit=mode == "any_hit").numpy()
    assert native.TRACE_PERLANE.launches == 0       # CPU: plain version
    ref = np.asarray(trace_perlane_pallas(
        _jax(o), _jax(d), _jax(alive != 0), _jax(tabs.plt_i),
        _jax(tabs.plt_s), _jax(tabs.ab), P, RB, interpret=True,
        chunk_live=None if chunk_live is None else _jax(chunk_live),
        excl=None if excl is None else _jax(excl)[None],
        any_hit=mode == "any_hit"))
    live = alive.numpy() != 0
    if mode == "dead_chunk":
        lanes = slice(INSIDE_CHUNK * RB, (INSIDE_CHUNK + 1) * RB)
        assert live[lanes].any()
        assert (ref[:, lanes] == 0).all() and (mine[:, lanes] == 0).all()
        live[lanes] = False
    if mode == "any_hit":
        occluded = ref[1] != 0
        assert 0.05 < occluded[live].mean() < 0.95
        np.testing.assert_array_equal(mine[1][live] != 0, occluded[live])
        ex = excl.numpy()
        sel = live & (ex != 0)
        assert sel.any() and (mine[1][sel] != ex[sel]).all()
        assert (mine[2:] == 0).all()
        return
    assert 0.2 < (ref[1][live] != 0).mean() < 0.99
    np.testing.assert_array_equal(mine[:, live].view(np.uint32),
                                  ref[:, live].view(np.uint32))
    if mode == "excl":
        ex = excl.numpy()
        assert (mine[1][live & (ex != 0)] != ex[live & (ex != 0)]).all()


def test_group_boxes_of_the_resident_tables(case):
    """`gab` is `group_boxes(pab)`: one box of 8 pages, 16 a bank; each
    holds its valid pages, and a group of padding pages is invalid."""
    tabs, _ = case
    assert torch.equal(tabs.gab, group_boxes(tabs.pab))
    NB = tabs.ab.shape[0] // GROUP
    assert tabs.gab.shape == (NB * GROUP // PAGES_A_BOX, 8)
    g = torch.arange(tabs.pab.shape[0]) // PAGES_A_BOX
    valid = tabs.pab[:, 6] != 0
    assert bool((tabs.gab[g[valid], 0:3] <= tabs.pab[valid, 0:3]).all())
    assert bool((tabs.gab[g[valid], 3:6] >= tabs.pab[valid, 3:6]).all())
    has = torch.zeros(tabs.gab.shape[0], dtype=torch.bool)
    has[g[valid]] = True
    assert torch.equal(tabs.gab[:, 6] != 0, has)
    assert not has.all()                   # the last bank's padding groups
