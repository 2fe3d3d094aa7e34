"""B7: the port's per-lane trace to winner rows (`trace_perlane`, plain on
the CPU) against `trace_perlane_pallas` in interpret mode, on one bank and
on two, nearest (with and without each ray's own triangle excluded, with a
dead chunk) and any-hit with exclusion (the occlusion bit); and the
per-lane shadow pass (`engine.shadow_mask_perlane`) against the JAX
engine's `_shadow_mask` with per-lane tables, under fixed and live RNG.
Bitwise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu import engine as jeng
from rust_raytrace_tpu.ops.intersect_perlane import trace_perlane_pallas
from rust_raytrace_tpu_torch.engine import shadow_mask_perlane, shadow_rays
from rust_raytrace_tpu_torch.ops.intersect_perlane import (perlane_tables,
                                                          trace_perlane,
                                                          trace_perlane_plain)
from rust_raytrace_tpu_torch.utils import native
from rust_raytrace_tpu_torch.utils.rng import prng_key

from test_torch_perlane import LIGHT, RB, R, _state, _tables

F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions are many small torch ops: with several test
    workers on one host, torch's intra-op threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("banks", [1, 2])
@pytest.mark.parametrize("mode", ["nearest", "excl", "dead_chunk",
                                  "any_hit"])
def test_trace_perlane_equals_jax(banks, mode):
    """All 16 rows by bit pattern on the live lanes (nearest; with each
    ray's own nearest triangle excluded; with the second chunk flagged dead:
    zero rows there); any-hit with exclusion: the occlusion bit (ROADMAP
    C5), never the excluded triangle."""
    page, (plt_i, plt_s, ab) = _tables(banks)
    st = torch.from_numpy(_state())
    o, d, alive = st[0:3], st[3:6], st[7]
    excl = chunk_live = None
    if mode in ("excl", "any_hit"):
        excl = trace_perlane_plain(o, d, alive, plt_i, plt_s, ab, page)[1]
    if mode == "dead_chunk":
        chunk_live = torch.tensor([1, 0], dtype=torch.int32)
    native.reset_launch_counts()
    mine = trace_perlane(o, d, alive, perlane_tables(plt_i, plt_s, ab), page,
                         RB, chunk_live=chunk_live, excl=excl,
                         any_hit=mode == "any_hit").numpy()
    assert native.TRACE_PERLANE.launches == 0       # CPU: plain version
    ref = np.asarray(trace_perlane_pallas(
        _jax(o), _jax(d), _jax(alive != 0), _jax(plt_i), _jax(plt_s),
        _jax(ab), page, RB, interpret=True,
        chunk_live=None if chunk_live is None else _jax(chunk_live),
        excl=None if excl is None else _jax(excl)[None],
        any_hit=mode == "any_hit"))
    live = alive.numpy() != 0
    if mode == "dead_chunk":
        assert (ref[:, RB:] == 0).all() and (mine[:, RB:] == 0).all()
        live[RB:] = False
    if mode == "any_hit":
        occluded = ref[1] != 0
        assert 0.05 < occluded[live].mean() < 0.95
        np.testing.assert_array_equal(mine[1][live] != 0, occluded[live])
        ex = excl.numpy()
        sel = live & (ex != 0)
        assert sel.any() and (mine[1][sel] != ex[sel]).all()
        assert (mine[2:] == 0).all()
        return
    assert (0.05 if mode == "excl" else 0.2) < (ref[1][live] != 0).mean() \
        < 0.95
    np.testing.assert_array_equal(mine[:, live].view(np.uint32),
                                  ref[:, live].view(np.uint32))
    if mode == "excl":
        ex = excl.numpy()
        assert (mine[1][live & (ex != 0)] != ex[live & (ex != 0)]).all()


@functools.lru_cache(maxsize=None)
def _jax_shadow_mask(page: int, fixed_rng: bool):
    """The JAX engine's shadow pass, its per-lane branch, jitted as the
    render program jits it."""
    def fn(o, d, alive, rows, key, light_orig, light_len2, plt_i, plt_s, ab):
        return jeng._shadow_mask(None, None, None, o, d, alive, rows, key, 1,
                                 fixed_rng, light_orig, light_len2, page, RB,
                                 True, 2, plt_i=plt_i, plt_s=plt_s,
                                 ab_tab=ab)
    return jax.jit(fn)


@pytest.mark.parametrize("banks", [1, 2])
@pytest.mark.parametrize("fixed_rng", [True, False])
def test_shadow_mask_perlane_equals_jax(banks, fixed_rng):
    """`shadow_mask_perlane` (shadow_rays, then B7 any-hit with
    self-exclusion) against the JAX `_shadow_mask(..., plt_i=...)` on a
    wave's winner rows: the same [R] mask, with a fair share shadowed."""
    page, (plt_i, plt_s, ab) = _tables(banks)
    st = torch.from_numpy(_state())
    rows = trace_perlane_plain(st[0:3], st[3:6], st[7], plt_i, plt_s, ab,
                               page)
    native.reset_launch_counts()
    mine = shadow_mask_perlane(st, rows, prng_key(4), 1, fixed_rng, LIGHT,
                               perlane_tables(plt_i, plt_s, ab), page,
                               RB).numpy()
    assert native.TRACE_PERLANE.launches == 0
    alive = st[7] != 0
    o_m = torch.where(alive[None], st[0:3], 0.0)
    d_m = torch.where(alive[None], st[3:6], 0.0)
    ref = np.asarray(_jax_shadow_mask(page, fixed_rng)(
        _jax(o_m), _jax(d_m), _jax(alive), _jax(rows),
        jax.random.PRNGKey(4), jnp.asarray(np.asarray(LIGHT[:3], F32)),
        jnp.asarray(F32(LIGHT[3])), _jax(plt_i), _jax(plt_s), _jax(ab)))
    hit = shadow_rays(st, rows, prng_key(4), 1, fixed_rng, LIGHT)[2].numpy()
    assert mine.shape == (R,) and mine.dtype == np.float32
    assert 0.1 < mine[hit].mean() < 0.9
    np.testing.assert_array_equal(mine != 0, ref)
