"""The union bounce waves of a scene past the resident tables' cap with
`Engine(streamed=False)` on the CPU, bitwise against the JAX Engine in
interpret mode (unlit, lit and the debug buffers, fixed and live RNG), and
the kernel extensions that path runs, B1 with chunk_live and B2 with
chunk_live and grid_live, against the JAX kernels in interpret mode on the
inputs of tests/union_exit_cases.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu.ops.cull_pallas import cull_mask_exact_pallas
from rust_raytrace_tpu.ops.intersect_pallas import trace_shade_chunks_pallas
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.ops.cull import cull_mask_exact
from rust_raytrace_tpu_torch.ops.intersect import trace_shade_chunks
from rust_raytrace_tpu_torch.utils.rng import prng_key
from test_torch_engine_args import (RB, assert_renders_equal, circles_pair,
                                    render_both)
from union_exit_cases import GRID_LIVE, LIVE_FLAGS, NC, P, flags_case


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def past_cap(jscene) -> dict:
    """Engine arguments that put circles past the cap at the adaptive page
    size 56: a table_slot_cap between its triangles and its page slots."""
    n_tris = len(jscene.tris) - 1
    assert -(-n_tris // 56) * 56 > n_tris
    return dict(ray_chunk=RB, streamed=False, table_slot_cap=n_tris)


@pytest.mark.parametrize("fixed_rng", [True, False], ids=["fixed", "live"])
@pytest.mark.parametrize("lit", [False, True], ids=["unlit", "lit"])
def test_past_cap_equals_jax_engine(lit, fixed_rng):
    jscene, scene, vp = circles_pair(lit)
    mine, ref, eng, jeng = render_both(jscene, scene, vp, fixed_rng,
                                       **past_cap(jscene))
    # the union tables and no per-lane or streamed ones, in both packages
    assert not eng.streamed and eng.ptables is None and eng.stables is None
    assert jeng.plt_i is None and jeng.slt_i is None
    assert eng.page_size == 56 and eng.PK is not None
    assert_renders_equal(mine, ref)


@pytest.mark.parametrize("fixed_rng", [True, False], ids=["fixed", "live"])
def test_past_cap_debug_equals_jax_engine(fixed_rng):
    """The debug buffers: the primary t and id and the primary chunks'
    candidate sets."""
    from rust_raytrace_tpu.engine import Engine as JEngine
    jscene, scene, vp = circles_pair(False)
    kw = past_cap(jscene)
    rk = dict(fixed_rng=True) if fixed_rng else {}
    ref = JEngine(jscene, interpret=True, **kw).render(
        vp, key=jax.random.PRNGKey(2), debug=True, **rk)
    mine = Engine(scene, device="cpu", **kw).render(
        vp, key=prng_key(2), debug=True, **rk)
    np.testing.assert_array_equal(mine.image, ref.image)
    np.testing.assert_array_equal(mine.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine.primary_t.view(np.uint32),
                                  ref.primary_t.view(np.uint32))
    np.testing.assert_array_equal(mine.primary_id, ref.primary_id)
    np.testing.assert_array_equal(mine.primary_chunk, ref.primary_chunk)
    assert len(mine.chunk_tris) == len(ref.chunk_tris)
    for a, b in zip(mine.chunk_tris, ref.chunk_tris):
        np.testing.assert_array_equal(a, b)


def _flag_inputs(c):
    st = c["state"]
    return (torch.from_numpy(st[0:3]), torch.from_numpy(st[3:6]),
            torch.from_numpy(st[7] != 0),
            torch.from_numpy(c["pages"].aabb_lo),
            torch.from_numpy(c["pages"].aabb_hi))


@pytest.mark.parametrize("rc", [1024, 2048])
def test_cull_chunk_live_equals_pallas(rc):
    """B1 with chunk_live: a chunk flagged 0 gets an empty mask and tmin
    +inf, though its rays hit pages."""
    c = flags_case(rc)
    flags = c["chunk_live"].copy()
    flags[3] = 0                            # a chunk whose rays do hit
    args = _flag_inputs(c)
    mask, tmin = cull_mask_exact(*args, rc, chunk_live=torch.from_numpy(flags))
    jm, jt = cull_mask_exact_pallas(
        *(jnp.asarray(a.numpy()) for a in args), rc,
        chunk_live=jnp.asarray(flags), interpret=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tmin.numpy().view(np.uint32),
                                  np.asarray(jt).view(np.uint32))
    unflagged, tmin0 = cull_mask_exact(*args, rc)
    assert unflagged[3].any() and not mask[3].any()
    assert torch.isinf(tmin[3]).all()
    live = torch.from_numpy(flags != 0)
    assert torch.equal(mask[live], unflagged[live])
    assert torch.equal(tmin[live], tmin0[live])


@pytest.mark.parametrize("fixed_rng", [True, False], ids=["fixed", "live"])
@pytest.mark.parametrize("rc", [1024, 2048])
def test_trace_shade_flags_equal_pallas(rc, fixed_rng):
    """B2 with chunk_live and grid_live: the flagged chunk and those past
    grid_live keep their state words (-0 and NaN included); the others
    are traced and shaded as without flags."""
    c = flags_case(rc)
    st = c["state"]
    seed = np.asarray([5, 123], np.uint32)
    flags, gl = c["chunk_live"], c["grid_live"]
    lists = (torch.from_numpy(c["PK"]), c["counts"], c["plist"], c["ptmin"],
             seed, P, rc, fixed_rng, 1 / 512)
    mine = trace_shade_chunks(
        torch.from_numpy(st), *lists, chunk_live=torch.from_numpy(flags),
        grid_live=torch.tensor(gl, dtype=torch.int32)).numpy()
    ref = np.asarray(trace_shade_chunks_pallas(
        jnp.asarray(st), jnp.asarray(c["PK"]),
        jnp.asarray(c["counts"].numpy()), jnp.asarray(c["plist"].numpy()),
        jnp.asarray(c["ptmin"].numpy()), jnp.asarray(seed), P, rc,
        fixed_rng=fixed_rng, weight_cutoff=1 / 512, interpret=True,
        chunk_live=jnp.asarray(flags), grid_live=jnp.int32(gl)))
    np.testing.assert_array_equal(mine.view(np.uint32), ref.view(np.uint32))
    plain = trace_shade_chunks(torch.from_numpy(st), *lists).numpy()
    words, src = mine.view(np.uint32), st.view(np.uint32)
    for ch in range(NC):
        lanes = slice(ch * rc, (ch + 1) * rc)
        if LIVE_FLAGS[ch] == 0 or ch >= GRID_LIVE:
            np.testing.assert_array_equal(words[:, lanes], src[:, lanes])
        else:
            np.testing.assert_array_equal(words[:, lanes],
                                          plain[:, lanes].view(np.uint32))
    assert not np.array_equal(words[:, :rc], src[:, :rc])
