"""The port's CUDA kernels on the card against their plain versions.

Marked `cuda`; each test skips where torch sees no CUDA device.  This file
imports no jax, so it runs on a machine without it:

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from rust_raytrace_tpu_torch.engine import (Engine, camera_rays_tiled,
                                            page_lists, pick_tile,
                                            shadow_mask_perlane, shadow_rays)
from rust_raytrace_tpu_torch import math3d as m3
from rust_raytrace_tpu_torch.camera import create_viewport
from rust_raytrace_tpu_torch.geometry import make_sphere, make_triangles
from rust_raytrace_tpu_torch.materials import matte, reflective
from rust_raytrace_tpu_torch.ops import (compact, cull, intersect,
                                        intersect_perlane, intersect_streamed,
                                        shade)
from rust_raytrace_tpu_torch.models import circles
from rust_raytrace_tpu_torch.render import WavefrontRenderer, camera_rays
from rust_raytrace_tpu_torch.scene import LightSource, assemble
from rust_raytrace_tpu_torch.utils import native, png
from rust_raytrace_tpu_torch.utils.rng import fold_in, prng_key

pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "circles_96x54.png")
RB = 128
#: the teapot preset's light, (ox, oy, oz, len2)
LIGHT = (-4.0, 8.0, 0.0, 0.2)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def wave0(dev):
    """The engine and the wave-0 state of circles at 96x54."""
    scene, vp = circles.build(resolution=(96, 54), maxdepth=5)
    eng = Engine(scene, ray_chunk=RB, device=dev)
    R = -(-vp.width * vp.height // RB) * RB
    o, d = camera_rays_tiled(vp, pick_tile(vp.width, vp.height), R, dev)
    o, pk0 = eng._pinhole_fold(vp, o)
    alive = (torch.arange(R, device=dev) < vp.width * vp.height).float()
    st = torch.cat([o, d, alive[None], alive[None],
                    torch.zeros((8, R), device=dev)])
    return eng, st, pk0


def _assert_states(got, want):
    assert torch.equal(got[[7, 11]], want[[7, 11]])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_kernels_match_plain(wave0):
    eng, st, pk0 = wave0
    P = eng.page_size
    args = (st[0:3], st[3:6], st[7] != 0, eng.aabb_lo, eng.aabb_hi, RB)
    mask, tmin = cull.cull_mask_exact(*args)
    mask_p, tmin_p = cull.cull_mask_exact_plain(*args)
    assert torch.equal(mask, mask_p) and torch.equal(tmin, tmin_p)

    counts, plist, ptmin = page_lists(mask, tmin)
    # the unfolded pages with the true origins (zero_origin=False) too
    args = (st, eng.PK, counts, plist, ptmin, fold_in(prng_key(3), 0), P, RB,
            False, 1 / 512)
    _assert_states(intersect.trace_shade_chunks(*args),
                   intersect.trace_shade_chunks_plain(*args))
    for fixed in (True, False):
        args = (st, pk0, counts, plist, ptmin, fold_in(prng_key(3), 0), P,
                RB, fixed, 1 / 512)
        st1 = intersect.trace_shade_chunks(*args, zero_origin=True)
        _assert_states(st1, intersect.trace_shade_chunks_plain(
            *args, zero_origin=True))
        live = (st1[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
        args = (st1, eng.ptables, fold_in(prng_key(3), 1), P, RB, fixed,
                1 / 512, live)
        _assert_states(intersect_perlane.trace_shade_perlane(*args),
                       intersect_perlane.trace_shade_perlane_plain(*args))


@pytest.mark.parametrize("R,cb", [(16384, 512), (3072, 128)])
def test_compaction_kernels_match_plain(dev, R, cb):
    """B3 and B5 bitwise against their plain versions, on an identity
    boundary too; with grid_live, B5 within the prefix."""
    g = torch.Generator(device="cpu").manual_seed(R)
    st = torch.randn((16, R), generator=g)
    u = torch.rand(R, generator=g)
    st[7] = (u < 0.4).float()
    st[11] = ((u >= 0.4) & (u < 0.7)).float()
    st[7, :cb], st[11, :cb] = 1.0, 0.0
    st[7, cb:2 * cb], st[11, cb:2 * cb] = 0.0, 1.0
    st = st.to(dev)
    base = torch.tensor(256, dtype=torch.int32, device=dev)
    for ident in (0, 1):
        meta, total_a, _, _ = compact.compact_meta(st[7], st[11], cb, base, R)
        meta[:, compact.M_IDENT] = ident
        dead = torch.rand((8, 2 * R), generator=g).to(dev)
        out_k, dead_k = compact.compact(st, dead.clone(), meta, cb)
        out_p, dead_p = compact.compact_plain(st, dead.clone(), meta, cb)
        assert torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))
        assert torch.equal(dead_k.view(torch.int32), dead_p.view(torch.int32))
        masks = torch.stack([st[7], st[11]])
        y = out_k[8:12].contiguous()
        back_k = compact.expand(y, dead_k, masks, meta, cb)
        back_p = compact.expand_plain(y, dead_k, masks, meta, cb)
        assert torch.equal(back_k.view(torch.int32), back_p.view(torch.int32))
        half = torch.tensor(R // 2, dtype=torch.int32, device=dev)
        back_g = compact.expand(y, dead_k, masks, meta, cb, grid_live=half)
        assert torch.equal(back_g[:, :R // 2], back_p[:, :R // 2])


@pytest.mark.parametrize("R,cb", [(16384, 512), (3072, 128)])
def test_second_boundary_kernels_match_plain(dev, R, cb):
    """The second boundary of a schedule: B3 with grid_live (the first
    boundary's prefix) and dead_base > 0 bitwise, B5 with grid_live within
    the prefix."""
    g = torch.Generator(device="cpu").manual_seed(R + 1)
    st = torch.randn((16, R), generator=g)
    u = torch.rand(R, generator=g)
    st[7] = (u < 0.5).float()
    st[11] = (u >= 0.8).float()
    st = st.to(dev)
    base = torch.zeros((), dtype=torch.int32, device=dev)
    meta, total_a, _, dead_end = compact.compact_meta(st[7], st[11], cb,
                                                      base, R)
    dead = compact.make_dead_array(R, dev, 2, cb)
    st1, dead = compact.compact(st, dead, meta, cb)
    # a wave on the prefix: some survivors retire
    v = torch.rand(R, generator=g).to(dev)
    retire = (st1[7] != 0) & (v < 0.4)
    st1[7] = torch.where(retire, 0.0, st1[7])
    st1[11] = torch.where(retire, 1.0, st1[11])
    meta2, _, skip, _ = compact.compact_meta(st1[7], st1[11], cb, dead_end, R)
    assert not bool(skip) and int(dead_end) > 0
    out_k, dead_k = compact.compact(st1, dead.clone(), meta2, cb,
                                    grid_live=total_a)
    out_p, dead_p = compact.compact_plain(st1, dead.clone(), meta2, cb)
    assert torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))
    assert torch.equal(dead_k.view(torch.int32), dead_p.view(torch.int32))
    masks = torch.stack([st1[7], st1[11]])
    y = out_k[8:12].contiguous()
    n = int(total_a)
    back_k = compact.expand(y, dead_k, masks, meta2, cb, grid_live=total_a)
    back_p = compact.expand_plain(y, dead_k, masks, meta2, cb)
    assert torch.equal(back_k[:, :n].contiguous().view(torch.int32),
                       back_p[:, :n].contiguous().view(torch.int32))


def test_golden_on_card_launches_every_kernel(dev):
    """The default Engine: compaction after waves 0 and 1 on the first
    render (the autotune replans only afterwards)."""
    scene, vp = circles.build(resolution=(96, 54), maxdepth=5)
    eng = Engine(scene, device=dev)
    native.reset_launch_counts()
    img = eng.render(vp, fixed_rng=True).image
    np.testing.assert_array_equal(img, png.read_png(GOLDEN))
    launches = {k.name: k.launches for k in native.KERNELS}
    assert launches == {"cull_mask_exact": 1, "trace_shade_chunks": 1,
                        "compact": 2, "trace_shade_perlane": vp.maxdepth - 1,
                        "expand": 2, "trace_chunks": 0, "shade": 0,
                        "trace_shade_streamed": 0, "trace_streamed": 0,
                        "nearest_hit": 0, "trace_perlane": 0,
                        "bankmajor_prep": 0, "bankmajor_sweep": 0,
                        "bankmajor_finish": 0, "cull_sorted": 0,
                        "compact_buckets": 0, "expand_buckets": 0}


def _bitwise(got, want):
    bad = got.view(torch.int32) != want.view(torch.int32)
    where = torch.nonzero(bad)[:5].tolist()
    assert not bad.any(), (f"{int(bad.sum())} words differ, e.g. at {where}: "
                           f"{[float(got[tuple(i)]) for i in where]} vs "
                           f"{[float(want[tuple(i)]) for i in where]}")


@pytest.mark.parametrize("fixed", [True, False])
def test_lights_kernels_match_plain(wave0, fixed):
    """The lights path's kernels bitwise against their plain versions: B6
    on camera rays (folded pages) and on the shadow rays with
    self-exclusion, B8 with the shadow mask, B4 with the fused feeler."""
    eng, st, pk0 = wave0
    P = eng.page_size
    key = prng_key(3)
    mask, tmin = cull.cull_mask_exact(st[0:3], st[3:6], st[7] != 0,
                                      eng.aabb_lo, eng.aabb_hi, RB)
    lists = page_lists(mask, tmin)
    rows = intersect.trace_chunks(st[0:3], st[3:6], pk0, *lists, P, RB,
                                  zero_origin=True)
    _bitwise(rows, intersect.trace_chunks_plain(st[0:3], st[3:6], pk0,
                                                *lists, RB, True))
    so, sd, hit, excl = shadow_rays(st, rows, key, 0, fixed, LIGHT)
    smask, stmin = cull.cull_mask_exact(so, sd, hit, eng.aabb_lo,
                                        eng.aabb_hi, RB)
    slists = page_lists(smask, stmin)
    srows = intersect.trace_chunks(so, sd, eng.PK, *slists, P, RB, excl=excl)
    _bitwise(srows, intersect.trace_chunks_plain(so, sd, eng.PK, *slists, RB,
                                                 excl=excl))
    shd = (hit & (srows[1] != 0)).float()
    assert 0 < int(shd.sum()) < int(hit.sum())
    live = torch.ones(st.shape[1] // RB, dtype=torch.int32, device=st.device)
    args = (st, rows, fold_in(key, 0), RB, fixed, 1 / 512, live, shd)
    st1 = shade.shade(*args)
    _bitwise(st1, shade.shade_plain(*args))
    clive = (st1[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    args = (st1, eng.ptables, fold_in(key, 1), P, RB, fixed, 1 / 512, clive,
            LIGHT)
    _bitwise(intersect_perlane.trace_shade_perlane(*args),
             intersect_perlane.trace_shade_perlane_plain(*args))


def test_lit_render_on_card_equals_cpu(dev):
    """circles 96x54 with the light, default Engine: the card's render
    equals the CPU's (plain versions) bitwise, through the lights path's
    kernels and not B2."""
    scene, vp = circles.build(resolution=(96, 54), maxdepth=5)
    scene.lights = LightSource(orig=np.asarray(LIGHT[:3], np.float32),
                               len2=LIGHT[3])
    native.reset_launch_counts()
    img = Engine(scene, device=dev).render(vp, key=prng_key(1)).image
    launches = {k.name: k.launches for k in native.KERNELS}
    assert launches == {"cull_mask_exact": 2, "trace_shade_chunks": 0,
                        "compact": 2, "trace_shade_perlane": vp.maxdepth - 1,
                        "expand": 2, "trace_chunks": 2, "shade": 1,
                        "trace_shade_streamed": 0, "trace_streamed": 0,
                        "nearest_hit": 0, "trace_perlane": 0,
                        "bankmajor_prep": 0, "bankmajor_sweep": 0,
                        "bankmajor_finish": 0, "cull_sorted": 0,
                        "compact_buckets": 0, "expand_buckets": 0}
    ref = Engine(scene, device="cpu").render(vp, key=prng_key(1)).image
    np.testing.assert_array_equal(img, ref)


def _sphere_scene(lit: bool):
    """A 40x40 sphere over a floor: 4 banks of pages at page size 8, with
    the teapot preset's light or without."""
    scene = assemble([
        make_sphere((0.0, 0.0, 6.0), 2.5, (40, 40),
                    matte(m3.make_color((252, 119, 0)), 0.2), 0.0),
        make_triangles(np.asarray([[[-20, -3, -10], [20, -3, -10],
                                    [0, -3, 40]]], np.float32),
                       reflective(m3.make_color((120, 120, 120)), 0.8, 0.1),
                       0.0)])
    if lit:
        scene.lights = LightSource(orig=np.asarray(LIGHT[:3], np.float32),
                                   len2=LIGHT[3])
    vp = create_viewport((64, 48), (1.0, 0.75), (0.0, 0.0, 0.0),
                         m3.unit(m3.vec(0.0, -0.2, 1.0)), 90.0, 0.0, 4, 1)
    return scene, vp


@pytest.mark.parametrize("fixed", [True, False])
def test_streamed_kernels_match_plain(dev, fixed):
    """B10 (nearest rows; with self-exclusion; a dead chunk; the any-hit
    occlusion bit) and B9 (every chunk live, then the wave-1 state with its
    chunk_live) bitwise against their plain versions on 4 banks."""
    scene, vp = _sphere_scene(False)
    eng = Engine(scene, page_size=8, ray_chunk=RB, streamed=True, device=dev)
    tabs = eng.stables
    R = -(-vp.width * vp.height // RB) * RB
    o, d = camera_rays_tiled(vp, pick_tile(vp.width, vp.height), R, dev)
    o, _ = eng._pinhole_fold(vp, o)
    alive = (torch.arange(R, device=dev) < vp.width * vp.height).float()
    st = torch.cat([o, d, alive[None], alive[None],
                    torch.zeros((8, R), device=dev)])
    nc = R // RB
    dead = torch.ones(nc, dtype=torch.int32, device=dev)
    dead[1::3] = 0
    rows = intersect_streamed.trace_streamed(o, d, alive, tabs, 8, RB)
    for kw in ({}, {"excl": rows[1].contiguous()}, {"chunk_live": dead}):
        _bitwise(intersect_streamed.trace_streamed(o, d, alive, tabs, 8, RB,
                                                   **kw),
                 intersect_streamed.trace_streamed_plain(
                     o, d, alive, tabs, 8, RB, **kw))
    so, sd, hit, excl = shadow_rays(st, rows, prng_key(3), 0, fixed, LIGHT)
    args = (so, sd, hit.float(), tabs, 8, RB)
    occ = intersect_streamed.trace_streamed(*args, excl=excl, any_hit=True)
    occ_p = intersect_streamed.trace_streamed_plain(*args, excl=excl,
                                                    any_hit=True)
    assert torch.equal(occ[1] != 0, occ_p[1] != 0)
    assert 0 < int((occ[1] != 0).sum()) < int(hit.sum())
    key = prng_key(3)
    for live in (torch.ones(nc, dtype=torch.int32, device=dev), dead):
        args = (st, tabs, fold_in(key, 0), 8, RB, fixed, 1 / 512, live)
        st1 = intersect_streamed.trace_shade_streamed(*args)
        _bitwise(st1, intersect_streamed.trace_shade_streamed_plain(*args))
    clive = (st1[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    args = (st1, tabs, fold_in(key, 1), 8, RB, fixed, 1 / 512, clive)
    _bitwise(intersect_streamed.trace_shade_streamed(*args),
             intersect_streamed.trace_shade_streamed_plain(*args))


@pytest.mark.parametrize("lit", [False, True])
def test_streamed_render_on_card_equals_cpu(dev, lit):
    """The forced-streamed Engine: the card's render equals the CPU's
    bitwise, through B9 (unlit) or B10 and B8 (lit), never B1, B2 or B4."""
    scene, vp = _sphere_scene(lit)
    native.reset_launch_counts()
    img = Engine(scene, page_size=8, ray_chunk=RB, streamed=True,
                 device=dev).render(vp, key=prng_key(1)).image
    launches = {k.name: k.launches for k in native.KERNELS}
    assert launches["cull_mask_exact"] == launches["trace_shade_chunks"] \
        == launches["trace_shade_perlane"] == 0
    assert launches["compact"] == launches["expand"] == 2
    if lit:
        assert launches["trace_streamed"] == 2 * vp.maxdepth
        assert launches["shade"] == vp.maxdepth
        assert launches["trace_shade_streamed"] == 0
    else:
        assert launches["trace_shade_streamed"] == vp.maxdepth
        assert launches["trace_streamed"] == launches["shade"] == 0
    ref = Engine(scene, page_size=8, ray_chunk=RB, streamed=True,
                 device="cpu").render(vp, key=prng_key(1)).image
    np.testing.assert_array_equal(img, ref)


def test_nearest_hit_matches_plain(dev):
    """B11 on circles' camera rays at 96x54 and on rays from the image
    plane in scattered directions, page size 256, with R not a multiple of
    the kernel's block: t and id bitwise."""
    scene, vp = circles.build(resolution=(96, 54), maxdepth=5)
    wr = WavefrontRenderer(scene, device=dev)
    o, d = camera_rays(vp, prng_key(0), dev)
    gen = torch.Generator(device="cpu").manual_seed(5)
    d2 = torch.nn.functional.normalize(
        torch.rand((1000, 3), generator=gen) - 0.5, dim=1).to(dev)
    PK = wr.tensors.PK
    for O, D in ((o, d), (o[:1000].contiguous(), d2.contiguous())):
        native.reset_launch_counts()
        t, i = intersect.nearest_hit(O, D, PK, 256)
        assert native.NEAREST_HIT.launches == 1
        tp, ip = intersect.nearest_hit_plain(O, D, PK)
        torch.cuda.synchronize()
        _bitwise(t, tp)
        assert torch.equal(i, ip) and i.dtype == torch.int32
        assert 0 < int((i != 0).sum()) < O.shape[0]


@pytest.mark.parametrize("backend", ["kernel", "portable"])
def test_wavefront_render_on_card_equals_cpu(dev, backend):
    """WavefrontRenderer at 64x36, live RNG, in two slabs: the card's float
    image, primary buffers and wave_rays equal the CPU's bitwise; the
    kernel backend launches B11 once a wave of each slab and nothing
    else."""
    scene, vp = circles.build(resolution=(64, 36), maxdepth=4)
    kw = dict(backend=backend, slab_size=1536)
    native.reset_launch_counts()
    got = WavefrontRenderer(scene, device=dev, **kw).render(
        vp, key=prng_key(2))
    launches = {k.name: k.launches for k in native.KERNELS}
    want = WavefrontRenderer(scene, device="cpu", **kw).render(
        vp, key=prng_key(2))
    n_b11 = 2 * vp.maxdepth if backend == "kernel" else 0
    assert launches == {k: (n_b11 if k == "nearest_hit" else 0)
                        for k in launches}
    for a, b in ((got.image, want.image), (got.primary_t, want.primary_t)):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    np.testing.assert_array_equal(got.primary_id, want.primary_id)
    np.testing.assert_array_equal(got.wave_rays, want.wave_rays)


def _sphere_state(eng, vp, dev):
    R = -(-vp.width * vp.height // RB) * RB
    o, d = camera_rays_tiled(vp, pick_tile(vp.width, vp.height), R, dev)
    o, _ = eng._pinhole_fold(vp, o)
    alive = (torch.arange(R, device=dev) < vp.width * vp.height).float()
    return torch.cat([o, d, alive[None], alive[None],
                      torch.zeros((8, R), device=dev)])


@pytest.mark.parametrize("fixed", [True, False])
def test_trace_perlane_matches_plain(dev, fixed):
    """B7 on the resident tables of 4 banks (page size 8): nearest rows,
    with self-exclusion, with a dead chunk, bitwise; the any-hit occlusion
    bit of the lit wave's shadow rays, and the per-lane shadow pass,
    against the plain versions."""
    scene, vp = _sphere_scene(False)
    eng = Engine(scene, page_size=8, ray_chunk=RB, device=dev)
    assert not eng.streamed and eng.ptables.ab.shape[0] == 4 * 128
    tabs = eng.ptables
    st = _sphere_state(eng, vp, dev)
    o, d, alive = st[0:3], st[3:6], st[7]
    rows = intersect_perlane.trace_perlane(o, d, alive, tabs, 8, RB)
    dead = torch.ones(st.shape[1] // RB, dtype=torch.int32, device=dev)
    dead[1::3] = 0
    for kw in ({}, {"excl": rows[1].contiguous()}, {"chunk_live": dead}):
        native.reset_launch_counts()
        got = intersect_perlane.trace_perlane(o, d, alive, tabs, 8, RB, **kw)
        assert native.TRACE_PERLANE.launches == 1
        _bitwise(got, intersect_perlane.trace_perlane_plain(
            o, d, alive, *tabs[:3], 8, ray_chunk=RB, **kw))
    key = prng_key(3)
    so, sd, hit, excl = shadow_rays(st, rows, key, 1, fixed, LIGHT)
    args = (so, sd, hit.float(), tabs, 8, RB)
    occ = intersect_perlane.trace_perlane(*args, excl=excl, any_hit=True)
    occ_p = intersect_perlane.trace_perlane_plain(
        so, sd, hit.float(), *tabs[:3], 8, excl=excl, any_hit=True)
    assert torch.equal(occ[1] != 0, occ_p[1] != 0)
    assert 0 < int((occ[1] != 0).sum()) < int(hit.sum())
    shd = shadow_mask_perlane(st, rows, key, 1, fixed, LIGHT, tabs, 8, RB)
    assert torch.equal(shd != 0, hit & (occ[1] != 0))


@pytest.mark.parametrize("mode", ["nearest", "excl", "dead_chunk",
                                  "any_hit"])
def test_trace_perlane_walk_case_matches_plain(dev, mode):
    """B7 on tests/streamed_walk_cases.py's scene as resident tables (4
    banks of pages of 8, the last mostly padding; a triangle and its copy
    in two banks, zero-normal slots mid-page) and state (camera rays, a
    chunk with no live ray, rays from inside the sphere, dead lanes),
    bitwise against its plain version (any-hit: the occlusion bit)."""
    import streamed_walk_cases as W
    from rust_raytrace_tpu_torch.ops.intersect_perlane import (
        build_perlane_tables, perlane_tables)

    pages, _, targets = W.scene()
    tabs = perlane_tables(*(torch.from_numpy(x).to(dev)
                            for x in build_perlane_tables(pages)))
    st = torch.from_numpy(W.state(targets)).to(dev)
    o, d, alive = st[0:3], st[3:6], st[7]
    kw = {}
    if mode in ("excl", "any_hit"):
        kw["excl"] = intersect_perlane.trace_perlane_plain(
            o, d, alive, *tabs[:3], W.P)[1].contiguous()
    if mode == "dead_chunk":
        kw["chunk_live"] = torch.ones(W.NC, dtype=torch.int32, device=dev)
        kw["chunk_live"][W.INSIDE_CHUNK] = 0
    kw["any_hit"] = mode == "any_hit"
    native.reset_launch_counts()
    got = intersect_perlane.trace_perlane(o, d, alive, tabs, W.P, W.RB, **kw)
    assert native.TRACE_PERLANE.launches == 1
    want = intersect_perlane.trace_perlane_plain(o, d, alive, *tabs[:3], W.P,
                                                 ray_chunk=W.RB, **kw)
    if mode == "any_hit":
        assert torch.equal(got[1] != 0, want[1] != 0)
    else:
        _bitwise(got, want)
    assert bool((got[1] != 0).any())


@pytest.mark.parametrize("fixed", [True, False])
def test_bankmajor_kernels_match_plain(dev, fixed):
    """B12 on 4 streamed banks, on the wave-2 state (after B9 waves 0 and
    1, dead chunks in it): prep's winner init and group demand, the sweep's
    winner stream (t, id, slot) and finish's state bitwise against the
    plain phases; the chained B12 equals B9 bitwise."""
    scene, vp = _sphere_scene(False)
    eng = Engine(scene, page_size=8, ray_chunk=RB, streamed=True, device=dev)
    tabs = eng.stables
    NB = tabs[0].shape[0]
    st = _sphere_state(eng, vp, dev)
    key = prng_key(3)
    wc = 0.0 if fixed else 1 / 512
    nc = st.shape[1] // RB
    live = torch.ones(nc, dtype=torch.int32, device=dev)
    for wave in (0, 1):
        st = intersect_streamed.trace_shade_streamed(
            st, tabs, fold_in(key, wave), 8, RB, fixed, wc, live)
        live = (st[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    assert 0 < int(live.sum()) < nc
    native.reset_launch_counts()
    win, gm = intersect_streamed.bankmajor_prep(st, tabs[3], NB, RB, live)
    win_p, gm_p = intersect_streamed.bankmajor_prep_plain(st, tabs[3], NB,
                                                          RB, live)
    _bitwise(win, win_p)
    assert torch.equal(gm, gm_p) and int((gm != 0).sum()) > 0
    count, order = intersect_streamed.bankmajor_order(gm)
    sw = intersect_streamed.bankmajor_sweep(st, win, gm, count, order, tabs,
                                            8, RB)
    _bitwise(sw, intersect_streamed.bankmajor_sweep_plain(
        st, win, gm, count, order, tabs, 8, RB))
    seed = fold_in(key, 2)
    fin = intersect_streamed.bankmajor_finish(st, sw, tabs[0], tabs[1], seed,
                                              8, RB, fixed, wc, live)
    _bitwise(fin, intersect_streamed.bankmajor_finish_plain(
        st, sw, tabs[0], tabs[1], seed, 8, RB, fixed, wc, live))
    assert (native.BM_PREP.launches, native.BM_SWEEP.launches,
            native.BM_FINISH.launches) == (1, 1, 1)
    _bitwise(intersect_streamed.trace_shade_bankmajor(
        st, tabs, seed, 8, RB, fixed, wc, live),
        intersect_streamed.trace_shade_streamed(st, tabs, seed, 8, RB,
                                                fixed, wc, live))


def test_streamed_records_on_card_equal_cpu(dev):
    """The streamed Engine's tables on the card, the page-major records
    built there included, equal the CPU build word for word."""
    scene, _ = _sphere_scene(False)
    eng = Engine(scene, page_size=8, ray_chunk=RB, streamed=True, device=dev)
    ref = intersect_streamed.upload_streamed_tables(eng.pages, "cpu")
    assert eng.stables.rec.shape == (eng.stables.ab.shape[0], 8, 24)
    for name, got, want in zip(ref._fields, eng.stables, ref):
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)), name


def _sweep_grids(fn) -> int:
    """The bm_sweep_kernel grids the card ran during fn()."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if "bm_sweep_kernel" in e.name)


def test_bankmajor_sweep_one_launch(dev):
    """B12b launches one grid a call, with demand and with none (every
    chunk dead: an empty wave), and the empty wave changes no winner."""
    scene, vp = _sphere_scene(False)
    eng = Engine(scene, page_size=8, ray_chunk=RB, streamed=True, device=dev)
    tabs = eng.stables
    NB = tabs.plt_i.shape[0]
    st = _sphere_state(eng, vp, dev)
    nc = st.shape[1] // RB
    for live in (torch.ones(nc, dtype=torch.int32, device=dev),
                 torch.zeros(nc, dtype=torch.int32, device=dev)):
        win, gm = intersect_streamed.bankmajor_prep(st, tabs.bank_ab, NB, RB,
                                                    live)
        count, order = intersect_streamed.bankmajor_order(gm)
        native.reset_launch_counts()
        out = []
        grids = _sweep_grids(lambda: out.append(
            intersect_streamed.bankmajor_sweep(st, win, gm, count, order,
                                               tabs, 8, RB)))
        assert grids == 1 and native.BM_SWEEP.launches == 1
        if int(live.sum()) == 0:
            assert int(count.sum()) == 0
            _bitwise(out[0], win)
        else:
            assert int((out[0][1] != 0).sum()) > 0


def test_bankmajor_render_on_card_equals_cpu(dev):
    """Engine(streamed=True, bank_major=True): the card's render equals the
    CPU's bitwise and the default streamed Engine's; B9 on waves 0-1, B12's
    three kernels on each later wave, never B1, B2, B4 or B11."""
    scene, vp = _sphere_scene(False)
    eng = Engine(scene, page_size=8, ray_chunk=RB, streamed=True,
                 bank_major=True, device=dev)
    native.reset_launch_counts()
    img = eng.render(vp, key=prng_key(1)).image
    launches = {k.name: k.launches for k in native.KERNELS}
    n = vp.maxdepth - 2
    assert launches == {k: {"trace_shade_streamed": 2, "compact": 2,
                            "expand": 2, "bankmajor_prep": n,
                            "bankmajor_sweep": n,
                            "bankmajor_finish": n}.get(k, 0)
                        for k in launches}
    ref = Engine(scene, page_size=8, ray_chunk=RB, streamed=True,
                 bank_major=True, device="cpu").render(
                     vp, key=prng_key(1)).image
    np.testing.assert_array_equal(img, ref)
    wl = Engine(scene, page_size=8, ray_chunk=RB, streamed=True,
                device=dev).render(vp, key=prng_key(1)).image
    np.testing.assert_array_equal(img, wl)


def _camera_state(eng, vp, R, dev):
    """The wave-0 state of vp's camera rays padded to R lanes, and the
    folded pages (None in the streamed regime)."""
    o, d = camera_rays_tiled(vp, pick_tile(vp.width, vp.height), R, dev)
    o, pk0 = eng._pinhole_fold(vp, o)
    alive = (torch.arange(R, device=dev) < vp.width * vp.height).float()
    return torch.cat([o, d, alive[None], alive[None],
                      torch.zeros((8, R), device=dev)]), pk0


@pytest.mark.parametrize("rc", [128, 1024, 2048])
def test_cull_sorted_matches_plain(dev, rc):
    """B13 bitwise against its plain version on the 4-bank sphere's camera
    rays (NP ~510, NPpad 512) with a dead chunk, and its split-form cross
    check (B1, then a stable sort)."""
    scene, vp = _sphere_scene(False)
    eng = Engine(scene, page_size=8, ray_chunk=RB, device=dev)
    NP = eng.aabb_lo.shape[0]
    R = -(-vp.width * vp.height // 2048) * 2048
    st, _ = _camera_state(eng, vp, R, dev)
    live = torch.ones(R // rc, dtype=torch.int32, device=dev)
    live[-1] = 0
    args = (st[0:3], st[3:6], st[7] != 0, eng.aabb_lo, eng.aabb_hi, rc)
    native.reset_launch_counts()
    got = cull.cull_sorted(*args, chunk_live=live)
    assert native.CULL_SORTED.launches == 1
    want = cull.cull_sorted_plain(*args, chunk_live=live)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _bitwise(got[2], want[2])
    assert got[1].shape == (R // rc, -(-NP // 128) * 128)
    counts, plist, ptmin = cull.cull_sorted(*args)
    mask, tmin = cull.cull_mask_exact(*args)
    assert torch.equal(counts, mask.sum(dim=1, dtype=torch.int32))
    assert torch.equal(plist[:, :NP].long(),
                       torch.argsort(tmin, dim=1, stable=True))
    assert int(counts.max()) > 0


def test_cull_sorted_branch_case_matches_plain(dev):
    """B13 on tests/cull_sorted_cases.py: a chunk on the fast path, a chunk
    whose hit keys reach BIGT and beyond (the all-pairs branch), a dead
    chunk and one with no valid ray, bitwise against its plain version."""
    import cull_sorted_cases as C

    o, d, valid, blo, bhi, live = (torch.from_numpy(x).to(dev)
                                   for x in C.case())
    args = (o, d, valid, blo, bhi, C.RB)
    native.reset_launch_counts()
    got = cull.cull_sorted(*args, chunk_live=live)
    assert native.CULL_SORTED.launches == 1
    want = cull.cull_sorted_plain(*args, chunk_live=live)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _bitwise(got[2], want[2])
    assert float(want[2][C.ALL_PAIRS_CHUNK].max()) > cull.BIGT


def _bucket_state(dev, R, cb, n_oct, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    st = torch.randn((16, R), generator=g)
    u = torch.rand(R, generator=g)
    code = torch.zeros(R)
    alive = u < 0.4
    code[alive] = (2 + torch.randint(0, n_oct, (R,), generator=g)
                   .float())[alive]
    code[(u >= 0.4) & (u < 0.7)] = 1.0
    code[:cb] = 0.0                                  # an idle chunk
    st[compact.ROW_CODE] = code
    st[8, cb:cb + 40] = -0.0
    st.view(torch.int32)[9, cb + 3] = 0x7FC12345
    return st.to(dev), code.to(dev)


@pytest.mark.parametrize("cb,R,n_oct", [(512, 16384, 2), (256, 3072, 2),
                                        (256, 256 * 6, 8)])
def test_bucketed_compaction_matches_plain(dev, cb, R, n_oct):
    """B14a and B14b bitwise against their plain versions, on a dead array
    whose lanes are not zero; n_oct 8 overflows (segments past R are not
    written, by the kernel as by the plain version)."""
    st, code = _bucket_state(dev, R, cb, n_oct, seed=R + cb)
    base = torch.tensor(256, dtype=torch.int32, device=dev)
    meta, total_a, overflow, _ = compact.compact_meta_buckets(code, cb, base,
                                                              R)
    assert bool(overflow) == (n_oct == 8)
    dead = torch.randn((8, 2 * R), device=dev)
    native.reset_launch_counts()
    out_k, dead_k = compact.compact_buckets(st, dead.clone(), meta, cb)
    out_p, dead_p = compact.compact_buckets_plain(st, dead.clone(), meta, cb)
    _bitwise(out_k, out_p)
    _bitwise(dead_k, dead_p)
    y = out_k[8:16].contiguous()
    back_k = compact.expand_buckets(y, dead_k, code[None], meta, cb)
    back_p = compact.expand_buckets_plain(y, dead_k, code[None], meta, cb)
    _bitwise(back_k, back_p)
    assert (native.COMPACT_BUCKETS.launches,
            native.EXPAND_BUCKETS.launches) == (1, 1)
    if not bool(overflow):
        both = code != 0
        _bitwise(back_k[:, both].contiguous(), st[8:16, both].contiguous())


@pytest.mark.parametrize("rc", [2048, 4096])
def test_ray_chunk_kernels_match_plain(dev, rc):
    """The kernels whose block is one chunk, at ray_chunk 2048 and 4096
    (blocks of 1024 threads, 2 or 4 rays a thread): B1, B2 (live and
    fixed RNG), B6 (camera rays, shadow rays with self-exclusion) and B12a,
    against their plain versions; then the Engine's render on the card
    equals the CPU's."""
    scene, vp = circles.build(resolution=(128, 64), maxdepth=3)
    eng = Engine(scene, ray_chunk=rc, device=dev)
    P = eng.page_size
    R = 128 * 64
    st, pk0 = _camera_state(eng, vp, R, dev)
    args = (st[0:3], st[3:6], st[7] != 0, eng.aabb_lo, eng.aabb_hi, rc)
    mask, tmin = cull.cull_mask_exact(*args)
    mask_p, tmin_p = cull.cull_mask_exact_plain(*args)
    assert torch.equal(mask, mask_p) and torch.equal(tmin, tmin_p)
    lists = page_lists(mask, tmin)
    for fixed in (True, False):
        a2 = (st, pk0, *lists, fold_in(prng_key(3), 0), P, rc, fixed, 1 / 512)
        _bitwise(intersect.trace_shade_chunks(*a2, zero_origin=True),
                 intersect.trace_shade_chunks_plain(*a2, zero_origin=True))
    rows = intersect.trace_chunks(st[0:3], st[3:6], pk0, *lists, P, rc,
                                  zero_origin=True)
    _bitwise(rows, intersect.trace_chunks_plain(st[0:3], st[3:6], pk0,
                                                *lists, rc, True))
    so, sd, hit, excl = shadow_rays(st, rows, prng_key(3), 0, False, LIGHT)
    sl = page_lists(*cull.cull_mask_exact(so, sd, hit, eng.aabb_lo,
                                          eng.aabb_hi, rc))
    _bitwise(intersect.trace_chunks(so, sd, eng.PK, *sl, P, rc, excl=excl),
             intersect.trace_chunks_plain(so, sd, eng.PK, *sl, rc,
                                          excl=excl))
    s_scene, s_vp = _sphere_scene(False)
    seng = Engine(s_scene, page_size=8, ray_chunk=rc, streamed=True,
                  device=dev)
    tabs = seng.stables
    sst, _ = _camera_state(seng, s_vp, 4096, dev)
    live = torch.ones(4096 // rc, dtype=torch.int32, device=dev)
    win, gm = intersect_streamed.bankmajor_prep(sst, tabs[3],
                                                tabs[0].shape[0], rc, live)
    win_p, gm_p = intersect_streamed.bankmajor_prep_plain(
        sst, tabs[3], tabs[0].shape[0], rc, live)
    _bitwise(win, win_p)
    assert torch.equal(gm, gm_p) and int((gm != 0).sum()) > 0
    img = eng.render(vp, key=prng_key(1)).image
    ref = Engine(scene, ray_chunk=rc, device="cpu").render(
        vp, key=prng_key(1)).image
    np.testing.assert_array_equal(img, ref)


@pytest.mark.parametrize("rc", [96, 1024, 2048, 3072, 4096])
def test_union_exit_kernels_match_plain(dev, rc):
    """B1, B6 and B2 on tests/union_exit_cases.py's inputs (copies of a
    triangle tied in two pages, winners on a chunk's last visited page,
    zero-normal slots mid-page, a chunk of invalid rays, a chunk whose
    count is 0, 37 pages): camera rays on folded pages, rays from
    scattered origins, each with and without the exclusion of the nearest
    triangle, against their plain versions bitwise (B1's tmin with
    torch.equal).  ray_chunk 96 leaves B1's last warp part empty (its
    kernel with slot checks) and 3072 gives B2/B6 three rays of four
    slots a thread."""
    import union_exit_cases as U

    for zero_origin, with_excl in ((True, False), (True, True),
                                   (False, False), (False, True)):
        c = U.case(rc, zero_origin, with_excl)
        ot, dt = c["ot"].to(dev), c["dt"].to(dev)
        lo = torch.from_numpy(c["pages"].aabb_lo).to(dev)
        hi = torch.from_numpy(c["pages"].aabb_hi).to(dev)
        args = (ot, dt, (dt != 0).any(dim=0), lo, hi, rc)
        mask, tmin = cull.cull_mask_exact(*args)
        mask_p, tmin_p = cull.cull_mask_exact_plain(*args)
        assert torch.equal(mask, mask_p) and torch.equal(tmin, tmin_p)
        assert not mask[U.DEAD_CHUNK].any()
        lists = [x.to(dev) for x in (c["counts"], c["plist"], c["ptmin"])]
        pk = c["pk"].to(dev)
        excl = None if c["excl"] is None else c["excl"].to(dev)
        rows = intersect.trace_chunks(ot, dt, pk, *lists, U.P, rc,
                                      zero_origin, excl)
        _bitwise(rows, intersect.trace_chunks_plain(ot, dt, pk, *lists, rc,
                                                    zero_origin, excl))
        if with_excl:
            continue
        st = torch.zeros((16, ot.shape[1]), device=dev)
        st[0:3], st[3:6] = ot, dt
        st[6] = 0.5
        st[7] = (dt != 0).any(dim=0).float()
        a2 = (st, pk, *lists, fold_in(prng_key(3), 0), U.P, rc, False,
              1 / 512)
        _bitwise(intersect.trace_shade_chunks(*a2, zero_origin=zero_origin),
                 intersect.trace_shade_chunks_plain(
                     *a2, zero_origin=zero_origin))


def test_debug_ids_on_card_equal_cpu(dev):
    """circles at 48x27, whose centre row's rays run exactly through
    shared triangle edges: the card's debug render (primary ids and t, the
    image) equals the CPU's, so where `cli diff` flags those rays the
    engine side is the same on both."""
    scene, vp = circles.build(resolution=(48, 27), maxdepth=5)
    got = Engine(scene, device=dev).render(vp, key=prng_key(0), debug=True)
    want = Engine(scene, device="cpu").render(vp, key=prng_key(0),
                                              debug=True)
    np.testing.assert_array_equal(got.primary_id, want.primary_id)
    np.testing.assert_array_equal(got.primary_t.view(np.uint32),
                                  want.primary_t.view(np.uint32))
    np.testing.assert_array_equal(got.image, want.image)


def _adversarial_rays(dev):
    """B11's hard rays against the 4-bank sphere and floor at page size 8:
    grazing rays along the floor's plane (md_n = 0 and subnormal md_n),
    rays starting on the floor (num = +-0), rays through the sphere's
    shared edges and vertices (exact t ties), d = 0 padding rays and
    subnormal direction components; with a mask that kills a third."""
    scene, _ = _sphere_scene(False)
    g = np.random.default_rng(9)
    rays = []
    for _ in range(300):                  # grazing the floor plane y = -3
        rays.append(([g.uniform(-5, 5), -3.0, g.uniform(-5, 20)],
                     [g.uniform(-1, 1), g.choice([0.0, 1e-39, -1e-39]),
                      g.uniform(0.2, 1)]))
    for _ in range(300):                  # from the floor, upwards
        rays.append(([g.uniform(-3, 3), -3.0, g.uniform(3, 9)],
                     [g.uniform(-0.3, 0.3), 1.0, g.uniform(-0.3, 0.3)]))
    for v in _sphere_vertices(600, g):    # at shared vertices and edges
        rays.append(([0.0, 0.0, 0.0], list(v)))
    rays += [([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])] * 20
    rays += [([0.0, 0.0, 0.0], [1e-40, 0.0, 1.0])] * 4
    O = torch.tensor([r[0] for r in rays], dtype=torch.float32)
    D = torch.tensor([r[1] for r in rays], dtype=torch.float32)
    n = torch.linalg.norm(D, dim=1, keepdim=True)
    D = torch.where(n > 0, D / torch.where(n > 0, n, 1.0), D)
    alive = torch.from_numpy(g.uniform(size=len(rays)) > 0.33)
    return scene, O.to(dev), D.contiguous().to(dev), alive.to(dev)


def _sphere_vertices(n, g):
    """n points on the 40x40 sphere's lat/lon grid (shared vertices) and
    midway along its meridians (shared edges)."""
    lat = g.integers(1, 40, n) * np.pi / 40
    lon = g.integers(0, 40, n) * 2 * np.pi / 40
    half = (g.uniform(size=n) < 0.5) * np.pi / 80
    p = np.stack([2.5 * np.sin(lat + half) * np.cos(lon),
                  2.5 * np.cos(lat + half),
                  6.0 + 2.5 * np.sin(lat + half) * np.sin(lon)], -1)
    return p.astype(np.float32)


def test_nearest_hit_mask_and_adversarial_rays_match_plain(dev):
    """B11 at page size 8 on the adversarial rays, with no mask, with a
    mask and with every ray dead: t and id bitwise against the plain
    version, dead rays (+inf, 0), one launch each."""
    scene, O, D, alive = _adversarial_rays(dev)
    wr = WavefrontRenderer(scene, page_size=8, device=dev)
    PK = wr.tensors.PK
    for live in (None, alive, torch.zeros_like(alive)):
        native.reset_launch_counts()
        t, i = intersect.nearest_hit(O, D, PK, 8, alive=live)
        assert native.NEAREST_HIT.launches == 1
        tp, ip = intersect.nearest_hit_plain(O, D, PK, alive=live)
        torch.cuda.synchronize()
        _bitwise(t, tp)
        assert torch.equal(i, ip)
        if live is None:
            assert 0 < int((ip != 0).sum()) < O.shape[0]
        else:
            assert torch.isposinf(t[~live]).all() and not i[~live].any()


@pytest.mark.parametrize("fixed", [True, False])
def test_trace_shade_perlane_records_match_plain(dev, fixed):
    """B4 over the page-major records of 4 resident banks, unlit and with
    the feeler, on the camera wave and the wave after it (a dead chunk
    among them): the state bitwise against the plain version, which reads
    the per-lane tables."""
    scene, vp = _sphere_scene(False)
    eng = Engine(scene, page_size=8, ray_chunk=RB, device=dev)
    assert not eng.streamed and eng.ptables.ab.shape[0] == 4 * 128
    st = _sphere_state(eng, vp, dev)
    key = prng_key(4)
    wc = 0.0 if fixed else 1 / 512
    for wave in (1, 2):
        live = (st[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
        live[1::5] = 0
        for light in (None, LIGHT):
            args = (st, eng.ptables, fold_in(key, wave), 8, RB, fixed, wc,
                    live, light)
            native.reset_launch_counts()
            got = intersect_perlane.trace_shade_perlane(*args)
            assert native.TRACE_SHADE_PERLANE.launches == 1
            _bitwise(got, intersect_perlane.trace_shade_perlane_plain(*args))
        st = got


@pytest.mark.parametrize("rc", [1024, 2048])
def test_union_flag_kernels_match_plain(dev, rc):
    """B1 with chunk_live and B2 with chunk_live and grid_live (the union
    bounce waves) on tests/union_exit_cases.py's flagged case, bitwise
    against their plain versions: a flagged chunk's cull is empty, and the
    chunks B2 passes through keep their state words, -0 and NaN included;
    the kernels launched (no fallback to the plain versions)."""
    import union_exit_cases as U

    c = U.flags_case(rc)
    st = torch.from_numpy(c["state"]).to(dev)
    lo = torch.from_numpy(c["pages"].aabb_lo).to(dev)
    hi = torch.from_numpy(c["pages"].aabb_hi).to(dev)
    flags = torch.from_numpy(c["chunk_live"]).to(dev)
    flags_b1 = flags.clone()
    flags_b1[3] = 0
    args = (st[0:3], st[3:6], st[7] != 0, lo, hi, rc)
    native.reset_launch_counts()
    mask, tmin = cull.cull_mask_exact(*args, chunk_live=flags_b1)
    assert native.CULL.launches == 1
    mask_p, tmin_p = cull.cull_mask_exact_plain(*args, chunk_live=flags_b1)
    assert torch.equal(mask, mask_p) and torch.equal(tmin, tmin_p)
    assert not mask[3].any() and torch.isinf(tmin[3]).all()
    gl = torch.tensor(U.GRID_LIVE, dtype=torch.int32, device=dev)
    for fixed in (True, False):
        args = (st, torch.from_numpy(c["PK"]).to(dev), c["counts"].to(dev),
                c["plist"].to(dev), c["ptmin"].to(dev),
                np.asarray([5, 123], np.uint32), U.P, rc, fixed, 1 / 512)
        native.reset_launch_counts()
        got = intersect.trace_shade_chunks(*args, chunk_live=flags,
                                           grid_live=gl)
        assert native.TRACE_SHADE_UNION.launches == 1
        want = intersect.trace_shade_chunks_plain(*args, chunk_live=flags,
                                                  grid_live=gl)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        words = got.view(torch.int32).cpu().numpy()
        src = c["state"].view(np.int32)
        for ch in range(U.NC):
            if U.LIVE_FLAGS[ch] == 0 or ch >= U.GRID_LIVE:
                lanes = slice(ch * rc, (ch + 1) * rc)
                np.testing.assert_array_equal(words[:, lanes],
                                              src[:, lanes])


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("flags", ["live", "all", "camera", "inside"])
def test_streamed_walk_kernels_match_plain(dev, fixed, flags):
    """B9 on tests/streamed_walk_cases.py's inputs (a triangle and its copy
    in two banks and two pages, zero-normal slots mid-page, rays from
    inside the sphere inside several bank boxes, a chunk with no live ray
    whose words hold -0 and NaNs, dead lanes in live chunks): the kernel
    against its plain version bitwise, chunk_live as the state says, every
    chunk flagged live, only the camera rays' chunk (whose rays start
    outside every bank box: the trace grid takes 16 lanes a ray) and only
    the chunk of rays from inside the sphere (32 lanes); its counting
    instance equal to it."""
    import streamed_walk_cases as W

    tabs, st, cl = W.torch_case(dev)
    if flags == "all":
        cl = torch.ones_like(cl)
    elif flags in ("camera", "inside"):
        keep = W.CAMERA_CHUNK if flags == "camera" else W.INSIDE_CHUNK
        cl = (torch.arange(W.NC, device=dev) == keep).to(torch.int32)
    args = (st, tabs, np.asarray([321, 654], np.uint32), W.P, W.RB, fixed,
            0.0 if fixed else 1 / 512, cl)
    out = intersect_streamed.trace_shade_streamed(*args)
    _bitwise(out, intersect_streamed.trace_shade_streamed_plain(*args))
    got, cnt, lanes = intersect_streamed.trace_shade_streamed_counts(*args)
    _bitwise(got, out)
    if flags in ("camera", "inside"):
        assert lanes == (16 if flags == "camera" else 32)
    traced = cnt[1] != 0
    assert traced.any() and (cnt[:, ~traced] == 0).all()
    assert (cnt[5, traced] * W.P == cnt[6, traced]).all()


@pytest.mark.parametrize("rc", [1024, 2048, 4096])
def test_bankmajor_prep_walk_case_matches_plain(dev, rc):
    """B12a on tests/streamed_walk_cases.py's state at ray_chunk 1024 (its
    chunk with no live ray flagged dead) and, over the same rays, at 2048
    and 4096 (every chunk live): winner init and group demand bitwise
    against its plain version, and with chunk_live None."""
    import streamed_walk_cases as W

    tabs, st, cl = W.torch_case(dev)
    NB = tabs.plt_i.shape[0]
    if rc != W.RB:
        st = torch.cat([st, st[:, :(-st.shape[1]) % rc]], dim=1)
        cl = torch.ones(st.shape[1] // rc, dtype=torch.int32, device=dev)
    for flags in (cl, None):
        args = (st, tabs.bank_ab, NB, rc, flags)
        win, gm = intersect_streamed.bankmajor_prep(*args)
        win_p, gm_p = intersect_streamed.bankmajor_prep_plain(*args)
        _bitwise(win, win_p)
        assert torch.equal(gm, gm_p) and bool((gm != 0).any())


def test_fma_peak_probe_reads_the_card(dev):
    """rt_fma_peak at the kept probe shape reads within [0.5, 1.05] of the
    H100 SXM data sheet's 67 TFLOP/s: above, the count is wrong (folded
    chains); below, the probe is latency-bound."""
    from rust_raytrace_tpu_torch.utils import roofline

    n = native.FMA_PEAK.launches
    rate = roofline.measure_fp32_peak(device=dev)
    assert native.FMA_PEAK.launches > n
    peak = roofline.PUBLISHED_FP32_FLOP_PER_S
    assert 0.5 * peak <= rate <= 1.05 * peak, rate


def test_device_metric_counts_the_loops_rays(dev):
    """device_metric on a small sphere Engine: positive numbers, its rays
    a render those of device_loop under the run's key."""
    from rust_raytrace_tpu_torch.utils import devbench

    scene, vp = _sphere_scene(lit=False)
    eng = Engine(scene, page_size=8, ray_chunk=RB, device=dev)
    runs = []
    mr, sec, rays = devbench.device_metric(eng, vp, ND=2, nruns=1,
                                           runs_out=runs)
    assert mr > 0 and sec > 0 and rays >= vp.width * vp.height
    assert len(runs) == 1 and runs[0] == (mr, sec)
    total = devbench.device_loop(eng, vp, 2, prng_key(100))
    assert total.is_cuda and int(total) // 2 == rays


def test_nearest_hit_matches_the_oracle(dev):
    """B11 on circles' camera rays at 160x90, page size 64, against the
    numpy model of its contract (least t, then least id: tie "lex"), at
    tests/test_intersect.py's tolerances."""
    from rust_raytrace_tpu_torch.ops.intersect_ref import nearest_hit_model
    from rust_raytrace_tpu_torch.ops.pages import build_pages

    scene, vp = circles.build(resolution=(160, 90), maxdepth=5)
    pages = build_pages(scene.tris, page_size=64)
    o, d = camera_rays(vp, prng_key(0), dev)
    t, i = intersect.nearest_hit(o.contiguous(), d.contiguous(),
                                 torch.from_numpy(pages.PK).to(dev), 64)
    t, i = t.cpu().numpy(), i.cpu().numpy()
    t_m, id_m = nearest_hit_model(o.cpu().numpy(), d.cpu().numpy(), pages,
                                  tie="lex")
    assert ((i == 0) == (id_m == 0)).all() and (i != 0).any()
    assert (i == id_m).mean() >= 0.999
    both = np.isfinite(t_m) & np.isfinite(t)
    np.testing.assert_allclose(t[both], t_m[both], rtol=1e-5, atol=1e-6)
