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
                                            shadow_rays)
from rust_raytrace_tpu_torch.ops import (compact, cull, intersect,
                                        intersect_perlane, shade)
from rust_raytrace_tpu_torch.models import circles
from rust_raytrace_tpu_torch.scene import LightSource
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
        args = (st1, eng.plt_i, eng.plt_s, eng.ab, fold_in(prng_key(3), 1),
                P, RB, fixed, 1 / 512, live)
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
                        "expand": 2, "trace_chunks": 0, "shade": 0}


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
    args = (st1, eng.plt_i, eng.plt_s, eng.ab, fold_in(key, 1), P, RB, fixed,
            1 / 512, clive, LIGHT)
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
                        "expand": 2, "trace_chunks": 2, "shade": 1}
    ref = Engine(scene, device="cpu").render(vp, key=prng_key(1)).image
    np.testing.assert_array_equal(img, ref)
