"""The portable renderer on the CPU: B11's plain version
(`ops.intersect.nearest_hit_plain`) against the JAX kernel in interpret
mode, the page scan (`ops.intersect_xla`) against `nearest_hit_xla`, and the
port's `WavefrontRenderer` against the JAX package's, all bitwise; its
camera's bulk draws against jax.random."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_raytrace_tpu.engine as jeng
import rust_raytrace_tpu.render as jrender
import rust_raytrace_tpu_torch.render as trender
from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.camera import create_viewport
from rust_raytrace_tpu.geometry import make_disk, make_sphere, make_triangles
from rust_raytrace_tpu.materials import matte, reflective, solid
from rust_raytrace_tpu.ops.intersect_pallas import nearest_hit_pallas
from rust_raytrace_tpu.ops.intersect_xla import nearest_hit_xla as jscan
from rust_raytrace_tpu.ops.pages import build_pages as jbuild_pages
from rust_raytrace_tpu.render import WavefrontRenderer as JRenderer
from rust_raytrace_tpu.scene import assemble
from rust_raytrace_tpu_torch.models import circles
from rust_raytrace_tpu_torch.ops import camera
from rust_raytrace_tpu_torch.ops.intersect import nearest_hit, nearest_hit_plain
from rust_raytrace_tpu_torch.ops.intersect_xla import nearest_hit_xla
from rust_raytrace_tpu_torch.render import WavefrontRenderer
from rust_raytrace_tpu_torch.utils import native, png
from rust_raytrace_tpu_torch.utils.rng import fold_in, prng_key, uniform
from test_fuzz import _rand_scene, _rand_viewport
from test_torch_engine import carry

F32 = np.float32
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
#: the port's backends and the JAX package's that each one reproduces
BACKENDS = [("kernel", "pallas_interpret"), ("portable", "xla")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soup_rays(case: str):
    """(O, D [R, 3], pages) of one input case: 'soup' a random soup and a
    sphere with rays that often miss, R = 1000 (not a multiple of the ray
    chunk 256); 'ties' the same soup with 20 triangles repeated, so that
    exact t ties fall across pages."""
    rng = np.random.default_rng(3)
    pts = (rng.uniform(-1, 1, (60, 3, 3)) * 0.6 + rng.uniform(-2, 2, (60, 1, 3))
           + [0, 0, 6]).astype(F32)
    if case == "ties":
        pts = np.concatenate([pts, pts[:20]])
    scene = assemble([
        make_triangles(pts, matte(m3.make_color((200, 100, 50)), 0.3), 0.05),
        make_sphere((0.5, 0.0, 7.0), 1.5, (6, 8),
                    matte(m3.make_color((20, 200, 50)), 0.3), 0.05)])
    R = 1000
    O = (rng.uniform(-1, 1, (R, 3)) * [1, 1, 0.5]).astype(F32)
    D = (rng.uniform(-0.6, 0.6, (R, 3)) + [0, 0, 1]).astype(F32)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    return O, D, jbuild_pages(scene.tris, page_size=32)


def _assert_hits(mine, ref):
    (mt, mi), (rt, ri) = mine, ref
    np.testing.assert_array_equal(mt.numpy().view(np.uint32),
                                  np.asarray(rt).view(np.uint32))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ri))
    assert mi.dtype == torch.int32


@pytest.mark.parametrize("case", ["soup", "ties"])
def test_nearest_hit_plain_equals_pallas(case):
    """B11: t and id, with misses, exact ties across pages and R not a
    multiple of the ray chunk; the wrapper on CPU tensors is the plain
    version and launches nothing."""
    O, D, pages = _soup_rays(case)
    ref = nearest_hit_pallas(jnp.asarray(O), jnp.asarray(D),
                             jnp.asarray(pages.PK), 32, ray_chunk=256,
                             interpret=True)
    assert 0 < int((np.asarray(ref[1]) != 0).sum()) < len(O)
    args = (torch.from_numpy(O), torch.from_numpy(D),
            torch.from_numpy(pages.PK))
    native.reset_launch_counts()
    _assert_hits(nearest_hit(*args, 32, ray_chunk=256), ref)
    _assert_hits(nearest_hit_plain(*args, 256), ref)
    assert native.NEAREST_HIT.launches == 0


@pytest.mark.parametrize("case", ["soup", "ties"])
def test_page_scan_equals_nearest_hit_xla(case):
    O, D, pages = _soup_rays(case)
    ref = jscan(jnp.asarray(O), jnp.asarray(D), jnp.asarray(pages.PK), 32)
    _assert_hits(nearest_hit_xla(torch.from_numpy(O), torch.from_numpy(D),
                                 torch.from_numpy(pages.PK), 32), ref)


def test_ties_take_the_least_id():
    """The soup's triangles 1..20 repeat as 61..80, on other pages: a ray
    that meets one of a pair meets both at the same t, and B11 keeps the
    lower id."""
    O, D, pages = _soup_rays("ties")
    _, ids = nearest_hit_plain(torch.from_numpy(O), torch.from_numpy(D),
                               torch.from_numpy(pages.PK))
    ids = ids.numpy()
    assert ((ids >= 1) & (ids <= 20)).any()
    assert not ((ids >= 61) & (ids <= 80)).any()


@pytest.fixture(scope="module")
def small_scene():
    """tests/test_render.py's scene: the three material kinds, edge
    wireframe and back faces; the JAX scene and its copy."""
    sphere = make_sphere((0.0, 0.5, 6.0), 1.5, (8, 12),
                         matte(m3.make_color((252, 119, 0)), 0.2), 0.05)
    disk = make_disk((2.5, 2.0, 7.0), m3.unit(m3.vec(-0.3, -0.55, -0.5)),
                     1.5, 0.1, 12,
                     reflective(m3.make_color((230, 230, 230)), 0.7, 0.0),
                     matte(m3.make_color((40, 40, 40)), 0.2), -1.0)
    wall = make_triangles(
        np.asarray([[[-8, -4, 12], [8, -4, 12], [0, 8, 12]]], dtype=F32),
        solid(m3.make_color((60, 120, 60))), 0.1)
    jscene = assemble([sphere, disk, wall])
    return jscene, carry(jscene)


def _view(spp: int):
    return create_viewport((48, 32), (1.0, 32 / 48), (0.0, 0.0, 0.0),
                           m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 5, spp)


def _assert_wavefront_equal(mine, ref):
    for got, want in ((mine.image, ref.image), (mine.primary_t,
                                                ref.primary_t)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    np.testing.assert_array_equal(mine.primary_id, ref.primary_id)
    np.testing.assert_array_equal(mine.wave_rays, ref.wave_rays)
    assert mine.rays_traced == ref.rays_traced


@pytest.mark.parametrize("backend,jbackend", BACKENDS)
@pytest.mark.parametrize("fixed_rng", [True, False])
@pytest.mark.parametrize("slab_size", [1 << 20, 512])
def test_wavefront_equals_jax(small_scene, backend, jbackend, fixed_rng,
                              slab_size):
    """Float image, primary buffers and wave_rays at 48x32, the slab loop
    whole (one slab) and split (three slabs, each drawing from its own
    fold_in(key, s))."""
    jscene, scene = small_scene
    vp = _view(1)
    kw = dict(ray_chunk=256, page_size=64, slab_size=slab_size)
    ref = JRenderer(jscene, backend=jbackend, **kw).render(
        vp, key=jax.random.PRNGKey(0), fixed_rng=fixed_rng)
    mine = WavefrontRenderer(scene, backend=backend, device="cpu",
                             **kw).render(vp, key=prng_key(0),
                                          fixed_rng=fixed_rng)
    _assert_wavefront_equal(mine, ref)


@pytest.mark.parametrize("backend,jbackend", BACKENDS)
@pytest.mark.parametrize("fixed_rng", [True, False])
def test_wavefront_spp4_equals_jax(small_scene, backend, jbackend,
                                   fixed_rng):
    """spp 4: the camera jitter (jax.random.uniform of shape (H*W*spp,)
    from fold_in(key, 1_000_001/1_000_002)), the sample buffers and the
    host mean."""
    jscene, scene = small_scene
    vp = _view(4)
    kw = dict(ray_chunk=256, page_size=64)
    ref = JRenderer(jscene, backend=jbackend, **kw).render(
        vp, key=jax.random.PRNGKey(3), fixed_rng=fixed_rng)
    mine = WavefrontRenderer(scene, backend=backend, device="cpu",
                             **kw).render(vp, key=prng_key(3),
                                          fixed_rng=fixed_rng)
    assert mine.primary_t.shape == (32, 48, 4)
    _assert_wavefront_equal(mine, ref)


@pytest.mark.parametrize("fixed_rng", [True, False])
def test_wavefront_wave_rays_equal_jax(fixed_rng, monkeypatch):
    """Every wave's ray origins and directions (what each wave hands to the
    nearest hit), read inside JAX's jitted trace_rays, on test_fuzz.py's
    seed-47 scene (solid, matte and reflective with scattering): the
    bounce directions carry XLA's contractions (ROADMAP C8), which an image
    alone does not show."""
    rng = np.random.default_rng(47)
    jscene = _rand_scene(rng, n_soup=3, spheres=[(6, 8)], disks=[5])
    vp = _rand_viewport(rng, (32, 24), maxdepth=4)
    got = {"jax": [], "port": []}
    real = jrender._nearest

    def capture(st, o, d, backend, ray_chunk):
        jax.debug.callback(lambda o, d: got["jax"].append(
            (np.asarray(o), np.asarray(d))), o, d)
        return real(st, o, d, backend, ray_chunk)

    monkeypatch.setattr(jrender, "_nearest", capture)
    JRenderer(jscene, backend="xla", ray_chunk=256, page_size=32).render(
        vp, fixed_rng=fixed_rng)
    real_port = trender._nearest

    def capture_port(st, o, d, backend, ray_chunk, alive):
        got["port"].append((o.numpy().copy(), d.numpy().copy()))
        return real_port(st, o, d, backend, ray_chunk, alive)

    monkeypatch.setattr(trender, "_nearest", capture_port)
    WavefrontRenderer(carry(jscene), backend="portable", ray_chunk=256,
                      page_size=32, device="cpu").render(vp,
                                                         fixed_rng=fixed_rng)
    assert len(got["port"]) == len(got["jax"]) == 4
    for mine_w, ref_w in zip(got["port"], got["jax"]):
        for mine, ref in zip(mine_w, ref_w):
            np.testing.assert_array_equal(mine.view(np.uint32),
                                          ref.view(np.uint32))


@pytest.mark.parametrize("backend,jbackend", BACKENDS)
def test_wavefront_walk_one_ray_equals_jax(small_scene, backend, jbackend):
    jscene, scene = small_scene
    vp = _view(1)
    kw = dict(ray_chunk=256, page_size=64)
    jr = JRenderer(jscene, backend=jbackend, **kw)
    mine = WavefrontRenderer(scene, backend=backend, device="cpu", **kw)
    for px in ((16, 20), (5, 40)):
        a, b = mine.walk_one_ray(vp, px), jr.walk_one_ray(vp, px)
        _assert_wavefront_equal(a, b)
        assert a.image.shape == (1, 1, 3)


def test_walk_rays_reports_progress(small_scene):
    _, scene = small_scene
    vp = _view(1)
    result, ctx = WavefrontRenderer(
        scene, backend="portable", ray_chunk=256, page_size=64,
        slab_size=512, device="cpu").walk_rays(vp, fixed_rng=True)
    assert ctx.total_rays == result.rays_traced
    assert ctx.finished_pixels == 48 * 32
    assert ctx.runtimes["Wave0Rays"].value == 48 * 32


def test_golden_circles_96x54():
    """B11's plain version through the port's WavefrontRenderer at
    tests/test_golden.py's settings, quantized on the host."""
    scene, vp = circles.build(resolution=(96, 54), maxdepth=5)
    img = WavefrontRenderer(scene, backend="kernel", page_size=128,
                            ray_chunk=512, device="cpu").render(
        vp, fixed_rng=True).image
    np.testing.assert_array_equal(
        png.quantize_u8(img),
        png.read_png(os.path.join(GOLDENS, "circles_96x54.png")))


def test_unknown_backend_names_the_mapping(small_scene):
    _, scene = small_scene
    with pytest.raises(ValueError, match="'xla' -> 'portable'"):
        WavefrontRenderer(scene, backend="xla", device="cpu")
    assert WavefrontRenderer(scene, device="cpu").backend == "kernel"


@pytest.mark.parametrize("shape", [(349_526, 3), (1_048_576,)])
def test_uniform_equals_jax_random(shape):
    """The bulk draws of the camera jitter ((H*W*spp,)) and of the scatter
    vectors ((R, 3)) on 1,048,578 or more values, threefry partitionable."""
    key = fold_in(prng_key(5), 1_000_001)
    ref = jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(5), 1_000_001), shape,
        dtype=jnp.float32)
    np.testing.assert_array_equal(
        uniform(key, shape, "cpu").numpy().view(np.uint32),
        np.asarray(ref).view(np.uint32))


def test_pos_uniform_equals_jax():
    """The Engine's position-keyed spp jitter on 1,048,576 positions."""
    q = np.arange(1 << 20, dtype=np.int32) + 12345
    ref = jeng._pos_uniform(jax.random.PRNGKey(9), jnp.asarray(q), 1_000_002)
    got = camera.pos_uniform(prng_key(9), torch.from_numpy(q), 1_000_002)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref).view(np.uint32))
