"""The port's legacy loop (`Engine(compact=False)`, and
`Engine(exact_cull=False)`) on the CPU against the JAX Engine's
`_render_device` in interpret mode, bitwise (u8, float image, wave_rays),
unlit and lit; the legacy shadow rays against the ones the JAX program
hands to its trace; and the port's compacted == legacy (the
tests/test_bitexact.py contract)."""

import os

import jax
import numpy as np
import pytest
import torch

import rust_raytrace_tpu.engine as jeng
from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu.scene import LightSource as JLightSource
from rust_raytrace_tpu_torch import engine
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.models import circles
from rust_raytrace_tpu_torch.scene import LightSource
from rust_raytrace_tpu_torch.utils import native, png
from rust_raytrace_tpu_torch.utils.rng import prng_key
from test_fuzz import _rand_scene, _rand_viewport
from test_torch_engine import carry

RB = 128
#: the teapot preset's light
LIGHT = ([-4.0, 8.0, 0.0], 0.2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(resolution, maxdepth, lit: bool):
    jscene, vp = jcircles.build(resolution=resolution, maxdepth=maxdepth)
    scene = carry(jscene)
    if lit:
        jscene.lights = JLightSource(orig=np.asarray(LIGHT[0], np.float32),
                                     len2=LIGHT[1])
        scene.lights = LightSource(orig=np.asarray(LIGHT[0], np.float32),
                                   len2=LIGHT[1])
    return jscene, scene, vp


def _assert_renders_equal(eng, vp, ref, fixed_rng):
    native.reset_launch_counts()
    mine_u8 = eng.render(vp, key=prng_key(0), fixed_rng=fixed_rng)
    mine_f = eng.render(vp, key=prng_key(0), fixed_rng=fixed_rng,
                        quantize=False)
    assert all(k.launches == 0 for k in native.KERNELS)
    np.testing.assert_array_equal(mine_u8.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine_f.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine_f.image.view(np.uint32),
                                  ref.image.view(np.uint32))
    np.testing.assert_array_equal(mine_u8.image, png.quantize_u8(ref.image))
    return mine_f


CASES = {
    # (resolution, maxdepth, lit, Engine arguments)
    "legacy": ((48, 27), 5, False, dict(compact=False)),
    "legacy lit": ((32, 24), 3, True, dict(compact=False)),
    "interval cull": ((32, 24), 4, False, dict(exact_cull=False)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fixed_rng", [True, False])
def test_legacy_equals_jax_engine(case, fixed_rng):
    """u8, float image and wave_rays bitwise; live RNG too, since the
    legacy loop draws its scatter vectors with jax.random.uniform."""
    resolution, maxdepth, lit, kw = CASES[case]
    jscene, scene, vp = _scenes(resolution, maxdepth, lit)
    ref = JEngine(jscene, ray_chunk=RB, interpret=True, **kw).render(
        vp, key=jax.random.PRNGKey(0), fixed_rng=fixed_rng, quantize=False)
    eng = Engine(scene, ray_chunk=RB, device="cpu", **kw)
    assert not eng._use_compact()
    _assert_renders_equal(eng, vp, ref, fixed_rng)


@pytest.mark.parametrize("fixed_rng", [True, False])
def test_legacy_shadow_rays_equal_jax(fixed_rng, monkeypatch):
    """The shadow rays the legacy loop hands to B6 at every wave (origins,
    directions, excluded ids) are the ones JAX's `_render_device` builds
    inline; under fixed_rng XLA normalizes them 16 floats wide there too
    (ROADMAP C7, C8)."""
    jscene, scene, vp = _scenes((32, 24), 3, True)
    got = {"jax": [], "port": []}
    real = jeng.trace_chunks_pallas

    def capture(OT, DT, *args, excl=None, **kw):
        out = real(OT, DT, *args, excl=excl, **kw)
        if excl is not None:
            jax.debug.callback(
                lambda o, d, e: got["jax"].append(
                    (np.asarray(o), np.asarray(d), np.asarray(e)[0])),
                OT, DT, excl)
        return out

    monkeypatch.setattr(jeng, "trace_chunks_pallas", capture)
    JEngine(jscene, ray_chunk=RB, interpret=True, compact=False).render(
        vp, key=jax.random.PRNGKey(0), fixed_rng=fixed_rng)
    real_port = engine.trace_chunks

    def capture_port(ot, dt, *args, excl=None, **kw):
        if excl is not None:
            got["port"].append((ot.numpy().copy(), dt.numpy().copy(),
                                excl.numpy().copy()))
        return real_port(ot, dt, *args, excl=excl, **kw)

    monkeypatch.setattr(engine, "trace_chunks", capture_port)
    Engine(scene, ray_chunk=RB, device="cpu", compact=False).render(
        vp, key=prng_key(0), fixed_rng=fixed_rng)
    assert len(got["port"]) == len(got["jax"]) == 3
    for mine_w, ref_w in zip(got["port"], got["jax"]):
        assert (ref_w[2] != 0).sum() > 50
        for mine, ref in zip(mine_w, ref_w):
            np.testing.assert_array_equal(mine.view(np.uint32),
                                          ref.view(np.uint32))


@pytest.mark.parametrize("fixed_rng", [True, False])
def test_legacy_wave_rays_equal_jax(fixed_rng, monkeypatch):
    """Every wave's masked rays (what each wave hands to B6), read inside
    JAX's jitted `_render_device`, on test_fuzz.py's seed-47 scene (solid,
    matte and reflective with scattering): the bounce directions carry
    XLA's contractions, |d.nf| unfused at wave 0 and fused after (ROADMAP
    C8), which the image alone does not show."""
    rng = np.random.default_rng(47)
    jscene = _rand_scene(rng, n_soup=3, spheres=[(6, 8)], disks=[5])
    vp = _rand_viewport(rng, (32, 24), maxdepth=5)
    got = {"jax": [], "port": []}
    real = jeng.trace_chunks_pallas

    def capture(OT, DT, *args, excl=None, **kw):
        if excl is None:
            jax.debug.callback(lambda o, d: got["jax"].append(
                (np.asarray(o), np.asarray(d))), OT, DT)
        return real(OT, DT, *args, excl=excl, **kw)

    monkeypatch.setattr(jeng, "trace_chunks_pallas", capture)
    JEngine(jscene, ray_chunk=RB, page_size=16, interpret=True,
            compact=False).render(vp, fixed_rng=fixed_rng, quantize=False)
    real_port = engine.trace_chunks

    def capture_port(ot, dt, *args, excl=None, **kw):
        if excl is None:
            got["port"].append((ot.numpy().copy(), dt.numpy().copy()))
        return real_port(ot, dt, *args, excl=excl, **kw)

    monkeypatch.setattr(engine, "trace_chunks", capture_port)
    Engine(carry(jscene), ray_chunk=RB, page_size=16, device="cpu",
           compact=False).render(vp, fixed_rng=fixed_rng, quantize=False)
    assert len(got["port"]) == len(got["jax"]) == 5
    for mine_w, ref_w in zip(got["port"], got["jax"]):
        for mine, ref in zip(mine_w, ref_w):
            np.testing.assert_array_equal(mine.view(np.uint32),
                                          ref.view(np.uint32))


@pytest.mark.parametrize("lit", [False, True])
def test_compacted_equals_legacy(lit):
    """The analogues of test_engine_compact_equals_no_compact and
    test_lights_fused_equals_unfused: under fixed_rng the compacted loop
    (fused B2/B4, the feeler in B4) and the legacy one (B6 and torch
    shade every wave) give the same float image."""
    scene, vp = circles.build(resolution=(48, 27), maxdepth=4)
    if lit:
        scene.lights = LightSource(orig=np.asarray(LIGHT[0], np.float32),
                                   len2=LIGHT[1])
    imgs = [Engine(scene, ray_chunk=RB, device="cpu", compact=c).render(
        vp, fixed_rng=True, quantize=False).image for c in (True, False)]
    np.testing.assert_array_equal(imgs[0].view(np.uint32),
                                  imgs[1].view(np.uint32))
    if lit:
        scene.lights = None
        unlit = Engine(scene, ray_chunk=RB, device="cpu").render(
            vp, fixed_rng=True, quantize=False).image
        assert (np.abs(imgs[0] - unlit) > 1 / 255).any()


def test_legacy_golden_circles_96x54():
    """The legacy loop through the plain versions reproduces the golden."""
    scene, vp = circles.build(resolution=(96, 54), maxdepth=5)
    img = Engine(scene, device="cpu", compact=False).render(
        vp, fixed_rng=True).image
    np.testing.assert_array_equal(
        img, png.read_png(os.path.join(os.path.dirname(__file__), "goldens",
                                       "circles_96x54.png")))
