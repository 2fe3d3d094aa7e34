"""The Engine's remaining arguments on the CPU, bitwise against the JAX
Engine in interpret mode with the same argument: weight_cutoff,
auto_pages=False, pinhole_origin=False and bounce_chunk (compacted and
legacy); and the arguments of the JAX Engine that the port does not take.
The union bounce waves past the resident tables' cap are in
tests/test_torch_union_bounce.py."""

import jax
import numpy as np
import pytest
import torch

import rust_raytrace_tpu.engine as jengine
from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu.scene import LightSource as JLightSource
from rust_raytrace_tpu_torch import engine
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.scene import (MATERIAL_FIELDS, TRIANGLE_FIELDS,
                                           scene_from_arrays)
from rust_raytrace_tpu_torch.utils import native
from rust_raytrace_tpu_torch.utils.rng import prng_key

RB = 128
LIGHT = (np.asarray([-4.0, 8.0, 0.0], np.float32), 0.2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry(jscene):
    """A JAX-built scene as the port's, through plain arrays."""
    t = jscene.tris
    fields = {k: getattr(t, k) for k in TRIANGLE_FIELDS}
    fields.update({k: getattr(t.materials, k) for k in MATERIAL_FIELDS})
    lights = None if jscene.lights is None else {
        "orig": jscene.lights.orig, "len2": jscene.lights.len2}
    return scene_from_arrays(fields, lights=lights)


def circles_pair(lit: bool, maxdepth: int = 5):
    """circles at 48x27 (lit by the teapot preset's light): the JAX scene,
    its copy and the view."""
    jscene, vp = jcircles.build(resolution=(48, 27), maxdepth=maxdepth)
    if lit:
        jscene.lights = JLightSource(orig=LIGHT[0], len2=LIGHT[1])
    return jscene, carry(jscene), vp


def assert_renders_equal(mine, ref):
    np.testing.assert_array_equal(mine.image.view(np.uint32),
                                  np.asarray(ref.image).view(np.uint32))
    np.testing.assert_array_equal(mine.wave_rays, ref.wave_rays)


def render_both(jscene, scene, vp, fixed_rng: bool, seed: int = 4, **kw):
    """The JAX Engine (interpret mode) and the port's on the CPU, with the
    same arguments; the port launches no kernel.  Returns (port's, JAX's)
    float renders and the two Engines."""
    jeng = JEngine(jscene, interpret=True, **kw)
    eng = Engine(scene, device="cpu", **kw)
    assert eng.page_size == jeng.page_size
    assert eng.streamed == jeng.streamed
    rk = dict(fixed_rng=True) if fixed_rng else {}
    ref = jeng.render(vp, key=jax.random.PRNGKey(seed), quantize=False, **rk)
    native.reset_launch_counts()
    mine = eng.render(vp, key=prng_key(seed), quantize=False, **rk)
    assert all(k.launches == 0 for k in native.KERNELS)
    return mine, ref, eng, jeng


#: (lit, maxdepth, Engine arguments) of each case; the bounce-chunk cases
#: run 3 waves, two of them at the bounce chunk (the compacted one on a
#: skip-then-compact schedule: wave 1 on the uncompacted layout)
CASES = {
    "weight_cutoff": (False, 5, dict(ray_chunk=RB, weight_cutoff=1 / 64)),
    "auto_pages_false": (False, 5, dict(ray_chunk=RB, auto_pages=False,
                                        table_slot_cap=1000)),
    "pinhole_origin_false": (False, 5, dict(ray_chunk=RB,
                                            pinhole_origin=False)),
    "bounce_chunk_compacted": (False, 3, dict(ray_chunk=1024,
                                              bounce_chunk=512,
                                              ncompact=(False, True))),
    "bounce_chunk_legacy_lit": (True, 3, dict(ray_chunk=1024,
                                              bounce_chunk=512,
                                              compact=False)),
}


# fixed_rng retires no ray by weight, so weight_cutoff's case is live only
@pytest.mark.parametrize(
    "name,fixed_rng",
    [(n, f) for n in CASES for f in (True, False)
     if not (n == "weight_cutoff" and f)],
    ids=lambda x: {True: "fixed", False: "live"}.get(x, x))
def test_argument_equals_jax_engine(name, fixed_rng):
    lit, maxdepth, kw = CASES[name]
    jscene, scene, vp = circles_pair(lit, maxdepth)
    mine, ref, eng, _ = render_both(jscene, scene, vp, fixed_rng, **kw)
    if name == "auto_pages_false":
        # past the cap the adaptive size would be 224
        assert eng.streamed and eng.page_size == 56
    assert_renders_equal(mine, ref)
    # the autotune plans the same schedule from the same wave counts
    assert engine.plan_boundaries(mine.wave_rays.tolist()) == \
        jengine.plan_boundaries(np.asarray(ref.wave_rays).tolist())


def test_bounce_chunk_must_divide_the_rays():
    _, scene, vp = circles_pair(False)
    with pytest.raises(ValueError, match="does not divide"):
        Engine(scene, ray_chunk=RB, bounce_chunk=96, device="cpu").render(
            vp, fixed_rng=True)


def test_tpu_only_arguments_are_not_accepted():
    """nbuf, interpret, gate_frac, wave0_fused_lights, wave0_skippable and
    profile_skip are TPU means: the port's Engine takes none of them."""
    _, scene, _ = circles_pair(False)
    for kw in (dict(nbuf=4), dict(interpret=True), dict(gate_frac=0.5),
               dict(wave0_fused_lights=True), dict(wave0_skippable=True),
               dict(profile_skip=("trace",))):
        with pytest.raises(TypeError):
            Engine(scene, device="cpu", **kw)


def test_walk_one_ray_keeps_its_ray_chunk():
    """walk_one_ray runs every wave at 128-ray chunks, bounce_chunk or not
    (as the JAX Engine's does): the probed pixel is the same."""
    _, scene, vp = circles_pair(False)
    a = Engine(scene, bounce_chunk=512, device="cpu").walk_one_ray(vp, (9, 20))
    b = Engine(scene, device="cpu").walk_one_ray(vp, (9, 20))
    np.testing.assert_array_equal(a.image.view(np.uint32),
                                  b.image.view(np.uint32))
    np.testing.assert_array_equal(a.wave_rays, b.wave_rays)
