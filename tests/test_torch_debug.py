"""The port's Engine with debug buffers and through `walk_one_ray`, on
the CPU against the JAX Engine in interpret mode, bitwise."""

import numpy as np
import pytest
import torch

from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu.scene import LightSource as JLightSource
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.scene import LightSource
from rust_raytrace_tpu_torch.utils import native
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


def _u32(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _lit(jscene, scene):
    jscene.lights = JLightSource(orig=np.asarray(LIGHT[0], np.float32),
                                 len2=LIGHT[1])
    scene.lights = LightSource(orig=np.asarray(LIGHT[0], np.float32),
                               len2=LIGHT[1])


DEBUG_CASES = {
    "resident": (False, {}),
    "resident lit": (True, {}),
    "streamed": (False, {"streamed": True}),
    "legacy": (False, {"compact": False}),
}


@pytest.mark.parametrize("case", list(DEBUG_CASES))
def test_debug_buffers_equal_jax_engine(case):
    """primary_t, primary_id and (resident compacted only) primary_chunk
    and chunk_tris; the image of a debug render is the plain render's."""
    lit, kw = DEBUG_CASES[case]
    jscene, vp = jcircles.build(resolution=(24, 16), maxdepth=3)
    scene = carry(jscene)
    if lit:
        _lit(jscene, scene)
    ref = JEngine(jscene, ray_chunk=RB, interpret=True, **kw).render(
        vp, fixed_rng=True, debug=True)
    eng = Engine(scene, ray_chunk=RB, device="cpu", **kw)
    native.reset_launch_counts()
    mine = eng.render(vp, fixed_rng=True, debug=True)
    assert all(k.launches == 0 for k in native.KERNELS)
    np.testing.assert_array_equal(mine.image, ref.image)
    np.testing.assert_array_equal(mine.image,
                                  eng.render(vp, fixed_rng=True).image)
    np.testing.assert_array_equal(_u32(mine.primary_t), _u32(ref.primary_t))
    np.testing.assert_array_equal(mine.primary_id, ref.primary_id)
    assert mine.primary_id.dtype == np.int32
    assert (mine.primary_id != 0).mean() > 0.3
    if ref.chunk_tris is None:
        assert mine.chunk_tris is None and mine.primary_chunk is None
    else:
        assert case.startswith("resident")
        np.testing.assert_array_equal(mine.primary_chunk, ref.primary_chunk)
        assert len(mine.chunk_tris) == len(ref.chunk_tris)
        for a, b in zip(mine.chunk_tris, ref.chunk_tris):
            np.testing.assert_array_equal(a, b)


def test_debug_at_spp2_keeps_sample_buffers():
    jscene, vp = jcircles.build(resolution=(16, 8), maxdepth=2, samples=2)
    ref = JEngine(jscene, ray_chunk=RB, interpret=True).render(
        vp, fixed_rng=True, debug=True)
    mine = Engine(carry(jscene), ray_chunk=RB, device="cpu").render(
        vp, fixed_rng=True, debug=True)
    assert mine.primary_t.shape == (8, 16, 2) and mine.chunk_tris is None
    np.testing.assert_array_equal(_u32(mine.primary_t), _u32(ref.primary_t))
    np.testing.assert_array_equal(mine.primary_id, ref.primary_id)


@pytest.mark.parametrize("lit", [False, True])
def test_walk_one_ray_equals_jax(lit):
    """One ray in lane 0 of a 128-lane chunk: equal to JAX's probe under
    fixed and live RNG, and under fixed_rng to the full render's pixel."""
    jscene, vp = jcircles.build(resolution=(24, 16), maxdepth=3)
    scene = carry(jscene)
    if lit:
        _lit(jscene, scene)
    je = JEngine(jscene, ray_chunk=RB, interpret=True)
    eng = Engine(scene, ray_chunk=RB, device="cpu")
    full = eng.render(vp, fixed_rng=True, quantize=False).image
    for px in ((5, 7), (12, 3)):
        for fixed in (True, False):
            a = eng.walk_one_ray(vp, px, fixed_rng=fixed)
            b = je.walk_one_ray(vp, px, fixed_rng=fixed)
            np.testing.assert_array_equal(_u32(a.image), _u32(b.image))
            np.testing.assert_array_equal(_u32(a.primary_t),
                                          _u32(b.primary_t))
            np.testing.assert_array_equal(a.primary_id, b.primary_id)
            np.testing.assert_array_equal(a.wave_rays, b.wave_rays)
        probe = eng.walk_one_ray(vp, px)
        np.testing.assert_array_equal(_u32(probe.image[0, 0]),
                                      _u32(full[px]))
