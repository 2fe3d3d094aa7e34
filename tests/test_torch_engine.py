"""The slice end to end on the CPU: the port's Engine (plain versions of the
kernels) against the committed golden and against the JAX Engine with
ncompact=0 in interpret mode."""

import os

import jax
import numpy as np
import pytest

from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.models import circles
from rust_raytrace_tpu.scene import LightSource
from rust_raytrace_tpu.utils import png
from rust_raytrace_tpu_torch import engine
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.utils import native
from rust_raytrace_tpu_torch.utils.rng import prng_key

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
RB = 128


@pytest.fixture(scope="module")
def small():
    """circles at 48x27 with 128-ray chunks: 11 chunks, 5 waves."""
    scene, vp = circles.build(resolution=(48, 27), maxdepth=5)
    return scene, vp, Engine(scene, ray_chunk=RB, device="cpu")


@pytest.fixture(scope="module")
def jax_engine(small):
    scene, _, _ = small
    return JEngine(scene, ray_chunk=RB, ncompact=0, interpret=True)


def test_golden_circles_96x54():
    scene, vp = circles.build(resolution=(96, 54), maxdepth=5)
    native.reset_launch_counts()
    img = Engine(scene, device="cpu").render(vp, fixed_rng=True).image
    np.testing.assert_array_equal(
        img, png.read_png(os.path.join(GOLDENS, "circles_96x54.png")))
    # CPU tensors take the plain versions: no kernel launched
    assert all(k.launches == 0 for k in native.KERNELS)


def test_fixed_rng_equals_jax_engine(small, jax_engine):
    """u8 image and wave_rays exact; the float image within 1e-5 (hit points
    and directions may differ by ulps, ROADMAP C1)."""
    _, vp, eng = small
    ref = jax_engine.render(vp, fixed_rng=True, quantize=False)
    mine_f = eng.render(vp, fixed_rng=True, quantize=False)
    mine_u8 = eng.render(vp, fixed_rng=True)
    np.testing.assert_array_equal(mine_u8.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine_f.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine_u8.image, png.quantize_u8(ref.image))
    np.testing.assert_allclose(mine_f.image, ref.image, rtol=1e-5, atol=1e-6)
    assert mine_u8.rays_traced == int(ref.wave_rays.sum())


def test_live_rng_close_to_jax_engine(small, jax_engine):
    """Key 0: the wave seeds are bitwise jax.random's and the scatter hash
    is exact, but scatter directions differ by ulps (C1), so the paths may
    part: wave_rays within 1% and >= 99% of u8 pixels identical."""
    _, vp, eng = small
    ref = jax_engine.render(vp, key=jax.random.PRNGKey(0))
    mine = eng.render(vp, key=prng_key(0))
    np.testing.assert_allclose(mine.wave_rays, ref.wave_rays, rtol=0.01)
    assert (mine.image == ref.image).all(axis=-1).mean() >= 0.99


@pytest.mark.parametrize("kwargs", [
    {"ncompact": None}, {"ncompact": 2}, {"ncompact": (True, False)},
    {"bounce_chunk": 256}])
def test_engine_rejects_what_the_slice_does_not_run(small, kwargs):
    scene, _, _ = small
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(scene, device="cpu", **kwargs)


def test_engine_rejects_streamed_regime(small, monkeypatch):
    """A scene whose page tables pass the resident cap needs the streamed
    regime, which the port does not run yet."""
    scene, _, _ = small
    monkeypatch.setattr(engine, "TABLE_SLOT_CAP", 1000)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        Engine(scene, device="cpu")


def test_engine_rejects_lights():
    scene, _ = circles.build(resolution=(8, 8))
    scene.lights = LightSource(orig=np.asarray([0.0, 5.0, 6.0], np.float32),
                               len2=0.5)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        Engine(scene, device="cpu")


def test_render_rejects_spp_and_debug(small):
    scene, vp, eng = small
    _, vp2 = circles.build(resolution=(16, 16), samples=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        eng.render(vp2, fixed_rng=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        eng.render(vp, fixed_rng=True, debug=True)
