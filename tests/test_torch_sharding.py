"""Image-tile data parallelism on the CPU (`parallel.sharding`,
`Engine.render_sharded`): at 2 and 4 shards byte-equal to render() under
fixed_rng on every path (unlit, lit, spp 2 float, the debug buffers, the
streamed regime, the legacy loop), and under live RNG bitwise equal to the
JAX package's `render_sharded` and `trace_rays_sharded` on its virtual
CPU mesh (tests/conftest.py gives it 8 devices)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu import math3d as jm3
from rust_raytrace_tpu.camera import camera_rays as jcamera_rays
from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.geometry import make_sphere as jmake_sphere
from rust_raytrace_tpu.materials import matte as jmatte
from rust_raytrace_tpu.parallel import sharding as jsharding
from rust_raytrace_tpu.render import upload_scene as jupload_scene
from rust_raytrace_tpu.scene import assemble as jassemble
from rust_raytrace_tpu_torch import math3d as m3
from rust_raytrace_tpu_torch.camera import create_viewport
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.geometry import make_sphere
from rust_raytrace_tpu_torch.materials import matte
from rust_raytrace_tpu_torch.models import circles
from rust_raytrace_tpu_torch.parallel.sharding import (make_mesh,
                                                       trace_rays_sharded)
from rust_raytrace_tpu_torch.render import trace_rays, upload_scene
from rust_raytrace_tpu_torch.scene import LightSource, assemble
from rust_raytrace_tpu_torch.utils.rng import prng_key
from test_torch_engine_args import carry

RB = 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(mods, lat_lon):
    g, mat, mm3, asm = mods
    return asm([g((0.0, 0.0, 6.0), 2.5, lat_lon,
                  mat(mm3.make_color((252, 119, 0)), 0.2), 0.0)])


PORT = (make_sphere, matte, m3, assemble)
JAX = (jmake_sphere, jmatte, jm3, jassemble)


def _view(spp=1, maxdepth=4):
    return create_viewport((32, 32), (1.0, 1.0), (0.0, 0.0, 0.0),
                           m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0,
                           maxdepth, spp)


def _circles(lit=False, spp=1):
    scene, vp = circles.build(resolution=(48, 27), maxdepth=5, samples=spp)
    if lit:
        scene.lights = LightSource(orig=np.asarray([-4.0, 8.0, 0.0],
                                                   np.float32), len2=0.2)
    return scene, vp


#: each path: (Engine, viewport, render kwargs)
PATHS = {
    "unlit": lambda: (Engine(_circles()[0], ray_chunk=RB, device="cpu"),
                      _circles()[1], {}),
    "lit": lambda: (Engine(_circles(lit=True)[0], ray_chunk=RB,
                           device="cpu"), _circles()[1], {}),
    "spp2_float": lambda: (Engine(_circles(spp=2)[0], ray_chunk=RB,
                                  device="cpu"), _circles(spp=2)[1],
                           dict(quantize=False)),
    "debug": lambda: (Engine(_circles()[0], ray_chunk=RB, device="cpu"),
                      _circles()[1], dict(debug=True)),
    "streamed": lambda: (Engine(_sphere(PORT, (40, 40)), page_size=8,
                                ray_chunk=RB, auto_pages=False,
                                streamed=True, device="cpu"), _view(), {}),
    "legacy": lambda: (Engine(_circles(lit=True)[0], ray_chunk=RB,
                              compact=False, device="cpu"),
                       _circles()[1], {}),
}


def test_make_mesh():
    assert make_mesh(3, ["cpu"]) == [torch.device("cpu")] * 3
    assert make_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        assert make_mesh(2) == [torch.device("cpu")] * 2


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("path", list(PATHS))
def test_render_sharded_equals_render(path, n):
    eng, vp, kw = PATHS[path]()
    if path == "streamed":
        assert eng.streamed and eng.stables.ab.shape[0] >= 3 * 128
    one = eng.render(vp, fixed_rng=True, **kw)
    many = eng.render_sharded(vp, n_devices=n, fixed_rng=True, **kw)
    assert many.image.dtype == one.image.dtype
    if many.image.dtype == np.float32:
        np.testing.assert_array_equal(many.image.view(np.uint32),
                                      one.image.view(np.uint32))
    else:
        np.testing.assert_array_equal(many.image, one.image)
    np.testing.assert_array_equal(many.wave_rays, one.wave_rays)
    assert many.rays_traced == one.rays_traced
    if path == "debug":
        np.testing.assert_array_equal(many.primary_t.view(np.uint32),
                                      one.primary_t.view(np.uint32))
        np.testing.assert_array_equal(many.primary_id, one.primary_id)
        assert (many.primary_id != 0).any() and (many.primary_id == 0).any()


#: live RNG against the JAX package: (port Engine kwargs, JAX scene maker)
LIVE = {
    "unlit": dict(ray_chunk=RB),
    "streamed": dict(page_size=8, ray_chunk=RB, auto_pages=False,
                     streamed=True),
}


@pytest.mark.parametrize("path", list(LIVE))
def test_render_sharded_live_equals_jax(path):
    """Two shards under key 5: each shard folds its index into the key and
    its scatter keys on its own compacted layout, in both packages."""
    kw = LIVE[path]
    if path == "unlit":
        from rust_raytrace_tpu.models import circles as jcircles
        jscene, vp = jcircles.build(resolution=(48, 27), maxdepth=5)
    else:
        jscene, vp = _sphere(JAX, (40, 40)), _view()
    ref = JEngine(jscene, interpret=True, **kw).render_sharded(
        vp, mesh=jsharding.make_mesh(2), key=jax.random.PRNGKey(5),
        quantize=False)
    mine = Engine(carry(jscene), device="cpu", **kw).render_sharded(
        vp, n_devices=2, key=prng_key(5), quantize=False)
    np.testing.assert_array_equal(mine.image.view(np.uint32),
                                  np.asarray(ref.image).view(np.uint32))
    np.testing.assert_array_equal(mine.wave_rays, ref.wave_rays)
    # the shards' keys differ: a one-shard render gives other bits
    one = Engine(carry(jscene), device="cpu", **kw).render(
        vp, key=prng_key(5), quantize=False)
    assert not np.array_equal(one.image, mine.image)


def test_trace_rays_sharded_equals_jax():
    """The portable renderer's trace over 2 shards (live RNG, key 3)
    against the JAX package's on its "xla" backend."""
    jscene = _sphere(JAX, (8, 12))
    vp = _view(maxdepth=3)
    o, d = jcamera_rays(vp)
    ref_c, ref_w = jsharding.trace_rays_sharded(
        jupload_scene(jscene, page_size=64), *jsharding.shard_rays(
            jnp.asarray(o), jnp.asarray(d), jsharding.make_mesh(2)),
        jax.random.PRNGKey(3), jsharding.make_mesh(2), maxdepth=3,
        backend="xla", ray_chunk=128)
    st = upload_scene(carry(jscene), page_size=64, device="cpu")
    ot, dt = torch.from_numpy(np.asarray(o)), torch.from_numpy(np.asarray(d))
    mesh = make_mesh(2, ["cpu"])
    colors, waves = trace_rays_sharded(st, ot, dt, prng_key(3), mesh,
                                       maxdepth=3, ray_chunk=128)
    np.testing.assert_array_equal(colors.numpy().view(np.uint32),
                                  np.asarray(ref_c).view(np.uint32))
    np.testing.assert_array_equal(waves.numpy(), np.asarray(ref_w))
    single, _ = trace_rays(st, ot, dt, prng_key(3), maxdepth=3,
                           ray_chunk=128)
    assert not torch.equal(single, colors)
