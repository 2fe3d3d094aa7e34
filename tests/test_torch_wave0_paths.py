"""The JAX wave loop's last paths in the port, on the CPU, bitwise against
the JAX package in interpret mode: the self-gating compaction
(`Engine(gate_frac=)`), the fused lit wave 0 (`wave0_fused_lights`: B4
with its shadow feeler on the camera wave), `wave0_skippable` (B2 with
all-ones chunk_live flags on wave 0) and the compaction chunk `cb`.  The
wave-0 knobs and cb reach the JAX loop only through
`_render_device_compact` (as `utils/devbench` passes them) and the port's
through `Engine._dispatch`: both renders here go through those, patched
with the knob.  Under fixed_rng each path also equals the port's default
render, since none of them changes an image bit there."""

import functools

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
from rust_raytrace_tpu_torch.ops.compact import DEFAULT_CB
from rust_raytrace_tpu_torch.scene import (MATERIAL_FIELDS, TRIANGLE_FIELDS,
                                           scene_from_arrays)
from rust_raytrace_tpu_torch.utils import devbench, native
from rust_raytrace_tpu_torch.utils.rng import prng_key

F32 = np.float32
#: the teapot preset's light (models/teapot.py, with_light=True)
LIGHT = JLightSource(orig=np.asarray([-4.0, 8.0, 0.0], F32), len2=0.2)
SEED = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry(jscene):
    """A JAX-built scene, light included, as the port's."""
    t = jscene.tris
    fields = {k: getattr(t, k) for k in TRIANGLE_FIELDS}
    fields.update({k: getattr(t.materials, k) for k in MATERIAL_FIELDS})
    lights = jscene.lights
    return scene_from_arrays(fields, lights=None if lights is None else {
        "orig": lights.orig, "len2": lights.len2})


def circles_pair(resolution, lit: bool = False):
    jscene, vp = jcircles.build(resolution=resolution, maxdepth=5)
    if lit:
        jscene.lights = LIGHT
    return jscene, carry(jscene), vp


def jax_render(monkeypatch, jeng, vp, fixed_rng: bool, **knobs):
    """The JAX Engine's render with `knobs` given to its wave loop."""
    with monkeypatch.context() as m:
        m.setattr(jengine, "_render_device_compact",
                  functools.partial(jengine._render_device_compact, **knobs))
        return jeng.render(vp, key=jax.random.PRNGKey(SEED), quantize=False,
                           fixed_rng=fixed_rng)


def port_render(eng, vp, fixed_rng: bool, **knobs):
    """The port's render with `knobs` given to `_dispatch`; no kernel
    launches on the CPU."""
    if knobs:
        eng._dispatch = functools.partial(Engine._dispatch, eng, **knobs)
    native.reset_launch_counts()
    try:
        out = eng.render(vp, key=prng_key(SEED), quantize=False,
                         fixed_rng=fixed_rng)
    finally:
        eng.__dict__.pop("_dispatch", None)
    assert all(k.launches == 0 for k in native.KERNELS)
    return out


def assert_equal(mine, ref):
    np.testing.assert_array_equal(mine.image.view(np.uint32),
                                  np.asarray(ref.image).view(np.uint32))
    np.testing.assert_array_equal(mine.wave_rays, np.asarray(ref.wave_rays))


def spy(monkeypatch, name):
    """Record the arguments of every call of the engine module's `name`."""
    calls = []
    fn = getattr(engine, name)

    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(engine, name, wrapper)
    return calls


@pytest.mark.parametrize("fixed_rng", [True, False], ids=["fixed", "live"])
def test_gate_frac_equals_jax(monkeypatch, fixed_rng):
    """circles 24x16 at ray_chunk 256, ncompact=-1, gate_frac=0.7: the
    gate keeps some boundaries and turns others into identities."""
    jscene, scene, vp = circles_pair((24, 16))
    kw = dict(ray_chunk=256, ncompact=-1, gate_frac=0.7)
    ref = jax_render(monkeypatch, JEngine(jscene, interpret=True, **kw), vp,
                     fixed_rng)
    eng = Engine(scene, device="cpu", **kw)
    metas = spy(monkeypatch, "compact_meta")
    mine = port_render(eng, vp, fixed_rng)
    assert_equal(mine, ref)
    skips = [bool(out[2]) for _, _, out in metas]
    assert len(skips) == vp.maxdepth - 1 and True in skips \
        and False in skips, skips
    assert all(m[1]["gate_frac"] == 0.7 for m in metas)
    if fixed_rng:
        base = port_render(Engine(scene, ray_chunk=256, device="cpu"), vp,
                           True)
        assert_equal(mine, base)


def test_gate_frac_keeps_the_autotune():
    """As in JAX, gate_frac leaves the schedule's autotune on."""
    _, scene, _ = circles_pair((16, 16))
    eng = Engine(scene, gate_frac=0.5, device="cpu")
    assert eng._auto_schedule and eng.ncompact == 2 and eng.gate_frac == 0.5
    eng = Engine(scene, ncompact=-1, gate_frac=0.5, device="cpu")
    assert not eng._auto_schedule and eng.ncompact == -1


def test_fused_lit_wave0_equals_jax_live(monkeypatch):
    """Lit circles 32x24 at ray_chunk 128 under a live key: B4 with its
    feeler on the camera wave (the feeler's jitter is the kernel's hash at
    the wave-0 chunk) equals JAX's fused render; five B4 waves, no B6."""
    jscene, scene, vp = circles_pair((32, 24), lit=True)
    ref = jax_render(monkeypatch, JEngine(jscene, interpret=True,
                                          ray_chunk=128), vp, False,
                     wave0_fused_lights=True)
    eng = Engine(scene, ray_chunk=128, device="cpu")
    b4 = spy(monkeypatch, "trace_shade_perlane")
    b6 = spy(monkeypatch, "trace_chunks")
    mine = port_render(eng, vp, False, wave0_fused_lights=True)
    assert_equal(mine, ref)
    assert len(b4) == vp.maxdepth and not b6
    wave0 = b4[0][0]
    assert wave0[4] == 128 and wave0[8] == eng.light
    assert bool((wave0[7] == 1).all())


def test_fused_lit_wave0_equals_the_unfused_under_fixed_rng(monkeypatch):
    """Both wave-0 shapes pin the shadow jitter at 0.5 under fixed_rng:
    the same image bits; the unfused one runs B6 and four B4 waves."""
    _, scene, vp = circles_pair((32, 24), lit=True)
    eng = Engine(scene, ray_chunk=128, device="cpu")
    b4 = spy(monkeypatch, "trace_shade_perlane")
    fused = port_render(eng, vp, True, wave0_fused_lights=True)
    assert len(b4) == vp.maxdepth
    b6 = spy(monkeypatch, "trace_chunks")
    unfused = port_render(eng, vp, True)
    assert len(b4) == 2 * vp.maxdepth - 1 and b6
    assert_equal(fused, unfused)


def test_fused_lit_wave0_needs_a_light_and_no_rows(monkeypatch):
    """Unlit, or with the primary rows wanted (debug), wave 0 stays on
    B1 and the union kernels, as in JAX."""
    _, scene, vp = circles_pair((16, 16))
    b4 = spy(monkeypatch, "trace_shade_perlane")
    port_render(Engine(scene, ray_chunk=128, device="cpu"), vp, True,
                wave0_fused_lights=True)
    assert len(b4) == vp.maxdepth - 1
    _, lit_scene, _ = circles_pair((16, 16), lit=True)
    eng = Engine(lit_scene, ray_chunk=128, device="cpu")
    eng._dispatch = functools.partial(Engine._dispatch, eng,
                                      wave0_fused_lights=True)
    eng.render(vp, fixed_rng=True, debug=True)
    assert len(b4) == 2 * (vp.maxdepth - 1)


@pytest.mark.parametrize("fixed_rng", [True, False], ids=["fixed", "live"])
def test_wave0_skippable_equals_jax(monkeypatch, fixed_rng):
    """B2 on wave 0 with all-ones chunk_live flags: JAX's bits under a
    live key, the default render's under fixed_rng."""
    jscene, scene, vp = circles_pair((32, 24))
    eng = Engine(scene, ray_chunk=128, device="cpu")
    b2 = spy(monkeypatch, "trace_shade_chunks")
    mine = port_render(eng, vp, fixed_rng, wave0_skippable=True)
    flags = b2[0][1]["chunk_live"]
    assert flags is not None and flags.shape == (6,) and bool(
        (flags == 1).all())
    assert b2[0][1]["grid_live"] is None
    if fixed_rng:
        assert_equal(mine, port_render(eng, vp, True))
    else:
        assert_equal(mine, jax_render(
            monkeypatch, JEngine(jscene, interpret=True, ray_chunk=128), vp,
            False, wave0_skippable=True))


@pytest.mark.parametrize("fixed_rng", [True, False], ids=["fixed", "live"])
def test_cb_equals_jax(monkeypatch, fixed_rng):
    """cb=256 on circles 32x32 (1,024 rays, where the default chunk is
    512): JAX's bits under a live key (the scatter hash sees the layout
    of 256-lane chunks), the default render's under fixed_rng."""
    jscene, scene, vp = circles_pair((32, 32))
    eng = Engine(scene, ray_chunk=128, device="cpu")
    b3 = spy(monkeypatch, "compact")
    mine = port_render(eng, vp, fixed_rng, cb=256)
    assert b3 and all(c[0][3] == 256 for c in b3)
    if fixed_rng:
        b3.clear()
        assert_equal(mine, port_render(eng, vp, True))
        assert all(c[0][3] == DEFAULT_CB for c in b3)
    else:
        assert_equal(mine, jax_render(
            monkeypatch, JEngine(jscene, interpret=True, ray_chunk=128), vp,
            False, cb=256))


def test_device_loop_passes_the_knobs(monkeypatch):
    """utils/devbench hands the wave loop's knobs to `_dispatch`, as the
    JAX version hands them to `_render_device_compact`."""
    _, scene, vp = circles_pair((16, 16), lit=True)
    eng = Engine(scene, ray_chunk=128, device="cpu")
    seen = []
    real = eng._dispatch

    def record(*args, **kw):
        seen.append(kw)
        return real(*args, **kw)

    eng._dispatch = record
    knobs = dict(wave0_skippable=True, wave0_fused_lights=True, cb=128)
    total = devbench.device_loop(eng, vp, 2, prng_key(1), **knobs)
    assert seen == [knobs, knobs] and int(total) > 0
