"""The port's native scene build (`utils/host_native`, its own copy of the
C++ scene pipeline) against the JAX package's, bitwise: the triangle
precompute, the Morton and KD page orders, the octree, both packages'
numpy paths under RUST_RAYTRACE_NO_NATIVE, and a render of the port's own
build of a scene against its render of the JAX package's arrays."""

import os
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import rust_raytrace_tpu.utils.native as jnative
from rust_raytrace_tpu import geometry as jgeom
from rust_raytrace_tpu import materials as jmat
from rust_raytrace_tpu import math3d as jm3
from rust_raytrace_tpu import octree as joct
from rust_raytrace_tpu.ops import pages as jpages
from rust_raytrace_tpu.scene import assemble as jassemble
from rust_raytrace_tpu_torch import geometry, materials, octree
from rust_raytrace_tpu_torch import math3d as m3
from rust_raytrace_tpu_torch.camera import create_viewport
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.ops import pages
from rust_raytrace_tpu_torch.scene import (MATERIAL_FIELDS, TRIANGLE_FIELDS,
                                           assemble, scene_from_arrays)
from rust_raytrace_tpu_torch.utils import host_native
from rust_raytrace_tpu_torch.utils.rng import prng_key

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("corners", "incenter", "norm", "sides", "side_lens", "bounding_r2")
CASES = ("sphere_1984", "sphere_12096", "soup_5000")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The render case runs the plain versions: one torch thread a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native library, loaded.  Its loader builds the
    library in place beside the source, so a test process can meet a
    half-written file and fall back to numpy for good; then build the JAX
    source with the loader's own `_build` into a private path and point
    the loader there.  Either way the JAX native path runs."""
    if os.environ.get("RUST_RAYTRACE_NO_NATIVE"):
        pytest.fail("RUST_RAYTRACE_NO_NATIVE is set: no native path to hold")
    with pytest.MonkeyPatch.context() as mp:
        if not jnative.available():
            so = str(tmp_path_factory.mktemp("jax_native") / "libscene.so")
            assert jnative._build(so), "g++ failed on the JAX source"
            mp.setattr(jnative, "_so_path", lambda: so)
            mp.setattr(jnative, "_TRIED", False)
            mp.setattr(jnative, "_LIB", None)
        assert jnative.available()
        assert host_native.available()
        yield jnative


def _points(case):
    """[N, 3, 3] float32 corners of each case."""
    if case == "soup_5000":
        rng = np.random.default_rng(5000)
        c = rng.uniform(-3.0, 3.0, (5000, 1, 3))
        return (c + rng.normal(0.0, 0.3, (5000, 3, 3))).astype(np.float32)
    lat_lon = (32, 32) if case == "sphere_1984" else (64, 96)
    s = geometry.make_sphere((0.0, 0.0, 5.0), 2.0, lat_lon,
                             materials.solid(m3.make_color((200, 10, 10))),
                             0.0)
    return s.corners


class _spy:
    """Within the block, module.name is wrapped: `results` holds what each
    call returned."""

    def __init__(self, module, name):
        self.results = []
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            self.results.append(fn(*a, **kw))
            return self.results[-1]

        self._patch = mock.patch.object(module, name, wrapper)

    def __enter__(self):
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        return self._patch.__exit__(*exc)


def test_source_is_a_byte_copy():
    assert host_native.SOURCE.read_bytes() == \
        (REPO / "native" / "scene_pipeline.cc").read_bytes()
    assert host_native.library_path().parent == REPO / "build" / "host"


@pytest.mark.parametrize("case", CASES)
def test_make_triangles_equals_jax_native(jax_native, case):
    pts = _points(case)
    assert len(pts) >= 1024
    before = host_native.calls["make_triangles"]
    with _spy(jax_native, "make_triangles_native") as spy:
        want = jgeom.make_triangles(pts, jmat.solid(jm3.make_color((1, 2, 3))),
                                    0.05)
    assert len(spy.results) == 1 and spy.results[0] is not None
    got = geometry.make_triangles(pts, materials.solid(
        m3.make_color((1, 2, 3))), 0.05)
    assert host_native.calls["make_triangles"] == before + 1
    for f in FIELDS + ("edge_thickness",):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("lat_lon", [(8, 12), (32, 32), (64, 96)])
def test_make_sphere_equals_jax(jax_native, lat_lon):
    """The port's sphere (one row of cells at a time) has the bits of the
    JAX package's (one cell at a time), corners and precompute."""
    args = ((0.5, -1.0, 5.0), 2.0, lat_lon)
    got = geometry.make_sphere(*args, materials.solid(
        m3.make_color((9, 8, 7))), 0.01)
    want = jgeom.make_sphere(*args, jmat.solid(jm3.make_color((9, 8, 7))),
                             0.01)
    for f in FIELDS + ("edge_thickness",):
        np.testing.assert_array_equal(getattr(got, f).view(np.uint32),
                                      getattr(want, f).view(np.uint32),
                                      err_msg=f)


def _tris_pair(case):
    """The port's own build of a case's scene and the JAX package's."""
    pts = _points(case)
    got = assemble([geometry.make_triangles(
        pts, materials.matte(m3.make_color((250, 80, 0)), 0.2), 0.0)]).tris
    want = jassemble([jgeom.make_triangles(
        pts, jmat.matte(jm3.make_color((250, 80, 0)), 0.2), 0.0)]).tris
    return got, want


@pytest.mark.parametrize("order", ["morton_order", "kd_order"])
def test_page_orders_equal_jax_native(jax_native, order):
    got_t, want_t = _tris_pair("sphere_12096")
    extra = () if order == "morton_order" else (56,)
    before = host_native.calls[order]
    with _spy(jax_native, f"{order}_native") as spy:
        want = getattr(jpages, order)(want_t, *extra)
    assert len(spy.results) == 1 and spy.results[0] is not None
    got = getattr(pages, order)(got_t, *extra)
    assert host_native.calls[order] == before + 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(1, len(got_t)))


def test_octree_equals_jax_native(jax_native):
    got_t, want_t = _tris_pair("sphere_1984")
    args = ((0.0, 0.0, 5.0), 2.5, 6, 8)
    flat_g = host_native.build_octree_native(got_t, *args)
    flat_w = jax_native.build_octree_native(want_t, *args)
    assert flat_g.keys() == flat_w.keys() and flat_g["root"] >= 0
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=k)
    before = host_native.calls["build_octree"]
    lines = {}
    for name, mod, t in (("port", octree, got_t), ("jax", joct, want_t)):
        lines[name] = []
        mod.print_tree(mod.build_bounding_box(t, *args),
                       out=lines[name].append)
    assert host_native.calls["build_octree"] == before + 1
    assert lines["port"] == lines["jax"] and len(lines["port"]) > 8


@pytest.mark.parametrize("what", ["make_triangles", "kd_order"])
def test_both_packages_take_numpy_without_native(jax_native, monkeypatch,
                                                 what):
    """RUST_RAYTRACE_NO_NATIVE switches both loaders off together; the two
    numpy paths agree."""
    monkeypatch.setenv("RUST_RAYTRACE_NO_NATIVE", "1")
    for mod in (jax_native, host_native):
        monkeypatch.setattr(mod, "_TRIED", False)
        monkeypatch.setattr(mod, "_LIB", None)
    assert not jax_native.available() and not host_native.available()
    before = dict(host_native.calls)
    got_t, want_t = _tris_pair("sphere_12096")
    if what == "kd_order":
        np.testing.assert_array_equal(pages.kd_order(got_t, 56),
                                      jpages.kd_order(want_t, 56))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got_t, f), getattr(want_t, f),
                                      err_msg=f)
    assert host_native.calls == before


@pytest.fixture(scope="module")
def sphere_scenes(jax_native):
    """A 1,984-triangle sphere (a part that takes the C++ path) over a
    ground sphere, built by the port, and the JAX package's build of it
    carried across as arrays."""
    def build(g, mat, mm3):
        return [g.make_sphere((0.0, 0.0, 5.0), 2.0, (32, 32),
                              mat.matte(mm3.make_color((250, 80, 0)), 0.3),
                              0.02),
                g.make_sphere((0.0, -102.0, 5.0), 100.0, (8, 8),
                              mat.matte(mm3.make_color((90, 200, 90)), 0.5),
                              0.0)]
    own = assemble(build(geometry, materials, m3))
    jt = jassemble(build(jgeom, jmat, jm3)).tris
    fields = {k: getattr(jt, k) for k in TRIANGLE_FIELDS}
    fields.update({k: getattr(jt.materials, k) for k in MATERIAL_FIELDS})
    return own, scene_from_arrays(fields)


# each view shows the numpy build's bits in the image: with the port's
# numpy path, 2 pixels of the first differ under fixed_rng, 1 of the
# second under key 3
@pytest.mark.parametrize("fixed_rng,view", [(True, (1.0, 0.75)),
                                            (False, (1.6, 1.2))],
                         ids=["fixed", "live"])
def test_own_build_renders_like_jax_arrays(sphere_scenes, fixed_rng, view):
    own, carried = sphere_scenes
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(own.tris, f),
                                      getattr(carried.tris, f), err_msg=f)
    vp = create_viewport((96, 72), view, (0.0, 0.0, 0.0),
                         m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 5, 1)
    kw = dict(fixed_rng=fixed_rng, key=prng_key(3), quantize=False)
    a = Engine(own, ray_chunk=128, device="cpu").render(vp, **kw)
    b = Engine(carried, ray_chunk=128, device="cpu").render(vp, **kw)
    np.testing.assert_array_equal(a.image.view(np.uint32),
                                  b.image.view(np.uint32))
    np.testing.assert_array_equal(a.wave_rays, b.wave_rays)
