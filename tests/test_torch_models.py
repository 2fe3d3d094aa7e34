"""The port's copies of the JAX package's numpy host modules build the same
arrays: models, geometry, pages, OBJ parsing, PNG, and the scene carried
across with `scene_from_arrays`."""

import os

import numpy as np
import pytest

import rust_raytrace_tpu.geometry as jgeom
import rust_raytrace_tpu.obj_parser as jobj
import rust_raytrace_tpu.ops.pages as jpages
import rust_raytrace_tpu.utils.png as jpng
from rust_raytrace_tpu.materials import matte as jmatte
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu.models import multi as jmulti
from rust_raytrace_tpu_torch import geometry, obj_parser
from rust_raytrace_tpu_torch.materials import matte as tmatte
from rust_raytrace_tpu_torch.models import REGISTRY, circles, multi
from rust_raytrace_tpu_torch.ops import pages
from rust_raytrace_tpu_torch.scene import (MATERIAL_FIELDS, TRIANGLE_FIELDS,
                                           scene_from_arrays)
from rust_raytrace_tpu_torch.utils import png

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
F32 = np.float32


def _tri_arrays(t):
    return ({k: getattr(t, k) for k in TRIANGLE_FIELDS}
            | {k: getattr(t.materials, k) for k in MATERIAL_FIELDS})


def _assert_tris_equal(mine, ref):
    a, b = _tri_arrays(mine), _tri_arrays(ref)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


def _assert_viewports_equal(mine, ref):
    for k in ("orig", "cam", "vu", "vv"):
        np.testing.assert_array_equal(getattr(mine, k), getattr(ref, k))
    for k in ("width", "height", "maxdepth", "samples_per_pixel"):
        assert getattr(mine, k) == getattr(ref, k)


@pytest.mark.parametrize("resolution", [(48, 27), (96, 54), "2k"])
def test_circles_build_equals_jax(resolution):
    scene, vp = circles.build(resolution=resolution, maxdepth=5)
    jscene, jvp = jcircles.build(resolution=resolution, maxdepth=5)
    _assert_tris_equal(scene.tris, jscene.tris)
    _assert_viewports_equal(vp, jvp)


def test_multi_build_equals_jax():
    """Without the reference teapot both drop the teapot instances."""
    scene, vp = multi.build(resolution=(64, 36))
    jscene, jvp = jmulti.build(resolution=(64, 36))
    _assert_tris_equal(scene.tris, jscene.tris)
    _assert_viewports_equal(vp, jvp)


def test_registry_names_equal_jax():
    from rust_raytrace_tpu.models import REGISTRY as JREGISTRY
    assert sorted(REGISTRY) == sorted(JREGISTRY)


@pytest.mark.parametrize("n", [3, 700, 1500])
def test_make_triangles_equal_jax_numpy_path(n):
    """The port keeps only the numpy path, which the JAX package takes
    below 1,024 triangles (and whenever its C++ library is absent)."""
    rng = np.random.default_rng(n)
    pts = rng.uniform(-3, 3, (n, 3, 3)).astype(F32)
    mine = geometry.make_triangles(pts, tmatte((0.2, 0.5, 0.7), 0.3), 0.05)
    ref = jgeom.make_triangles(pts, jmatte((0.2, 0.5, 0.7), 0.3), 0.05)
    if n < 1024:
        _assert_tris_equal(mine, ref)
    else:
        # the JAX package's C++ path agrees with numpy within rtol 1e-3
        np.testing.assert_allclose(mine.norm, ref.norm, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("page_size", [8, 56])
def test_kd_pages_equal_jax(page_size):
    """circles at 2,068 triangles: the JAX package may take its C++ kd_order
    there, which equals its numpy path, so the page tables are equal."""
    jscene, _ = jcircles.build(resolution=(8, 8))
    scene = scene_from_arrays(_tri_arrays(jscene.tris))
    mine = pages.build_pages_kd(scene.tris, page_size=page_size)
    ref = jpages.build_pages_kd(jscene.tris, page_size=page_size)
    np.testing.assert_array_equal(mine.PK, ref.PK)
    np.testing.assert_array_equal(mine.aabb_lo, ref.aabb_lo)
    np.testing.assert_array_equal(mine.aabb_hi, ref.aabb_hi)


def test_obj_parse_equals_jax():
    path = os.path.join(ASSETS, "two_mats.obj")
    rot = np.eye(3, dtype=F32)
    args = ((0.5, -1.0, 6.0), 1.5, rot)
    mine = obj_parser.parse_obj_with_mtl(path, *args,
                                         tmatte((0.5, 0.5, 0.5), 0.2), 0.02)
    ref = jobj.parse_obj_with_mtl(path, *args,
                                  jmatte((0.5, 0.5, 0.5), 0.2), 0.02)
    _assert_tris_equal(mine, ref)


def test_png_round_trip_and_quantize_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.uniform(-0.2, 1.2, (9, 16, 3)).astype(F32)
    img[0, 0] = np.nan
    np.testing.assert_array_equal(png.quantize_u8(img), jpng.quantize_u8(img))
    png.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(jpng.read_png(str(tmp_path / "a.png")),
                                  jpng.quantize_u8(img))


def test_scene_from_arrays_copies_and_checks():
    jscene, _ = jcircles.build(resolution=(8, 8))
    fields = _tri_arrays(jscene.tris)
    scene = scene_from_arrays(fields, lights={"orig": [0.0, 5.0, 6.0],
                                              "len2": 0.5})
    _assert_tris_equal(scene.tris, jscene.tris)
    assert scene.tris.norm is not jscene.tris.norm
    assert scene.lights.len2 == 0.5
    del fields["alpha"]
    with pytest.raises(KeyError, match="alpha"):
        scene_from_arrays(fields)
