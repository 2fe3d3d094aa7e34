"""The port's numpy model of the nearest-hit contract
(`rust_raytrace_tpu_torch/ops/intersect_ref.py`) against the JAX
package's, bit for bit, and the port's nearest-hit functions against it.

The scene is tests/test_intersect.py's sphere shell and floor, with the
floor triangle twice, built by each package's own geometry and
`build_pages`.  In the "split" layout the two copies lie in different pages
(the later id first), so a ray that hits the floor ties across pages and
the two tie rules pick different ids."""

import numpy as np
import pytest
import torch

from rust_raytrace_tpu import geometry as jgeometry
from rust_raytrace_tpu import materials as jmaterials
from rust_raytrace_tpu import math3d as jm3
from rust_raytrace_tpu import scene as jscene_mod
from rust_raytrace_tpu.ops import intersect_ref as jref
from rust_raytrace_tpu.ops import pages as jpages
from rust_raytrace_tpu_torch import geometry, materials
from rust_raytrace_tpu_torch import math3d as m3
from rust_raytrace_tpu_torch.camera import camera_rays, create_viewport
from rust_raytrace_tpu_torch.ops import intersect, intersect_ref
from rust_raytrace_tpu_torch.ops.intersect_xla import nearest_hit_xla
from rust_raytrace_tpu_torch.ops.pages import build_pages
from rust_raytrace_tpu_torch.scene import assemble

F32 = np.float32
FLOOR = np.asarray([[[-20, -3, -10], [20, -3, -10], [0, -3, 40]]], dtype=F32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(g, mat, m, assemble_fn):
    s = g.make_sphere((0.0, 0.0, 6.0), 2.0, (8, 12),
                      mat.solid(m.make_color((200, 60, 60))), -1.0)
    floor = g.make_triangles(FLOOR, mat.solid(m.make_color((120, 120, 120))),
                             0.0)
    return assemble_fn([s, floor, floor])


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, the port's scene), each built by its own package."""
    return (_scene(jgeometry, jmaterials, jm3, jscene_mod.assemble),
            _scene(geometry, materials, m3, assemble))


@pytest.fixture(scope="module")
def rays():
    """The camera rays of a 24x18 view, then 512 seeded rays from a box
    around the camera in every direction."""
    vp = create_viewport((24, 18), (1.0, 0.75), (0.0, 0.0, 0.0),
                         m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 5, 1)
    O, D = camera_rays(vp)
    g = np.random.default_rng(14)
    Os = g.uniform(-2.5, 2.5, (512, 3)).astype(F32)
    Ds = g.normal(size=(512, 3))
    Ds = (Ds / np.linalg.norm(Ds, axis=1, keepdims=True)).astype(F32)
    return (np.concatenate([np.asarray(O, F32), Os]),
            np.concatenate([np.asarray(D, F32), Ds]))


def _order(n_tris: int, layout: str):
    """Triangle ids in page order: 1..n ("ids"), or the second floor copy
    first and the first copy last ("split")."""
    ids = np.arange(1, n_tris + 1)
    if layout == "ids":
        return ids
    return np.concatenate([[n_tris], ids[:-2], [n_tris - 1]])


def _pages(scenes, page_size: int, layout: str):
    js, ts = scenes
    n = len(ts.tris) - 1
    jp = jpages.build_pages(js.tris, page_size=page_size,
                            order=_order(n, layout))
    tp = build_pages(ts.tris, page_size=page_size, order=_order(n, layout))
    np.testing.assert_array_equal(tp.PK.view(np.int32), jp.PK.view(np.int32))
    return jp, tp


@pytest.mark.parametrize("page_size", [64, 128])
@pytest.mark.parametrize("layout", ["ids", "split"])
@pytest.mark.parametrize("tie", ["page", "lex"])
@pytest.mark.parametrize("visit", ["all", "reversed", "subset"])
def test_model_equals_jax(scenes, rays, page_size, layout, tie, visit):
    """Every page in order, in reverse, and in reverse without page 0."""
    jp, tp = _pages(scenes, page_size, layout)
    O, D = rays
    NP = tp.num_pages
    order = {"all": None, "reversed": list(range(NP - 1, -1, -1)),
             "subset": list(range(NP - 1, 0, -1))}[visit]
    t_j, id_j = jref.nearest_hit_model(O, D, jp, page_order=order, tie=tie)
    t_t, id_t = intersect_ref.nearest_hit_model(O, D, tp, page_order=order,
                                                tie=tie)
    assert t_t.dtype == np.float32 and id_t.dtype == np.int32
    np.testing.assert_array_equal(t_t.view(np.int32), t_j.view(np.int32))
    np.testing.assert_array_equal(id_t, id_j)
    assert (id_t != 0).mean() > 0.3


def test_tie_rules_differ_across_pages(scenes, rays):
    """On the split layout, a floor hit ties across pages: "page" keeps the
    earlier page's copy (the later id), "lex" the least id."""
    _, tp = _pages(scenes, 64, "split")
    O, D = rays
    n = len(scenes[1].tris) - 1
    _, id_page = intersect_ref.nearest_hit_model(O, D, tp, tie="page")
    _, id_lex = intersect_ref.nearest_hit_model(O, D, tp, tie="lex")
    floor = id_lex == n - 1
    assert floor.sum() > 10
    assert (id_page[floor] == n).all()
    assert (id_page[~floor] == id_lex[~floor]).all()


@pytest.mark.parametrize("fn", ["nearest_hit_plain", "nearest_hit_xla"])
@pytest.mark.parametrize("page_size", [64, 128])
def test_port_nearest_hit_matches_model(scenes, rays, fn, page_size):
    """tests/test_intersect.py's tolerances: hit/miss sets equal, ids on at
    least 99.9% of rays, t within rtol 1e-5, atol 1e-6 where both hit."""
    _, tp = _pages(scenes, page_size, "ids")
    O, D = rays
    t_m, id_m = intersect_ref.nearest_hit_model(O, D, tp, tie="lex")
    Ot, Dt, PK = (torch.from_numpy(np.ascontiguousarray(a))
                  for a in (O, D, tp.PK))
    if fn == "nearest_hit_plain":
        t_p, id_p = intersect.nearest_hit_plain(Ot, Dt, PK, 128)
    else:
        t_p, id_p = nearest_hit_xla(Ot, Dt, PK, page_size)
    t_p, id_p = t_p.numpy(), id_p.numpy()
    assert ((id_p == 0) == (id_m == 0)).all()
    assert (id_p == id_m).mean() >= 0.999
    both = np.isfinite(t_m) & np.isfinite(t_p)
    np.testing.assert_allclose(t_p[both], t_m[both], rtol=1e-5, atol=1e-6)


def test_sentinel_and_padding_never_hit(scenes):
    """A camera that looks away from the scene: every ray misses, under
    both tie rules and in B11's plain version."""
    _, tp = _pages(scenes, 64, "ids")
    O, D = camera_rays(create_viewport((16, 16), (1.0, 1.0), (0.0, 0.0, 0.0),
                                       m3.unit(m3.vec(0.0, 1.0, 0.0)), 90.0,
                                       0.0, 5, 1))
    for tie in ("page", "lex"):
        t_m, id_m = intersect_ref.nearest_hit_model(O, D, tp, tie=tie)
        assert (id_m == 0).all() and np.isinf(t_m).all()
    t_p, id_p = intersect.nearest_hit_plain(
        torch.from_numpy(np.asarray(O, F32)),
        torch.from_numpy(np.asarray(D, F32)), torch.from_numpy(tp.PK), 128)
    assert (id_p == 0).all() and torch.isinf(t_p).all()
