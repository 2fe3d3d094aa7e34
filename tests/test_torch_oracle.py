"""The port's copies of the JAX package's numpy host modules that the
command line needs — oracle, octree, utils/raydebug, utils/term_display
and utils/tracelog — against the originals, on the same inputs.

The scenes, cases and assertions are those of tests/test_oracle.py,
test_octree.py, test_differ.py, test_term_display.py and the tracing and
differ cases of test_aux.py, merged into parametrised tests: each case runs
through both packages, the port's result must equal the JAX package's, and
the original assertion must hold for the port's.  One case is new: the ray
differ over the port's Engine debug render on the CPU against the oracle.
"""

import io
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import rust_raytrace_tpu.camera as jcamera
import rust_raytrace_tpu.geometry as jgeometry
import rust_raytrace_tpu.materials as jmaterials
import rust_raytrace_tpu.math3d as jm3
import rust_raytrace_tpu.octree as joctree
import rust_raytrace_tpu.oracle as joracle
import rust_raytrace_tpu.scene as jscene
import rust_raytrace_tpu.utils.raydebug as jraydebug
import rust_raytrace_tpu.utils.term_display as jterm
import rust_raytrace_tpu_torch.camera as tcamera
import rust_raytrace_tpu_torch.geometry as tgeometry
import rust_raytrace_tpu_torch.materials as tmaterials
import rust_raytrace_tpu_torch.math3d as tm3
import rust_raytrace_tpu_torch.octree as toctree
import rust_raytrace_tpu_torch.oracle as toracle
import rust_raytrace_tpu_torch.scene as tscene
import rust_raytrace_tpu_torch.utils.raydebug as traydebug
import rust_raytrace_tpu_torch.utils.term_display as tterm
from rust_raytrace_tpu_torch.engine import Engine

F32 = np.float32

PKGS = {
    "jax": SimpleNamespace(m3=jm3, oracle=joracle, octree=joctree,
                           geometry=jgeometry, materials=jmaterials,
                           scene=jscene, camera=jcamera, raydebug=jraydebug,
                           term=jterm, logger="rust_raytrace_tpu.trace"),
    "port": SimpleNamespace(m3=tm3, oracle=toracle, octree=toctree,
                            geometry=tgeometry, materials=tmaterials,
                            scene=tscene, camera=tcamera, raydebug=traydebug,
                            term=tterm,
                            logger="rust_raytrace_tpu_torch.trace"),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_octree_in_numpy():
    """Both packages build octrees in C++ where their native library
    builds, else in numpy, and the two builds differ; both are held to the
    numpy build here (tests/test_torch_host_native.py holds the two C++
    builds equal)."""
    import rust_raytrace_tpu.utils.native as jnative
    from rust_raytrace_tpu_torch.utils import host_native
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(host_native, "available", lambda: False)
        yield


def both(fn):
    """fn(pkg) through the JAX package and the port: (jax's, port's)."""
    return fn(PKGS["jax"]), fn(PKGS["port"])


def assert_same(a, b):
    """Equal values, arrays bit for bit, through tuples, lists and dicts."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    else:
        assert a == b


# -- oracle (tests/test_oracle.py) ----------------------------------------

def one_tri_scene(p, surface, edge_thickness=0.0, z=2.0, half=5.0):
    """Sentinel + one big triangle in the z=const plane facing the camera."""
    pts = np.asarray([[[-half, -half, z], [half, -half, z], [0, 2 * half, z]]],
                     dtype=F32)
    return p.scene.assemble([p.geometry.make_triangles(pts, surface,
                                                       edge_thickness)])


def vp(p, w=4, h=4, maxdepth=5):
    return p.camera.create_viewport((w, h), (1.0, h / w), (0.0, 0.0, 0.0),
                                    p.m3.unit(p.m3.vec(0.0, 0.0, 1.0)), 90.0,
                                    0.0, maxdepth, 1)


O = np.zeros(3, dtype=F32)
D = np.asarray([0, 0, 1], dtype=F32)
SURF = (252, 119, 0)


def _miss(p):
    return p.oracle.render(p.scene.assemble([]).tris, vp(p),
                           rng=p.oracle.FixedRng())


def _solid(p, edge=0.0):
    scene = one_tri_scene(p, p.materials.solid(p.m3.make_color((10, 200, 30))),
                          edge)
    return p.oracle.render(scene.tris, vp(p), rng=p.oracle.FixedRng())[2, 2]


def _project(p, surface, depth, rv, pts=None, d=D):
    scene = (one_tri_scene(p, surface) if pts is None else
             p.scene.assemble([p.geometry.make_triangles(pts, surface, 0.0)]))
    return p.oracle.project_ray(scene.tris, O, d, depth, p.oracle.FixedRng(rv))


def _nearest(p):
    near = p.geometry.make_triangles(
        np.asarray([[[-5, -5, 2], [5, -5, 2], [0, 10, 2]]], dtype=F32),
        p.materials.solid(p.m3.make_color((255, 0, 0))), 0.0)
    far = p.geometry.make_triangles(
        np.asarray([[[-5, -5, 4], [5, -5, 4], [0, 10, 4]]], dtype=F32),
        p.materials.solid(p.m3.make_color((0, 255, 0))), 0.0)
    scene = p.scene.assemble([far, near])
    return p.oracle.nearest_hit(scene.tris, O, D)


def _stats(p):
    scene = one_tri_scene(p, p.materials.matte(p.m3.make_color(SURF), 0.25))
    stats = p.oracle.OracleStats()
    p.oracle.project_ray(scene.tris, O, D, 5,
                         p.oracle.FixedRng((0.0, 0.6, -0.8)), stats)
    return stats.rays


def _mix(p, surf, other, a):
    return p.m3.mix_color(p.m3.make_color(surf), other, F32(a))


BACK = np.asarray([[[-5, -5, -2], [5, -5, -2], [0, 10, -2]]], dtype=F32)

ORACLE_CASES = {
    "miss_is_sky": (
        _miss, lambda img, p: np.testing.assert_allclose(
            img, np.broadcast_to(p.oracle.SKY_COLOR, img.shape), rtol=1e-6)),
    "solid_hit_color": (
        _solid, lambda c, p: np.testing.assert_allclose(
            c, p.m3.make_color((10, 200, 30)), rtol=1e-6)),
    "depth_zero_is_black": (
        lambda p: _project(p, p.materials.solid(p.m3.make_color(
            (10, 200, 30))), 0, None),
        lambda c, p: np.testing.assert_allclose(c, [0, 0, 0])),
    "matte_mixes_surface_with_bounce_sky": (
        lambda p: _project(p, p.materials.matte(p.m3.make_color(SURF), 0.25),
                           5, (0.0, 0.6, -0.8)),
        lambda c, p: np.testing.assert_allclose(
            c, _mix(p, SURF, p.oracle.SKY_COLOR, 0.25), rtol=1e-5)),
    "matte_bounce_at_last_depth_is_black": (
        lambda p: _project(p, p.materials.matte(p.m3.make_color(SURF), 0.25),
                           1, (0.0, 0.6, -0.8)),
        lambda c, p: np.testing.assert_allclose(
            c, _mix(p, SURF, np.zeros(3, F32), 0.25), rtol=1e-5)),
    "reflective_zero_fuzz_mirror": (
        lambda p: _project(p, p.materials.reflective(
            p.m3.make_color((230, 230, 230)), 0.7, 0.0), 5, (1.0, 0.0, 0.0)),
        lambda c, p: np.testing.assert_allclose(
            c, _mix(p, (230, 230, 230), p.oracle.SKY_COLOR, 0.7),
            rtol=1e-5)),
    "edge_band_shades_black": (
        lambda p: _solid(p, 1.0),
        lambda c, p: np.testing.assert_allclose(c, [0, 0, 0], atol=1e-7)),
    "back_face_normal_flip": (
        lambda p: _project(p, p.materials.matte(
            p.m3.make_color((100, 100, 100)), 0.5), 5, (0.0, 0.6, 0.8),
            pts=BACK, d=np.asarray([0, 0, -1], dtype=F32)),
        lambda c, p: np.testing.assert_allclose(
            c, _mix(p, (100, 100, 100), p.oracle.SKY_COLOR, 0.5),
            rtol=1e-5)),
    "nearest_hit_picks_closest": (
        _nearest, lambda hit, p: (hit is not None and hit[1] == 2
                                  and abs(hit[0] - 2.0) < 1e-5) or
        pytest.fail(f"nearest hit {hit}")),
    "sentinel_slot_never_hits": (
        lambda p: p.oracle.nearest_hit(
            p.scene.assemble([]).tris, O,
            p.m3.unit(np.asarray([1, 1, 1], dtype=F32))),
        lambda hit, p: hit is None or pytest.fail(f"hit {hit}")),
    "ray_counting_stats": (
        _stats, lambda n, p: n == 2 or pytest.fail(f"{n} rays")),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_oracle_case(case):
    fn, check = ORACLE_CASES[case]
    want, got = both(fn)
    assert_same(want, got)
    check(got, PKGS["port"])


def test_oracle_render_equals_jax():
    """A whole image of a lit-free matte sphere under the seeded NumpyRng
    (the CLI's oracle backend)."""
    def render(p):
        scene = p.scene.assemble([p.geometry.make_sphere(
            (0.0, 0.0, 6.0), 2.0, (8, 12),
            p.materials.matte(p.m3.make_color(SURF), 0.2), 0.05)])
        stats = p.oracle.OracleStats()
        img = p.oracle.render(scene.tris, vp(p, 12, 10, 3),
                              rng=p.oracle.NumpyRng(3), stats=stats)
        return img, stats.rays
    want, got = both(render)
    assert_same(want, got)
    assert got[1] > 12 * 10


# -- octree (tests/test_octree.py) ----------------------------------------

def sphere_scene(p):
    return p.scene.assemble([p.geometry.make_sphere(
        (0.0, 0.0, 6.0), 2.0, (8, 12),
        p.materials.solid(p.m3.make_color((200, 60, 60))), -1.0)])


_TREES = {}


def tree_of(name):
    """The sphere scene and its octree (maxdepth 6, minobjs 8)."""
    if name not in _TREES:
        p = PKGS[name]
        scene = sphere_scene(p)
        _TREES[name] = (scene, p.octree.build_bounding_box(
            scene.tris, (0.0, 0.0, 6.0), 8.0, maxdepth=6, minobjs=8))
    return _TREES[name]


def _tree_lines(name):
    lines = []
    PKGS[name].octree.print_tree(tree_of(name)[1], out=lines.append)
    return lines


def _face_case(p):
    tris = p.geometry.make_triangles(
        np.asarray([[[1.0, 0.4, 0.2], [1.0, 0.2, -0.3], [0.6, 0.6, -0.5]]],
                   dtype=F32), p.materials.solid(p.m3.make_color((0, 0, 0))),
        0.0)
    return p.octree._face_contains_triangles(
        np.asarray([2.0, 2.0, 2.0], dtype=F32),
        np.asarray([0.0, 0.0, -1.0], dtype=F32), 2.0, tris, np.asarray([0]))


def _leaf_sets(name):
    return [sorted(int(t) for t in leaf.tri_indices)
            for leaf in PKGS[name].octree.leaves(tree_of(name)[1])]


def _collides(name):
    t = tree_of(name)[1]
    oc = PKGS[name].octree
    return (oc.collides(t, (0.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
            oc.collides(t, (100.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
            oc.collides(t, (100.0, 0.0, 6.0),
                        PKGS[name].m3.unit(PKGS[name].m3.vec(1.0, 0.3, 0.3))))


def _all_objects(name):
    return PKGS[name].octree.get_all_objects_for_ray(
        tree_of(name)[1], (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def _walks(name):
    p = PKGS[name]
    scene, tree = tree_of(name)
    rng = np.random.default_rng(7)
    center = np.asarray([0.0, 0.0, 6.0], dtype=F32)
    out = []
    for _ in range(40):
        o = rng.normal(size=3).astype(F32) * 0.5
        d = p.m3.unit((center - o + rng.normal(size=3).astype(F32)
                       * 1.5).astype(F32))
        out.append((p.oracle.nearest_hit(scene.tris, o, d),
                    p.octree.get_object_intersection_for_ray(tree, scene.tris,
                                                             o, d)))
    return out


def _trivial(name):
    p = PKGS[name]
    scene = tree_of(name)[0]
    triv = p.octree.build_trivial_bounding_box(scene.tris, (0.0, 0.0, 6.0),
                                               8.0)
    empty = p.octree.build_empty_box()
    return (triv.is_leaf, triv.tri_indices, empty.is_leaf, empty.tri_indices)


def _page_order(name):
    return PKGS[name].octree.octree_page_order(
        tree_of(name)[0].tris, (0.0, 0.0, 6.0), 8.0, maxdepth=6, minobjs=8)


def _check_leaves(sets, p):
    seen = set()
    for s in sets:
        seen.update(s)
    assert seen == set(range(1, len(tree_of("port")[0].tris)))
    for leaf in p.octree.leaves(tree_of("port")[1]):
        assert leaf.depth <= 6
        if leaf.depth < 6:
            assert leaf.tri_indices.shape[0] < 8 or leaf.depth == 0


def _check_collides(hits, p):
    tmin, tmax = hits[0]
    assert tmin < tmax and abs(tmin - (-2.0)) < 1e-4
    assert hits[1] is not None and hits[2] is None


def _check_all_objects(objs, p):
    keys = list(objs)
    assert keys == sorted(keys)
    union = set()
    for v in objs.values():
        union.update(int(t) for t in v)
    hit = p.oracle.nearest_hit(tree_of("port")[0].tris, O, D)
    assert hit is not None and hit[1] in union


def _check_walks(pairs, p):
    matched = 0
    for brute, walk in pairs:
        if brute is None:
            assert walk is None
        else:
            assert walk[1] == brute[1] and abs(walk[0] - brute[0]) < 1e-4
            matched += 1
    assert matched > 5


OCTREE_CASES = {
    "face_collision_reference_case": (
        lambda name: _face_case(PKGS[name]),
        lambda hit, p: bool(hit[0]) or pytest.fail("no face collision")),
    "every_triangle_lands_in_a_leaf": (_leaf_sets, _check_leaves),
    "collides_slab": (_collides, _check_collides),
    "get_all_objects_sorted": (_all_objects, _check_all_objects),
    "walk_matches_bruteforce": (_walks, _check_walks),
    "trivial_and_empty_boxes": (
        _trivial, lambda r, p: (r[0] and r[1].shape[0] ==
                                len(tree_of("port")[0].tris) - 1 and r[2]
                                and r[3].shape[0] == 0)
        or pytest.fail(f"{r}")),
    "octree_page_order_unique_and_complete": (
        _page_order, lambda order, p: sorted(order.tolist()) == list(
            range(1, len(tree_of("port")[0].tris))) or pytest.fail("order")),
    "print_tree": (
        _tree_lines, lambda lines, p: lines[0].startswith("Bx: 0")
        or pytest.fail(lines[0])),
}


@pytest.mark.parametrize("case", sorted(OCTREE_CASES))
def test_octree_case(case):
    fn, check = OCTREE_CASES[case]
    want, got = fn("jax"), fn("port")
    assert_same(want, got)
    check(got, PKGS["port"])


# -- term_display (tests/test_term_display.py) ----------------------------

def _img_exact():
    return np.array([[[255, 0, 0], [0, 255, 0]],
                     [[0, 0, 255], [10, 20, 30]]], dtype=np.uint8)


def _img_float():
    return np.array([[[0.5, 1.5, float("nan")]],
                     [[-1.0, 0.999, 0.0]]], dtype=np.float32)


def _img_blocks():
    img = np.zeros((4, 4, 3), dtype=np.uint8)
    img[:2, :2] = 100
    img[:2, 2:] = 200
    img[2:, :2] = 40
    img[2:, 2:] = [8, 16, 24]
    return img


def _frame(p):
    buf = io.StringIO()
    p.term.display_image(np.zeros((4, 4, 3), dtype=np.uint8), out=buf)
    return buf.getvalue()


TERM_CASES = {
    "to_ansi_exact_cells": (
        lambda p: p.term.to_ansi(_img_exact()),
        lambda s: s == ("\x1b[38;2;255;0;0m\x1b[48;2;0;0;255m▀"
                        "\x1b[38;2;0;255;0m\x1b[48;2;10;20;30m▀"
                        "\x1b[0m\n")),
    "to_ansi_quantizes_like_png": (
        lambda p: p.term.to_ansi(_img_float()),
        lambda s: "\x1b[38;2;127;255;0m" in s and "\x1b[48;2;0;254;0m" in s),
    "to_ansi_odd_height_pads_black": (
        lambda p: p.term.to_ansi(np.full((1, 1, 3), 200, dtype=np.uint8)),
        lambda s: "\x1b[48;2;0;0;0m" in s),
    "downsample_box_filter_mean": (
        lambda p: p.term.downsample_u8(_img_blocks(), 2, 2),
        lambda out: out.shape == (2, 2, 3) and (out[0, 0] == 100).all()
        and (out[0, 1] == 200).all() and (out[1, 0] == 40).all()
        and tuple(out[1, 1]) == (8, 16, 24)),
    "downsample_never_upscales": (
        lambda p: p.term.downsample_u8(np.zeros((3, 5, 3), np.uint8), 100,
                                       100),
        lambda out: out.shape == (3, 5, 3)),
    "to_ansi_bounds_output_size": (
        lambda p: p.term.to_ansi(np.zeros((64, 64, 3), np.uint8), max_cols=8,
                                 max_rows=4),
        lambda s: len(s.rstrip("\n").split("\n")) <= 4
        and s.rstrip("\n").split("\n")[0].count("▀") <= 8),
    "display_image_writes_frame": (
        _frame, lambda text: text.startswith("-- Results --\n")
        and text.count("▀") == 8),
}


@pytest.mark.parametrize("case", sorted(TERM_CASES))
def test_term_display_case(case):
    fn, check = TERM_CASES[case]
    want, got = both(fn)
    assert_same(want, got)
    assert check(got)


# -- raydebug and tracelog (tests/test_aux.py) ----------------------------

def _debug_ctx_roundtrip(p):
    """DebugCtx recording, CSV and the classifying compare_to."""
    DebugCtx = p.raydebug.DebugCtx
    a, b = DebugCtx(), DebugCtx()
    o = np.asarray([1.0, 2.0, 3.0])
    d = np.asarray([0.0, 0.0, 1.0])
    for ctx in (a, b):
        ctx.register_ray(o, (0, 0))
        ctx.add_ray(o, d)
        ctx.update_ray_triangles(o, [5, 3, 5])
    a.update_ray_hit(o, 3, 1.5)
    b.update_ray_hit(o, 3, 1.5)
    out = io.StringIO()
    a.write_debug_header(out)
    a.write_all_debug_context(out)
    results = [out.getvalue()]
    diff = io.StringIO()
    results.append((a.compare_to(b, diff), diff.getvalue()))
    b.update_ray_hit(o, 5, 1.5)
    diff = io.StringIO()
    results.append((a.compare_to(b, diff), diff.getvalue()))
    c = DebugCtx()
    c.register_ray(o, (0, 0))
    c.add_ray(o, d)
    c.update_ray_triangles(o, [99])
    c.update_ray_hit(o, 99, 1.5)
    diff = io.StringIO()
    results.append((a.compare_to(c, diff), diff.getvalue()))
    return results


def test_debug_ctx_roundtrip_and_compare():
    want, got = both(_debug_ctx_roundtrip)
    assert_same(want, got)
    text, same, bad_hit, missing = got
    assert text.startswith("Pixel_x;Pixel_y;ray_p;ray_v;tri_hit;hit_t")
    assert "3,5" in text
    assert same[0] == 0
    assert bad_hit[0] == 1 and "Bad hit detection" in bad_hit[1]
    assert "does not contain our hit" in missing[1]


def test_depth_indented_trace_logging(caplog):
    """RUST_LOG analog: per-ray and per-box depth-indented tracing
    (raytrace.rs:912-918, 954-958, 1027, 1259), the same messages on the
    port's logger as on the JAX package's."""
    def trace(p):
        scene = p.scene.assemble([p.geometry.make_sphere(
            (0.0, 0.0, 6.0), 2.0, (6, 8),
            p.materials.matte(p.m3.make_color((250, 0, 0)), 0.2), 0.05)])
        tree = p.octree.build_bounding_box(scene.tris, (0.0, 0.0, 6.0), 6.0,
                                           3, 6)
        caplog.clear()
        with caplog.at_level(logging.DEBUG, logger=p.logger):
            p.oracle.project_ray(scene.tris, np.zeros(3, F32),
                                 np.asarray([0, 0, 1], F32), 1,
                                 p.oracle.FixedRng())
            p.octree.get_object_intersection_for_ray(
                tree, scene.tris, np.zeros(3, F32),
                np.asarray([0, 0, 1], F32))
        return [r.getMessage() for r in caplog.records if r.name == p.logger]
    want, got = both(trace)
    assert_same(want, got)
    assert any(m.startswith("Ray: orig=") for m in got)
    assert any("Bounding box:" in m for m in got)
    assert any(m.startswith(" ") and "Bounding box:" in m for m in got)


# -- the ray differ (tests/test_differ.py) --------------------------------

@pytest.fixture(scope="module")
def differ():
    """The oracle's trace with octree-walk candidate sets, through both
    packages, and the port Engine's debug render with packet-cull
    candidate sets (on the CPU)."""
    out = {}
    for name, p in PKGS.items():
        scene = p.scene.assemble([p.geometry.make_sphere(
            (0.0, 0.0, 6.0), 2.0, (8, 12),
            p.materials.matte(p.m3.make_color(SURF), 0.2), 0.05)])
        view = p.camera.create_viewport(
            (24, 24), (1.0, 1.0), (0.0, 0.0, 0.0),
            p.m3.unit(p.m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 2, 1)
        tree = p.octree.build_bounding_box(scene.tris, (0.0, 0.0, 6.0), 8.0,
                                           4, 4)
        octx = p.raydebug.DebugCtx()
        p.oracle.render(scene.tris, view, rng=p.oracle.FixedRng(),
                        debug_ctx=octx, octree=tree)
        out[name] = (scene, view, octx)
    scene, view, _ = out["port"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = Engine(scene, page_size=16, ray_chunk=128, device="cpu").render(
            view, fixed_rng=True, debug=True, quantize=False)
    finally:
        torch.set_num_threads(n)
    out["engine"] = traydebug.from_render_result(res, view)
    return out


def _csv(ctx):
    f = io.StringIO()
    ctx.write_debug_header(f)
    ctx.write_all_debug_context(f)
    return f.getvalue()


def test_oracle_trace_equals_jax(differ):
    assert _csv(differ["port"][2]) == _csv(differ["jax"][2])


def test_candidate_sets_are_populated(differ):
    octx, ectx = differ["port"][2], differ["engine"]
    assert sum(1 for c in octx.checks.values() if c.check_tris) > 0
    assert sum(1 for c in ectx.checks.values() if c.check_tris) > 0
    # engine candidate sets are chunk-granular SUPERSETS of the per-ray
    # octree sets on hit pixels (the cull is conservative)
    for px, oc in octx.checks.items():
        if oc.tri_hit != 0:
            assert oc.tri_hit in ectx.checks[px].check_tris


def test_port_engine_agrees_with_the_oracle(differ):
    """The new case: 0 errors, as the JAX test finds for the JAX Engine."""
    out = io.StringIO()
    err = differ["engine"].compare_to(differ["port"][2], out)
    assert err == 0, out.getvalue()
    assert out.getvalue().endswith("Found 0 errors\n")


def test_broken_cull_is_classified(differ):
    """A cull bug the differ must flag with the reference's classification
    strings (debug.rs:181-192)."""
    octx, ectx = differ["port"][2], differ["engine"]
    px = next(px for px, c in octx.checks.items() if c.tri_hit != 0)
    broken = ectx.checks[px]
    hit = octx.checks[px].tri_hit
    orig_hit, orig_tris = broken.tri_hit, list(broken.check_tris)
    try:
        broken.tri_hit = 0
        broken.check_tris = [t for t in broken.check_tris if t != hit]
        out = io.StringIO()
        assert ectx.compare_to(octx, out) == 1
        assert "Bad hit detection for ray" in out.getvalue()
        broken.check_tris = orig_tris
        out = io.StringIO()
        assert ectx.compare_to(octx, out) == 1
        assert "Their hit not in our tri list" in out.getvalue()
    finally:
        broken.tri_hit = orig_hit
        broken.check_tris = orig_tris
