"""The reference's two paths for scenes the port builds or renders apart:
parts of 1,024 or more triangles (the port's C++ precompute) and scenes
past the resident tables (the streamed regime), each held to the port
bit for bit; and the resident path's bits for `disks_2k`, held to a
digest the reference gave before either path existed."""

import dataclasses
import hashlib
import json

import numpy as np
import pytest

from rtbench import bench, check, traffic
from rtbench.reference import arith
from rtbench.reference import geometry as ref_geometry
from rtbench.reference import render as ref_render
from rtbench.reference.materials import solid
from rtbench.reference.scenes import disks as ref_disks
from rtbench.tests.conftest import tiny_config

SEED = 2 ** 31 + 5003
#: a table cap under the scene's triangles: both sides take the default
#: decision and page size of a scene past the real cap
SMALL_CAP = 16384


def _native():
    from rust_raytrace_tpu_torch.utils import host_native

    if not host_native.available():
        pytest.skip("the port's host library cannot be built here")
    return host_native


def _random_points(rng, n):
    return (rng.normal(size=(n, 3, 3)) * 10.0).astype(np.float32)


def _sphere_points(rng, n):
    from rust_raytrace_tpu_torch.geometry import make_sphere
    from rust_raytrace_tpu_torch.materials import matte

    part = make_sphere((0.0, 0.0, 10.0), 4.0, (72, 72),
                       matte(np.ones(3, np.float32), 0.2), 0.0)
    assert len(part) >= 1024
    return part.corners


def _sliver_points(rng, n):
    # near-collinear corners: c a hair off the line through a and b, by
    # offsets from 1e-7 to 1e-2 of the edge
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = a + rng.normal(size=(n, 3)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, size=(n, 1)).astype(np.float32)
    off = rng.normal(size=(n, 3)) * 10.0 ** rng.uniform(-7, -2, (n, 1))
    c = (a + t * (b - a) + off.astype(np.float32)).astype(np.float32)
    return np.stack([a, b, c], axis=1)


@pytest.mark.parametrize("points", [_random_points, _sphere_points,
                                    _sliver_points])
def test_a_large_part_takes_the_ports_cpp_precompute(points):
    native = _native()
    pts = points(np.random.default_rng(7), 4096)
    want = native.make_triangles_native(pts)
    with np.errstate(divide="ignore", invalid="ignore"):    # slivers
        got = ref_geometry.make_triangles(
            pts, solid(np.ones(3, np.float32)), 0.0)
    for name, w in zip(("incenter", "norm", "sides", "side_lens"), want):
        g = getattr(got, name)
        assert g.dtype == np.float32 and g.shape == w.shape, name
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), (
            name, int((g.view(np.uint32) != w.view(np.uint32)).sum()))


def _large_parts_config(wedges: int):
    """The disks at `wedges` a disk (two parts of 2 * wedges triangles a
    disk), the camera close to the larger disk."""
    cfg = tiny_config((64, 32), lit=True)
    cfg["camera"]["pos"] = [3.278, 2.556, 4.472]
    for d in cfg["disks"]:
        d["wedges"] = wedges
    return cfg


@pytest.fixture(scope="module")
def large_parts():
    """regime -> (the reference's tables, lit and unlit; the port's
    Engines, lit and unlit; the port's and the reference's views): 48,000
    triangles past SMALL_CAP, streamed in 2 banks of pages of 224, and
    4,800 under the real cap, resident in one bank of pages of 56."""
    from rust_raytrace_tpu_torch.engine import Engine

    from rtbench.scenes import disks

    _native()
    out = {}
    for regime, cap, wedges, banks, P in (
            ("streamed", SMALL_CAP, 6000, 2, 224),
            ("resident", ref_render.TABLE_SLOT_CAP, 600, 1, 56)):
        cfg = _large_parts_config(wedges)
        engines = {}
        for lit in (False, True):
            scene, view = disks.build(cfg, 1, lit)
            engines[lit] = Engine(scene, device="cpu", table_slot_cap=cap)
            assert engines[lit].streamed == (regime == "streamed")
            assert engines[lit].page_size == P
        tris, light, rview = ref_disks.build(cfg, 1)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref_render, "TABLE_SLOT_CAP", cap)
            tabs = ref_render.scene_tables(tris, light, "cpu")
        assert tabs.page_size == P
        if regime == "streamed":
            assert tabs.streamed[0].shape[0] == banks
        else:
            assert tabs.streamed is None
            assert tabs.perlane[2].shape[0] == banks * 128
        out[regime] = ({True: tabs,
                        False: dataclasses.replace(tabs, light=None)},
                       engines, view, rview)
    return out


@pytest.mark.parametrize("regime,lit", [("streamed", False),
                                        ("streamed", True),
                                        ("resident", True)],
                         ids=["streamed-unlit", "streamed-lit",
                              "resident-lit"])
def test_large_parts_render_as_the_engine_does(large_parts, regime, lit):
    tabs, engines, view, rview = large_parts[regime]
    key = traffic.frame_key(SEED, 3)
    got = engines[lit].render(view, key=key)
    ref = ref_render.render(tabs[lit], rview, key)
    assert got.wave_rays[1] > 0 and got.wave_rays[2] > 0
    assert check.differ(ref, (got.image, got.wave_rays)) == {
        "bytes_differing": 0, "wave_rays_differing": 0}


def test_the_streamed_shards_equal_the_ports_sharded_render(large_parts):
    tabs, engines, view, rview = large_parts["streamed"]
    key = traffic.frame_key(SEED, 4)
    got = engines[True].render_sharded(view, n_devices=4, key=key)
    ref = ref_render.render(tabs[True], rview, key, shards=4)
    assert check.differ(ref, (got.image, got.wave_rays)) == {
        "bytes_differing": 0, "wave_rays_differing": 0}


#: sha256 of the image bytes and the int64 wave counts of the reference's
#: disks_2k frame at 64x36 spp 4, key frame_key(2**31 + 77, 5), the default
#: schedule, as the reference gave them before its C++-precompute and
#: streamed paths existed; keyed by the first 16 hex digits of the sha256
#: of the host's rsqrt estimate table (the frame's bits follow the host's
#: rsqrtps)
DISKS_DIGESTS = {
    "0edb097273eca38a":
        "51697e5192a73fd00ca54d5898f02926f6e0311fbc1fd8d9735323a8817e2cfa",
}


def test_disks_2k_keeps_its_path_and_bits():
    table = hashlib.sha256(arith._capture_words().tobytes()).hexdigest()[:16]
    if table not in DISKS_DIGESTS:
        pytest.skip(f"no digest recorded for this host's rsqrt table "
                    f"{table}")
    cfg = json.loads((bench.HERE / "configs" / "disks_2k.json").read_text())
    cfg["resolution"] = [64, 36]
    tris, light, view = ref_disks.build(cfg, 4)
    tabs = ref_render.scene_tables(tris, None, "cpu")
    assert tabs.streamed is None and tabs.PK.shape[0] == 8
    img, counts = ref_render.render(tabs, view,
                                    traffic.frame_key(2 ** 31 + 77, 5),
                                    check.default_schedule(5))
    digest = hashlib.sha256(
        img.tobytes() + np.asarray(counts, np.int64).tobytes()).hexdigest()
    assert digest == DISKS_DIGESTS[table], counts
