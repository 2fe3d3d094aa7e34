"""The reference against the port on the card at full size, on scenes no
cell holds yet: the 1,001,112-triangle sphere (`make_sphere` 708x708, one
part, built on the port's C++ path), which the default Engine renders in
the streamed regime, unlit and lit by a light outside it; and the
99,904-triangle sphere (224x224), resident in seven banks.  Each scene is
built once through the port's API and its corner points handed to the
reference, which makes its own precompute, pages and tables.  Each Engine
renders a planning frame (the default schedule, from which it plans) and
three checked frames under the plan, at 2560x1440 spp 1; the reference
renders the same frames, planning from its own counts, and then the
control (`arith.lowered()`) renders the checked frames again.  One JSON
line a frame (run with -s): the program's numbers, the control's, and the
reference's seconds for the frame.

    python -m pytest -s -q rtbench/tests/test_rtbench_reference_card.py
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from rtbench import check, traffic
from rtbench.reference import arith
from rtbench.reference import geometry as ref_geometry
from rtbench.reference import math3d as ref_m3
from rtbench.reference import render as ref_render
from rtbench.reference.materials import matte as ref_matte

RES = (2560, 1440)
COLOR = (252, 119, 0)
#: (orig, len2) of the light: above, left of and in front of the sphere
LIGHT = ((-6.0, 6.0, 3.0), 0.25)
SEED = 2 ** 31 + 7001
KEYS = 3


def _build(lat_lon):
    """(the port's scene, the reference's triangles) of a lat/lon sphere of
    radius 4 at z = 10: the port builds it, the reference takes its
    corners."""
    from rust_raytrace_tpu_torch import math3d as m3
    from rust_raytrace_tpu_torch.geometry import make_sphere
    from rust_raytrace_tpu_torch.materials import matte
    from rust_raytrace_tpu_torch.scene import assemble

    part = make_sphere((0.0, 0.0, 10.0), 4.0, lat_lon,
                       matte(m3.make_color(COLOR), 0.2), 0.0)
    tris = ref_geometry.assemble([ref_geometry.make_triangles(
        part.corners, ref_matte(ref_m3.make_color(COLOR), 0.2), 0.0)])
    return assemble([part]), tris


def _views():
    from rust_raytrace_tpu_torch import math3d as m3
    from rust_raytrace_tpu_torch.camera import create_viewport

    args = (RES, (1.6, 0.9), (0.0, 0.0, 0.0))
    port = create_viewport(*args, m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0,
                           5, 1)
    ref = ref_geometry.create_viewport(
        *args, ref_m3.unit(ref_m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 5, 1)
    return port, ref


def _check(card, scene, tabs, lit: bool, label: str, streamed: bool):
    """Render the frames on both sides, print the readings and hold the
    program to 0 and 0 and the control above it on every frame."""
    from rust_raytrace_tpu_torch.engine import Engine
    from rust_raytrace_tpu_torch.scene import LightSource

    view, rview = _views()
    scene.lights = (LightSource(orig=np.asarray(LIGHT[0], np.float32),
                                len2=LIGHT[1]) if lit else None)
    tabs = dataclasses.replace(tabs, light=(
        tuple(float(np.float32(x)) for x in (*LIGHT[0], LIGHT[1]))
        if lit else None))
    eng = Engine(scene, device=card)
    assert eng.streamed == streamed
    keys = [traffic.frame_key(SEED, i) for i in range(KEYS + 1)]
    got = [eng.render(view, key=k) for k in keys]
    got = [(g.image, np.asarray(g.wave_rays)) for g in got]
    del eng
    torch.cuda.empty_cache()
    default = check.default_schedule(rview.maxdepth)
    readings = []

    def timed(key, sched):
        torch.cuda.synchronize(card)
        t0 = time.perf_counter()
        out = ref_render.render(tabs, rview, key, sched)
        return out, time.perf_counter() - t0

    ref, sec = timed(keys[0], default)
    plan = ref_render.plan_boundaries(ref[1].tolist())
    readings.append({"frame": "planning", "program": check.differ(
        ref, got[0]), "reference_s": sec})
    for i in range(1, KEYS + 1):
        ref, sec = timed(keys[i], plan)
        with arith.lowered():
            low, low_sec = timed(keys[i], plan)
        readings.append({"frame": i, "program": check.differ(ref, got[i]),
                         "control": check.differ(ref, low),
                         "reference_s": sec, "control_s": low_sec})
    for r in readings:
        print(json.dumps({"scene": label, "lit": lit, "plan": plan,
                          "wave_rays": got[0][1].tolist(), **r}),
              flush=True)
    for r in readings:
        assert check.correct(r["program"]), r
        if "control" in r:
            assert not check.correct(r["control"]), r


@pytest.fixture(scope="module")
def sphere_1m():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    t0 = time.perf_counter()
    scene, tris = _build((708, 708))
    assert len(scene.tris) == 1_001_113
    tabs = ref_render.scene_tables(tris, None, torch.device("cuda", 0))
    assert tabs.streamed is not None and tabs.page_size == 224
    print(json.dumps({"scene": "sphere_1m", "build_s":
                      time.perf_counter() - t0,
                      "banks": tabs.streamed[0].shape[0]}), flush=True)
    return scene, tabs


@pytest.mark.cuda
@pytest.mark.parametrize("lit", [False, True], ids=["unlit", "lit"])
def test_the_1m_sphere_streamed_equals_the_reference(card, sphere_1m, lit):
    scene, tabs = sphere_1m
    _check(card, scene, tabs, lit, "sphere_1m", streamed=True)


@pytest.mark.cuda
def test_the_100k_sphere_resident_equals_the_reference(card):
    scene, tris = _build((224, 224))
    tabs = ref_render.scene_tables(tris, None, card)
    assert tabs.streamed is None and tabs.perlane[2].shape[0] == 7 * 128
    _check(card, scene, tabs, False, "sphere_100k", streamed=False)
