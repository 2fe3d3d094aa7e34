"""dm_control's dog (`models.dog`): the baked file, the camera against
MuJoCo's, the whole scene through `Engine.render` against the benchmark's
plain reference, unlit and lit, and the spans of the split waves in both
regimes."""

import hashlib
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest

from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.models import dog
from rust_raytrace_tpu_torch.utils.rng import prng_key

ROOT = Path(__file__).resolve().parents[1]
DIGEST = "e830d52d0a1d0fd98cb60e0346e8f13db427397549f0813c6656899f314871ae"
RES = (64, 36)
SEED = 2 ** 31 + 23017
SPANS = ("engine.trace", "engine.shadow", "engine.shade")


def test_the_baked_file():
    assert hashlib.sha256(Path(dog.DATA_PATH).read_bytes()).hexdigest() \
        == DIGEST
    data = dog.load()
    assert len(data["part_names"]) == 19 and data["part_names"][-1] == "skin"
    assert len(data["faces"]) == 49_548
    assert data["vertex_offsets"][-1] == len(data["vertices"]) == 31_925
    assert data["face_offsets"][-1] == len(data["faces"])
    sizes = np.diff(data["face_offsets"])
    assert sizes[-1] == 33_900 and (sizes >= 1024).sum() == 3
    assert tuple(data["offsize"]) == (1920, 1080)
    # the dog stands on the floor
    assert 0.0 < data["vertices"][:, 2].min() < 0.01
    scene, _ = dog.build(resolution=RES)
    assert len(scene.tris) == 1 + 49_548 + 2


def test_rebaking_gives_the_same_bytes(tmp_path, monkeypatch):
    pytest.importorskip("mujoco")
    monkeypatch.setenv("MUJOCO_GL", "disable")
    pytest.importorskip("dm_control.suite")
    spec = importlib.util.spec_from_file_location(
        "bake_dog", ROOT / "scripts" / "bake_dog.py")
    bake = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bake)
    out = tmp_path / "dog.npz"
    bake.write_npz(str(out), bake.bake())
    assert out.read_bytes() == Path(dog.DATA_PATH).read_bytes()


@pytest.mark.parametrize("res", [(1920, 1080), RES])
def test_the_viewport_is_mujocos_camera(res):
    """The centre ray is the camera's -z, the image's up its y and right
    its x, the pinhole the camera, and the vertical extent its fovy."""
    data = dog.load()
    r = data["cam_xmat"].reshape(3, 3)
    _, v = dog.build(resolution=res)
    np.testing.assert_array_equal(v.cam, data["cam_xpos"].astype(np.float32))
    centre = (v.orig + v.vu * np.float32(0.5) + v.vv * np.float32(0.5)
              - v.cam).astype(np.float64)
    np.testing.assert_allclose(centre / np.linalg.norm(centre), -r[:, 2],
                               atol=4e-7)
    np.testing.assert_allclose(-v.vv / np.linalg.norm(v.vv), r[:, 1],
                               atol=4e-7)
    np.testing.assert_allclose(v.vu / np.linalg.norm(v.vu), r[:, 0],
                               atol=4e-7)
    top = (v.orig + v.vu * np.float32(0.5) - v.cam).astype(np.float64)
    bottom = top + v.vv
    angle = math.degrees(math.acos(
        top @ bottom / np.linalg.norm(top) / np.linalg.norm(bottom)))
    assert angle == pytest.approx(float(data["cam_fovy"]), abs=2e-5)
    assert dog.horizontal_fov_deg(45.0, 1920, 1080) == pytest.approx(
        72.734, abs=1e-3)


@pytest.fixture(scope="module")
def pair():
    """The dog at RES, spp 1, on each side: the port's Engine and the
    reference's tables, unlit and lit (both resident, as the default
    Engine takes the scene)."""
    from rtbench.reference import render as ref_render
    from rtbench.reference.scenes import dog as ref_dog

    cfg = json.loads((ROOT / "rtbench" / "configs" / "dog_1080.json")
                     .read_text())
    cfg["resolution"] = list(RES)
    tris, light, rview = ref_dog.build(cfg, 1)
    out = {}
    for lit in (False, True):
        scene, view = dog.build(resolution=RES, with_light=lit)
        eng = Engine(scene, device="cpu")
        tabs = ref_render.scene_tables(tris, light if lit else None, "cpu")
        assert not eng.streamed and tabs.streamed is None
        assert eng.page_size == tabs.page_size
        out[lit] = (eng, view, tabs)
    return out, rview


def _key():
    from rtbench.traffic import frame_key

    return frame_key(SEED, 0)


@pytest.mark.parametrize("lit", [False, True], ids=["unlit", "lit"])
def test_the_whole_dog_equals_the_reference(pair, lit):
    """0 bytes and 0 wave counts differing."""
    from rtbench import check
    from rtbench.reference import render as ref_render

    sides, rview = pair
    eng, view, tabs = sides[lit]
    ref = ref_render.render(tabs, rview, _key(),
                            check.default_schedule(rview.maxdepth))
    res = eng.render(view, key=_key())
    assert check.differ(ref, (res.image, res.wave_rays)) == {
        "bytes_differing": 0, "wave_rays_differing": 0}
    assert res.wave_rays[0] == RES[0] * RES[1]


def _spans(render):
    """(name, start ns, end ns) of the engine's spans of one render, read
    from the profiler's raw events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render()
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("engine.")]


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["resident", "streamed"])
def test_the_split_waves_spans(pair, streamed):
    """Inside `engine.dispatch`: resident, the lit wave 0 records the three
    spans once and an unlit render none of them; streamed, each lit wave
    records the three and each unlit wave `engine.trace` alone."""
    sides, _ = pair
    _, view = dog.build(resolution=(16, 8))
    waves = view.maxdepth if streamed else 1
    for lit, want in ((True, SPANS), (False, SPANS[:1] if streamed else ())):
        eng = sides[lit][0]
        if streamed:
            eng = Engine(eng.scene, streamed=True, device="cpu")
        ev = _spans(lambda: eng.render(view, key=prng_key(5)))
        dispatch = [(s, e) for n, s, e in ev if n == "engine.dispatch"]
        assert len(dispatch) == 1
        for name in SPANS:
            inside = [(s, e) for n, s, e in ev if n == name]
            assert len(inside) == (waves if name in want else 0)
            assert all(dispatch[0][0] <= s <= e <= dispatch[0][1]
                       for s, e in inside)
