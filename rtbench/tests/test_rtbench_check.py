"""The check that decides `correct`: the reference agrees with the port,
and the control and each fault the cells can have come out not correct."""

import json

import numpy as np
import pytest
import torch

from rtbench import bench, check, run, traffic
from rtbench.tests.conftest import tiny_config
from rtbench.reference import render as ref_render
from rtbench.reference.scenes import disks as ref_disks

SEED = 2 ** 31 + 4099


def test_the_shards_equal_the_ports_sharded_render():
    from rust_raytrace_tpu_torch.engine import Engine
    from rust_raytrace_tpu_torch.scene import LightSource

    from rtbench.scenes import disks

    cfg = tiny_config()
    scene, view = disks.build(cfg, 1, True)
    assert isinstance(scene.lights, LightSource)
    key = traffic.frame_key(SEED, 3)
    got = Engine(scene, device="cpu").render_sharded(view, n_devices=4,
                                                     key=key)
    tris, light, rview = ref_disks.build(cfg, 1)
    tabs = ref_render.scene_tables(tris, light, "cpu")
    img, counts = ref_render.render(tabs, rview, key, shards=4)
    assert np.array_equal(img, got.image)
    assert np.array_equal(counts, got.wave_rays)
    # the exchange between the ranks left out: rank 0 alone
    lost = got.image.copy()
    mask = np.zeros(img.shape[:2], bool)
    perm = ref_render.tile_permutation(32, 64, 1, 32)
    mask.reshape(-1)[perm[len(perm) // 4:]] = True
    lost[mask] = 0
    assert check.differ((img, counts), (lost, got.wave_rays))[
        "bytes_differing"] > 0


def test_the_control_is_not_correct():
    # float32 without the exactness rules, on the configuration as it
    # stands at a sixteenth of its pixels: a seed where it shows
    cfg = json.loads((bench.HERE / "configs" / "disks_2k.json").read_text())
    cfg["resolution"] = [640, 360]
    tris, light, view = ref_disks.build(cfg, 1)
    tabs = ref_render.scene_tables(tris, None, "cpu")
    key = traffic.frame_key(2 ** 31, 1)
    from rtbench.reference import arith

    exact = ref_render.render(tabs, view, key, check.default_schedule(5))
    with arith.lowered():
        low = ref_render.render(tabs, view, key, check.default_schedule(5))
    numbers = check.differ(exact, low)
    assert not check.correct(numbers)


def _break(monkeypatch, fault):
    import rust_raytrace_tpu_torch.engine as eng

    if fault == "state unchanged":
        monkeypatch.setattr(eng, "trace_shade_perlane",
                            lambda state, *a, **k: state)
    elif fault == "half the rays left out":
        orig = eng.Engine._primary_rays

        def half(self, v, key):
            tile, o, d, alive0, pk0 = orig(self, v, key)
            alive0 = alive0.clone()
            alive0[alive0.shape[0] // 2:] = False
            return tile, o, d, alive0, pk0

        monkeypatch.setattr(eng.Engine, "_primary_rays", half)
    elif fault == "an answer altered":
        orig = eng.Engine.render

        def altered(self, v, **kw):
            res = orig(self, v, **kw)
            res.image = res.image.copy()
            res.image[0, 0, 0] ^= 1
            return res

        monkeypatch.setattr(eng.Engine, "render", altered)


@pytest.mark.parametrize("fault", ["state unchanged",
                                   "half the rays left out",
                                   "an answer altered"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    bench_path, root = tiny
    _break(monkeypatch, fault)
    result, _ = run.run_cell("disks_tiny.spp4", SEED, 0.2, False,
                             bench_path, root, device="cpu")
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["check"].values())


@pytest.mark.cuda
def test_a_cell_on_the_card_is_correct(card):
    result, banned = run.run_cell("disks_2k.spp4", SEED, 2.0, False)
    assert banned == [] and result["correct"] is True
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
