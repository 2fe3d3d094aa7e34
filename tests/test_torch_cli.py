"""The port's command line on the CPU (`--device cpu`) against the JAX
package's, at 16x16 on circles: the same arguments write the same PNG bytes
and the same debug CSV; the other options run; `diff` finds no error;
`tune` walks a reduced grid; and `--device cuda` without a card fails."""

import os

import pytest
import torch

from rust_raytrace_tpu.cli import main as jax_main
from rust_raytrace_tpu_torch import cli
from rust_raytrace_tpu_torch.utils import native, png

ASSET = os.path.join(os.path.dirname(__file__), "assets", "two_mats.obj")
BASE = ["--scene", "circles", "--resolution", "16x16", "--maxdepth", "2"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(*args):
    return cli.main(["render", "--device", "cpu", *BASE, *args])


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    """The JAX CLI's outputs, rendered once: {backend: PNG bytes}, and the
    engine's debug CSV."""
    d = tmp_path_factory.mktemp("jax_cli")
    out = {}
    for backend in ("engine", "xla", "oracle"):
        path = str(d / f"{backend}.png")
        assert jax_main(["render", *BASE, "--backend", backend,
                         "--out", path]) == 0
        out[backend] = open(path, "rb").read()
    csv = str(d / "engine.csv")
    assert jax_main(["render", *BASE, "--backend", "engine", "--out",
                     str(d / "debug.png"), "--debug-csv", csv]) == 0
    out["csv"] = open(csv).read()
    return out


@pytest.mark.parametrize("backend", ["engine", "xla", "oracle"])
def test_render_png_equals_jax_cli(backend, jax_out, tmp_path):
    path = str(tmp_path / "t.png")
    native.reset_launch_counts()
    assert port("--backend", backend, "--out", path) == 0
    assert all(k.launches == 0 for k in native.KERNELS)
    assert open(path, "rb").read() == jax_out[backend]


def test_debug_csv_equals_jax_cli(jax_out, tmp_path):
    csv = str(tmp_path / "d.csv")
    assert port("--backend", "engine", "--out", str(tmp_path / "t.png"),
                "--debug-csv", csv) == 0
    text = open(csv).read()
    assert text == jax_out["csv"]
    assert len(text.splitlines()) == 1 + 16 * 16


@pytest.mark.parametrize("args", [
    ("--band-rows", "16"),
    ("--f32",),
    ("--stats", "--progress"),
    ("--backend", "simple"),
    ("--backend", "pallas_interpret"),
    ("--backend", "oracle", "--view"),
], ids=lambda a: " ".join(a))
def test_render_options_run(args, tmp_path, capsys):
    path = str(tmp_path / "t.png")
    assert port(*args, "--out", path) == 0
    assert png.read_png(path).shape == (16, 16, 3)
    text = capsys.readouterr().out
    assert f"wrote {path}" in text
    if "--stats" in args:
        assert "million rays" in text
    if "--view" in args:
        assert "▀" in text


def test_band_rows_png_equals_render_banded(tmp_path):
    """--band-rows renders through Engine.render_banded (two bands of 16
    rows at 16x32), under key 0."""
    from rust_raytrace_tpu_torch.engine import Engine
    from rust_raytrace_tpu_torch.models import circles
    from rust_raytrace_tpu_torch.utils.rng import prng_key

    path = str(tmp_path / "b.png")
    assert cli.main(["render", "--device", "cpu", "--scene", "circles",
                     "--resolution", "16x32", "--maxdepth", "2",
                     "--band-rows", "16", "--out", path]) == 0
    scene, vp = circles.build(resolution=(16, 32), maxdepth=2)
    want = Engine(scene, device="cpu").render_banded(
        vp, key=prng_key(0), band_rows=16).image
    assert (png.read_png(path) == want).all()


def test_golden_rmse(tmp_path, capsys):
    path = str(tmp_path / "t.png")
    assert port("--out", path) == 0
    assert port("--out", str(tmp_path / "u.png"), "--golden", path) == 0
    assert f"rmse vs {path}: 0.000000" in capsys.readouterr().out


def test_obj_scene(tmp_path):
    out = str(tmp_path / "o.png")
    assert cli.main(["render", "--device", "cpu", "--scene", "obj", "--obj",
                     ASSET, "--resolution", "16x16", "--backend", "oracle",
                     "--maxdepth", "2", "--out", out]) == 0
    assert png.read_png(out).shape == (16, 16, 3)
    with pytest.raises(SystemExit, match="--obj"):
        cli.main(["render", "--device", "cpu", "--scene", "obj",
                  "--resolution", "16x16", "--backend", "oracle", "--out",
                  out])


def test_diff_engine_oracle_finds_no_error(capsys):
    assert cli.main(["diff", "--device", "cpu", *BASE, "--a", "engine",
                     "--b", "oracle"]) == 0
    assert "Found 0 errors" in capsys.readouterr().out


def test_tune_walks_a_reduced_grid(monkeypatch, capsys):
    """The grid is a module constant: the test narrows it (the CLI's own
    default is the JAX CLI's, ray_chunk up to 4096)."""
    assert cli.CHUNK_OPTS == (256, 512, 1024, 2048, 4096)
    monkeypatch.setattr(cli, "CHUNK_OPTS", (128, 256))
    monkeypatch.setattr(cli, "PAGE_STEPS", range(0, 2))
    assert cli.main(["tune", "--device", "cpu", *BASE]) == 0
    text = capsys.readouterr().out
    assert text.count("Runtime: ") >= 2
    assert "Found minimum at page_size=" in text


def test_device_cuda_without_a_card_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["render", *BASE, "--out", str(tmp_path / "t.png")])
    assert e.value.code not in (0, None)
    assert not (tmp_path / "t.png").exists()
