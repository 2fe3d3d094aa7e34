"""Fixtures of the benchmark's own tests: a throwaway benchmark at a tiny
size, laid out as the real one (its BENCHMARK.json, configs, cells and
metric readers), which the harness drives on the CPU."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from rtbench import bench

TINY = (64, 32)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where torch sees none")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(res=TINY, lit=True) -> dict:
    """The disks configuration at res pixels, its camera turned onto the
    larger disk so that most rays hit and bounce; lit by a light above."""
    cfg = json.loads((bench.HERE / "configs" / "disks_2k.json").read_text())
    cfg.update(name="disks_tiny", resolution=list(res),
               camera={"pos": [2.0, 0.0, 0.0], "dir": [2.0, 4.0, 7.0],
                       "roll": 0.0},
               light={"orig": [-4.0, 8.0, 0.0], "len2": 0.2} if lit else None)
    return cfg


def write_tiny(root: Path, cells=(("spp4", 4, False, 1), ("lit", 1, True, 1))):
    """A benchmark of the disks configuration at TINY pixels under root:
    its BENCHMARK.json and data directory (root itself)."""
    shutil.copytree(bench.HERE / "metrics", root / "metrics")
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    real = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    (root / "configs" / "disks_tiny.json").write_text(
        json.dumps(tiny_config()))
    workloads = []
    for traffic, spp, lit, ranks in cells:
        name = f"disks_tiny.{traffic}"
        (root / "workloads" / f"{name}.json").write_text(json.dumps({
            "config": "disks_tiny", "traffic": traffic, "spp": spp,
            "lit": lit, "ranks": ranks}))
        workloads.append({"name": name, "config": "disks_tiny",
                          "traffic": traffic, "chips": ranks,
                          "why": "a test"})
    real["workloads"] = workloads
    real["configs"] = [{**real["configs"][0], "name": "disks_tiny",
                        "file": "configs/disks_tiny.json"}]
    (root / "BENCHMARK.json").write_text(json.dumps(real))
    return root / "BENCHMARK.json", root


@pytest.fixture(autouse=True)
def _few_frames(monkeypatch):
    """The tiny runs check the window's first frame and trace two."""
    from rtbench import traffic

    monkeypatch.setattr(traffic, "CHECK_WITHIN", 1)
    monkeypatch.setattr(traffic, "TRACE_FRAMES", 2)


@pytest.fixture
def tiny(tmp_path):
    return write_tiny(tmp_path)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda", 0)
