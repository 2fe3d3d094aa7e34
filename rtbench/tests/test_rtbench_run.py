"""A run of the harness on the CPU at a tiny size, what it prints, and what
it imports."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from rtbench import bench, run

SEED = 2 ** 31 + 977


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cpu_run_is_correct_and_keyed(tiny, trace):
    bench_path, root = tiny
    result, banned = run.run_cell("disks_tiny.spp4", SEED, 0.5,
                                  bool(trace), bench_path, root,
                                  device="cpu")
    assert banned == []
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[:5] == keys
    assert list(result)[5:] == (["breakdown", "check"] if trace
                                else ["check"])
    assert result["correct"] is True and result["failed"] == 0
    want = ({"host_gap_ms", "glue_ms", "kernels_ms", "device_idle_pct"}
            if trace else {"mrays_per_s", "frame_ms_p95", "setup_s"})
    assert set(result["metrics"]) == want
    assert all(v["limit"] == 0 and v["value"] == 0
               for v in result["check"].values())
    json.dumps(result)


def test_no_card_no_result():
    # no card visible, also on a machine that has one
    p = subprocess.run(
        [sys.executable, "-m", "rtbench.run", "--workload",
         "disks_2k.spp4", "--seed", "1", "--seconds", "1"],
        cwd=bench.ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_no_jax(tiny):
    bench_path, root = tiny
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        "from rtbench import run, traffic\n"
        "traffic.CHECK_WITHIN = 1\n"
        f"res, banned = run.run_cell('disks_tiny.lit', {SEED}, 0.1, False,"
        f" {str(bench_path)!r}, {str(root)!r}, device='cpu')\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(mods & {'jax', 'jaxlib', 'flax', 'rust_raytrace_tpu'}),"
        " banned, res['correct'])\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[] [] True"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    ref = bench.HERE / "reference"
    for path in ref.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "rust_raytrace_tpu",
                           "rust_raytrace_tpu_torch", "rtbench"}, path
    code = ("import sys, json\n"
            "from rtbench.reference import render, geometry\n"
            "from rtbench.reference.scenes import disks\n"
            "from rtbench import check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT,
                       capture_output=True, text=True, timeout=300)
    tops = set(json.loads(p.stdout.strip().replace("'", '"')))
    assert not tops & {"jax", "jaxlib", "rust_raytrace_tpu",
                       "rust_raytrace_tpu_torch"}


def test_a_tiny_run_across_four_processes_is_correct(tmp_path, monkeypatch):
    # four gloo ranks on the CPU, one shard each, as the nccl ranks of the
    # four-card cell; one thread each, or their threads contend
    from rtbench.tests.conftest import write_tiny

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    bench_path, root = write_tiny(tmp_path, cells=(("lit.x4", 1, True, 4),))
    result, banned = run.run_cell("disks_tiny.lit.x4", SEED, 0.2, True,
                                  bench_path, root, device="cpu")
    assert banned == [] and result["correct"] is True
    assert result["device"]["count"] == 4
