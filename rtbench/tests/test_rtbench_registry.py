"""The harness finds cells, configurations and metrics by name, and a new
cell or metric is new files only."""

import json

from rtbench import bench


def test_every_cell_of_the_benchmark_loads():
    real = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    for w in real["workloads"]:
        cell = bench.load_cell(w["name"])
        assert cell.chips == w["chips"] == cell.traffic["ranks"]
        assert cell.config["name"] == w["config"]
        names = [m.name for m in cell.metrics]
        assert "setup_s" in names and any(m.per_layer for m in cell.metrics)
        assert ("collective_ms" in names) == (w["chips"] > 1)
    for c in real["configs"]:
        assert (bench.ROOT / c["file"]).is_file()
        assert bench.recipe(json.loads(
            (bench.ROOT / c["file"]).read_text())["recipe"], reference=True)


def test_a_throwaway_cell_and_metric_need_only_new_files(tiny):
    bench_path, root = tiny
    (root / "workloads" / "disks_tiny.extra.json").write_text(json.dumps({
        "config": "disks_tiny", "traffic": "extra", "spp": 2,
        "lit": False, "ranks": 1}))
    (root / "metrics" / "frames_seen.py").write_text(
        "def read(run):\n    return float(len(run.frames))\n")
    b = json.loads(bench_path.read_text())
    b["workloads"].append({"name": "disks_tiny.extra",
                           "config": "disks_tiny", "traffic": "extra",
                           "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "frames_seen", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "mrays_per_s",
                           "workloads": ["disks_tiny.extra"]})
    bench_path.write_text(json.dumps(b))
    cell = bench.load_cell("disks_tiny.extra", bench_path, root)
    assert cell.traffic["spp"] == 2
    m = {m.name: m for m in cell.metrics}["frames_seen"]
    assert m.per_layer and m.read(type("R", (), {"frames": [1, 2]})) == 2.0
    other = bench.load_cell("disks_tiny.spp4", bench_path, root)
    assert "frames_seen" not in [m.name for m in other.metrics]
