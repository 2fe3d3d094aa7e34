"""The split wave's three metrics (`trace_ms`, `shadow_ms`, `shade_ms`) on
a synthetic traced window: the kernels launched inside `engine.trace`,
`engine.shadow` and `engine.shade`, spans nested in `engine.dispatch`; and
nothing read where the program records no such span (an unlit resident
render, or a program without them)."""

import pytest

from rtbench import bench, profile
from rtbench.run import Run

MS = 1e-3
NEW = ("trace_ms", "shadow_ms", "shade_ms")
SPANS = ("camera_ms", "enqueue_ms", "dispatch_glue_ms", "unpermute_ms",
         "readback_ms")


def _window(tmp_path, spans=True, drop_launch=False):
    """Two frames of 10 ms, each a prep [0, 1] ms launching a torch kernel
    and a dispatch [1, 8] of two waves.  Frame 0's wave 0: trace [1, 2]
    launches a port kernel (run 1.2-2.2), shadow [2, 3] a torch kernel
    (2.2-2.6) and a port kernel (2.6-3.6), shade [3, 4] a port kernel
    (3.6-4.0); wave 1: trace [4, 5] (4.1-4.4), shadow [5, 6] (5.1-5.3),
    shade [6, 7] (6.1-6.2); then at 7.5 the dispatch's own torch kernel
    (7.6-7.7).  Frame 1: one wave, trace [11, 12] (11.1-11.5), shadow
    [12, 13] (12.1-12.3), shade [13, 14] (13.1-13.2).  spans=False drops
    the three spans, as a program without them records."""
    k = "kernel"
    port = "void (anonymous namespace)::trace_streamed_kernel<1>(float)"
    glue = "void at::native::vectorized_elementwise_kernel<4>(int)"
    device = [(glue, 0.6, 0.8), (port, 1.2, 2.2), (glue, 2.2, 2.6),
              (port, 2.6, 3.6), (port, 3.6, 4.0), (port, 4.1, 4.4),
              (port, 5.1, 5.3), (port, 6.1, 6.2), (glue, 7.6, 7.7),
              (port, 11.1, 11.5), (port, 12.1, 12.3), (port, 13.1, 13.2)]
    launches = [0.5, 1.1, 2.1, 2.5, 3.5, 4.05, 5.05, 6.05, 7.5, 11.05,
                12.05, 13.05]
    if drop_launch:
        launches.remove(12.05)
    host = [("engine.prep", 0.0, 1.0), ("engine.dispatch", 1.0, 8.0),
            ("engine.prep", 10.0, 10.9), ("engine.dispatch", 10.9, 14.5)]
    if spans:
        for base in (1.0, 4.0):
            host += [("engine.trace", base, base + 1.0),
                     ("engine.shadow", base + 1.0, base + 2.0),
                     ("engine.shade", base + 2.0, base + 3.0)]
        host += [("engine.trace", 11.0, 12.0), ("engine.shadow", 12.0, 13.0),
                 ("engine.shade", 13.0, 14.0)]
    host += [("cudaLaunchKernel", t, t + 0.01) for t in launches]
    r = profile.RankTrace(
        frames=[(0.0, 10 * MS), (10 * MS, 20 * MS)],
        device=[(n, s * MS, e * MS, k) for n, s, e in device],
        host=sorted(((n, s * MS, e * MS) for n, s, e in host),
                    key=lambda h: h[1]))
    lib = tmp_path / "build" / "kernels"
    lib.mkdir(parents=True, exist_ok=True)
    (lib / "libraytrace-0.so").write_bytes(
        b"\x00_ZN12_GLOBAL__N_121trace_streamed_kernelILi1EEEvf\x00")
    names = [d[0] for d in r.device]
    return Run(frames=[], setup_s=1.0, trace=profile.Trace(
        [r], profile.port_kernel_ids(names, tmp_path)))


def _read(name, run):
    return bench.metric_module(name).read(run)


def test_the_split_waves_metrics(tmp_path):
    run = _window(tmp_path)
    assert run.trace.port_ids == {"trace_streamed_kernel"}
    # trace: 1.0 + 0.3 (frame 0) + 0.4 (frame 1) ms over two frames
    assert _read("trace_ms", run) == pytest.approx((1.3 + 0.4) / 2)
    # shadow: 0.4 + 1.0 + 0.2, then 0.2
    assert _read("shadow_ms", run) == pytest.approx((1.6 + 0.2) / 2)
    # shade: 0.4 + 0.1, then 0.1
    assert _read("shade_ms", run) == pytest.approx((0.5 + 0.1) / 2)
    # the spans nest in engine.dispatch, which still reads its torch
    # kernels: the shadow pass's and its own
    assert _read("dispatch_glue_ms", run) == pytest.approx((0.4 + 0.1) / 2)
    assert _read("camera_ms", run) == pytest.approx(0.2 / 2)


def test_no_spans_or_no_pairing_reads_nothing(tmp_path):
    """An unlit resident render, or the parent program, records none of
    the spans; a window whose launches do not pair reads nothing either; an
    untraced run has no trace."""
    bare = _window(tmp_path, spans=False)
    unpaired = _window(tmp_path, drop_launch=True)
    for name in NEW:
        assert _read(name, bare) is None
        assert _read(name, unpaired) is None
        assert _read(name, Run([(0.0, 0.1, 1)], 1.0)) is None
    assert _read("dispatch_glue_ms", bare) == pytest.approx((0.4 + 0.1) / 2)


def test_the_cells_metrics_are_listed():
    """The three metrics are read in the dog's cell alone, each moving the
    rays a second; the engine's phase spans are read in both cells."""
    import json

    b = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    got = {m["name"]: m for m in b["per_layer"] if m["name"] in NEW}
    assert set(got) == set(NEW)
    for m in got.values():
        assert m["workloads"] == ["dog_1080.lit.spp4"]
        assert m["moves"] == "mrays_per_s"
        assert m["layer"] == ("wave split: Engine._union_wave and "
                              "Engine._streamed_wave")
    cell = bench.load_cell("dog_1080.lit.spp4")
    assert cell.chips == 1 and cell.traffic["lit"] is True
    assert cell.traffic["spp"] == 4
    assert set(NEW) <= {m.name for m in cell.metrics}
    disks = {m.name for m in bench.load_cell("disks_2k.spp4").metrics}
    assert not set(NEW) & disks
    assert set(SPANS) <= disks & {m.name for m in cell.metrics}
