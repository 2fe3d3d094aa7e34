"""Each metric's arithmetic on a synthetic traced window."""

import pytest

from rtbench import bench, profile
from rtbench.run import Run


def _trace(tmp_path):
    # two frames of 10 ms; on the card a port kernel, a torch kernel, a copy
    # and an NCCL kernel, one overlapping another
    r = profile.RankTrace(
        frames=[(0.000, 0.010), (0.010, 0.020)],
        device=[("void (anonymous namespace)::cull_kernel<1>(float const*)",
                 0.001, 0.003, "kernel"),
                ("void at::native::vectorized_elementwise_kernel<4>(int)",
                 0.002, 0.004, "kernel"),
                ("Memcpy DtoH (Device -> Pageable)", 0.005, 0.006, "copy"),
                ("ncclDevKernel_Gather_RING_LL(x)", 0.012, 0.013, "kernel")],
        host=[("cudaMemcpyAsync", 0.004, 0.0061),
              ("aten::sort", 0.0065, 0.0095)])
    lib = tmp_path / "build" / "kernels"
    lib.mkdir(parents=True)
    (lib / "libraytrace-0.so").write_bytes(
        b"\x00_ZN12_GLOBAL__N_111cull_kernelILi1EEEvPKf\x00")
    names = [d[0] for d in r.device]
    return profile.Trace([r], profile.port_kernel_ids(names, tmp_path))


def _read(name, run):
    return bench.metric_module(name).read(run)


def test_kernel_identifiers_and_classification(tmp_path):
    tr = _trace(tmp_path)
    assert profile.kernel_identifier(
        "void (anonymous namespace)::cull_kernel<1, true>(float const*, int)"
    ) == "cull_kernel"
    assert profile.kernel_identifier(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "(anonymous namespace)::Op<float>>(int, float*)"
    ) == "vectorized_elementwise_kernel"
    assert tr.port_ids == {"cull_kernel"}


def test_layer_metrics(tmp_path):
    run = Run(frames=[], setup_s=1.0, trace=_trace(tmp_path))
    # busy: [1, 4] + [5, 6] + [12, 13] ms = 5 ms of the 20 ms window
    assert _read("device_idle_pct", run) == pytest.approx(75.0)
    # frame gaps: 10 - 4 = 6 ms and 10 - 1 = 9 ms
    assert _read("host_gap_ms", run) == pytest.approx(7.5)
    assert _read("kernels_ms", run) == pytest.approx(1.0)
    assert _read("glue_ms", run) == pytest.approx(1.0)
    assert _read("collective_ms", run) == pytest.approx(0.5)
    assert profile.busy_s(run.trace.ranks[0]) == pytest.approx(0.005)
    bd = profile.breakdown(run.trace.ranks[0])
    assert bd["device_ops"][0][1] == pytest.approx(0.002)
    gaps = dict(bd["idle_gaps"])
    # [0, 1] ms: the frame span, no op; [6, 12] ms: midpoint 9 ms, the
    # sort runs to 9.5 ms; [13, 20] ms: midpoint 16.5 ms
    assert gaps["aten::sort"] == pytest.approx(0.006)
    assert gaps[profile.FRAME_SPAN] == pytest.approx(0.001 + 0.007)


def test_untraced_runs_read_no_layer_metric():
    run = Run(frames=[(0.0, 0.1, 10_000_000), (0.1, 0.3, 10_000_000)],
              setup_s=3.0)
    for name in ("host_gap_ms", "glue_ms", "kernels_ms", "device_idle_pct",
                 "collective_ms"):
        assert _read(name, run) is None
    assert _read("mrays_per_s", run) == pytest.approx(20e6 / 0.3 / 1e6)
    assert _read("frame_ms_p95", run) == pytest.approx(195.0)
    assert _read("setup_s", run) == 3.0
