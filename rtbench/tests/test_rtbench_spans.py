"""The engine's spans and the card's work tied to the span that launched
it (`rtbench/spans.py`): each new metric's arithmetic on a synthetic
traced window, a run on the CPU that reads the spans, and on the card the
pairing of launches held to the profiler's own correlation ids."""

import json

import pytest

from rtbench import bench, profile, run, spans
from rtbench.run import Run

NEW = ("unpermute_ms", "readback_ms", "enqueue_ms", "camera_ms",
       "dispatch_glue_ms")
SEED = 2 ** 31 + 1213
MS = 1e-3


def _window(tmp_path, host_extra=(), drop_launch=False):
    """Two frames of 10 ms.  Frame 0: prep [0, 2] ms launches a torch
    kernel (run 1.5-2.5), dispatch [2, 6] a torch kernel (3.5-4.5) and a
    port kernel (4.5-5.5), readback [6, 8] a kernel (6.3-6.4) and a copy
    (6.6-6.8), unpermute [8, 9.5]; a kernel launched at 9.7 ms, in no span
    (9.8-9.9).  Frame 1: prep [10, 11], dispatch [11, 13] launching a torch
    kernel (12.5-14.5), readback [13, 16], unpermute [16, 19]."""
    k = "kernel"
    device = [
        ("void at::native::vectorized_elementwise_kernel<4>(int)",
         1.5, 2.5, k),
        ("void at::native::radix_sort_kernel<1>(int)", 3.5, 4.5, k),
        ("void (anonymous namespace)::cull_kernel<1>(float const*)",
         4.5, 5.5, k),
        ("void at::native::CatArrayBatchedCopy<int>(int)", 6.3, 6.4, k),
        ("Memcpy DtoH (Device -> Pageable)", 6.6, 6.8, "copy"),
        ("void at::native::vectorized_elementwise_kernel<4>(int)",
         9.8, 9.9, k),
        ("void at::native::vectorized_elementwise_kernel<4>(int)",
         12.5, 14.5, k)]
    host = [
        ("engine.prep", 0.0, 2.0), ("cudaLaunchKernel", 1.0, 1.01),
        ("engine.dispatch", 2.0, 6.0), ("cudaLaunchKernel", 3.0, 3.01),
        ("cudaLaunchKernel", 4.0, 4.01),
        ("engine.readback", 6.0, 8.0), ("cudaLaunchKernel", 6.2, 6.21),
        ("cudaMemcpyAsync", 6.5, 6.9), ("cudaStreamSynchronize", 6.9, 7.9),
        ("engine.unpermute", 8.0, 9.5), ("cudaLaunchKernel", 9.7, 9.71),
        ("engine.prep", 10.0, 11.0), ("engine.dispatch", 11.0, 13.0),
        ("cudaLaunchKernel", 12.0, 12.01),
        ("engine.readback", 13.0, 16.0), ("engine.unpermute", 16.0, 19.0),
        *host_extra]
    if drop_launch:
        host.remove(("cudaLaunchKernel", 12.0, 12.01))
    r = profile.RankTrace(
        frames=[(0.0, 10 * MS), (10 * MS, 20 * MS)],
        device=[(n, s * MS, e * MS, kind) for n, s, e, kind in device],
        host=sorted(((n, s * MS, e * MS) for n, s, e in host),
                    key=lambda h: h[1]))
    lib = tmp_path / "build" / "kernels"
    lib.mkdir(parents=True, exist_ok=True)
    (lib / "libraytrace-0.so").write_bytes(
        b"\x00_ZN12_GLOBAL__N_111cull_kernelILi1EEEvPKf\x00")
    names = [d[0] for d in r.device]
    return Run(frames=[], setup_s=1.0, trace=profile.Trace(
        [r], profile.port_kernel_ids(names, tmp_path)))


def _read(name, run):
    return bench.metric_module(name).read(run)


def test_launches_pair_with_the_cards_work_kind_by_kind(tmp_path):
    r = _window(tmp_path).trace.ranks[0]
    at = spans.launched_at(r, "kernel")
    assert [None if a is None else round(a / MS, 6) for a in at] == [
        1.0, 3.0, 4.0, 6.2, None, 9.7, 12.0]
    copies = spans.launched_at(r, "copy")
    assert [a is not None for a in copies] == [False] * 4 + [True, False,
                                                             False]
    # a memset call the card never ran breaks the copies' pairing alone
    extra = _window(tmp_path, [("cudaMemsetAsync", 7.0, 7.01)])
    assert spans.launched_at(extra.trace.ranks[0], "copy") is None
    assert spans.launched_at(extra.trace.ranks[0], "kernel") == at
    assert spans.device_s_by_span(r, (spans.PREP,)) == pytest.approx(MS)
    assert spans.device_s_by_span(
        r, (spans.READBACK,), "copy") == pytest.approx(0.2 * MS)


def test_the_new_metrics_arithmetic(tmp_path):
    run = _window(tmp_path)
    assert _read("unpermute_ms", run) == pytest.approx((1.5 + 3.0) / 2)
    assert _read("readback_ms", run) == pytest.approx((2.0 + 3.0) / 2)
    assert _read("enqueue_ms", run) == pytest.approx((6.0 + 3.0) / 2)
    # the prep kernel; the dispatch's torch kernels, not the port's
    assert _read("camera_ms", run) == pytest.approx(1.0 / 2)
    assert _read("dispatch_glue_ms", run) == pytest.approx((1.0 + 2.0) / 2)
    # glue_ms times the same kernels, with the readback's and the
    # stray one, from outside
    assert _read("glue_ms", run) == pytest.approx((1 + 1 + 0.1 + 0.1 + 2) / 2)
    assert _read("kernels_ms", run) == pytest.approx(1.0 / 2)


def test_no_spans_or_no_pairing_reads_nothing(tmp_path):
    run = _window(tmp_path)
    r = run.trace.ranks[0]
    bare = Run([], 1.0, profile.Trace(
        [profile.RankTrace(r.frames, r.device, [
            h for h in r.host if not h[0].startswith("engine.")])],
        run.trace.port_ids))
    unpaired = _window(tmp_path, drop_launch=True)
    for name in NEW:
        assert _read(name, bare) is None
        assert _read(name, Run([(0.0, 0.1, 1)], 1.0)) is None
    for name in ("camera_ms", "dispatch_glue_ms"):
        assert _read(name, unpaired) is None
    assert _read("unpermute_ms", unpaired) == pytest.approx(2.25)


def test_a_tiny_cpu_run_reads_the_host_spans(tiny):
    """The five metrics listed for the tiny cell: the CPU window has the
    spans but nothing on a card, so the host spans read and the kernels'
    two do not."""
    bench_path, root = tiny
    b = json.loads(bench_path.read_text())
    for m in b["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("disks_tiny.spp4")
    bench_path.write_text(json.dumps(b))
    result, banned = run.run_cell("disks_tiny.spp4", SEED, 0.5, True,
                                  bench_path, root, device="cpu")
    assert banned == [] and result["correct"] is True
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(got) == {"host_gap_ms", "glue_ms", "kernels_ms",
                        "device_idle_pct", "unpermute_ms", "readback_ms",
                        "enqueue_ms"}
    assert all(got[k] > 0 for k in ("unpermute_ms", "readback_ms",
                                    "enqueue_ms"))
    assert got["enqueue_ms"] + got["readback_ms"] + got["unpermute_ms"] \
        <= got["host_gap_ms"]


@pytest.mark.cuda
def test_the_pairing_is_the_profilers_correlation_on_the_card(card):
    """Three traced frames of disks_2k.spp4 on the card: every kernel's
    launch by order is the launch of its correlation id, and the spans
    cover the frame and the glue as the metrics need."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    from rust_raytrace_tpu_torch.engine import Engine

    cell = bench.load_cell("disks_2k.spp4")
    tr = cell.traffic
    scene, view = bench.recipe(cell.config["recipe"]).build(
        cell.config, int(tr["spp"]), bool(tr["lit"]))
    eng = Engine(scene, device=card)
    for i in range(2):
        eng.render(view, key=[0, i])
    torch.cuda.synchronize(card)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            with record_function(profile.FRAME_SPAN):
                eng.render(view, key=[1, i])
    rank = profile.reduce(prof)
    events = list(prof.profiler.kineto_results.events())
    t0 = min(profile._ns(e, "start") for e in events
             if e.name() == profile.FRAME_SPAN
             and e.device_type() == DeviceType.CPU)
    launch = {e.correlation_id(): (profile._ns(e, "start") - t0) * 1e-9
              for e in events if e.device_type() == DeviceType.CPU
              and e.name().startswith(spans.LAUNCHES["kernel"])}
    by_corr = {}
    for e in events:
        if e.device_type() != DeviceType.CPU \
                and profile._device_kind(e) == "kernel":
            by_corr[(e.name(), (profile._ns(e, "start") - t0) * 1e-9)] = \
                launch.get(e.correlation_id())
    at = spans.launched_at(rank, "kernel")
    calls = [h[0] for h in rank.host if h[0].startswith(("cu", "cuda"))]
    assert at is not None, {n: calls.count(n) for n in set(calls)}
    kernels = [(d, a) for d, a in zip(rank.device, at) if d[3] == "kernel"]
    total = sum(d[2] - d[1] for d, _ in kernels)
    agree = sum(d[2] - d[1] for d, a in kernels
                if by_corr.get((d[0], d[1])) == a)
    assert agree >= 0.99 * total, (agree, total)

    names = [m["name"] for m in json.loads(
        (bench.ROOT / "BENCHMARK.json").read_text())["per_layer"]]
    port = profile.port_kernel_ids([d[0] for d in rank.device], bench.ROOT)
    window = Run([], 0.0, profile.Trace([rank], port))
    got = {n: bench.metric_module(n).read(window) for n in names}
    assert all(got[n] is not None for n in NEW), got
    frame_ms = 1e3 * sum(b - a for a, b in rank.frames) / len(rank.frames)
    host = got["unpermute_ms"] + got["readback_ms"] + got["enqueue_ms"]
    assert host >= 0.95 * frame_ms, (host, frame_ms)
    glue = got["camera_ms"] + got["dispatch_glue_ms"]
    assert abs(glue - got["glue_ms"]) <= 0.02 * got["glue_ms"], got
    # the image is un-tiled on the card: no idle stretch of the card over
    # 1 ms lies in `engine.unpermute` (the host's numpy scatter held it
    # idle for ~90 ms a frame there before)
    unpermute = spans.spans(rank, (spans.UNPERMUTE,))
    for a, b in profile.idle_gaps(rank):
        inside = sum(max(0.0, min(b, e) - max(a, s)) for s, e in unpermute)
        assert inside <= 1e-3, (a, b, inside)
