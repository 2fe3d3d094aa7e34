"""The port's profiling helpers (`rust_raytrace_tpu_torch/utils/profiling.py`):
tests/test_profiling.py's `sync` test on torch CPU tensors, the trace, and
the spans `Engine.render` records (`engine.prep`, `engine.dispatch`,
`engine.unpermute`, `engine.readback`; a float image's `engine.unpermute`
after its readback) on the CPU."""

import contextlib
import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.models import circles
from rust_raytrace_tpu_torch.utils import profiling
from rust_raytrace_tpu_torch.utils.profiling import annotate, sync, trace

#: a quantized render's spans: the image is un-tiled where it lies, before
#: the copy to the host
SPANS = ("engine.prep", "engine.dispatch", "engine.unpermute",
         "engine.readback")
#: a float render's: the un-permute runs on the host, after the copy
FLOAT_SPANS = ("engine.prep", "engine.dispatch", "engine.readback",
               "engine.unpermute")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    """circles at 16x32, spp 2 (tile 16: two bands of 16 rows), 2 waves."""
    scene, vp = circles.build(resolution=(16, 32), maxdepth=2, samples=2)
    return Engine(scene, device="cpu", ray_chunk=128), vp


def _profiled(fn):
    """fn() under a CPU torch.profiler; returns (its value, the events:
    (name, start us, end us, thread) sorted by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted(((e.name, e.time_range.start, e.time_range.end,
                      e.thread) for e in prof.events()), key=lambda x: x[1])
    return out, events


def _assert_spans_each_frame(events, want):
    """Each of the two frames holds the four spans once, in the order
    `want`, one after another, on the frame's thread."""
    for i in range(2):
        (_, lo, hi, thread), = [e for e in events
                                if e[0] == f"test.frame{i}"]
        spans = [e for e in events if e[0].startswith("engine.")
                 and lo <= e[1] and e[2] <= hi]
        assert tuple(name for name, *_ in spans) == want
        assert all(t == thread for *_, t in spans)
        for (_, _, end, _), (_, start, _, _) in zip(spans, spans[1:]):
            assert end <= start
    assert sum(e[0].startswith("engine.") for e in events) == 8


def _two_frames(eng, vp, **kw):
    def run():
        for i in range(2):
            with record_function(f"test.frame{i}"):
                eng.render(vp, **kw)
    return run


def test_render_records_the_four_spans_in_order_each_frame(small):
    eng, vp = small
    _, events = _profiled(_two_frames(eng, vp))
    _assert_spans_each_frame(events, SPANS)


def test_a_float_render_unpermutes_after_its_readback(small):
    eng, vp = small
    _, events = _profiled(_two_frames(eng, vp, quantize=False))
    _assert_spans_each_frame(events, FLOAT_SPANS)


def test_spans_off_are_one_null_context_and_leave_the_bits(small):
    eng, vp = small
    a, b = annotate("engine.prep"), annotate("other")
    assert a is b is profiling._OFF
    assert isinstance(a, contextlib.nullcontext)
    off = eng.render(vp)
    on, events = _profiled(lambda: eng.render(vp))
    assert {name for name, *_ in events} >= set(SPANS)
    assert off.image.dtype == on.image.dtype == np.uint8
    np.testing.assert_array_equal(off.image, on.image)
    np.testing.assert_array_equal(off.wave_rays, on.wave_rays)


@pytest.mark.parametrize("path", ["banded", "sharded"])
def test_every_render_path_records_the_dispatch_span(small, path):
    """render_banded (two bands) and render_sharded (two shards of the
    CPU) run `_dispatch` twice a frame, each inside `engine.dispatch`; the
    other three spans are render()'s own.  Under fixed_rng both images
    equal render()'s."""
    eng, vp = small
    if path == "banded":
        res, events = _profiled(lambda: eng.render_banded(
            vp, band_rows=16, fixed_rng=True))
    else:
        res, events = _profiled(lambda: eng.render_sharded(
            vp, n_devices=2, fixed_rng=True))
    names = [name for name, *_ in events if name.startswith("engine.")]
    assert names == ["engine.dispatch"] * 2
    np.testing.assert_array_equal(res.image,
                                  eng.render(vp, fixed_rng=True).image)


def test_sync_forces_completion():
    x = torch.ones((8, 8)) * 2.0
    sync(x)          # a CPU tensor: nothing to wait for
    sync([x, x])     # list form
    sync((x,))
    assert float(x[0, 0]) == 2.0


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    logdir = str(tmp_path / "tr")
    with trace(logdir) as prof:
        with annotate("port-span"):
            y = torch.ones((64, 64)) @ torch.ones((64, 64))
    assert float(y[0, 0]) == 64.0
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert files == [prof.trace_path]
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "port-span" in names
    assert any("matmul" in (n or "") or "mm" == (n or "").split("::")[-1]
               for n in names)
