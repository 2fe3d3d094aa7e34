"""The port's profiling helpers (`rust_raytrace_tpu_torch/utils/profiling.py`),
tests/test_profiling.py's two tests on torch CPU tensors, and the trace."""

import glob
import json
import os
import time

import torch

from rust_raytrace_tpu_torch.utils.profiling import (annotate, phase_timers,
                                                     sync, trace)


def test_phase_timers():
    with phase_timers() as pt:
        with pt.phase("a"):
            time.sleep(0.01)
        with pt.phase("b"):
            time.sleep(0.02)
        with pt.phase("a", sync_value=torch.ones(2)):
            time.sleep(0.01)
    r = pt.report()
    assert set(r) == {"a", "b"}
    assert r["a"] >= 0.02
    assert r["b"] >= 0.02


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
