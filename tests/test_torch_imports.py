"""The torch port stands apart from JAX: every module imports with jax
blocked, and the constants it copies equal the JAX package's."""

import os
import subprocess
import sys

import pytest

import rust_raytrace_tpu.ops.compact as jcompact
import rust_raytrace_tpu.ops.intersect_pallas as jtrace
import rust_raytrace_tpu.ops.intersect_perlane as jperlane
import rust_raytrace_tpu_torch.ops.intersect_perlane as tperlane
import rust_raytrace_tpu_torch.ops.state as tstate

PORT_MODULES = [
    "rust_raytrace_tpu_torch",
    "rust_raytrace_tpu_torch.engine",
    "rust_raytrace_tpu_torch.render",
    "rust_raytrace_tpu_torch.ops.state",
    "rust_raytrace_tpu_torch.ops.shade",
    "rust_raytrace_tpu_torch.ops.cull",
    "rust_raytrace_tpu_torch.ops.intersect",
    "rust_raytrace_tpu_torch.ops.intersect_perlane",
    "rust_raytrace_tpu_torch.utils.rng",
    "rust_raytrace_tpu_torch.utils.native",
]


def test_port_imports_without_jax():
    """A subprocess, because this process (tests/conftest.py) already
    imported jax: with sys.modules["jax"] = None any jax import raises."""
    code = ("import sys\nsys.modules['jax'] = None\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("name", [
    "ROW_T", "ROW_ID", "ROW_NORM", "ROW_ENC", "ROW_COLOR", "ROW_ALPHA",
    "ROW_SCAT", "TRACE_ROWS"])
def test_trace_rows_equal_jax(name):
    assert getattr(tstate, name) == getattr(jtrace, name)


@pytest.mark.parametrize("name", [
    "ROW_O", "ROW_D", "ROW_W", "ROW_ALIVE", "ROW_ACC", "ROW_DEAD",
    "STATE_ROWS"])
def test_state_rows_equal_jax(name):
    assert getattr(tstate, name) == getattr(jcompact, name)


@pytest.mark.parametrize("name", ["N_INT", "N_SHD", "GROUP", "MAX_BANKS"])
def test_perlane_constants_equal_jax(name):
    assert getattr(tperlane, name) == getattr(jperlane, name)
