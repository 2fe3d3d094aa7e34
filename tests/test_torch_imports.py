"""The torch port stands apart from JAX and from the JAX package: every
module imports with both blocked, and the constants it copies equal the JAX
package's."""

import os
import subprocess
import sys

import pytest

import rust_raytrace_tpu.materials as jmaterials
import rust_raytrace_tpu.ops.compact as jcompact
import rust_raytrace_tpu.ops.intersect_pallas as jtrace
import rust_raytrace_tpu.ops.intersect_perlane as jperlane
import rust_raytrace_tpu.ops.pages as jpages
import rust_raytrace_tpu_torch.materials as tmaterials
import rust_raytrace_tpu_torch.ops.compact as tcompact
import rust_raytrace_tpu_torch.ops.intersect_perlane as tperlane
import rust_raytrace_tpu_torch.ops.pages as tpages
import rust_raytrace_tpu_torch.ops.state as tstate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "rust_raytrace_tpu_torch",
    "rust_raytrace_tpu_torch.engine",
    "rust_raytrace_tpu_torch.render",
    "rust_raytrace_tpu_torch.math3d",
    "rust_raytrace_tpu_torch.materials",
    "rust_raytrace_tpu_torch.geometry",
    "rust_raytrace_tpu_torch.scene",
    "rust_raytrace_tpu_torch.camera",
    "rust_raytrace_tpu_torch.obj_parser",
    "rust_raytrace_tpu_torch.models",
    "rust_raytrace_tpu_torch.models.circles",
    "rust_raytrace_tpu_torch.models.teapot",
    "rust_raytrace_tpu_torch.models.objfile",
    "rust_raytrace_tpu_torch.models.multi",
    "rust_raytrace_tpu_torch.ops.pages",
    "rust_raytrace_tpu_torch.ops.state",
    "rust_raytrace_tpu_torch.ops.shade",
    "rust_raytrace_tpu_torch.ops.cull",
    "rust_raytrace_tpu_torch.ops.intersect",
    "rust_raytrace_tpu_torch.ops.intersect_perlane",
    "rust_raytrace_tpu_torch.ops.intersect_streamed",
    "rust_raytrace_tpu_torch.ops.intersect_xla",
    "rust_raytrace_tpu_torch.ops.compact",
    "rust_raytrace_tpu_torch.utils.rng",
    "rust_raytrace_tpu_torch.utils.native",
    "rust_raytrace_tpu_torch.utils.xla_rsqrt",
    "rust_raytrace_tpu_torch.utils.png",
    "rust_raytrace_tpu_torch.utils.progress",
    "rust_raytrace_tpu_torch.cli",
    "rust_raytrace_tpu_torch.oracle",
    "rust_raytrace_tpu_torch.octree",
    "rust_raytrace_tpu_torch.utils.raydebug",
    "rust_raytrace_tpu_torch.utils.term_display",
    "rust_raytrace_tpu_torch.utils.tracelog",
    "rust_raytrace_tpu_torch.utils.host_native",
    "rust_raytrace_tpu_torch.parallel",
    "rust_raytrace_tpu_torch.parallel.sharding",
    "rust_raytrace_tpu_torch.parallel.distributed",
    "rust_raytrace_tpu_torch.ops.intersect_ref",
    "rust_raytrace_tpu_torch.utils.parity",
    "rust_raytrace_tpu_torch.utils.profiling",
    "rust_raytrace_tpu_torch.utils.devbench",
    "rust_raytrace_tpu_torch.utils.roofline",
]


def _run_blocked(body: str, blocked=("jax",)):
    """Run `body` in a subprocess, because this process (tests/conftest.py)
    already imported jax: with sys.modules[name] = None, importing a
    blocked package raises."""
    code = ("import sys\n"
            + "".join(f"sys.modules[{b!r}] = None\n" for b in blocked)
            + body + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_imports_without_jax():
    _run_blocked("".join(f"import {m}\n" for m in PORT_MODULES))


def test_port_imports_without_the_jax_package():
    """Nothing of rust_raytrace_tpu, not even its jax-free modules; the
    port renders with both blocked."""
    _run_blocked(
        "".join(f"import {m}\n" for m in PORT_MODULES)
        + "from rust_raytrace_tpu_torch.engine import Engine\n"
        "from rust_raytrace_tpu_torch.models import circles\n"
        "scene, vp = circles.build(resolution=(16, 9), maxdepth=2)\n"
        "img = Engine(scene, ray_chunk=128, device='cpu').render(vp).image\n"
        "assert img.shape == (9, 16, 3)\n",
        blocked=("jax", "rust_raytrace_tpu"))


def test_portable_renderer_runs_without_the_jax_package():
    """WavefrontRenderer, both backends, with jax and the JAX package
    blocked (one torch thread: the suite's workers share the host)."""
    _run_blocked(
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from rust_raytrace_tpu_torch.models import circles\n"
        "from rust_raytrace_tpu_torch.render import WavefrontRenderer\n"
        "scene, vp = circles.build(resolution=(16, 9), maxdepth=2)\n"
        "for b in ('kernel', 'portable'):\n"
        "    img = WavefrontRenderer(scene, backend=b, device='cpu')"
        ".render(vp).image\n"
        "    assert img.shape == (9, 16, 3)\n",
        blocked=("jax", "rust_raytrace_tpu"))


def test_banded_bank_major_and_perlane_shadow_run_without_the_jax_package():
    """render_banded, the bank-major streamed Engine and the per-lane
    shadow pass, with jax and the JAX package blocked."""
    _run_blocked(
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from rust_raytrace_tpu_torch import engine\n"
        "from rust_raytrace_tpu_torch.models import circles\n"
        "from rust_raytrace_tpu_torch.ops.intersect_perlane import "
        "perlane_tables, upload_perlane_tables\n"
        "from rust_raytrace_tpu_torch.utils.rng import prng_key\n"
        "scene, vp = circles.build(resolution=(16, 16), maxdepth=3)\n"
        "e = engine.Engine(scene, ray_chunk=128, device='cpu')\n"
        "img = e.render_banded(vp, band_rows=16).image\n"
        "assert img.shape == (16, 16, 3)\n"
        "s = engine.Engine(scene, ray_chunk=128, streamed=True, "
        "bank_major=True, device='cpu')\n"
        "assert s.render(vp).image.shape == (16, 16, 3)\n"
        "st = torch.zeros((16, 128))\n"
        "st[5] = st[7] = 1.0\n"
        "rows = torch.zeros((16, 128))\n"
        "m = engine.shadow_mask_perlane(st, rows, prng_key(0), 1, True, "
        "(0.0, 5.0, 0.0, 0.1), "
        "perlane_tables(*upload_perlane_tables(e.pages, 'cpu')), "
        "e.page_size, 128)\n"
        "assert m.shape == (128,) and not m.any()\n",
        blocked=("jax", "rust_raytrace_tpu"))


def test_cli_runs_without_the_jax_package():
    """The command line on the CPU (engine, oracle and the ray differ), with
    jax and the JAX package blocked."""
    _run_blocked(
        "import os, tempfile, torch\n"
        "torch.set_num_threads(1)\n"
        "from rust_raytrace_tpu_torch.cli import main\n"
        "base = ['--device', 'cpu', '--scene', 'obj', '--obj', "
        "'tests/assets/two_mats.obj', '--resolution', '16x16', "
        "'--maxdepth', '2']\n"
        "out = os.path.join(tempfile.mkdtemp(), 't.png')\n"
        "for b in ('engine', 'oracle'):\n"
        "    assert main(['render', *base, '--backend', b, '--out', "
        "out]) == 0\n"
        "assert main(['diff', *base, '--a', 'engine', '--b', 'oracle']) "
        "== 0\n",
        blocked=("jax", "rust_raytrace_tpu"))


def _imports_of(path):
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py names no jax or rust_raytrace_tpu import, and its
    import block loads with both blocked."""
    names = _imports_of(os.path.join(ROOT, "chip_smoke.py"))
    bad = [n for n in names if n.split(".")[0] in ("jax", "rust_raytrace_tpu")]
    assert not bad, bad
    _run_blocked("import runpy\n"
                 "runpy.run_path('chip_smoke.py', run_name='imported')\n",
                 blocked=("jax", "rust_raytrace_tpu"))


@pytest.mark.parametrize("module", PORT_MODULES)
def test_port_module_imports_nothing_of_jax(module):
    import importlib
    path = importlib.import_module(module).__file__
    bad = [n for n in _imports_of(path)
           if n.split(".")[0] in ("jax", "rust_raytrace_tpu")]
    assert not bad, bad


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


@pytest.mark.parametrize("name", [
    "DEFAULT_CB", "ALIGN", "M_CNT_A", "M_CASE_A", "M_OFF_A", "M_CNT_D",
    "M_CASE_D", "M_OFF_D", "M_IDENT", "META_COLS", "ROW_CODE"])
def test_compact_constants_equal_jax(name):
    assert getattr(tcompact, name) == getattr(jcompact, name)


@pytest.mark.parametrize("name", [
    "LANE_N", "LANE_S0", "LANE_S1", "LANE_S2", "LANE_NC", "LANE_S0C",
    "LANE_S1C", "LANE_S2C", "LANE_ID", "LANE_ET", "LANE_KIND", "LANE_COLOR",
    "LANE_ALPHA", "LANE_SCAT", "PACK_LANES"])
def test_page_lanes_equal_jax(name):
    assert getattr(tpages, name) == getattr(jpages, name)


def test_render_constants_equal_jax():
    """The sky of the portable shade and the fixed_rng scatter vector,
    which XLA folds from unit((0.36, 0.48, 0.8)) inside the jitted
    trace_rays."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import rust_raytrace_tpu.render as jrender
    import rust_raytrace_tpu_torch.render as trender
    np.testing.assert_array_equal(np.asarray(trender.SKY, np.float32),
                                  np.asarray(jrender.SKY))
    folded = jax.jit(lambda: jrender._unit(
        jnp.asarray([0.36, 0.48, 0.8], dtype=jnp.float32)))()
    np.testing.assert_array_equal(np.asarray(trender.FIXED_RV, np.float32),
                                  np.asarray(folded))


@pytest.mark.parametrize("name", ["KIND_SOLID", "KIND_MATTE",
                                  "KIND_REFLECTIVE"])
def test_material_kinds_equal_jax(name):
    assert getattr(tmaterials, name) == getattr(jmaterials, name)


def test_cull_sorted_miss_key_equals_jax():
    """B13's finite key of a missed page."""
    import rust_raytrace_tpu.ops.cull_pallas as jcull
    import rust_raytrace_tpu_torch.ops.cull as tcull
    assert tcull.BIGT == jcull.BIGT
